"""The PyTorch port's training slice, as a whole, against the JAX
package's executor: Transformer-base's ``build`` (paddle_tpu/models/
transformer.py:701) at a small size -- vocab 64, max_len 16, d_model 32,
d_inner 64, 4 heads, 2 + 2 layers, batch 4, dropout off.

JAX side: ``build`` under ``program_guard``, the startup program run in a
fresh scope, then ``Executor.run`` for 10 Adam steps fetching the loss and
every ``<param>@GRAD``. Port side: ``paddle_tpu_torch.models.transformer.
build`` on ``device="cpu"``, the same scope carried across with
``transformer_params_from_jax``, the same feeds, 10 steps. On the CPU the
JAX fused block runs ``ops/attention_block.py`` and the port's runs the
plain versions of its flash kernels. With ``fused_head`` the port's loss
runs the plain versions of its fused-CE kernels, against the JAX op twice:
through its CPU route, the composed matmul + CE branch (``fused_head``),
and with ``PADDLE_TPU_FORCE_PALLAS=1``, the Pallas kernel in interpret
mode (``fused_head_pallas``).

Tolerances, each with its reason:
- step-1 gradients rtol 1e-4 / atol 1e-6: one fp32 forward and backward
  whose sums run in another order on each side (the softmax normalised
  before or after the value product, XLA's dot order against torch's);
- loss curve rtol 1e-4 / atol 1e-5: the JAX package's own bound for
  curve parity (__graft_entry__.py:180), ten Adam steps amplifying those
  last-bit differences. A curve that is not finite fails outright
  (assert_allclose counts NaN equal to NaN)."""

import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import transformer as jT

from paddle_tpu_torch import learning_rate_scheduler as tlrs
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.optimizer import Adam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(src_vocab=64, tgt_vocab=64, max_len=16, d_model=32, d_inner=64,
           n_head=4, n_layer=2)
BATCH, STEPS = 4, 10
RUNS = {"fused": dict(fused_attention=True),
        "composed": dict(fused_attention=False),
        "fused_noam": dict(fused_attention=True, lr_scheduler="noam",
                           lr=1.0, warmup=4),
        "fused_head": dict(fused_attention=True, fused_head=True),
        "fused_head_pallas": dict(fused_attention=True, fused_head=True)}
PALLAS_RUNS = {"fused_head_pallas"}    # JAX side under FORCE_PALLAS=1
FORCE_PALLAS = "PADDLE_TPU_FORCE_PALLAS"
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)


def _feeds():
    rng = np.random.RandomState(2)
    shape = (BATCH, CFG["max_len"], 1)
    return [tuple(rng.randint(0, CFG["src_vocab"], shape).astype(np.int64)
                  for _ in range(3)) for _ in range(STEPS)]


def _finite_curve(curve):
    if not all(np.isfinite(curve)):
        raise AssertionError(f"non-finite loss curve: {curve}")
    return curve


def _jax_run(kw, force_pallas=False):
    """(initial parameters, step-1 gradients, loss curve) of the JAX
    executor. ``force_pallas`` sets ``PADDLE_TPU_FORCE_PALLAS=1`` for this
    run only, which sends ``fused_linear_ce`` to the Pallas kernel in
    interpret mode; the kernel's entry is wrapped to witness that it was
    traced in exactly the runs that force it."""
    pfc = importlib.import_module("paddle_tpu.ops.pallas.fused_ce")
    kernel, old = pfc.fused_linear_ce, os.environ.get(FORCE_PALLAS)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)
    pfc.fused_linear_ce = counted
    if force_pallas:
        os.environ[FORCE_PALLAS] = "1"
    try:
        out = _jax_train(kw)
    finally:
        pfc.fused_linear_ce = kernel
        if old is None:
            os.environ.pop(FORCE_PALLAS, None)
        else:
            os.environ[FORCE_PALLAS] = old
    assert bool(calls) == force_pallas, (kw, force_pallas, len(calls))
    return out


def _jax_train(kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = jT.build(**CFG, dropout=0.0, **kw)
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in names}
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    curve, grads = [], None
    for src, tgt, lbl in _feeds():
        out = exe.run(main, feed={"src_ids": src, "tgt_ids": tgt,
                                  "lbl_ids": lbl},
                      fetch_list=fetch, scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        if grads is None:
            grads = {n: np.asarray(g) for n, g in zip(names, out[1:])}
    return init, grads, _finite_curve(curve)


def _port_run(init, kw):
    model, opt = tT.build(**CFG, dropout=0.0, device="cpu", **kw)
    model.load_state_dict(convert.transformer_params_from_jax(init))
    keys = convert.transformer_state_keys(init)
    params = dict(model.named_parameters())
    curve, grads = [], None
    for src, tgt, lbl in _feeds():
        opt.zero_grad(set_to_none=True)
        loss = model(*(torch.from_numpy(x) for x in (src, tgt, lbl)))
        loss.backward()
        if grads is None:
            grads = {n: params[keys[n]].grad.numpy().copy() for n in init}
        opt.step()
        curve.append(float(loss.detach()))
    return grads, _finite_curve(curve)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX configuration built and run once for the module."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _jax_run(RUNS[name], name in PALLAS_RUNS)
        return done[name]
    return get


@pytest.mark.parametrize("run", sorted(RUNS))
def test_training_matches_the_jax_executor(jax_runs, run):
    init, want_grads, want_curve = jax_runs(run)
    grads, curve = _port_run(init, RUNS[run])
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name], g, err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(curve, want_curve, **CURVE_TOL)


@pytest.mark.parametrize("run", ["fused", "composed", "fused_head"])
def test_scope_names_map_onto_every_port_parameter(jax_runs, run):
    """The auto-named scope parameters of one build cover the port's
    parameters exactly once; a scope from another build (other counters)
    maps the same way, family by family."""
    init, _, _ = jax_runs(run)
    keys = convert.transformer_state_keys(init)
    fused, head = (RUNS[run].get(k, False)
                   for k in ("fused_attention", "fused_head"))
    model = tT.Transformer(**CFG, fused_attention=fused, fused_head=head,
                           device="cpu")
    assert sorted(keys.values()) == sorted(model.state_dict())
    fresh = convert.transformer_jax_names(CFG["n_layer"], fused, head)
    by_key = {v: k for k, v in keys.items()}

    def family(name):
        return re.sub(r"_\d+\.", ".", name)
    for key, name in fresh.items():
        assert np.shape(init[by_key[key]]) == tuple(
            model.state_dict()[key].shape)
        assert family(name) == family(by_key[key])
    head_name = by_key["head_w"]
    assert head_name.startswith("fused_linear_ce_" if head else "fc_")


@pytest.mark.parametrize("head", [False, True])
def test_evaluation_loss_matches_the_jax_executor(head):
    """``is_train=False`` (no dropout, no smoothing): one forward of the
    evaluation program from its startup weights, on both sides."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = jT.build(**CFG, is_train=False, fused_attention=True,
                              fused_head=head)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = [p.name for p in main.global_block().all_parameters()]
    init = {n: np.array(scope.find_var(n)) for n in names}
    src, tgt, lbl = _feeds()[0]
    want = float(np.asarray(exe.run(
        main, feed={"src_ids": src, "tgt_ids": tgt, "lbl_ids": lbl},
        fetch_list=[loss.name], scope=scope)[0]).reshape(()))
    model, opt = tT.build(**CFG, is_train=False, fused_attention=True,
                          fused_head=head, device="cpu")
    assert opt is None and model.fused_head == head
    model.load_state_dict(convert.transformer_params_from_jax(init))
    with torch.no_grad():
        got = float(model(*(torch.from_numpy(x) for x in (src, tgt, lbl))))
    np.testing.assert_allclose(got, want, **CURVE_TOL)


def test_converter_raises_on_what_fits_no_transformer(jax_runs):
    init, _, _ = jax_runs("fused")
    with pytest.raises(KeyError, match="not a Transformer parameter"):
        convert.transformer_params_from_jax({**init, "learning_rate_0": 1})
    ln = sorted(n for n in init if n.startswith("layer_norm_"))
    with pytest.raises(ValueError, match="layer norms"):
        convert.transformer_params_from_jax(
            {n: v for n, v in init.items() if n not in ln[:2]})
    bad = dict(init)
    name = next(n for n in init if n.startswith("fc_") and
                n.endswith(".w_0"))
    bad[name] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.transformer_params_from_jax(bad)


def test_noam_rates_follow_the_jax_formula():
    sched = tlrs.noam_decay(32, 4, learning_rate=2.0)
    got = [sched() for _ in range(8)]
    want = [2.0 * 32 ** -0.5 * min(n ** -0.5, n * 4 ** -1.5)
            for n in range(1, 9)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(r.dtype == np.float32 for r in got)


def test_adam_follows_the_jax_update_rule():
    """Two steps of the JAX rule (optimizer_ops.py:101,140-142) in numpy:
    beta powers start at beta1/beta2, epsilon outside the sqrt; a
    parameter without a gradient keeps its value and its beta powers."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    idle = torch.nn.Parameter(torch.ones(2))
    opt = Adam([p, idle], learning_rate=0.1, beta1=0.9, beta2=0.997,
               epsilon=1e-9)
    want, m1, m2, b1p, b2p = p0.astype(np.float64), 0.0, 0.0, 0.9, 0.997
    for _ in range(2):
        g = rng.randn(5).astype(np.float32)
        p.grad = torch.from_numpy(g)
        opt.step()
        lr_t = 0.1 * np.sqrt(1 - b2p) / (1 - b1p)
        m1 = 0.9 * m1 + 0.1 * g
        m2 = 0.997 * m2 + 0.003 * g * g
        want = want - lr_t * m1 / (np.sqrt(m2) + 1e-9)
        b1p, b2p = b1p * 0.9, b2p * 0.997
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(opt.state[p]["beta1_pow"], 0.9 ** 3,
                               rtol=1e-6)
    assert torch.equal(idle.detach(), torch.ones(2)) and \
        not opt.state[idle]


def test_build_rejects_what_the_port_does_not_run(monkeypatch):
    model, opt = tT.build(**CFG, fused_head=True, device="cpu")
    assert model.fused_head and model.training and opt is not None
    with pytest.raises(ValueError, match="Noam multiplier"):
        tT.build(**CFG, lr_scheduler="noam", lr=1e-4, device="cpu")
    with pytest.raises(ValueError, match="lr_scheduler"):
        tT.build(**CFG, lr_scheduler="cosine", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tT.build(**CFG)
    model, opt = tT.build(**CFG, is_train=False, device="cpu")
    assert opt is None and not model.training and model.dropout_p == 0.0


def test_dropout_draws_its_seeds_from_the_generator():
    """With dropout on, two forwards from equally seeded generators give
    the same loss and a third (fresh seeds) another; eval mode drops
    nothing."""
    def loss_with(gen):
        model, _ = tT.build(**CFG, dropout=0.3, fused_attention=True,
                            device="cpu", generator=gen)
        model.reset_parameters(torch.Generator().manual_seed(0))
        src, tgt, lbl = (torch.from_numpy(x) for x in _feeds()[0])
        return model, float(model(src, tgt, lbl).detach())
    gen = torch.Generator().manual_seed(9)
    model, a = loss_with(gen)
    _, b = loss_with(torch.Generator().manual_seed(9))
    src, tgt, lbl = (torch.from_numpy(x) for x in _feeds()[0])
    c = float(model(src, tgt, lbl).detach())
    assert a == b and a != c
    model.eval()
    with torch.no_grad():
        assert float(model(src, tgt, lbl)) == float(model(src, tgt, lbl))


def test_training_modules_import_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.models.transformer, "
        "paddle_tpu_torch.optimizer, paddle_tpu_torch.learning_rate_scheduler"
        ", paddle_tpu_torch.ops.kernels.flash_attention"
        ", paddle_tpu_torch.ops.kernels.fused_ce\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
