"""The PyTorch port's machine-translation slice, as a whole, against the JAX
package's executor: ``machine_translation.build`` (paddle_tpu/models/
machine_translation.py:49), training with lazy Adam over row-sparse table
gradients, then beam decoding through the inference program.

JAX side: ``build(is_train=True)`` under ``program_guard``, the startup
program run in a fresh scope, then ``Executor.run`` for 10 Adam steps on
the chain task of tests/test_beam_search.py:79-90 (a fresh batch each
step), fetching the loss and every ``<param>@GRAD`` (the executor
densifies the tables' row-sparse gradients); then ``build(is_train=False)``
run in the same scope. Port side: ``paddle_tpu_torch.models.
machine_translation.build`` on ``device="cpu"``, the same startup weights
carried across with ``mt_params_from_jax``, the same feeds; on the CPU the
port's GRU runs the plain versions of its kernels. Two runs:

- ``scan``: V 24, T 6, B 16, E 24, H 24 (tests/test_beam_search.py:67).
  On the CPU the JAX op takes its ``lax.scan`` branch.
- ``pallas``: H 128, B 8, where the JAX op's alignment rule holds;
  ``kernel_enabled`` and ``fused_gru_train`` are patched for this run
  only, so that the JAX side runs its Pallas GRU kernels in interpret
  mode, forward and backward (a counter witnesses it).

Tolerances, each with its reason:
- step-1 gradients rtol 1e-4 / atol 1e-7: one fp32 forward and backward
  whose sums run in another order on each side;
- loss curve rtol 1e-4 / atol 1e-5: the JAX package's own bound for curve
  parity (__graft_entry__.py:180), ten Adam steps amplifying those last-bit
  differences. A curve that is not finite fails outright;
- beam scores rtol 1e-4: the same weights, fp32 sums in another order over
  T steps of the decoder; the ids exactly (no near ties at these seeds)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import machine_translation as jM
from paddle_tpu.ops import pallas as pk

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import machine_translation as tM
from paddle_tpu_torch.ops.kernels import fused_rnn as tfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"scan": (dict(src_vocab=24, tgt_vocab=24, max_len=6, emb_dim=24,
                      hid_dim=24), 16),
        "pallas": (dict(src_vocab=24, tgt_vocab=24, max_len=6, emb_dim=24,
                        hid_dim=128), 8)}
STEPS = 10
LR = 5e-3
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)


def _feeds(cfg, batch, steps=STEPS, seed=0):
    """(src, tgt_in, tgt_out) [B, T] int64 per step: src random, the
    target the chain tgt_out[k] = (2 tgt_in[k] + 1) % V from the start
    id 1, as tests/test_beam_search.py:79-90 makes it."""
    rng = np.random.RandomState(seed)
    v, t = cfg["tgt_vocab"], cfg["max_len"]
    out = []
    for _ in range(steps):
        src = rng.randint(2, cfg["src_vocab"], (batch, t)).astype(np.int64)
        tgt_in = np.zeros((batch, t), np.int64)
        tgt_out = np.zeros((batch, t), np.int64)
        tgt_in[:, 0] = 1
        for k in range(t):
            tgt_out[:, k] = (tgt_in[:, k] * 2 + 1) % v
            if k + 1 < t:
                tgt_in[:, k + 1] = tgt_out[:, k]
        out.append((src, tgt_in, tgt_out))
    return out


def _finite_curve(curve):
    if not all(np.isfinite(curve)):
        raise AssertionError(f"non-finite loss curve: {curve}")
    return curve


def _jax_train(cfg, batch):
    """(initial parameters, step-1 gradients, loss curve, trained
    parameters, the inference program's (ids, scores) on a fresh batch)
    of the JAX executor."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = jM.build(is_train=True, lr=LR, **cfg)
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in names}
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    curve, grads = [], None
    for src, tgt_in, tgt_out in _feeds(cfg, batch):
        out = exe.run(main, feed={"src": src, "tgt_in": tgt_in,
                                  "tgt_out": tgt_out},
                      fetch_list=fetch, scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        if grads is None:
            grads = {n: np.asarray(g) for n, g in zip(names, out[1:])}
    trained = {n: np.array(scope.find_var(n)) for n in names}
    infer, infer_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(infer, infer_startup):
        sent, ssc, _ = jM.build(is_train=False, **cfg)
    src = _feeds(cfg, batch, steps=1, seed=5)[0][0]
    ids, scores = exe.run(infer, feed={"src": src}, fetch_list=[sent, ssc],
                          scope=scope)
    return (init, grads, _finite_curve(curve), trained,
            (src, np.asarray(ids), np.asarray(scores)))


def _jax_run(name):
    cfg, batch = RUNS[name]
    if name != "pallas":
        return _jax_train(cfg, batch)
    enabled, kernel, calls = pk.kernel_enabled, pk.fused_gru_train, []

    def interpreted(xproj, w, sl, h0):
        calls.append(1)
        return kernel(xproj, w, sl, h0, True)
    pk.kernel_enabled = lambda align=128, *dims: all(
        d % align == 0 for d in dims)
    pk.fused_gru_train = interpreted
    try:
        out = _jax_train(cfg, batch)
    finally:
        pk.kernel_enabled, pk.fused_gru_train = enabled, kernel
    # traced once per program: train (encoder, decoder) and infer (encoder)
    assert len(calls) >= 3, "the JAX run did not reach its Pallas GRU kernel"
    return out


def _port_model(state, cfg, is_train=True):
    model, opt, _ = tM.build(is_train=is_train, lr=LR, device="cpu", **cfg)
    model.load_state_dict(convert.mt_params_from_jax(state))
    return model, opt


def _port_train(init, cfg, batch, steps=STEPS):
    model, opt = _port_model(init, cfg)
    params = dict(model.named_parameters())
    curve, grads = [], None
    for feed in _feeds(cfg, batch, steps):
        opt.zero_grad(set_to_none=True)
        loss = model(*(torch.from_numpy(x) for x in feed))
        loss.backward()
        if grads is None:
            grads = {n: params[convert.mt_state_key(n)].grad.to_dense()
                     .numpy().copy() for n in init}
        opt.step()
        curve.append(float(loss.detach()))
    return model, opt, grads, _finite_curve(curve)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX configuration built and run once for the module."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _jax_run(name)
        return done[name]
    return get


@pytest.mark.parametrize("run", sorted(RUNS))
def test_loss_curve_matches_the_jax_executor(jax_runs, run):
    init, _, want_curve, _, _ = jax_runs(run)
    before = dict(tfr.LAUNCHES)
    _, _, _, curve = _port_train(init, *RUNS[run])
    assert tfr.LAUNCHES == before
    np.testing.assert_allclose(curve, want_curve, **CURVE_TOL)
    assert curve[-1] < curve[0]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_step_one_gradients_match_the_jax_executor(jax_runs, run):
    init, want_grads, _, _, _ = jax_runs(run)
    _, _, grads, _ = _port_train(init, *RUNS[run], steps=1)
    assert set(grads) == set(want_grads) and len(grads) == 14
    for name, g in want_grads.items():
        assert bool(np.any(g != 0)), name
        np.testing.assert_allclose(grads[name], g, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_generate_matches_the_jax_infer_program(jax_runs, run):
    """The port's ``generate`` on the JAX run's trained weights gives the
    infer program's ids and lane scores."""
    _, _, _, trained, (src, want_ids, want_scores) = jax_runs(run)
    cfg, batch = RUNS[run]
    model, _ = _port_model(trained, cfg, is_train=False)
    ids, scores = model.generate(torch.from_numpy(src))
    assert ids.dtype == torch.int32
    assert tuple(ids.shape) == (batch, 4, cfg["max_len"])
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-4,
                               atol=0)
    assert np.all(np.diff(scores.numpy(), axis=1) <= 0)


def test_lazy_adam_leaves_untouched_rows_alone(jax_runs):
    """After steps whose sources never use some ids, those rows of the
    source table and their moments are exactly as they started; the
    touched rows moved."""
    init, _, _, _, _ = jax_runs("scan")
    cfg, batch = RUNS["scan"]
    model, opt = _port_model(init, cfg)
    feeds = _feeds(cfg, batch, 3)
    used = np.unique(np.concatenate([f[0].reshape(-1) for f in feeds]))
    unused = np.setdiff1d(np.arange(cfg["src_vocab"]), used)
    assert unused.size and 0 in unused and 1 in unused
    start = model.src_emb.detach().clone()
    for feed in feeds:
        opt.zero_grad(set_to_none=True)
        model(*(torch.from_numpy(x) for x in feed)).backward()
        assert model.src_emb.grad.is_sparse
        opt.step()
    st = opt.state[model.src_emb]
    rows = torch.from_numpy(unused)
    assert torch.equal(model.src_emb[rows], start[rows])
    assert not bool(st["moment1"][rows].any())
    assert not bool(st["moment2"][rows].any())
    touched = torch.from_numpy(used)
    assert bool((model.src_emb[touched] != start[touched]).any(dim=1).all())
    b1 = np.float32(0.9)
    assert st["beta1_pow"] == b1 * b1 * b1 * b1


def test_sparse_adam_without_lazy_mode_decays_every_row():
    """lazy_mode=False with a sparse gradient is the dense rule on the
    densified gradient (``ops/optimizer_ops.py:127-139``): a row touched
    once keeps moving on its moments. With lazy_mode=True it stops."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ops import nn_ops
    rng = np.random.RandomState(1)
    w0 = torch.from_numpy(rng.randn(7, 3).astype(np.float32))
    steps = [torch.tensor([[2, 4, 2]]), torch.tensor([[4, 6, 4]]),
             torch.tensor([[6, 4, 1]])]
    tables, after_one = {}, {}
    for sparse, lazy in ((True, False), (False, False), (True, True)):
        w = torch.nn.Parameter(w0.clone())
        opt = Adam([w], learning_rate=0.1, lazy_mode=lazy)
        for i, ids in enumerate(steps):
            opt.zero_grad(set_to_none=True)
            (nn_ops.lookup_table(w, ids, sparse=sparse) ** 2).sum().backward()
            assert w.grad.is_sparse == sparse
            opt.step()
            if i == 0:
                after_one[sparse, lazy] = w.detach().clone()
        tables[sparse, lazy] = w.detach()
    np.testing.assert_allclose(tables[True, False].numpy(),
                               tables[False, False].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert not torch.equal(tables[True, False][2], after_one[True, False][2])
    assert torch.equal(tables[True, True][2], after_one[True, True][2])
    assert torch.equal(tables[True, True][0], w0[0])


def test_mt_params_from_jax_raises_on_missing_and_unused_names(jax_runs):
    init, _, _, _, _ = jax_runs("scan")
    state = convert.mt_params_from_jax(init)
    model = tM.MachineTranslation(24, 24, 6, 24, 24, device="cpu")
    assert sorted(state) == sorted(model.state_dict())
    missing = {n: v for n, v in init.items() if n != "mt.h0.b"}
    with pytest.raises(KeyError, match="mt.h0.b"):
        convert.mt_params_from_jax(missing)
    with pytest.raises(KeyError, match="not a machine-translation"):
        convert.mt_params_from_jax({**init, "mt.extra.w": init["mt.h0.b"]})
    wrong = dict(init)
    wrong["mt.attn.w"] = init["mt.attn.w"][:10]
    with pytest.raises(ValueError, match="attn_w"):
        convert.mt_params_from_jax(wrong)


def test_build_follows_the_jax_defaults_and_the_device_rule():
    model, opt, specs = tM.build(device="cpu")
    assert specs == {"src": ([-1, 8], "int64"), "tgt_in": ([-1, 8], "int64"),
                     "tgt_out": ([-1, 8], "int64")}
    group = opt.param_groups[0]
    assert (group["lr"], group["beta1"], group["beta2"],
            group["epsilon"], opt.lazy_mode) == (0.001, 0.9, 0.999, 1e-8,
                                                 True)
    assert (model.src_vocab, model.tgt_vocab, model.emb_dim, model.hid_dim,
            model.beam_size, model.start_id, model.end_id) == \
        (30, 30, 32, 32, 4, 1, 0)
    assert model.training and len(list(model.parameters())) == 14
    evaluated, none, specs = tM.build(is_train=False, device="cpu")
    assert none is None and not evaluated.training
    assert specs == {"src": ([-1, 8], "int64")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tM.build()


def test_new_modules_import_no_jax():
    """Importing the slice's modules pulls in neither jax nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.models.machine_translation\n"
        "import paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.ops.beam_ops\n"
        "import paddle_tpu_torch.ops.rnn_ops\n"
        "import paddle_tpu_torch.ops.nn_ops\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.ops.kernels.fused_rnn\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
