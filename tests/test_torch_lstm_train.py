"""The PyTorch port's LSTM training slice, as a whole, against the JAX
package's executor: ``stacked_dynamic_lstm.build`` (paddle_tpu/models/
stacked_dynamic_lstm.py:37) at a small size, peepholes on, ragged lengths.

JAX side: ``build`` under ``program_guard``, the startup program run in a
fresh scope (the LSTM biases, which start at 0, are then set to seeded
values so that the peepholes are live from the first step), then
``Executor.run`` for 10 Adam steps fetching the loss and every
``<param>@GRAD``. Port side: ``paddle_tpu_torch.models.
stacked_dynamic_lstm.build`` on ``device="cpu"``, the same scope carried
across with ``lstm_params_from_jax``, the same feeds, 10 steps; on the CPU
the port's LSTM runs the plain versions of its kernels. Two runs:

- ``scan``: dict 50, max_len 8, emb 16, hid 16, 2 layers, batch 4 (the size
  of tests/test_sequence_ops.py:228). On the CPU the JAX op takes its
  ``lax.scan`` refer branch.
- ``pallas``: hid 128, batch 8, where the JAX op's alignment rule holds;
  ``kernel_enabled`` and the kernel's ``interpret`` flag are patched for
  this run only, so that the JAX side runs its Pallas LSTM kernels in
  interpret mode, forward and backward (a counter witnesses it).

Tolerances, each with its reason:
- step-1 gradients rtol 1e-4 / atol 1e-6: one fp32 forward and backward
  whose sums run in another order on each side;
- loss curve rtol 1e-4 / atol 1e-5: the JAX package's own bound for curve
  parity (__graft_entry__.py:180), ten Adam steps amplifying those last-bit
  differences. A curve that is not finite fails outright."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.fluid import unique_name
from paddle_tpu.models import stacked_dynamic_lstm as jL
from paddle_tpu.ops import pallas as pk

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import stacked_dynamic_lstm as tL
from paddle_tpu_torch.ops.kernels import fused_rnn as tfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"scan": (dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16,
                      stacked_num=2), 4),
        "pallas": (dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=128,
                        stacked_num=2), 8)}
STEPS = 10
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)


def _feeds(cfg, batch):
    rng = np.random.RandomState(2)
    out = []
    for _ in range(STEPS):
        lens = rng.randint(1, cfg["max_len"] + 1, batch).astype(np.int32)
        lens[0] = cfg["max_len"]
        out.append((rng.randint(0, cfg["dict_dim"],
                                (batch, cfg["max_len"])).astype(np.int64),
                    lens, rng.randint(0, 2, (batch, 1)).astype(np.int64)))
    return out


def _finite_curve(curve):
    if not all(np.isfinite(curve)):
        raise AssertionError(f"non-finite loss curve: {curve}")
    return curve


def _jax_startup(cfg, fresh_names=True):
    """(main, loss, acc, parameter names, scope, executor) of the JAX
    build, its startup run. ``fresh_names``: built under its own
    ``unique_name`` guard, so the names do not depend on what the process
    built before."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), (
            unique_name.guard() if fresh_names else contextlib.nullcontext()):
        loss, (acc,), _ = jL.build(**cfg)
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, loss, acc, names, scope, exe


def _jax_train(cfg, batch):
    """(initial parameters, step-1 gradients, loss curve, accuracies) of
    the JAX executor."""
    main, loss, acc, names, scope, exe = _jax_startup(cfg)
    rng = np.random.RandomState(3)
    for n in names:
        if n.startswith("dynamic_lstm_") and n.endswith(".b_0"):
            shape = np.array(scope.find_var(n)).shape
            scope.set_var(n, (rng.randn(*shape) * 0.1).astype(np.float32))
    init = {n: np.array(scope.find_var(n)) for n in names}
    fetch = [loss.name, acc.name] + [n + "@GRAD" for n in names]
    curve, accs, grads = [], [], None
    for words, lens, label in _feeds(cfg, batch):
        out = exe.run(main, feed={"words": words, "seq_lens": lens,
                                  "label": label},
                      fetch_list=fetch, scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        accs.append(float(np.asarray(out[1]).reshape(())))
        if grads is None:
            grads = {n: np.asarray(g) for n, g in zip(names, out[2:])}
    return init, grads, _finite_curve(curve), accs


def _jax_run(name):
    cfg, batch = RUNS[name]
    if name != "pallas":
        return _jax_train(cfg, batch)
    enabled, kernel, calls = pk.kernel_enabled, pk.fused_lstm_train, []

    def interpreted(xproj, w, peep, sl, h0, c0):
        calls.append(1)
        return kernel(xproj, w, peep, sl, h0, c0, True)
    pk.kernel_enabled = lambda align=128, *dims: all(
        d % align == 0 for d in dims)
    pk.fused_lstm_train = interpreted
    try:
        out = _jax_train(cfg, batch)
    finally:
        pk.kernel_enabled, pk.fused_lstm_train = enabled, kernel
    assert calls, "the JAX run did not reach its Pallas LSTM kernel"
    return out


def _port_run(init, cfg, batch):
    model, opt, _ = tL.build(**cfg, device="cpu")
    n_layer = cfg["stacked_num"]
    model.load_state_dict(convert.lstm_params_from_jax(init, n_layer))
    keys = convert.lstm_state_keys(init, n_layer)
    params = dict(model.named_parameters())
    curve, accs, grads = [], [], None
    for feed in _feeds(cfg, batch):
        opt.zero_grad(set_to_none=True)
        loss, acc = model(*(torch.from_numpy(x) for x in feed))
        loss.backward()
        if grads is None:
            grads = {n: params[keys[n]].grad.numpy().copy() for n in init}
        opt.step()
        curve.append(float(loss.detach()))
        accs.append(float(acc))
    return grads, _finite_curve(curve), accs


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
    init, _, want_curve, want_accs = jax_runs(run)
    before = dict(tfr.LAUNCHES)
    _, curve, accs = _port_run(init, *RUNS[run])
    assert tfr.LAUNCHES == before
    np.testing.assert_allclose(curve, want_curve, **CURVE_TOL)
    np.testing.assert_allclose(accs, want_accs, rtol=0, atol=1e-7)
    assert curve[-1] != curve[0]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_step_one_gradients_match_the_jax_executor(jax_runs, run):
    init, want_grads, _, _ = jax_runs(run)
    grads, _, _ = _port_run(init, *RUNS[run])
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        assert bool(np.any(g != 0)), name
        np.testing.assert_allclose(grads[name], g, err_msg=name, **GRAD_TOL)


def test_scope_names_map_onto_every_port_parameter(jax_runs):
    """The auto-named scope parameters of one build cover the port's
    parameters exactly once, whatever the counters; a fresh process's
    names are those of ``lstm_jax_names``."""
    init, _, _, _ = jax_runs("scan")
    cfg, _ = RUNS["scan"]
    keys = convert.lstm_state_keys(init, cfg["stacked_num"])
    model = tL.StackedDynamicLSTM(cfg["dict_dim"], cfg["emb_dim"],
                                  cfg["hid_dim"], cfg["stacked_num"],
                                  device="cpu")
    assert sorted(keys.values()) == sorted(model.state_dict())
    for name, key in keys.items():
        assert init[name].shape == tuple(model.state_dict()[key].shape)
    fresh = convert.lstm_jax_names(cfg["stacked_num"])
    assert sorted(fresh) == sorted(model.state_dict())
    assert fresh["layers.1.fc_w1"] == "fc_1.w_1"
    assert fresh["head_w0"] == "fc_2.w_0"
    shifted = {n.replace("fc_", "fc_1"): v for n, v in init.items()}
    assert sorted(convert.lstm_state_keys(shifted, 2).values()) == \
        sorted(keys.values())


def _check_refusals(init, n_layer):
    """``lstm_params_from_jax``'s six refusals on the scope ``init``."""
    lstm_bias = next(n for n in init if n.startswith("dynamic_lstm_")
                     and n.endswith(".b_0"))
    missing = {n: v for n, v in init.items() if n != lstm_bias}
    with pytest.raises(KeyError, match="dynamic_lstm"):
        convert.lstm_params_from_jax(missing, n_layer)
    fc_index = {n: int(n.split("_")[1].split(".")[0]) for n in init
                if n.startswith("fc_")}
    head = max(fc_index, key=fc_index.get)
    with pytest.raises(KeyError, match="fc"):
        convert.lstm_params_from_jax(
            {n: v for n, v in init.items()
             if n.split(".")[0] != head.split(".")[0]}, n_layer)
    with pytest.raises(KeyError, match="not a stacked-LSTM parameter"):
        convert.lstm_params_from_jax({**init, "layer_norm_0.w_0": init[
            lstm_bias]}, n_layer)
    unused = f"fc_{max(fc_index.values()) + 1}.w_0"    # no layer of the scope
    with pytest.raises(KeyError, match="fc"):
        convert.lstm_params_from_jax({**init, unused: init[lstm_bias]},
                                     n_layer)
    with pytest.raises(KeyError, match="layers in the scope"):
        convert.lstm_params_from_jax(init, n_layer + 1)
    no_peep = dict(init)
    no_peep[lstm_bias] = init[lstm_bias][:, :4 * 16]
    with pytest.raises(ValueError, match="lstm_b"):
        convert.lstm_params_from_jax(no_peep, n_layer)


def test_lstm_params_from_jax_raises_on_missing_and_unused_names(jax_runs):
    init, _, _, _ = jax_runs("scan")
    _check_refusals(init, RUNS["scan"][0]["stacked_num"])


@pytest.mark.parametrize("fresh_names", [True, False],
                         ids=["guarded_build", "unguarded_build"])
def test_lstm_params_from_jax_refusals_after_97_fc_names(fresh_names):
    """The refusals hold whatever the process drew before: 97 ``fc`` names
    drawn first (the JAX build's own ``fc`` layers then number 97-99
    without a guard of their own, and the "unused" name is past them)."""
    cfg = RUNS["scan"][0]
    with unique_name.guard():
        for _ in range(97):
            unique_name.generate("fc")
        _, _, _, names, scope, _ = _jax_startup(cfg, fresh_names)
    init = {n: np.array(scope.find_var(n)) for n in names}
    assert any(n.startswith("fc_97") for n in init) != fresh_names
    _check_refusals(init, cfg["stacked_num"])


def test_build_follows_the_jax_defaults_and_the_device_rule():
    model, opt, specs = tL.build(dict_dim=30, emb_dim=8, hid_dim=8,
                                 stacked_num=1, device="cpu")
    assert specs == {"words": ([-1, 100], "int64"),
                     "seq_lens": ([-1], "int32"),
                     "label": ([-1, 1], "int64")}
    group = opt.param_groups[0]
    assert (group["lr"], group["beta1"], group["beta2"],
            group["epsilon"]) == (0.001, 0.9, 0.999, 1e-8)
    assert model.training and len(model.layers) == 1
    assert not hasattr(model.layers[0], "fc_w1")
    evaluated, none, _ = tL.build(is_train=False, dict_dim=30, emb_dim=8,
                                  hid_dim=8, stacked_num=1, device="cpu")
    assert none is None and not evaluated.training
    words = torch.randint(0, 30, (3, 5))
    lens = torch.tensor([5, 2, 0], dtype=torch.int32)
    prob = evaluated.predict(words, lens)
    assert prob.shape == (3, 2)
    np.testing.assert_allclose(prob.sum(-1).detach().numpy(), 1.0,
                               rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tL.build(dict_dim=30, emb_dim=8, hid_dim=8, stacked_num=1)
    with pytest.raises(ValueError, match="stacked_num"):
        tL.build(stacked_num=0, device="cpu")


def test_new_modules_import_no_jax():
    """Importing the slice's modules pulls in neither jax nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.models.stacked_dynamic_lstm\n"
        "import paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.ops.rnn_ops\n"
        "import paddle_tpu_torch.ops.sequence_ops\n"
        "import paddle_tpu_torch.ops.nn_ops\n"
        "import paddle_tpu_torch.ops.kernels.fused_rnn\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
