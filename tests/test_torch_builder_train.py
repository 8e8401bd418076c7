"""Programs built by the port's program builder, trained through the
port's executor against the JAX executor on the JAX package's build.

- mnist and the tiny Transformer (fused attention and head, the Noam
  schedule at warmup 400, dropout 0) are built by each package under a fresh
  guard; the JAX startup scope is carried across
  (``tests/test_torch_train_programs.py``'s convention) and each side
  trains 3 steps, the port through ``fluid.Executor(fluid.CPUPlace())``.
  Checked at that file's tolerances: the loss curve (rtol 1e-4 / atol
  1e-5), every persistable after the steps (rtol 1e-4 / atol 1e-6), and
  the learning rate each step fetched (the Noam closed form too).
- The emitters this slice adds (``ops/basic.py``, ``ops/math_ops.py``)
  against the JAX emitters on the same inputs.
- ``fluid.io``: ``main_program=None`` is the default main program;
  ``save_checkpoint`` / ``load_checkpoint`` with their retention; a JAX
  checkpoint loads into the port and the port's back into JAX, bit-equal;
  an inference model saved from a test clone answers as the clone.
- A subprocess builds mnist into the default programs with
  ``paddle_tpu_torch.fluid`` alone, trains it through ``exe.run()``
  without a program, and finds neither ``jax`` nor ``paddle_tpu`` in
  ``sys.modules``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.models import mnist as tmnist
from paddle_tpu_torch.fluid.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3
WARMUP = 400
D_MODEL = 32

CASES = {
    "mnist": ((jmnist, tmnist), {},
              lambda r: {"pixel": r.randn(4, 1, 28, 28).astype(np.float32),
                         "label": r.randint(0, 10, (4, 1)).astype(np.int64)}),
    "transformer_noam": (
        (jtransformer, ttransformer),
        dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=D_MODEL,
             d_inner=64, n_head=2, n_layer=1, dropout=0.0,
             fused_attention=True, fused_head=True, lr_scheduler="noam",
             lr=2.0, warmup=WARMUP),
        lambda r: {k: r.randint(1, 64, (4, 8, 1)).astype(np.int64)
                   for k in ("src_ids", "tgt_ids", "lbl_ids")}),
}


def _build(fluid, unique, mod, kwargs):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique.guard():
        loss, _, _ = mod.build(**kwargs)
    return main, startup, loss.name


def _lr_name(main):
    return next(op for op in main.global_block().desc.ops
                if op.type == "adam").input("LearningRate")[0]


def _persistables(main):
    return sorted(n for n, v in main.desc.global_block.vars.items()
                  if v.persistable)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX build's scope before the steps, its losses, its
    learning rates and its persistables after the steps (one dispatch of
    STEPS iterations)."""
    out = {}
    for name, ((jmod, _), kwargs, feeds_of) in CASES.items():
        main, startup, loss = _build(jfluid, junique, jmod, kwargs)
        rng = np.random.RandomState(0)
        feeds = [feeds_of(rng) for _ in range(STEPS)]
        scope = jfluid.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup, scope=scope)
        names = _persistables(main)
        start = {n: np.array(scope.find_var(n)) for n in names}
        losses, lrs = exe.run(main, feed=feeds, iterations=STEPS,
                              scope=scope, fetch_list=[loss, _lr_name(main)])
        after = {n: np.array(scope.find_var(n)) for n in names}
        out[name] = dict(start=start, feeds=feeds, losses=np.asarray(losses),
                         lrs=np.asarray(lrs).reshape(-1), after=after)
    return out


def _port_scope(arrays):
    s = tfluid.Scope()
    for n, a in arrays.items():
        s.set_var(n, torch.from_numpy(a.copy()))
    return s


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_built_program_trains_as_jax(jax_runs, case):
    (_, tmod), kwargs, _ = CASES[case]
    ref = jax_runs[case]
    main, startup, loss = _build(tfluid, tunique, tmod, kwargs)
    assert _persistables(main) == sorted(ref["start"])
    scope = _port_scope(ref["start"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, lrs = [], []
    for feed in ref["feeds"]:
        l, r = exe.run(main, feed=feed, fetch_list=[loss, _lr_name(main)],
                       scope=scope)
        losses.append(float(l))
        lrs.append(float(np.asarray(r).reshape(-1)[0]))
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref["losses"].reshape(-1),
                               **CURVE_TOL)
    np.testing.assert_allclose(lrs, ref["lrs"], rtol=1e-6)
    for n, want in ref["after"].items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), want,
                                   err_msg=n, **STATE_TOL)
    if case == "transformer_noam":
        steps = np.arange(1, STEPS + 1, dtype=np.float64)
        noam = 2.0 * D_MODEL ** -0.5 * np.minimum(steps ** -0.5,
                                                  steps * WARMUP ** -1.5)
        np.testing.assert_allclose(lrs, noam, rtol=1e-6)
        assert float(scope.find_var("@lr_decay_counter@")[0]) == STEPS


def test_startup_runs_on_the_port(jax_runs):
    """The port's own startup fills every persistable in its declared
    shape and dtype (the draws are the port's)."""
    (_, tmod), kwargs, _ = CASES["transformer_noam"]
    main, startup, _ = _build(tfluid, tunique, tmod, kwargs)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    for n, want in jax_runs["transformer_noam"]["start"].items():
        got = scope.find_var(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
    pe = scope.find_var("transformer_pos_enc").numpy()
    assert pe.tobytes() == jax_runs["transformer_noam"]["start"][
        "transformer_pos_enc"].tobytes()


# -- the new emitters against the JAX emitters --------------------------------

def _f(r, *shape, positive=False):
    a = r.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


EMITTERS = {
    "increment": (lambda r: {"X": np.array([3.0], np.float32)},
                  {"step": 1.0}),
    "pow": (lambda r: {"X": _f(r, 3, 4, positive=True)}, {"factor": -0.5}),
    "elementwise_div": (lambda r: {"X": _f(r, 3, 4),
                                   "Y": _f(r, 4, positive=True)}, {}),
    "elementwise_max": (lambda r: {"X": _f(r, 3, 4), "Y": _f(r, 3)},
                        {"axis": 0}),
    "elementwise_min": (lambda r: {"X": _f(r, 3, 4), "Y": _f(r, 3, 4)},
                        {}),
    "elementwise_pow": (lambda r: {"X": _f(r, 3, 4, positive=True),
                                   "Y": _f(r, 3, 4)}, {}),
    "floor": (lambda r: {"X": _f(r, 3, 4) * 3}, {}),
    "ceil": (lambda r: {"X": _f(r, 3, 4) * 3}, {}),
    "cos": (lambda r: {"X": _f(r, 3, 4)}, {}),
    "exp": (lambda r: {"X": _f(r, 3, 4)}, {}),
    "sqrt": (lambda r: {"X": _f(r, 3, 4, positive=True)}, {}),
    "reciprocal": (lambda r: {"X": _f(r, 3, 4, positive=True)}, {}),
    "less_than": (lambda r: {"X": _f(r, 3, 4), "Y": _f(r, 3, 4)}, {}),
    "select": (lambda r: {"Condition": r.rand(3, 4) > 0.5,
                          "X": _f(r, 3, 4), "Y": _f(r, 3, 4)}, {}),
    "clip": (lambda r: {"X": _f(r, 3, 4)}, {"min": -0.5, "max": 0.7}),
    "sign": (lambda r: {"X": np.array([-2.0, 0.0, 3.0], np.float32)}, {}),
    "assign": (lambda r: {"X": _f(r, 3, 4)}, {}),
    "cast": (lambda r: {"X": _f(r, 3, 4) * 5}, {"out_dtype": "int32"}),
    "squared_l2_norm": (lambda r: {"X": _f(r, 3, 4)}, {}),
}


@pytest.mark.parametrize("op_type", sorted(EMITTERS))
def test_new_emitter_matches_jax(op_type):
    make, attrs = EMITTERS[op_type]
    ins = make(np.random.RandomState(sorted(EMITTERS).index(op_type)))
    jout = jreg.get_op(op_type).emit(
        jreg.EmitContext(base_key=jax.random.key(0)),
        {k: [jax.numpy.asarray(v)] for k, v in ins.items()}, attrs)
    tout = treg.get_op(op_type).emit(
        treg.EmitContext(), {k: [torch.from_numpy(np.array(v))]
                             for k, v in ins.items()}, attrs)
    assert sorted(tout) == sorted(jout) == ["Out"]
    want, got = np.asarray(jout["Out"][0]), tout["Out"][0].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- fluid.io -----------------------------------------------------------------

def _arrays(names, seed=0):
    r = np.random.RandomState(seed)
    return {n: r.randn(3, 2).astype(np.float32) for n in names}


def test_unread_outputs_are_not_kept(monkeypatch):
    """A training dropout's Mask has no reader: the step's environment
    drops it as its op returns and the tape keeps nothing in its place,
    while the dropout's Out stays for the ops that read it."""
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.ops import grad_ops
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tunique.guard():
        x = tfluid.layers.data("x", shape=[8])
        h = tfluid.layers.dropout(tfluid.layers.fc(x, 8),
                                  dropout_prob=0.5)
        loss = tfluid.layers.mean(h)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    drop = next(op for op in main.desc.global_block.ops
                if op.type == "dropout")
    out, mask = drop.output("Out")[0], drop.output("Mask")[0]
    envs, tapes = [], []
    run_ops, record = lowering.emit_op_seq, grad_ops.record_forward

    def spy_run(program, block, indices, env, *args, **kwargs):
        run_ops(program, block, indices, env, *args, **kwargs)
        envs.append(set(env))

    def spy_record(ctx, op, ins, in_grad_mask):
        outs, rec = record(ctx, op, ins, in_grad_mask)
        if op.type == "dropout":
            tapes.append(dict(zip(sorted(op.outputs), rec[1])))
        return outs, rec
    monkeypatch.setattr(lowering, "emit_op_seq", spy_run)
    monkeypatch.setattr(grad_ops, "record_forward", spy_record)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, feed={"x": np.ones((4, 8), np.float32)},
                  fetch_list=[loss], scope=scope)[0]
    assert np.isfinite(got).all()
    assert out in envs[-1] and mask not in envs[-1]
    assert len(tapes) == 1
    assert tapes[0]["Mask"] is None and tapes[0]["Out"].requires_grad


def test_io_default_program_and_checkpoints(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tunique.guard():
        tfluid.layers.fc(tfluid.layers.data("x", [2]), 2)
        names = _persistables(main)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = _port_scope(_arrays(names))
        # main_program=None is the default main program
        saved = tfluid.io.save_persistables(exe, str(tmp_path / "p"),
                                            scope=scope)
        assert saved == names
        ck = str(tmp_path / "ck")
        for step in range(4):
            scope.set_var(names[0], torch.full((2, 2), float(step)))
            assert tfluid.io.save_checkpoint(exe, ck, max_num_checkpoints=2,
                                             scope=scope) == step
    assert sorted(os.listdir(ck)) == ["checkpoint_2", "checkpoint_3"]
    back = tfluid.Scope()
    assert tfluid.io.load_checkpoint(exe, ck, main_program=main,
                                     scope=back) == 3
    assert torch.equal(back.find_var(names[0]), torch.full((2, 2), 3.0))
    assert tfluid.io.load_checkpoint(exe, ck, serial=2, scope=back) == 2
    assert torch.equal(back.find_var(names[0]), torch.full((2, 2), 2.0))
    with pytest.raises(FileNotFoundError):
        tfluid.io.load_checkpoint(exe, str(tmp_path / "none"), scope=back)


def test_checkpoints_cross_between_packages(tmp_path, jax_runs):
    """A JAX checkpoint loads into the port and the port's into JAX,
    every array bit-equal."""
    (jmod, tmod), kwargs, _ = CASES["mnist"]
    jmain, _, _ = _build(jfluid, junique, jmod, kwargs)
    tmain, _, _ = _build(tfluid, tunique, tmod, kwargs)
    arrays = jax_runs["mnist"]["after"]
    jscope = jfluid.Scope()
    for n, a in arrays.items():
        jscope.set_var(n, jax.numpy.asarray(a))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    ck = str(tmp_path / "ck")
    with jfluid.scope_guard(jscope):
        assert jfluid.io.save_checkpoint(jexe, ck, main_program=jmain) == 0
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    assert tfluid.io.load_checkpoint(texe, ck, main_program=tmain,
                                     scope=tscope) == 0
    for n, a in arrays.items():
        assert tscope.find_var(n).numpy().tobytes() == a.tobytes(), n
    assert tfluid.io.save_checkpoint(texe, ck, main_program=tmain,
                                     scope=tscope) == 1
    back = jfluid.Scope()
    with jfluid.scope_guard(back):
        assert jfluid.io.load_checkpoint(jexe, ck, main_program=jmain) == 1
    for n, a in arrays.items():
        assert np.asarray(back.find_var(n)).tobytes() == a.tobytes(), n


def test_inference_model_of_a_test_clone(tmp_path, jax_runs):
    (_, tmod), kwargs, _ = CASES["transformer_noam"]
    main, _, loss = _build(tfluid, tunique, tmod, kwargs)
    test = main.clone(for_test=True)
    ref = jax_runs["transformer_noam"]
    scope = _port_scope(ref["after"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = ref["feeds"][0]
    d = str(tmp_path / "inf")
    tfluid.io.save_inference_model(d, sorted(feed), [loss], exe,
                                   main_program=test, scope=scope)
    # the clone keeps the optimizer ops, so its run also updates the
    # scope: the model is saved first, and the fetch comes before the
    # update
    want = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)[0]
    loaded_scope = tfluid.Scope()
    prog, feeds, fetches = tfluid.io.load_inference_model(
        d, exe, scope=loaded_scope)
    assert feeds == sorted(feed) and fetches == [loss]
    got = exe.run(prog, feed=feed, fetch_list=fetches,
                  scope=loaded_scope)[0]
    assert got.tobytes() == want.tobytes()


_SUBPROCESS = r"""
import sys
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.models import mnist
with fluid.unique_name.guard():
    loss, (acc,), feeds = mnist.build()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(fluid.default_startup_program())
r = np.random.RandomState(0)
batch = {"pixel": r.rand(8, 1, 28, 28).astype(np.float32),
         "label": r.randint(0, 10, (8, 1)).astype(np.int64)}
losses = [float(exe.run(feed=batch, fetch_list=[loss])[0])
          for _ in range(4)]
assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
bad = sorted(m for m in sys.modules if m in ("jax", "paddle_tpu")
             or m.startswith(("jax.", "jaxlib", "paddle_tpu.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_builds_and_trains_without_jax():
    res = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
