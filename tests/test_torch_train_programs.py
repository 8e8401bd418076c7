"""Training programs through the port's executor (``paddle_tpu_torch/
core``: the ``__vjp__`` op, the optimizer ops, the row-sparse table
gradients and the startup ops) against the JAX executor.

The five tiny training pairs of ``tests/torch_programs/`` (the JAX
models' ``build(is_train=True)``: ``transformer_tiny_train`` with the
fused attention and head at dropout 0, ``stacked_dynamic_lstm_tiny_train``,
``mnist_train``, ``deepfm_tiny_train`` with its lazy Adam over a
row-sparse table, and ``machine_translation_tiny_train``) each train 3
steps on both sides: the JAX executor from its own startup scope, and the
port's ``Executor(CPUPlace())`` from that scope carried across. Checked:
the loss curve (rtol 1e-4 / atol 1e-5, the curve bound of
``__graft_entry__.py:180``), every persistable after the 3 steps, the
moments and beta powers included, and one fetched ``@GRAD`` a step, dense
(rtol 1e-4 / atol 1e-6: three fp32 steps, each summed in another order).

Beside them: a step that does not fetch the loss (its ``mean`` is dead and
its ``__vjp__`` replays it) updates the weights as one that does; the
Transformer's dropout-zeroed copy (``chip_smoke.zero_dropout``, phase 24's
oracle program) trains as the JAX build at ``dropout=0.0``; the startup
ops (``fill_constant`` and ``assign_value`` exact, the random ops in shape,
dtype, bounds and moments, and repeating under a non-zero
``random_seed``). ``tools/torch_export_programs.py --check`` holds the
committed pairs to what the models' ``build`` gives now, and
``tests/test_torch_executor.py`` lists them.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import unique_name

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.observability import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = os.path.join(REPO, "tests", "torch_programs")
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 3
LOSS = "mean_0.tmp_0"

# pair -> (the @GRAD fetched each step, feeds(rng) of one batch)
PAIRS = {
    "transformer_tiny_train": (
        "transformer_src_emb@GRAD",
        lambda r: {k: r.randint(1, 64, (4, 8, 1)).astype(np.int64)
                   for k in ("src_ids", "tgt_ids", "lbl_ids")}),
    "stacked_dynamic_lstm_tiny_train": (
        "fc_0.w_0@GRAD",
        lambda r: {"words": r.randint(0, 50, (4, 8)).astype(np.int64),
                   "seq_lens": np.array([8, 5, 3, 1], np.int32),
                   "label": r.randint(0, 2, (4, 1)).astype(np.int64)}),
    "mnist_train": (
        "conv2d_0.w_0@GRAD",
        lambda r: {"pixel": r.randn(4, 1, 28, 28).astype(np.float32),
                   "label": r.randint(0, 10, (4, 1)).astype(np.int64)}),
    "deepfm_tiny_train": (
        "deepfm_emb@GRAD",
        lambda r: {"feat_ids": r.randint(0, 64, (8, 4, 1)).astype(np.int64),
                   "label": r.randint(0, 2, (8, 1)).astype(np.float32)}),
    "machine_translation_tiny_train": (
        "mt.src_emb@GRAD",
        lambda r: {k: r.randint(0, 30, (4, 8)).astype(np.int64)
                   for k in ("src", "tgt_in", "tgt_out")}),
}


def _files(name):
    out = {}
    for f in ("__main__", "__startup__"):
        with open(os.path.join(PROGRAMS, name, f + ".json"), "rb") as fh:
            out[f] = fh.read()
    return out


def _jax_program(data):
    """A JAX ``Program`` over a parsed desc (as ``fluid.io`` restores one)."""
    desc = jir.ProgramDesc.parse_from_string(data)
    p = jfw.Program()
    p.desc = desc
    p.blocks = [jfw.Block(p, i) for i in range(len(desc.blocks))]
    for b in p.blocks:
        for n, vd in b.desc.vars.items():
            b.vars[n] = jfw.Variable(b, vd)
        b.ops = [jfw.Operator(b, od) for od in b.desc.ops]
    return p


def _port_program(data):
    return tfluid.Program(tir.ProgramDesc.parse_from_string(data))


def _persistables(data):
    return sorted(n for n, v in json.loads(data)["blocks"][0]["vars"].items()
                  if v["persistable"])


def _feeds(name, seed=0):
    rng = np.random.RandomState(seed)
    return [PAIRS[name][1](rng) for _ in range(STEPS)]


def _jax_trained(name, files, feeds):
    """(losses [STEPS], grads [STEPS, ...], the scope before the steps,
    the scope after them) of the JAX executor's 3 steps, one dispatch."""
    main, startup = (_jax_program(files[k])
                     for k in ("__main__", "__startup__"))
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    start = {n: np.array(scope.find_var(n))
             for n in _persistables(files["__main__"])}
    losses, grads = exe.run(main, feed=feeds, iterations=STEPS, scope=scope,
                            fetch_list=[LOSS, PAIRS[name][0]])
    return np.asarray(losses), np.asarray(grads), start, scope


def _port_scope(arrays):
    s = tfluid.Scope()
    for n, a in arrays.items():
        s.set_var(n, torch.from_numpy(a.copy()))
    return s


def _port_steps(prog, scope, feeds, fetch):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_training_pair_matches_jax(name):
    files = _files(name)
    feeds = _feeds(name)
    jlosses, jgrads, start, jscope = _jax_trained(name, files, feeds)
    scope = _port_scope(start)
    outs = _port_steps(_port_program(files["__main__"]), scope, feeds,
                       [LOSS, PAIRS[name][0]])
    np.testing.assert_allclose([o[0].reshape(-1)[0] for o in outs],
                               jlosses.reshape(STEPS), **CURVE_TOL)
    for k, o in enumerate(outs):
        assert o[1].shape == jgrads[k].shape       # fetched dense
        np.testing.assert_allclose(o[1], jgrads[k], err_msg=f"step {k}",
                                   **STATE_TOL)
    moved = 0
    for n in start:
        got = scope.find_var(n).numpy()
        want = np.asarray(jscope.find_var(n))
        np.testing.assert_allclose(got, want, err_msg=n, **STATE_TOL)
        moved += not np.array_equal(got, start[n])
    assert moved > len(start) // 2          # the steps updated the state


def _port_startup(name, seed=0, place=None):
    files = _files(name)
    startup = _port_program(files["__startup__"])
    startup.random_seed = seed
    scope = tfluid.Scope()
    tfluid.Executor(place or tfluid.CPUPlace()).run(startup, scope=scope)
    return files, scope


def test_dead_forward_replays_with_the_same_weights():
    """Not fetching the loss leaves ``mean`` (and the loss op under it)
    dead: their ``__vjp__`` replays them, and the weights move exactly as
    in a step that fetches the loss. The kept forwards are the live ones
    a ``__vjp__`` names."""
    files, s0 = _port_startup("mnist_train", seed=3)
    arrays = {n: s0.find_var(n).numpy() for n in
              _persistables(files["__main__"])}
    feeds = _feeds("mnist_train", seed=1)[:2]
    prog = _port_program(files["__main__"])
    scopes = [_port_scope(arrays), _port_scope(arrays)]
    _port_steps(prog, scopes[0], feeds, [LOSS])
    _port_steps(prog, scopes[1], feeds, [])
    for n in arrays:
        np.testing.assert_array_equal(scopes[1].find_var(n).numpy(),
                                      scopes[0].find_var(n).numpy(), n)
    block = prog.desc.global_block
    for fetch in ([LOSS], []):
        sig = tlow.analyze_block(block, sorted(feeds[0]), fetch)
        kept = {block.ops[i].type for i in
                tlow.recorded_forwards(block, sig.live_ops)}
        assert ("mean" in kept) == bool(fetch)
        assert {"conv2d", "pool2d", "mul"} <= kept


def test_zeroed_dropout_copy_trains_as_the_dropout_0_build():
    """Phase 24's oracle program: the JAX build at dropout 0.1 with every
    dropout probability zeroed trains, through the port, as the committed
    build at ``dropout=0.0`` (which the pair test holds to JAX)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tool = _export_tool()
    module, kwargs = tool.TRAIN_PROGRAMS["transformer_tiny_train"]
    from paddle_tpu.models import transformer
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), unique_name.guard():
        transformer.build(is_train=True, **dict(kwargs, dropout=0.1))
    desc = tir.ProgramDesc.parse_from_string(main.desc.serialize_to_string())
    assert any(op.type == "dropout" for op in desc.global_block.ops)
    zeroed = tfluid.Program(smoke.zero_dropout(desc))
    files, s0 = _port_startup("transformer_tiny_train", seed=5)
    arrays = {n: s0.find_var(n).numpy() for n in
              _persistables(files["__main__"])}
    feeds = _feeds("transformer_tiny_train", seed=2)[:2]
    scopes = [_port_scope(arrays), _port_scope(arrays)]
    a = _port_steps(zeroed, scopes[0], feeds, [LOSS])
    b = _port_steps(_port_program(files["__main__"]), scopes[1], feeds,
                    [LOSS])
    np.testing.assert_allclose([x[0] for x in a], [x[0] for x in b],
                               rtol=1e-6, atol=0)
    for n in arrays:
        np.testing.assert_allclose(scopes[0].find_var(n).numpy(),
                                   scopes[1].find_var(n).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_startup_ops():
    """``fill_constant`` and ``assign_value`` give their attrs exactly (and
    the JAX emitters' values); the random ops have their shape and dtype,
    stay in bounds (uniform in [min, max]), and have the moments of their
    law within 5 sigma over all their draws; a non-zero ``random_seed``
    repeats every draw, and another seed changes them."""
    files, scope = _port_startup("transformer_tiny_train", seed=11)
    desc = json.loads(files["__startup__"])
    jctx = jreg.EmitContext(base_key=jax.random.key(0))
    seen = set()
    for op in desc["blocks"][0]["ops"]:
        name = op["outputs"]["Out"][0]
        got = scope.find_var(name).numpy()
        a = op["attrs"]
        assert got.shape == tuple(a["shape"]) and str(got.dtype) == a["dtype"]
        seen.add(op["type"])
        if op["type"] in ("fill_constant", "assign_value"):
            want = np.asarray(jreg.get_op(op["type"]).emit(jctx, {}, a)
                              ["Out"][0])
            np.testing.assert_array_equal(got, want, name)
            continue
        x = got.astype(np.float64).ravel()
        n = x.size
        if op["type"] == "uniform_random":
            lo, hi = a["min"], a["max"]
            assert lo <= x.min() and x.max() <= hi
            mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        else:                                   # gaussian_random
            mean, var = a["mean"], a["std"] ** 2
        assert abs(x.mean() - mean) <= 5 * np.sqrt(var / n) + 1e-12, name
        # the sample variance's own sigma: var * sqrt(2 / n) for a normal,
        # below it for the uniform
        assert abs(x.var() - var) <= 5 * var * np.sqrt(2.0 / n), name
    assert seen == {"fill_constant", "assign_value", "uniform_random",
                    "gaussian_random"}
    _, again = _port_startup("transformer_tiny_train", seed=11)
    _, other = _port_startup("transformer_tiny_train", seed=12)
    drawn = [op["outputs"]["Out"][0] for op in desc["blocks"][0]["ops"]
             if op["type"].endswith("_random")]
    for n in drawn:
        np.testing.assert_array_equal(again.find_var(n).numpy(),
                                      scope.find_var(n).numpy(), n)
        assert not np.array_equal(other.find_var(n).numpy(),
                                  scope.find_var(n).numpy()), n
    # the truncated normal, which no bench startup holds: in [-2, 2] sigma
    t = treg.get_op("truncated_gaussian_random").emit(
        treg.EmitContext(base_seed=4), {},
        {"shape": [4000], "mean": 1.0, "std": 0.5, "dtype": "float32"})
    t = t["Out"][0].double()
    assert 0.0 <= t.min() and t.max() <= 2.0 and abs(t.mean() - 1.0) < 0.05
    z = treg.get_op("fill_zeros_like").emit(
        treg.EmitContext(), {"X": [torch.ones(2, 3, dtype=torch.int64)]}, {})
    assert z["Out"][0].dtype == torch.int64 and not z["Out"][0].any()


def test_sparse_rows_touched_counts_each_step():
    """deepfm's lazy Adam applies a row-sparse gradient of B * F rows: the
    executor advances ``paddle_sparse_rows_touched_total`` by them a
    step, as the JAX executor does."""
    files, s0 = _port_startup("deepfm_tiny_train", seed=2)
    fam = tmetrics.counter("paddle_sparse_rows_touched_total", "",
                           ("param",))
    before = fam.labels(param="deepfm_emb").value
    feeds = _feeds("deepfm_tiny_train")[:2]
    _port_steps(_port_program(files["__main__"]), s0, feeds, [LOSS])
    assert fam.labels(param="deepfm_emb").value - before == 2 * 8 * 4


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_export_programs",
        os.path.join(REPO, "tools", "torch_export_programs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool
