"""The port's program executor (``paddle_tpu_torch/core``, ``fluid``)
against the JAX package's: the IR, the scope, the block analysis, the op
emitters, ``Executor.run`` (``iterations`` included), ``fluid.io`` both
ways, the refusals, the chaos site, and the committed programs of
``tests/torch_programs/``.

The programs here are built with the JAX ``fluid.layers`` at tiny widths,
their JAX startup run in a JAX scope, and the same arrays carried into a
port scope as CPU tensors; the port runs the JAX program's desc parsed
from its JSON. Tolerances, fp32: ``TOL`` rtol 1e-5 / atol 1e-6 (one
forward whose sums run in another order on each side); integer outputs
(``top_k``'s indices, ``accuracy``'s counts) are equal.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import ir as jir
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core import scope as jscope_mod
from paddle_tpu.fluid import layers, unique_name
from paddle_tpu.fluid import sharded_io as jsio

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core import scope as tscope_mod
from paddle_tpu_torch.fluid import sharded_io as tsio
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.observability import flight_recorder as trec
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.utils import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = os.path.join(REPO, "tests", "torch_programs")
# the saved inference programs (the training pairs beside them are
# tests/test_torch_train_programs.py's)
COMMITTED = sorted(n for n in os.listdir(PROGRAMS) if os.path.exists(
    os.path.join(PROGRAMS, n, "__model__.json")))
TOL = dict(rtol=1e-5, atol=1e-6)


# -- helpers ------------------------------------------------------------------

def _committed(name):
    with open(os.path.join(PROGRAMS, name, "__model__.json")) as f:
        return json.load(f)


def _port_program(jprog):
    """The port's Program over the JAX program's desc, through its JSON."""
    p = tfluid.Program(tir.ProgramDesc.parse_from_string(
        jprog.desc.serialize_to_string()))
    p._is_test = jprog._is_test
    return p


def _port_scope(jscope, names):
    s = tfluid.Scope()
    for n in names:
        s.set_var(n, torch.from_numpy(np.array(jscope.find_var(n))))
    return s


def _persistables(jprog):
    return [n for n, v in jprog.desc.global_block.vars.items()
            if v.persistable]


def _op_program():
    """A program of the op types that no bench model's ``build`` reaches
    at inference: concat, elementwise_mul, sigmoid, dropout (both
    implementations, by the test program and by the ``is_test`` attr),
    cross_entropy, top_k and accuracy on an input with ties. Returns
    (test program, JAX scope, {name: var})."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[6], dtype="float32")
        y = layers.data("y", shape=[6], dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        h = layers.fc(layers.concat([x, y], axis=1), size=8, act="relu")
        h = layers.elementwise_mul(h, layers.sigmoid(layers.fc(x, size=8)))
        down = layers.dropout(h, 0.3)
        up = layers.dropout(h, 0.3, dropout_implementation="upscale_in_train")
        attr = layers.dropout(h, 0.5, is_test=True)
        logits = layers.fc(layers.elementwise_add(
            layers.elementwise_add(down, up), attr), size=5)
        prob = layers.softmax(logits)
        loss = layers.mean(layers.cross_entropy(prob, label))
        vals, idx = layers.topk(x, k=3)
        acc = layers.accuracy(x, label, k=2)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    test = main.clone(for_test=True)
    return test, scope, dict(x=x, prob=prob, loss=loss, vals=vals, idx=idx,
                             acc=acc, down=down, up=up, attr=attr)


def _op_feeds(seed=0, b=4):
    rng = np.random.RandomState(seed)
    # x from {0, 1, 2}: top_k and accuracy see ties in every row
    return {"x": rng.randint(0, 3, (b, 6)).astype(np.float32),
            "y": rng.randn(b, 6).astype(np.float32),
            "label": rng.randint(0, 5, (b, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def op_program():
    return _op_program()


def _run_jax(prog, scope, feeds, fetch, **kw):
    return [np.asarray(o) for o in jfluid.Executor(jfluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=fetch, scope=scope, **kw)]


# -- the IR -------------------------------------------------------------------

@pytest.mark.parametrize("name", COMMITTED)
def test_ir_round_trips_both_ways(name):
    """A program serialized by either side parses on the other, and its
    JSON is byte-equal after the round trip."""
    data = json.dumps(_committed(name)["program"]).encode()
    jdesc = jir.ProgramDesc.parse_from_string(data)
    tdesc = tir.ProgramDesc.parse_from_string(jdesc.serialize_to_string())
    assert tdesc.serialize_to_string() == jdesc.serialize_to_string()
    back = jir.ProgramDesc.parse_from_string(tdesc.serialize_to_string())
    assert back.serialize_to_string() == tdesc.serialize_to_string()
    assert tdesc.to_dict() == jdesc.to_dict()
    assert tdesc.clone().to_dict() == jdesc.clone().to_dict()
    assert tdesc.clone().version_token != tdesc.version_token


def test_ir_prune_and_sub_blocks_match(op_program):
    """``prune_block``, ``find_var_recursive`` and a sub-block round trip,
    on the op program."""
    prog, _, v = op_program
    jdesc = prog.desc.clone()          # the module's program stays as it is
    tdesc = tir.ProgramDesc.parse_from_string(jdesc.serialize_to_string())
    for targets, feeds in (([v["loss"].name], ["x", "y", "label"]),
                           ([v["idx"].name], ["x"])):
        jb = jir.prune_block(jdesc.global_block, targets, feeds)
        tb = tir.prune_block(tdesc.global_block, targets, feeds)
        assert tb.to_dict() == jb.to_dict()
    for d, mod in ((jdesc, jir), (tdesc, tir)):
        d.append_block(0).append_op(
            mod.OpDesc("scale", {"X": ["x"]}, {"Out": ["s"]}))
    assert tdesc.serialize_to_string() == jdesc.serialize_to_string()
    sub_t = tdesc.block(1)
    assert tir.find_var_recursive(tdesc, sub_t, "x").name == "x"
    assert tir.find_var_recursive(tdesc, sub_t, "nope") is None


@pytest.mark.parametrize("name", COMMITTED)
def test_analyze_block_matches_jax(name):
    payload = _committed(name)
    data = json.dumps(payload["program"]).encode()
    jb = jir.ProgramDesc.parse_from_string(data).global_block
    tb = tir.ProgramDesc.parse_from_string(data).global_block
    first_out = tb.ops[0].output_names()[0]
    for feeds, fetches in ((payload["feed_names"], payload["fetch_names"]),
                           (payload["feed_names"][:1], [first_out]),
                           (payload["feed_names"],
                            payload["fetch_names"] + [first_out])):
        want = jlow.analyze_block(jb, feeds, fetches)
        got = tlow.analyze_block(tb, feeds, fetches)
        assert got.__dict__ == want.__dict__


# -- the scope ----------------------------------------------------------------

def test_scope_hierarchy_matches_jax():
    """The same calls on both scopes give the same observations."""
    def drive(mod, fluid):
        obs = []
        root = mod.Scope()
        kid = root.new_scope()
        grand = kid.new_scope()
        root.set_var("a", 1)
        kid.set_var("b", 2)
        grand.set_var("a", 3)              # shadows the root's
        obs += [grand.find_var("a"), kid.find_var("a"), grand.find_var("b"),
                root.find_var("b"), grand.has_var("b"), root.has_var("b")]
        v0 = grand.version()
        root.set_var("c", 4)               # a parent write counts for kids
        obs += [grand.version() - v0, sorted(kid.local_var_names())]
        obs.append(sorted(n for n, _ in root.iter_vars()))
        kid.erase(["b", "missing"])
        obs += [grand.find_var("b"), kid.version() - v0]
        root.drop_kids()
        obs.append(sorted(n for n, _ in root.iter_vars()))
        outer = mod.global_scope()
        with fluid.scope_guard(root):
            obs.append(mod.global_scope() is root)
        obs.append(mod.global_scope() is outer)
        return obs

    assert drive(tscope_mod, tfluid) == drive(jscope_mod, jfluid)


# -- Executor.run -------------------------------------------------------------

def test_op_program_matches_jax(op_program):
    prog, jscope, v = op_program
    feeds = _op_feeds()
    fetch = [v[k].name for k in ("prob", "loss", "vals", "idx", "acc",
                                 "down", "up", "attr")]
    want = _run_jax(prog, jscope, feeds, fetch)
    tprog = _port_program(prog)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed=feeds, fetch_list=fetch,
        scope=_port_scope(jscope, _persistables(prog)))
    for name, w, g in zip(fetch, want, got):
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer) or name == v["acc"].name:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)
    # the ties: top_k takes equal values in index order
    x = feeds["x"]
    order = np.lexsort((np.arange(6)[None].repeat(4, 0), -x), axis=1)[:, :3]
    np.testing.assert_array_equal(got[3], order)


def test_liveness_and_unfed_inputs_match_jax(op_program):
    """Fetching the prediction needs no label (the loss ops are dead and
    skipped); fetching the loss without it raises the same error on both
    sides."""
    prog, jscope, v = op_program
    feeds = {k: a for k, a in _op_feeds().items() if k != "label"}
    tprog = _port_program(prog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = _port_scope(jscope, _persistables(prog))
    want = _run_jax(prog, jscope, feeds, [v["prob"].name])
    got = texe.run(tprog, feed=feeds, fetch_list=[v["prob"]], scope=tscope)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    with pytest.raises(RuntimeError) as jerr:
        _run_jax(prog, jscope, feeds, [v["loss"].name])
    with pytest.raises(RuntimeError) as terr:
        texe.run(tprog, feed=feeds, fetch_list=[v["loss"]], scope=tscope)
    assert str(terr.value) == str(jerr.value)


def _bn_program():
    """fc -> batch_norm in training mode: each run updates the moving
    statistics, the state an ``iterations`` loop threads from step to
    step."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[5], dtype="float32")
        y = layers.batch_norm(layers.fc(x, size=4), momentum=0.5)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    stats = sorted(n for n in _persistables(main)
                   if n.endswith((".mean_0", ".var_0")))
    return main, scope, y, stats


@pytest.mark.parametrize("feed_kind", ["list", "resident"])
def test_iterations_match_jax(feed_kind):
    """``iterations`` 3 over a list of batches (one a step) and over one
    resident batch: the stacked fetches and the moving statistics after
    the run equal the JAX executor's (its one scanned dispatch)."""
    prog, jscope, y, stats = _bn_program()
    rng = np.random.RandomState(5)
    batches = [{"x": rng.randn(6, 5).astype(np.float32)} for _ in range(3)]
    feed = batches if feed_kind == "list" else batches[0]
    tscope = _port_scope(jscope, _persistables(prog))
    want = _run_jax(prog, jscope, feed, [y.name] + stats, iterations=3)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        _port_program(prog), feed=feed, fetch_list=[y.name] + stats,
        scope=tscope, iterations=3)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.shape[0] == 3
        np.testing.assert_allclose(g, w, **TOL)
    for n in stats:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)), **TOL)


def test_executor_places_and_cache(op_program):
    """``Executor()`` is the card's and raises without one; a run reuses
    its runner until the program's version moves; feeds are cast to
    their declared dtypes; ``run(None)`` runs the default main program;
    a CPU executor refuses a scope value on another device (checked here
    with a meta tensor)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    prog, jscope, v = op_program
    tprog = _port_program(prog)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = _port_scope(jscope, _persistables(prog))
    feeds = _op_feeds()
    feeds["x"] = feeds["x"].astype(np.float64)     # declared float32
    out = exe.run(tprog, feed=feeds, fetch_list=[v["vals"]], scope=scope,
                  return_numpy=False)
    assert out[0].dtype == torch.float32
    exe.run(tprog, feed=feeds, fetch_list=[v["vals"]], scope=scope)
    assert len(exe._cache) == 1
    tprog.random_seed = 3
    want = exe.run(tprog, feed=feeds, fetch_list=[v["vals"]], scope=scope)
    assert len(exe._cache) == 2
    with tfluid.program_guard(tprog):
        got = exe.run(None, feed=feeds, fetch_list=[v["vals"]], scope=scope)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(exe._cache) == 2
    name = _persistables(prog)[0]
    scope.set_var(name, torch.empty(tuple(scope.find_var(name).shape),
                                    device="meta"))
    with pytest.raises(ValueError, match="executors of its own device"):
        exe.run(tprog, feed=feeds, fetch_list=[v["prob"]], scope=scope)


def test_check_nan_inf(op_program):
    prog, jscope, v = op_program
    feeds = _op_feeds()
    feeds["y"][0, 0] = np.inf
    tflags.set("check_nan_inf", True)
    try:
        with pytest.raises(FloatingPointError, match="check_nan_inf"):
            tfluid.Executor(tfluid.CPUPlace()).run(
                _port_program(prog), feed=feeds, fetch_list=[v["prob"]],
                scope=_port_scope(jscope, _persistables(prog)))
    finally:
        tflags.reset("check_nan_inf")


# -- refusals -----------------------------------------------------------------

def _train_program():
    """A training program (``__vjp__`` and ``adam`` ops, which the port
    runs) over an op type the port has not ported (``log``)."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), unique_name.guard():
        x = layers.data("x", shape=[4], dtype="float32")
        loss = layers.mean(layers.log(layers.fc(x, size=2)))
        jfluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, loss


def _tag(desc, what):
    """Tag ``desc`` (either package's) in place as case ``what`` says."""
    ops = desc.global_block.ops
    if what == "amp":
        next(op for op in ops if op.type == "mul").attrs["__amp_bf16__"] = True
    elif what == "nhwc":
        next(op for op in ops
             if op.type == "concat").attrs["__nhwc_concat__"] = True
    elif what == "sharded":
        next(v for v in desc.global_block.vars.values()
             if v.persistable).attrs["__sharded__"] = True
    elif what == "sub_block":
        desc.append_block(0)


def _tagged(op_program, what):
    prog, _, _ = op_program
    desc = tir.ProgramDesc.parse_from_string(prog.desc.serialize_to_string())
    _tag(desc, what)
    p = tfluid.Program(desc)
    p._is_test = prog._is_test
    return p


@pytest.mark.parametrize("what,match", [
    ("unregistered", r"not registered in the port: \['log'\].*A6\.6"),
    ("amp", None),
    ("nhwc", None),
    ("sharded", r"__sharded__ tables.*A6\.9"),
    ("sub_block", r"sub-blocks \(2 blocks.*A6\.4b\.c")])
def test_refusals_before_any_op_runs(op_program, monkeypatch, what, match):
    """Each unported cause raises before any op runs. An AMP-tagged op
    (a conservative ``mul``: bf16 operands, fp32 result) and an
    NHWC-tagged one (``__nhwc_concat__`` on the rank-2 concat, which the
    JAX op re-aims at its last axis, 1, as it is) are ported: the tagged
    program runs and its fetch matches the JAX executor's on the same
    desc (``TOL``: the bf16 products are exact in fp32 on both sides)."""
    ran = []
    real = tlow.emit_op_seq
    monkeypatch.setattr(tlow, "emit_op_seq",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    if match is None:
        prog, jscope, vs = op_program
        tagged = _tagged(op_program, what)
        jprog = prog.clone(for_test=True)
        _tag(jprog.desc, what)
        fetch = [vs["prob"].name]
        want = _run_jax(jprog, jscope, _op_feeds(), fetch)
        got = tfluid.Executor(tfluid.CPUPlace()).run(
            tagged, feed=_op_feeds(), fetch_list=fetch,
            scope=_port_scope(jscope, _persistables(prog)))
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert ran
        return
    if what == "unregistered":
        main, loss = _train_program()
        prog, feeds, fetch = _port_program(main), {
            "x": np.ones((2, 4), np.float32)}, [loss.name]
    else:
        prog, feeds = _tagged(op_program, what), _op_feeds()
        fetch = [op_program[2]["prob"].name]
    with pytest.raises(NotImplementedError, match=match):
        tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed=feeds, fetch_list=fetch, scope=tfluid.Scope())
    assert not ran


# -- the chaos site -----------------------------------------------------------

def test_dispatch_oom_writes_the_memdump(op_program, tmp_path):
    """``executor.dispatch:raise@1:exc=MemoryError``: the memdump names the
    program's ``_obs_name``, one ``paddle_oom_events_total`` count, and
    the error goes on (tests/test_memory_observability.py:211 for the
    JAX executor)."""
    prog, jscope, v = op_program
    tprog = _port_program(prog)
    tprog.desc._obs_name = "t_exec_oom"
    before = tmem.OOM_EVENTS.labels(program="t_exec_oom").value
    tflags.set("flight_recorder_dir", str(tmp_path))
    try:
        with tfaults.active("executor.dispatch:raise@1:exc=MemoryError"):
            with pytest.raises(MemoryError):
                tfluid.Executor(tfluid.CPUPlace()).run(
                    tprog, feed=_op_feeds(), fetch_list=[v["prob"]],
                    scope=_port_scope(jscope, _persistables(prog)))
    finally:
        tflags.reset("flight_recorder_dir")
        trec.shutdown()
    dumps = [f for f in os.listdir(tmp_path) if f.endswith(".memdump.json")]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        doc = json.load(f)
    assert (doc["program"], doc["reason"], doc["exc_type"]) == (
        "t_exec_oom", "oom", "MemoryError")
    assert tmem.OOM_EVENTS.labels(program="t_exec_oom").value == before + 1


# -- fluid.io -----------------------------------------------------------------

def test_port_saved_model_runs_on_jax(op_program, tmp_path):
    """The port's ``save_inference_model`` writes a directory that the JAX
    ``load_inference_model`` runs to the port's own fetches."""
    prog, jscope, v = op_program
    tprog = _port_program(prog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    d = str(tmp_path / "saved")
    fetch = [v["prob"].name, v["idx"].name]
    tfluid.io.save_inference_model(
        d, ["x", "y"], fetch, texe, main_program=tprog,
        scope=_port_scope(jscope, _persistables(prog)))
    feeds = {k: a for k, a in _op_feeds(1).items() if k != "label"}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jprog, jfeeds, jfetch = jfluid.io.load_inference_model(
        d, jexe, scope=jfluid.Scope())
    lscope = jfluid.Scope()
    jprog, jfeeds, jfetch = jfluid.io.load_inference_model(d, jexe,
                                                           scope=lscope)
    want = _run_jax(jprog, lscope, feeds, jfetch)
    sscope = tfluid.Scope()
    sprog, sfeeds, sfetch = tfluid.io.load_inference_model(d, texe,
                                                           scope=sscope)
    assert (sfeeds, sfetch) == (jfeeds, jfetch) == (["x", "y"], fetch)
    got = texe.run(sprog, feed=feeds, fetch_list=sfetch, scope=sscope)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])


def test_params_and_persistables_round_trip(op_program, tmp_path):
    """``save_params`` / ``load_params`` and ``save_persistables`` /
    ``load_persistables`` on the port, read back by the JAX package."""
    prog, jscope, _ = op_program
    tprog = _port_program(prog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    scope = _port_scope(jscope, _persistables(prog))
    params = tfluid.io.save_params(texe, str(tmp_path / "p"), tprog,
                                   scope=scope)
    assert params == sorted(p.name for p in prog.all_parameters())
    back = tfluid.Scope()
    tfluid.io.load_params(texe, str(tmp_path / "p"), tprog, scope=back)
    saved = tfluid.io.save_persistables(texe, str(tmp_path / "all"), tprog,
                                        scope=scope)
    jback = jfluid.Scope()
    jfluid.io.load_persistables(None, str(tmp_path / "all"), prog,
                                scope=jback)
    for n in saved:
        np.testing.assert_array_equal(np.asarray(jback.find_var(n)),
                                      scope.find_var(n).numpy())
    for n in params:
        assert torch.equal(back.find_var(n), scope.find_var(n))


def _tamper(d):
    name = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    with open(os.path.join(d, name), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\x00\x01\x02\x03")


def test_checksum_both_sides(op_program, tmp_path):
    prog, jscope, v = op_program
    d = str(tmp_path / "saved")
    jfluid.io.save_inference_model(d, ["x", "y"], [v["prob"].name],
                                   jfluid.Executor(jfluid.CPUPlace()),
                                   main_program=prog, scope=jscope)
    _tamper(d)
    before = tsio.CKPT_CRC_FAILURES.value
    with pytest.raises(tsio.ChecksumError):
        tfluid.io.load_inference_model(d, tfluid.Executor(tfluid.CPUPlace()),
                                       scope=tfluid.Scope())
    assert tsio.CKPT_CRC_FAILURES.value == before + 1
    with pytest.raises(jsio.ChecksumError):
        jfluid.io.load_inference_model(d, jfluid.Executor(jfluid.CPUPlace()),
                                       scope=jfluid.Scope())


def test_ckpt_write_var_fault_sites(op_program, tmp_path):
    """``ckpt.write_var``: a raise before the first file, and a tear after
    its checksum that the load then catches."""
    prog, jscope, _ = op_program
    tprog = _port_program(prog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    scope = _port_scope(jscope, _persistables(prog))
    with tfaults.active("ckpt.write_var:raise@1:exc=OSError"):
        with pytest.raises(OSError):
            tfluid.io.save_persistables(texe, str(tmp_path / "a"), tprog,
                                        scope=scope)
    with tfaults.active("ckpt.write_var:truncate@2:to=10"):
        tfluid.io.save_persistables(texe, str(tmp_path / "b"), tprog,
                                    scope=scope)
    with pytest.raises(tsio.ChecksumError):
        tfluid.io.load_persistables(texe, str(tmp_path / "b"), tprog,
                                    scope=tfluid.Scope())


# -- the committed programs and the imports -----------------------------------

def test_committed_programs_are_current():
    """``tools/torch_export_programs.py`` regenerates every program of
    ``tests/torch_programs/`` from the JAX models' ``build`` as it is now; each
    must equal the committed file as a JSON value (the variables' order in
    a file follows string hashing). The parameter names are the ones the
    port's converters map."""
    spec = importlib.util.spec_from_file_location(
        "torch_export_programs",
        os.path.join(REPO, "tools", "torch_export_programs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert sorted(tool.PROGRAMS) == COMMITTED
    assert sorted(tool.TRAIN_PROGRAMS) == sorted(
        set(os.listdir(PROGRAMS)) - set(COMMITTED))
    for name in COMMITTED:
        assert tool.is_current(name), name
    tf_vars = _committed("transformer_base")["program"]["blocks"][0]["vars"]
    params = {n for n, vd in tf_vars.items() if vd["is_parameter"]}
    assert params == set(convert.transformer_jax_names(6, True, True)
                         .values())
    lstm_vars = _committed("stacked_dynamic_lstm")["program"]["blocks"][0][
        "vars"]
    assert {n for n, vd in lstm_vars.items() if vd["persistable"]} == set(
        convert.lstm_jax_names(3).values())


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.core.ir\n"
            "import paddle_tpu_torch.core.scope\n"
            "import paddle_tpu_torch.core.registry\n"
            "import paddle_tpu_torch.core.lowering\n"
            "import paddle_tpu_torch.core.executor\n"
            "import paddle_tpu_torch.ops.basic\n"
            "import paddle_tpu_torch.ops.math_ops\n"
            "import paddle_tpu_torch.ops.metric_ops\n"
            "import paddle_tpu_torch.fluid\n"
            "import paddle_tpu_torch.fluid.framework\n"
            "import paddle_tpu_torch.fluid.io\n"
            "import paddle_tpu_torch.fluid.sharded_io\n"
            "import paddle_tpu_torch.models.convert\n"
            "import paddle_tpu_torch.fluid.ir_pass\n"
            "import paddle_tpu_torch.fluid.debugger\n"
            "import paddle_tpu_torch.inference\n"
            "import paddle_tpu_torch.inference.predictor\n"
            "import paddle_tpu_torch.inference.transpiler\n"
            "import paddle_tpu_torch.ops.lod_ops\n"
            "import paddle_tpu_torch.ops.misc_ops\n"
            "import paddle_tpu_torch.ops.grad_ops\n"
            "import paddle_tpu_torch.ops.optimizer_ops\n"
            "import paddle_tpu_torch.core.selected_rows\n"
            "import paddle_tpu_torch.serving.engine\n"
            "import paddle_tpu_torch.serving.replica\n"
            "from paddle_tpu_torch import serving\n"
            "serving.ServedModel\n"
            "from paddle_tpu_torch.core.registry import OPS\n"
            "import paddle_tpu_torch.core.shape_inference\n"
            "import paddle_tpu_torch.fluid.layers\n"
            "import paddle_tpu_torch.fluid.optimizer\n"
            "import paddle_tpu_torch.fluid.models.transformer\n"
            "import paddle_tpu_torch.fluid.models.mnist\n"
            "import paddle_tpu_torch.fluid.models.stacked_dynamic_lstm\n"
            "import paddle_tpu_torch.fluid.models.smallnet\n"
            "import paddle_tpu_torch.fluid.models.alexnet\n"
            "import paddle_tpu_torch.fluid.models.vgg\n"
            "import paddle_tpu_torch.fluid.models.resnet\n"
            "import paddle_tpu_torch.fluid.models.se_resnext\n"
            "import paddle_tpu_torch.fluid.models.googlenet\n"
            "import paddle_tpu_torch.fluid.models.deepfm\n"
            "import paddle_tpu_torch.fluid.models.machine_translation\n"
            "import paddle_tpu_torch.fluid.nets\n"
            "import paddle_tpu_torch.ops.beam_ops\n"
            "assert len(OPS) == 124, sorted(OPS)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu'\n"
            "             or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
