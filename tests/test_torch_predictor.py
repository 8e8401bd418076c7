"""The port's predictor (``paddle_tpu_torch/inference/``) against the JAX
predictor on the same saved directories, on the CPU.

Each case is a small JAX program whose pattern one analysis pass rewrites
(built as ``tests/test_fuse_passes.py`` and
``tests/test_build_strategy_passes.py:110-290`` build them), its startup
run in a fresh scope (a few values set to make the folds matter), saved by
the JAX ``save_inference_model``. The port's ``PaddlePredictor``
(``disable_gpu()``) and the JAX ``PaddlePredictor`` each load it into a
scope of their own and run ``ANALYSIS_PASSES``; then

- the rewritten ``ProgramDesc.to_dict()`` is equal on both sides;
- every persistable of the two scopes is bit-equal, the folded weights
  (conv + batch norm, conv + affine channel, the embedding table times
  the gate projection) included: both sides fold in numpy float32;
- the fetches agree within ``TOL`` (rtol 1e-5 / atol 1e-6: one fp32
  forward whose sums run in another order on each side);
- the case's pass fired: applied one by one on the port's unrewritten
  program, it changes that program's ``to_dict()``.

``graph_to_program_pass`` and ``graph_viz_pass``, which the predictor
does not run, go through each side's ``PassBuilder``. The bench programs
(mnist, deepfm, the stacked LSTM and the fused Transformer at tiny
widths, as ``tests/test_torch_saved_models.py`` builds them, the
Transformer at one layer, and the conv + bn case) run with ``ir_optim``
on and off. The subprocess import check of the new modules is
``tests/test_torch_executor.py``'s.

Each saved directory and its JAX predictor are built once per process,
when a test first needs them (``_case``, ``_bench``).
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import inference as jinf
from paddle_tpu.core.registry import get_op as jget_op
from paddle_tpu.fluid import ir_pass as jir_pass
from paddle_tpu.fluid import layers, unique_name
from paddle_tpu.fluid.layer_helper import LayerHelper

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.fluid import ir_pass as tir_pass
from paddle_tpu_torch.ops import lod_ops

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, D = 2, 4, 6


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _save(d, build, scope_fn=None):
    """Build a program with ``build()`` -> (feed names, targets, feeds),
    run its startup in a fresh scope, apply ``scope_fn(scope)``, save it
    to ``d``. Returns the feeds."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = 3
    with jfluid.program_guard(main, startup), unique_name.guard():
        feed_names, targets, feeds = build()
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if scope_fn is not None:
        scope_fn(scope)
    jfluid.io.save_inference_model(d, feed_names, targets, exe,
                                   main_program=main, scope=scope)
    return feeds


def _set(scope, name, value):
    scope.set_var(name, np.asarray(value, np.float32))


# -- the pass cases -----------------------------------------------------------

def _fc_mlp():
    x = layers.data(name="x", shape=[4], dtype="float32")
    h = layers.fc(x, size=8, act="relu")
    return ["x"], [layers.fc(h, size=3)], {"x": _rand(1, B, 4)}


def _dropout_mlp():
    x = layers.data(name="x", shape=[4], dtype="float32")
    h = layers.dropout(layers.fc(x, size=8, act="relu"), dropout_prob=0.5)
    return ["x"], [layers.fc(h, size=3)], {"x": _rand(2, B, 4)}


def _conv_affine():
    img = layers.data(name="img", shape=[3, 6, 6], dtype="float32")
    c = layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
    h = LayerHelper("ac")
    scale = h.create_parameter(jfluid.ParamAttr(name="ac_s"), shape=[4])
    bias = h.create_parameter(jfluid.ParamAttr(name="ac_b"), shape=[4],
                              is_bias=True)
    return (["img"], [layers.affine_channel(c, scale, bias)],
            {"img": _rand(3, B, 3, 6, 6)})


def _affine_scope(scope):
    _set(scope, "ac_s", _rand(4, 4) + 0.5)
    _set(scope, "ac_b", _rand(5, 4))


def _conv_bn():
    """conv (no bias) + bn + relu, then conv (bias) + bn, a residual add
    and relu: ResNet's block, and the transpiler's conv-bias branch."""
    img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    c1 = layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
    b1 = layers.batch_norm(c1, act="relu")
    c2 = layers.conv2d(b1, 4, 3, padding=1)
    b2 = layers.batch_norm(c2)
    out = layers.relu(layers.elementwise_add(b2, b1))
    return ["img"], [out], {"img": _rand(6, B, 3, 8, 8)}


def _conv_eltwise(act, residual):
    def build():
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        out = layers.conv2d(img, 4, 3, padding=1, act=None)
        if residual:
            res = layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
            out = layers.elementwise_add(out, res)
        if act:
            out = getattr(layers, act)(out)
        return ["img"], [out], {"img": _rand(7, B, 3, 8, 8)}
    return build


def _seq_feeds(seed):
    return {"x": _rand(seed, B, T, D), "sl": np.array([3, 4], np.int32)}


def _emb_fc_lstm():
    ids = layers.data(name="ids", shape=[T, 1], dtype="int64")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    emb = layers.embedding(ids, size=[12, D],
                           param_attr=jfluid.ParamAttr(name="emb_tbl"))
    proj = layers.fc(emb, size=4 * D, num_flatten_dims=2, bias_attr=False)
    h, _ = layers.dynamic_lstm(proj, size=4 * D, seq_lens=sl)
    rng = np.random.RandomState(8)
    return (["ids", "sl"], [h],
            {"ids": rng.randint(0, 12, (B, T, 1)).astype(np.int64),
             "sl": np.array([3, 4], np.int32)})


def _fc_rnn(cell):
    def build():
        x = layers.data(name="x", shape=[T, D], dtype="float32")
        sl = layers.data(name="sl", shape=[], dtype="int32")
        size = (4 if cell == "lstm" else 3) * D
        proj = layers.fc(x, size=size, num_flatten_dims=2, bias_attr=False)
        if cell == "lstm":
            out, _ = layers.dynamic_lstm(proj, size=size, seq_lens=sl)
        else:
            out = layers.dynamic_gru(proj, size=D, seq_lens=sl)
        return ["x", "sl"], [out], _seq_feeds(9)
    return build


def _seqconv():
    x = layers.data(name="x", shape=[T, D], dtype="float32")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    conv = layers.sequence_conv(x, num_filters=5, filter_size=3,
                                seq_lens=sl, bias_attr=False)
    bias = LayerHelper("scb").create_parameter(
        jfluid.ParamAttr(name="scb"), shape=[5], is_bias=True)
    out = layers.relu(layers.elementwise_add(conv, bias))
    return ["x", "sl"], [out], _seq_feeds(10)


def _seqconv_scope(scope):
    _set(scope, "scb", _rand(11, 5) - 0.5)


def _seqpool_concat():
    """AVERAGE pools with a zero-length row (row 0)."""
    a = layers.data(name="a", shape=[5, 3], dtype="float32")
    b = layers.data(name="b", shape=[5, 3], dtype="float32")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    pa = layers.sequence_pool(a, "average", seq_lens=sl)
    pb = layers.sequence_pool(b, "average", seq_lens=sl)
    out = layers.concat([pa, pb], axis=1)
    return (["a", "b", "sl"], [out],
            {"a": _rand(12, B, 5, 3), "b": _rand(13, B, 5, 3),
             "sl": np.array([0, 5], np.int32)})


def _seq_concat_fc():
    seq = layers.data(name="seq", shape=[T, 5], dtype="float32")
    v1 = layers.data(name="v1", shape=[3], dtype="float32")
    v2 = layers.data(name="v2", shape=[2], dtype="float32")
    cat = layers.concat([seq, layers.sequence_expand(v1, seq),
                         layers.sequence_expand(v2, seq)], axis=2)
    out = layers.fc(cat, size=7, num_flatten_dims=2, act="relu")
    return (["seq", "v1", "v2"], [out],
            {"seq": _rand(14, B, T, 5), "v1": _rand(15, B, 3),
             "v2": _rand(16, B, 2)})


def _transpose_flatten_concat():
    a = layers.data(name="a", shape=[2, 3, 4], dtype="float32")
    b = layers.data(name="b", shape=[2, 3, 4], dtype="float32")
    helper = LayerHelper("tfc")
    flats = []
    for v in (a, b):
        t = helper.create_variable_for_type_inference("float32")
        helper.append_op("transpose2", inputs={"X": [v]},
                         outputs={"Out": [t]}, attrs={"axis": [0, 2, 3, 1]})
        f = helper.create_variable_for_type_inference("float32")
        helper.append_op("flatten2", inputs={"X": [t]}, outputs={"Out": [f]},
                         attrs={"axis": 1})
        flats.append(f)
    return (["a", "b"], [layers.concat(flats, axis=1)],
            {"a": _rand(17, B, 2, 3, 4), "b": _rand(18, B, 2, 3, 4)})


def _with_feed_fetch_ops(d):
    """Put the feed / fetch plumbing ops that infer_clean_graph_pass
    strips into a saved program (``prune_block`` drops them)."""
    path = os.path.join(d, "__model__.json")
    with open(path) as f:
        payload = json.load(f)
    ops = payload["program"]["blocks"][0]["ops"]
    for i, n in enumerate(payload["feed_names"]):
        ops.insert(i, {"type": "feed", "inputs": {"X": ["feed"]},
                       "outputs": {"Out": [n]}, "attrs": {"col": i}})
    for i, n in enumerate(payload["fetch_names"]):
        ops.append({"type": "fetch", "inputs": {"X": [n]},
                    "outputs": {"Out": ["fetch"]}, "attrs": {"col": i}})
    with open(path, "w") as f:
        json.dump(payload, f)


# pass -> (build function, scope_fn, post-save edit)
CASES = {
    "infer_clean_graph_pass": (_fc_mlp, None, _with_feed_fetch_ops),
    "is_test_pass": (_dropout_mlp, None, None),
    "conv_affine_channel_fuse_pass": (_conv_affine, _affine_scope, None),
    "conv_bn_fuse_pass": (_conv_bn, "bn", None),
    "conv_elementwise_add2_act_fuse_pass": (_conv_eltwise("relu", True),
                                            None, None),
    "conv_elementwise_add_act_fuse_pass": (_conv_eltwise("relu", False),
                                           None, None),
    "conv_elementwise_add_fuse_pass": (_conv_eltwise(None, False), None,
                                       None),
    "embedding_fc_lstm_fuse_pass": (_emb_fc_lstm, None, None),
    "fc_lstm_fuse_pass": (_fc_rnn("lstm"), None, None),
    "fc_gru_fuse_pass": (_fc_rnn("gru"), None, None),
    "seqconv_eltadd_relu_fuse_pass": (_seqconv, _seqconv_scope, None),
    "seqpool_concat_fuse_pass": (_seqpool_concat, None, None),
    "seq_concat_fc_fuse_pass": (_seq_concat_fc, None, None),
    "transpose_flatten_concat_fuse_pass": (_transpose_flatten_concat, None,
                                           None),
    "fc_fuse_pass": (_fc_mlp, None, None),
    # not in ANALYSIS_PASSES: each side's PassBuilder
    "graph_to_program_pass": (_fc_mlp, None, None),
    "graph_viz_pass": (_fc_mlp, None, None),
}
_BUILT = {}


def _bn_values(scope):
    """Every batch norm's statistics and affine terms, and the conv
    bias, away from the startup's 0 / 1."""
    rng = np.random.RandomState(19)
    for name in sorted(n for n, _ in scope.iter_vars()):
        v = np.asarray(scope.find_var(name))
        if v.ndim == 1 and name.startswith(("batch_norm", "conv2d")):
            _set(scope, name, rng.rand(*v.shape) + 0.5)


def _case(name, tmp_path_factory):
    """(directory, feeds, JAX predictor) of pass case ``name``."""
    if name not in _BUILT:
        build, scope_fn, post = CASES[name]
        d = str(tmp_path_factory.mktemp(name))
        feeds = _save(d, build,
                      _bn_values if scope_fn == "bn" else scope_fn)
        if post is not None:
            post(d)
        jp = jinf.PaddlePredictor(jinf.AnalysisConfig(model_dir=d))
        _BUILT[name] = (d, feeds, jp)
    return _BUILT[name]


def _port(d, ir_optim=True):
    cfg = tinf.AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return tinf.PaddlePredictor(cfg)


def _persistables(p):
    block = p._program.desc.global_block
    return sorted(n for n, v in block.vars.items() if v.persistable)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fired(d, name):
    """Whether pass ``name``, applied in ANALYSIS_PASSES' order to the
    port's unrewritten program, changes its to_dict()."""
    p = _port(d, ir_optim=False)
    block = p._program.desc.global_block
    for pname in tinf.PaddlePredictor.ANALYSIS_PASSES:
        before = p._program.desc.to_dict()
        ps = tir_pass.get_pass(pname)
        ps.scope = p._scope
        ps(tir_pass.Graph(block))
        if pname == name:
            return p._program.desc.to_dict() != before
    raise AssertionError(f"{name} is not in ANALYSIS_PASSES")


@pytest.mark.parametrize("name", sorted(CASES))
def test_pass_matches_the_jax_predictor(name, tmp_path_factory, tmp_path):
    d, feeds, jp = _case(name, tmp_path_factory)
    if name in ("graph_to_program_pass", "graph_viz_pass"):
        _check_pipeline_pass(name, d, tmp_path)
        return
    tp = _port(d)
    assert tp._program.desc.to_dict() == jp._program.desc.to_dict()
    names = _persistables(tp)
    assert names == sorted(n for n, v in jp._program.desc.global_block
                           .vars.items() if v.persistable)
    for n in names:
        want = np.asarray(jp._scope.find_var(n))
        got = _host(tp._scope.find_var(n))
        assert got.dtype == want.dtype and np.array_equal(got, want), n
    want = jp.run(feeds)
    got = tp.run(feeds)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    assert _fired(d, name), f"{name} changed nothing"


def _check_pipeline_pass(name, d, tmp_path):
    """graph_to_program_pass leaves the program as it is; graph_viz_pass
    writes the same dot source on both sides (FLAGS_debug_graphviz_path)."""
    jprog, _, _ = jfluid.io.load_inference_model(
        d, jfluid.Executor(jfluid.CPUPlace()), scope=jfluid.Scope())
    tp = _port(d, ir_optim=False)
    before = tp._program.desc.to_dict()
    assert before == jprog.desc.to_dict()
    paths = {}
    for side, irp, fl, prog in (("jax", jir_pass, jflags, jprog),
                                ("port", tir_pass, tflags, tp._program)):
        paths[side] = str(tmp_path / f"{side}.dot")
        fl.set("debug_graphviz_path", paths[side])
        try:
            irp.PassBuilder([name]).apply(prog)
        finally:
            fl.reset("debug_graphviz_path")
    assert tp._program.desc.to_dict() == jprog.desc.to_dict() == before
    if name == "graph_viz_pass":
        with open(paths["jax"]) as f, open(paths["port"]) as g:
            dot = g.read()
            assert dot == f.read() and "digraph" in dot
    else:
        assert not any(os.path.exists(p) for p in paths.values())


# -- the bench programs, ir_optim on and off ----------------------------------

TF = dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32, d_inner=64,
          n_head=2, n_layer=1)
LSTM = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2)


def _bench_build(model, kwargs, feed_names, fetch, feeds):
    def build():
        mod = importlib.import_module(f"paddle_tpu.models.{model}")
        loss, _, _ = mod.build(is_train=False, **kwargs)
        main = jfluid.default_main_program()
        if fetch == "loss":
            target = loss
        else:
            target = [op for op in main.global_block().desc.ops
                      if op.type == fetch][-1].output("Out")[0]
        return feed_names, [target], feeds
    return build


def _bench_cases():
    rng = np.random.RandomState(20)
    src = rng.randint(3, 64, (2, 8, 1)).astype(np.int64)
    return {
        "mnist": ("mnist", {}, ["pixel"], "softmax",
                  {"pixel": rng.standard_normal((4, 1, 28, 28))
                   .astype(np.float32)}),
        "deepfm": ("deepfm", dict(num_fields=4, vocab_size=50), ["feat_ids"],
                   "sigmoid",
                   {"feat_ids": rng.randint(0, 50, (8, 4, 1))
                    .astype(np.int64)}),
        "stacked_dynamic_lstm": (
            "stacked_dynamic_lstm", LSTM, ["words", "seq_lens"], "softmax",
            {"words": rng.randint(0, 50, (4, 8)).astype(np.int64),
             "seq_lens": np.array([8, 3, 1, 6], np.int32)}),
        "transformer": (
            "transformer", dict(TF, fused_attention=True, fused_head=True),
            ["src_ids", "tgt_ids", "lbl_ids"], "loss",
            {"src_ids": src, "tgt_ids": np.concatenate(
                [np.ones((2, 1, 1), np.int64), src[:, :-1]], 1),
             "lbl_ids": src}),
    }


_BENCH_DIRS = {}
_BENCH = {}


def _bench(name, ir_optim, tmp_path_factory):
    """(directory, feeds, JAX predictor at ``ir_optim``) of bench program
    ``name`` (or the conv + bn case)."""
    key = (name, ir_optim)
    if key not in _BENCH:
        jp = None
        if name == "conv_bn":
            d, feeds, jp = _case("conv_bn_fuse_pass", tmp_path_factory)
        else:
            if name not in _BENCH_DIRS:
                d = str(tmp_path_factory.mktemp(name))
                _BENCH_DIRS[name] = (d, _save(d, _bench_build(
                    *_bench_cases()[name])))
            d, feeds = _BENCH_DIRS[name]
        if jp is None or not ir_optim:
            cfg = jinf.AnalysisConfig(model_dir=d)
            cfg.switch_ir_optim(ir_optim)
            jp = jinf.PaddlePredictor(cfg)
        _BENCH[key] = (d, feeds, jp)
    return _BENCH[key]


@pytest.mark.parametrize("ir_optim", [True, False])
@pytest.mark.parametrize("name", ["mnist", "deepfm", "stacked_dynamic_lstm",
                                  "transformer", "conv_bn"])
def test_bench_program_through_the_predictor(name, ir_optim,
                                             tmp_path_factory):
    d, feeds, jp = _bench(name, ir_optim, tmp_path_factory)
    tp = _port(d, ir_optim)
    assert tp._program.desc.to_dict() == jp._program.desc.to_dict()
    assert tp.get_input_names() == jp.get_input_names()
    assert tp.get_output_names() == jp.get_output_names()
    want = jp.run(feeds)
    got = tp.run([feeds[n] for n in tp.get_input_names()])   # a list
    for w, g in zip(want, got):
        assert g.shape == np.shape(w) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    types = {op.type for op in tp._program.desc.global_block.ops}
    if ir_optim and name != "transformer":
        assert "fc" in types or "conv2d_fusion" in types, types
    if not ir_optim:
        assert not types & {"fc", "conv2d_fusion", "fusion_lstm"}


# -- the fused pool on a zero-length row; the refusals; the stale runner ------

@pytest.mark.parametrize("pooltype", ["SUM", "AVERAGE", "SQRT"])
def test_fusion_seqpool_concat_zero_length_row(pooltype):
    """The port routes the fused op through ``sequence_pool``; the JAX
    emitter has its own mask and divides by max(len, 1): a row of length
    0 pools to 0 on both sides, and the rest agree."""
    import jax.numpy as jnp
    xs = [_rand(21, 3, 5, 4), _rand(22, 3, 5, 2)]
    lens = [np.array([0, 5, 2], np.int32)] * 2
    want = np.asarray(jget_op("fusion_seqpool_concat").emit(
        None, {"X": [jnp.asarray(x) for x in xs],
               "SeqLens": [jnp.asarray(n) for n in lens]},
        {"pooltype": pooltype})["Out"][0])
    got = lod_ops.fusion_seqpool_concat(
        [torch.from_numpy(x) for x in xs],
        [torch.from_numpy(n) for n in lens], pooltype).numpy()
    assert np.array_equal(got[0], np.zeros(6, np.float32))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("op_type,attr,match", [
    ("fc", "__amp_bf16__", r"not registered in the port: "
                           r"\['depthwise_conv2d'\]"),
    ("conv2d_fusion", "__nhwc__", r"not registered in the port: "
                                  r"\['depthwise_conv2d'\]"),
    ("fusion_lstm", None, "not registered")])
def test_no_fallback(op_type, attr, match, tmp_path_factory):
    """An op type with no emitter raises before any op runs, whatever
    its tags: an AMP- or NHWC-tagged fused op (both tags are ported, so
    neither is named) turned into ``depthwise_conv2d`` (ROADMAP A6.5),
    and an unknown fused op."""
    case = {"fc": "fc_fuse_pass", "conv2d_fusion":
            "conv_elementwise_add_fuse_pass",
            "fusion_lstm": "fc_lstm_fuse_pass"}[op_type]
    d, feeds, _ = _case(case, tmp_path_factory)
    tp = _port(d)
    op = next(o for o in tp._program.desc.global_block.ops
              if o.type == op_type)
    if attr:
        op.attrs[attr] = True
        op.type = "depthwise_conv2d"
    else:
        op.type = "fusion_lstm_unported"
    tp._program.desc.bump_version()
    with pytest.raises(NotImplementedError, match=match) as err:
        tp.run(feeds)
    assert "AMP" not in str(err.value) and "NHWC" not in str(err.value)


def test_default_place_is_the_card(tmp_path_factory, monkeypatch):
    """A predictor not asked for the CPU never runs there: without a card
    its construction raises."""
    d, _, _ = _case("fc_fuse_pass", tmp_path_factory)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tinf.AnalysisConfig(model_dir=d)
    assert cfg.use_gpu and repr(cfg.place()) == "CUDAPlace(0)"
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.create_paddle_predictor(cfg)


def test_passes_retire_a_cached_runner(tmp_path_factory):
    """The passes rewrite the loaded block in place; bump_version makes
    the executor build a new runner instead of serving the old one."""
    d, feeds, jp = _case("fc_fuse_pass", tmp_path_factory)
    tp = _port(d, ir_optim=False)
    before = tp.run(feeds)
    token = tp._program.desc.version_token
    tp._run_analysis_passes(tp._program)
    assert tp._program.desc.version_token != token
    after = tp.run(feeds)
    assert len(tp._exe._cache) == 2
    runner = tp._exe._cache[next(k for k in tp._exe._cache
                                 if k[0] == tp._program.desc.version_token)]
    assert [runner.block.ops[i].type for i in runner.sig.live_ops] == \
        ["fc", "fc"]
    np.testing.assert_allclose(after[0], before[0], **TOL)
    np.testing.assert_allclose(after[0], jp.run(feeds)[0], **TOL)


def test_flash_attention_hands_the_kernel_contiguous_heads_at_batch_1(
        monkeypatch):
    """ROADMAP C10: at batch 1 the heads of the [1,T,H,D] transpose
    reshaped to [H,T,D] are a strided view, which the card's kernel
    refuses ("the kernel takes contiguous tensors"); the wrapper hands
    it contiguous q, k, v at every batch."""
    from paddle_tpu_torch.ops.attention_block import fused_attention_block
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    seen = []
    real = fa.FlashAttention.apply

    def spy(q, k, v, *args):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, *args)
    monkeypatch.setattr(fa.FlashAttention, "apply", spy)
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(32, 32, generator=g) for _ in range(4)]
    for b in (1, 2):
        x = torch.randn(b, 8, 32, generator=g)
        fused_attention_block(x, x, *ws, n_head=4)
    assert seen == [True, True]
