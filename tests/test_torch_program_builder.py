"""The port's program builder (``paddle_tpu_torch/fluid``: framework,
layers, nets, initializers, ``append_backward``, the optimizers with their
regularizers and clips, the learning-rate schedules and the bench
builders under ``fluid/models``) against the JAX package's.

Every case builds the same program with both packages, each under a fresh
``Program`` pair and a fresh ``unique_name.guard()``, and holds the two
main and the two startup ``ProgramDesc``s equal as JSON values: every op
with its inputs, outputs and attrs, every variable with its shape (as
each package's shape inference wrote it), dtype and flags. Covered: each
builder in several configs, each ported layer at small shapes, each
initializer, each optimizer x {no decay, L1, L2} x {no clip, by value, by
norm, by global norm}, each learning-rate schedule, and the committed
``tests/torch_programs`` training pairs (mnist, the tiny Transformer and
the tiny stacked LSTM) built by the port alone.
"""

import json
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.models import mnist as tmnist
from paddle_tpu_torch.fluid.models import stacked_dynamic_lstm as tlstm
from paddle_tpu_torch.fluid.models import transformer as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = os.path.join(REPO, "tests", "torch_programs")

SIDES = {"jax": (jfluid, junique), "port": (tfluid, tunique)}
MODELS = {"mnist": (jmnist, tmnist),
          "stacked_dynamic_lstm": (jlstm, tlstm),
          "transformer": (jtransformer, ttransformer)}

TINY_LSTM = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16,
                 stacked_num=2)
TINY_TRANSFORMER = dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32,
                        d_inner=64, n_head=2, n_layer=1)


def build(side, fn):
    """(main, startup) as JSON values of ``fn(fluid)`` built with one
    package under a fresh program pair and name generator."""
    fluid, unique = SIDES[side]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique.guard():
        fn(fluid)
    return tuple(json.loads(p.desc.serialize_to_string())
                 for p in (main, startup))


def _diffs(a, b, path=""):
    """The paths where two JSON values differ (the first few)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(f"{path}/{k}: only in "
                           f"{'port' if k in a else 'jax'}")
            else:
                out += _diffs(a[k], b[k], f"{path}/{k}")
        return out[:8]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diffs(x, y, f"{path}[{i}]")][:8]
    return [] if a == b else [f"{path}: port {a!r:.80} jax {b!r:.80}"]


def assert_same_build(fn):
    jmain, jstart = build("jax", fn)
    tmain, tstart = build("port", fn)
    assert tmain == jmain, _diffs(tmain, jmain)
    assert tstart == jstart, _diffs(tstart, jstart)
    return tmain


# -- the builders -------------------------------------------------------------

BUILDS = {
    "mnist": ("mnist", {}),
    "mnist_test": ("mnist", dict(is_train=False)),
    "lstm_tiny": ("stacked_dynamic_lstm", TINY_LSTM),
    "lstm_tiny_one_layer": ("stacked_dynamic_lstm",
                            dict(TINY_LSTM, stacked_num=1, lr=0.01)),
    "transformer_fused_both": ("transformer", dict(
        TINY_TRANSFORMER, dropout=0.0, fused_attention=True,
        fused_head=True)),
    "transformer_fused_noam": ("transformer", dict(
        TINY_TRANSFORMER, fused_attention=True, fused_head=True,
        lr_scheduler="noam", lr=2.0)),
    "transformer_composed": ("transformer", dict(TINY_TRANSFORMER)),
    "transformer_composed_noam_fused_head": ("transformer", dict(
        TINY_TRANSFORMER, fused_head=True, lr_scheduler="noam", lr=1.0)),
    "transformer_fused_attention_test": ("transformer", dict(
        TINY_TRANSFORMER, is_train=False, fused_attention=True)),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_builder_matches_jax(case):
    model, kwargs = BUILDS[case]
    jmod, tmod = MODELS[model]

    def fn(fluid):
        mod = jmod if fluid is jfluid else tmod
        loss, fetches, feeds = mod.build(**kwargs)
        assert loss.name == "mean_0.tmp_0"
        return feeds

    assert_same_build(fn)


@pytest.mark.parametrize("name,model,kwargs", [
    ("mnist_train", "mnist", {}),
    ("transformer_tiny_train", "transformer",
     dict(TINY_TRANSFORMER, dropout=0.0, fused_attention=True,
          fused_head=True)),
    ("stacked_dynamic_lstm_tiny_train", "stacked_dynamic_lstm", TINY_LSTM),
])
def test_builder_matches_committed_pair(name, model, kwargs):
    """The committed training pairs, built by the port alone."""
    tmain, tstart = build("port", lambda f: MODELS[model][1].build(**kwargs))
    for got, fname in ((tmain, "__main__"), (tstart, "__startup__")):
        with open(os.path.join(PROGRAMS, name, fname + ".json")) as fh:
            assert got == json.load(fh), fname


def test_builder_signatures_match_jax():
    import inspect
    for jmod, tmod in MODELS.values():
        assert (inspect.signature(tmod.build)
                == inspect.signature(jmod.build))


# -- the layers ---------------------------------------------------------------

def _x(L, shape=(4, 6), dtype="float32", name="x"):
    return L.data(name=name, shape=list(shape), dtype=dtype)


def _img(L):
    return L.data(name="img", shape=[3, 8, 8], dtype="float32")


def _seq(L):
    x = L.data(name="seq", shape=[5, 8], dtype="float32")
    lens = L.data(name="lens", shape=[], dtype="int32")
    return x, lens


def _attr(fluid, **kw):
    return fluid.ParamAttr(**kw)


LAYERS = {
    "data_no_batch": lambda f, L: L.data(
        name="d", shape=[3, 2], dtype="int64", append_batch_size=False),
    "fc": lambda f, L: L.fc(_x(L), size=5),
    "fc_act_flatten": lambda f, L: L.fc(
        _x(L, (3, 4)), size=5, num_flatten_dims=2, act="relu"),
    "fc_multi_input_no_bias": lambda f, L: L.fc(
        [_x(L), _x(L, name="y")], size=3, bias_attr=False, act="tanh"),
    "fc_named_params": lambda f, L: L.fc(
        _x(L), size=3, param_attr=_attr(f, name="w"),
        bias_attr=_attr(f, name="b", learning_rate=0.5)),
    "embedding": lambda f, L: L.embedding(
        _x(L, (5, 1), "int64"), size=[20, 4]),
    "embedding_sparse_padding": lambda f, L: L.embedding(
        _x(L, (5,), "int64"), size=[20, 4], is_sparse=True, padding_idx=0),
    "conv2d": lambda f, L: L.conv2d(_img(L), 4, 3, act="relu"),
    "conv2d_strided_no_bias": lambda f, L: L.conv2d(
        _img(L), 4, [3, 2], stride=2, padding=1, bias_attr=False),
    "pool2d_max": lambda f, L: L.pool2d(_img(L), 2, "max", 2),
    "pool2d_avg_global": lambda f, L: L.pool2d(
        _img(L), 2, "avg", global_pooling=True),
    "batch_norm": lambda f, L: L.batch_norm(_img(L), act="relu"),
    "layer_norm": lambda f, L: L.layer_norm(_x(L, (3, 4)),
                                            begin_norm_axis=2),
    "layer_norm_no_affine": lambda f, L: L.layer_norm(
        _x(L), scale=False, shift=False),
    "dropout": lambda f, L: L.dropout(_x(L), 0.3),
    "dropout_upscale_test": lambda f, L: L.dropout(
        _x(L), 0.3, is_test=True, dropout_implementation="upscale_in_train"),
    "cross_entropy": lambda f, L: L.cross_entropy(
        L.softmax(_x(L)), _x(L, (1,), "int64", "lbl")),
    "softmax_with_cross_entropy": lambda f, L: L.softmax_with_cross_entropy(
        _x(L), _x(L, (1,), "int64", "lbl"), return_softmax=True),
    "softmax_with_cross_entropy_smoothed":
        lambda f, L: L.softmax_with_cross_entropy(
            _x(L), _x(L, (1,), "int64", "lbl"), label_smoothing=0.1),
    "mean": lambda f, L: L.mean(_x(L)),
    "reduce_sum_all": lambda f, L: L.reduce_sum(_x(L)),
    "reduce_sum_dim_keep": lambda f, L: L.reduce_sum(_x(L, (3, 4)), dim=1,
                                                     keep_dim=True),
    "mul": lambda f, L: L.mul(_x(L, (2, 3)),
                              L.fill_constant([6, 5], "float32", 1.0),
                              x_num_col_dims=1),
    "matmul": lambda f, L: L.matmul(_x(L, (3, 4)), _x(L, (5, 4), name="y"),
                                    transpose_y=True, alpha=0.5),
    "scale": lambda f, L: L.scale(_x(L), scale=2.0, bias=1.0,
                                  bias_after_scale=False, act="sigmoid"),
    "softmax": lambda f, L: L.softmax(_x(L)),
    "topk": lambda f, L: L.topk(_x(L), k=2),
    "clip": lambda f, L: L.clip(_x(L), -1.0, 1.0),
    "reshape": lambda f, L: L.reshape(_x(L, (3, 4)), shape=[0, -1]),
    "reshape_act": lambda f, L: L.reshape(_x(L), shape=[-1, 3, 2],
                                          act="relu"),
    "squeeze": lambda f, L: L.squeeze(_x(L, (1, 4)), axes=[1]),
    "transpose": lambda f, L: L.transpose(_x(L, (3, 4)), perm=[0, 2, 1]),
    "slice": lambda f, L: L.slice(_x(L, (6, 4)), axes=[1, 2],
                                  starts=[1, 0], ends=[4, 2]),
    "accuracy": lambda f, L: L.accuracy(
        L.softmax(_x(L)), _x(L, (1,), "int64", "lbl"), k=2),
    "fused_multi_head_attention": lambda f, L: L.fused_multi_head_attention(
        _x(L, (5, 8)), _x(L, (7, 8), name="kv"), 8, 2, causal=False,
        dropout_prob=0.1),
    "fused_multi_head_attention_named": lambda f, L:
        L.fused_multi_head_attention(_x(L, (5, 8)), _x(L, (5, 8)), 8, 2,
                                     causal=True,
                                     param_attr=_attr(f, name="att")),
    "fused_linear_cross_entropy": lambda f, L: L.fused_linear_cross_entropy(
        _x(L, (8,)), _x(L, (1,), "int64", "lbl"), 11, label_smoothing=0.1),
    "dynamic_lstm": lambda f, L: L.dynamic_lstm(
        L.fc(_seq(L)[0], 16, num_flatten_dims=2), 16,
        seq_lens=L.data(name="lens", shape=[], dtype="int32")),
    "dynamic_lstm_no_peepholes_reverse": lambda f, L: L.dynamic_lstm(
        _x(L, (5, 16)), 16, use_peepholes=False, is_reverse=True),
    "dynamic_gru": lambda f, L: L.dynamic_gru(
        _x(L, (5, 12)), 4,
        seq_lens=L.data(name="lens", shape=[], dtype="int32")),
    "sequence_pool_max": lambda f, L: L.sequence_pool(*(lambda s: (
        s[0], "max", s[1]))(_seq(L))),
    "sequence_pool_sum_first_last": lambda f, L: [
        L.sequence_pool(_seq(L)[0], "sum"),
        L.sequence_first_step(_x(L, (5, 8), name="a")),
        L.sequence_last_step(_x(L, (5, 8), name="b"))],
    "fill_constant_concat_sums": lambda f, L: L.sums([
        L.concat([L.fill_constant([2, 3], "float32", 1.5),
                  L.zeros([2, 3])], axis=1),
        L.ones([2, 6])]),
    "assign_cast_zeros_like": lambda f, L: L.cast(
        L.zeros_like(L.assign(_x(L))), "int32"),
    "unary": lambda f, L: [getattr(L, op)(_x(L)) for op in (
        "sigmoid", "exp", "tanh", "sqrt", "ceil", "floor", "cos",
        "reciprocal", "square", "relu")],
    "binary": lambda f, L: [getattr(L, op)(_x(L), _x(L, (6,), name="y"),
                                           axis=1) for op in (
        "elementwise_add", "elementwise_sub", "elementwise_mul",
        "elementwise_div", "elementwise_max", "elementwise_min",
        "elementwise_pow")],
    "binary_act": lambda f, L: L.elementwise_add(_x(L), _x(L, name="y"),
                                                 act="relu"),
    "less_than_pow": lambda f, L: [
        L.less_than(_x(L), _x(L, name="y")), L.pow(_x(L), factor=3.0)],
    "variable_sugar": lambda f, L: ((_x(L) + 1.0) - _x(L, name="y")) * 2.0
        / _x(L, name="z"),
    "simple_img_conv_pool": lambda f, L: f.nets.simple_img_conv_pool(
        _img(L), 4, 3, 2, 2, act="relu"),
    "img_conv_group": lambda f, L: f.nets.img_conv_group(
        _img(L), [4, 4], 2, conv_act="relu", conv_with_batchnorm=[True, False],
        conv_batchnorm_drop_rate=[0.2, 0.0], pool_stride=2),
    "name_scope": lambda f, L: _in_name_scope(f, L),
}


def _in_name_scope(fluid, L):
    with fluid.name_scope("blk"):
        return L.fc(_x(L), 3)


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    assert_same_build(lambda fluid: LAYERS[case](fluid, fluid.layers))


INITIALIZERS = {
    "constant": lambda I: I.Constant(0.25),
    "uniform": lambda I: I.Uniform(-0.5, 0.5, seed=3),
    "normal": lambda I: I.Normal(0.1, 0.2),
    "truncated_normal": lambda I: I.TruncatedNormal(0.0, 0.3, seed=7),
    "xavier_uniform": lambda I: I.Xavier(),
    "xavier_normal_fans": lambda I: I.Xavier(uniform=False, fan_in=5,
                                             fan_out=7),
    "msra_uniform": lambda I: I.MSRA(),
    "msra_normal": lambda I: I.MSRA(uniform=False),
    "numpy_array": lambda I: I.NumpyArrayInitializer(
        np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0),
}


@pytest.mark.parametrize("case", sorted(INITIALIZERS))
def test_initializer_matches_jax(case):
    def fn(fluid):
        init = INITIALIZERS[case](fluid.initializer)
        fluid.layers.fc(_x(fluid.layers, (3,)), size=4,
                        param_attr=fluid.ParamAttr(initializer=init))

    _, start = build("port", fn)
    assert_same_build(fn)
    assert any(op["type"] in ("uniform_random", "gaussian_random",
                              "truncated_gaussian_random", "fill_constant",
                              "assign_value") for op in
               start["blocks"][0]["ops"])


def test_bilinear_initializer_matches_jax():
    def fn(fluid):
        block = fluid.default_startup_program().global_block()
        v = block.create_var(name="up", shape=[2, 2, 4, 4],
                             dtype="float32", persistable=True)
        fluid.initializer.Bilinear()(v, block)

    assert_same_build(fn)


def test_position_table_is_bit_equal():
    """The Transformer's ``assign_value`` table: the port's
    ``position_encoding`` gives the JAX one's bits."""
    a = jtransformer.position_encoding(128, 512)
    b = ttransformer.position_encoding(128, 512)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


def test_weight_norm_param_attr_is_queued():
    with pytest.raises(NotImplementedError, match="A6.4b"):
        tfluid.WeightNormParamAttr(dim=0)


# -- optimizers x regularizers x clips ----------------------------------------

OPTIMIZERS = {
    "SGD": lambda O, **kw: O.SGD(0.1, **kw),
    "Momentum": lambda O, **kw: O.Momentum(0.1, 0.9, use_nesterov=True,
                                           **kw),
    "LarsMomentum": lambda O, **kw: O.LarsMomentum(0.1, 0.9, **kw),
    "Adam": lambda O, **kw: O.Adam(0.01, lazy_mode=True, **kw),
    "Adamax": lambda O, **kw: O.Adamax(0.01, **kw),
    "Adagrad": lambda O, **kw: O.Adagrad(0.1, **kw),
    "DecayedAdagrad": lambda O, **kw: O.DecayedAdagrad(0.1, **kw),
    "Adadelta": lambda O, **kw: O.Adadelta(0.1, **kw),
    "RMSProp": lambda O, **kw: O.RMSProp(0.1, centered=True, momentum=0.5,
                                         **kw),
    "Ftrl": lambda O, **kw: O.Ftrl(0.1, l1=0.01, l2=0.02, **kw),
}
DECAYS = {"none": lambda R: None, "L1": lambda R: R.L1Decay(1e-3),
          "L2": lambda R: R.L2Decay(1e-4)}
CLIPS = {"none": lambda C: None, "value": lambda C: C.GradientClipByValue(
    0.5), "norm": lambda C: C.GradientClipByNorm(1.0),
    "global_norm": lambda C: C.GradientClipByGlobalNorm(2.0)}


def _tiny_loss(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[6], dtype="float32")
    lbl = L.data(name="lbl", shape=[1], dtype="int64")
    h = L.fc(x, 5, act="relu")
    return L.mean(L.softmax_with_cross_entropy(L.fc(h, 3), lbl))


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(opt, decay, clip):
    def fn(fluid):
        c = CLIPS[clip](fluid.clip)
        fluid.clip.set_gradient_clip(c)
        try:
            loss = _tiny_loss(fluid)
            reg = DECAYS[decay](fluid.regularizer)
            ops, pg = OPTIMIZERS[opt](fluid.optimizer,
                                      regularization=reg).minimize(loss)
            assert len(ops) == len(pg) == 4
        finally:
            fluid.clip.set_gradient_clip(None)

    assert_same_build(fn)


def test_per_parameter_attrs_match_jax():
    """A parameter's own learning rate, regularizer and clip, a frozen
    parameter, ``parameter_list`` and ``ModelAverage.apply_ema``."""
    def fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[6], dtype="float32")
        h = L.fc(x, 5, param_attr=fluid.ParamAttr(
            learning_rate=0.5, regularizer=fluid.regularizer.L1Decay(0.1),
            gradient_clip=fluid.clip.GradientClipByValue(0.3)))
        h = L.fc(h, 4, param_attr=fluid.ParamAttr(trainable=False))
        loss = L.mean(L.fc(h, 2))
        opt = fluid.optimizer.Momentum(0.1, 0.9, regularization=fluid.
                                       regularizer.L2Decay(0.01))
        _, pg = opt.minimize(loss, parameter_list=[
            "fc_0.w_0", "fc_0.b_0", "fc_2.w_0"])
        assert sorted(p.name for p, _ in pg) == ["fc_0.b_0", "fc_0.w_0",
                                                 "fc_2.w_0"]
        fluid.optimizer.ModelAverage(0.15).apply_ema(
            [p for p, _ in pg])

    assert_same_build(fn)


def test_append_backward_pairs_match_jax():
    names = {}

    def fn(fluid):
        loss = _tiny_loss(fluid)
        pg = fluid.backward.append_backward(loss, no_grad_set={"fc_1.b_0"})
        names[fluid is jfluid] = [(p.name, g.name) for p, g in pg]

    assert_same_build(fn)
    assert names[True] == names[False]
    assert ("fc_0.w_0", "fc_0.w_0@GRAD") in names[False]


# -- learning-rate schedules --------------------------------------------------

SCHEDULES = {
    "noam": lambda S: S.noam_decay(32, 4000, learning_rate=2.0),
    "exponential": lambda S: S.exponential_decay(0.1, 10, 0.5),
    "exponential_staircase": lambda S: S.exponential_decay(0.1, 10, 0.5,
                                                           staircase=True),
    "natural_exp": lambda S: S.natural_exp_decay(0.1, 10, 0.5,
                                                 staircase=True),
    "inverse_time": lambda S: S.inverse_time_decay(0.1, 10, 0.5),
    "polynomial": lambda S: S.polynomial_decay(0.1, 100, power=2.0),
    "polynomial_cycle": lambda S: S.polynomial_decay(0.1, 100, cycle=True),
    "piecewise": lambda S: S.piecewise_decay([10, 20], [0.1, 0.05, 0.01]),
    "cosine": lambda S: S.cosine_decay(0.1, 10, 5),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(case):
    def fn(fluid):
        loss = _tiny_loss(fluid)
        rate = SCHEDULES[case](fluid.learning_rate_scheduler)
        fluid.optimizer.SGD(learning_rate=rate).minimize(loss)

    main = assert_same_build(fn)
    assert main["blocks"][0]["vars"]["@lr_decay_counter@"]["persistable"]


def test_append_lars_matches_jax():
    def fn(fluid):
        loss = _tiny_loss(fluid)
        opt = fluid.optimizer.SGD(learning_rate=0.1)
        pg = fluid.backward.append_backward(loss)
        lr = opt._create_lr_var()
        fluid.layers.append_LARS(pg, lr, 0.5)
        opt.apply_gradients(pg)

    assert_same_build(fn)


# -- the framework ------------------------------------------------------------

def test_framework_surface():
    """Defaults and guards, blocks, parameters, clone, loaded descs."""
    main, startup = tfluid.Program(), tfluid.Program()
    assert tfluid.default_main_program() is not main
    with tfluid.program_guard(main, startup), tunique.guard():
        assert tfluid.default_main_program() is main
        assert tfluid.default_startup_program() is startup
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        y = tfluid.layers.fc(x, 2)
        sub = main.create_block()
        assert main.current_block() is sub and sub.var_recursive("x") is x
        main.rollback()
        assert main.current_block() is main.global_block()
    assert [p.name for p in main.all_parameters()] == ["fc_0.w_0",
                                                      "fc_0.b_0"]
    assert y.shape == (-1, 2) and y.dtype == "float32"
    y.stop_gradient = True
    y.persistable = True
    assert y.desc.stop_gradient and y.desc.persistable
    op = main.global_block().ops[0]
    assert op.type == "mul" and op.input("Y") == ["fc_0.w_0"]
    assert op.output("Out") == [y.name.replace("tmp_1", "tmp_0")]
    assert op.attrs["x_num_col_dims"] == 1
    names = {v.name for v in main.list_vars()}
    assert {"x", "fc_0.w_0", "fc_0.b_0"} <= names
    test = main.clone(for_test=True)
    assert test._is_test and test.desc is not main.desc
    assert test.desc.to_dict() == main.desc.to_dict()
    assert [p.name for p in test.all_parameters()] == ["fc_0.w_0",
                                                      "fc_0.b_0"]
    loaded = tfluid.Program(type(main.desc).parse_from_string(
        main.desc.serialize_to_string()))
    assert sorted(p.name for p in loaded.all_parameters()) == [
        "fc_0.b_0", "fc_0.w_0"]
    assert loaded.global_block().var("x").shape == (-1, 3)
    assert tfluid.framework.convert_dtype(np.float16) == "float16"
    old = tfluid.default_main_program()
    tfluid.framework.reset_default_programs()
    assert tfluid.default_main_program() is not old
