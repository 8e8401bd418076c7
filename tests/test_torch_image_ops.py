"""The image classifiers' ops of the PyTorch port
(paddle_tpu_torch/ops/nn_ops.py ``conv2d``, ``pool2d``, ``batch_norm``,
``dropout`` with ``downgrade_in_infer``, the ``axis`` broadcasts of
``elementwise_add`` / ``elementwise_mul``, ``concat``, ``sums``, ``fc``
over a 4-D input; paddle_tpu_torch/optimizer.py ``Momentum`` and
paddle_tpu_torch/regularizer.py) against the JAX emitters
(paddle_tpu/ops/nn_ops.py, basic.py, math_ops.py, optimizer_ops.py) on the
CPU: the same seeded numpy inputs, outputs and gradients (``jax.vjp`` of
the emitter against autograd).

Tolerances, each with its reason:
- fp32 outputs and gradients: rtol 1e-5 / atol 1e-5 of the largest
  magnitude (fp32 sums in another order: a conv's and a batch norm's
  channel sums, the pools' windows);
- the running statistics: rtol 1e-6 / atol 1e-7 (one fp32 mean or
  variance and two products a channel), the bound the controls fail: a
  copy that stores the unbiased variance (off by n / (n - 1) of the batch
  term) and one that weighs the batch by ``momentum`` (PyTorch's
  convention, the weights swapped);
- max pooling and its gradient with ties, ``concat``, ``sums``, the axis
  broadcasts and dropout: bit-equal (no sum in another order: a window's
  gradient goes to its first maximum on both sides);
- bf16 (AMP conv, the low-precision batch norm): within one bf16 step of
  each element's magnitude plus one of the largest (the JAX side may round
  a fused bf16 multiply-add once where torch rounds each product);
- the scale's and bias's gradients of a bf16 batch norm in test mode
  (autodiff through the folded ``x * k + b``, where each side sums 128
  bf16 products over the batch and map and JAX's CPU reduction keeps a
  bf16 accumulator): rtol 5e-2 / atol 3e-2 of the largest;
- the Momentum update: rtol 1e-6 / atol 1e-7 (the same fp32 products).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.ops import nn_ops as tnn

F32 = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-6, atol=1e-7)
BF16_SUM = dict(rtol=5e-2, atol=3e-2)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy, an emitter call and its vjp."""
    jax = pytest.importorskip("jax")
    importlib.import_module("paddle_tpu.ops")       # registers the emitters
    registry = importlib.import_module("paddle_tpu.core.registry")

    def ctx(is_test=False):
        return registry.EmitContext(base_key=jax.random.PRNGKey(0),
                                    is_test=is_test)

    def emit(op_type, ins, attrs, slot, is_test=False):
        return registry.get_op(op_type).emit(ctx(is_test), ins,
                                             attrs)[slot][0]
    return SimpleNamespace(jax=jax, jnp=jax.numpy, ctx=ctx, emit=emit)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=F32, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(),
                                                      1.0), err_msg=label)


def _vjp(jx, fn, args, cot):
    out, back = jx.jax.vjp(fn, *[jx.jnp.asarray(a) for a in args])
    return out, back(jx.jnp.asarray(cot))


def _leaves(*arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


# -- conv2d ------------------------------------------------------------------

CONVS = {   # x shape, filter shape, strides, paddings, dilations, groups
    "plain": ((2, 3, 9, 9), (4, 3, 3, 3), 1, 0, 1, 1),
    "stride_pad": ((2, 3, 11, 10), (5, 3, 7, 7), 2, 3, 1, 1),
    "dilation": ((2, 4, 12, 12), (6, 4, 3, 3), 1, 2, 2, 1),
    # cardinality 4 with 2 channels a group: the JAX op densifies it
    "groups_dense": ((2, 8, 7, 7), (8, 2, 3, 3), 2, 1, 1, 4),
    # 16 channels a group: the JAX op keeps it grouped
    "groups": ((2, 32, 5, 5), (8, 16, 3, 3), 1, 1, 1, 2),
    "asymmetric": ((1, 3, 10, 8), (2, 3, 3, 5), (2, 1), (1, 2), 1, 1),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv2d_matches_the_jax_emitter(jx, case):
    xs, ws, s, p, d, g = CONVS[case]
    x, w = _r(*xs, seed=1), _r(*ws, seed=2)
    pair = (lambda v: list(v) if isinstance(v, tuple) else [v, v])
    attrs = {"strides": pair(s), "paddings": pair(p),
             "dilations": pair(d), "groups": g}
    out = tnn.conv2d(*_leaves(x, w), s, p, d, g)
    cot = _r(*out.shape, seed=3)
    want, (gx, gw) = _vjp(jx, lambda a, b: jx.emit(
        "conv2d", {"Input": [a], "Filter": [b]}, attrs, "Output"),
        (x, w), cot)
    xt, wt = _leaves(x, w)
    out = tnn.conv2d(xt, wt, s, p, d, g)
    out.backward(torch.from_numpy(cot))
    _close(out, want, label="out")
    _close(xt.grad, gx, label="dx")
    _close(wt.grad, gw, label="dw")


@pytest.mark.parametrize("mode", ["pure", "conservative"])
def test_amp_conv2d_matches_the_jax_emitter(jx, mode):
    """Tagged ``conv2d``: bf16 operands and a bf16 conv, the result kept
    bf16 (pure) or widened to fp32 (conservative), as the JAX op."""
    model = SimpleNamespace(op_sites=lambda: ["conv2d"])
    tmp.rewrite_program_amp(model, pure=mode == "pure")
    tags = {"__amp_bf16__": True}
    if mode == "pure":
        tags["__amp_keep_bf16__"] = True
    x, w = _r(2, 8, 9, 9, seed=4), _r(6, 4, 3, 3, seed=5) * 0.2
    attrs = {"strides": [1, 1], "paddings": [1, 1], "groups": 2, **tags}
    xt, wt = _leaves(x, w)
    out = tnn.conv2d(xt, wt, 1, 1, 1, 2, amp=model.amp)
    cot = _r(*out.shape, seed=6)
    want, (gx, gw) = _vjp(jx, lambda a, b: jx.emit(
        "conv2d", {"Input": [a], "Filter": [b]}, attrs, "Output"),
        (x, w), cot.astype(np.float32) if mode == "conservative"
        else cot.astype(jx.jnp.bfloat16))
    out.backward(torch.from_numpy(cot).to(out.dtype))
    assert str(out.dtype).split(".")[-1] == str(want.dtype)
    assert xt.grad.dtype == wt.grad.dtype == torch.float32
    for got, ref, label in ((out, want, "out"), (xt.grad, gx, "dx"),
                            (wt.grad, gw, "dw")):
        _bf16_close(got, ref, label)


def _bf16_close(got, want, label):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100)))
                   - 7)
    top = np.exp2(np.floor(np.log2(np.abs(want).max())) - 7)
    bad = np.abs(got - want) > step + top
    assert not bad.any(), (label, float(np.abs(got - want).max()))


# -- pool2d ------------------------------------------------------------------

POOLS = {   # attrs of the JAX op, the port's arguments
    "max": ({"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]}, (3, "max", 2, 1)),
    "max_2x2": ({"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                 "paddings": [0, 0]}, (2, "max", 2, 0)),
    "avg_exclusive_padded": ({"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [1, 1], "paddings": [1, 1]},
                             (3, "avg", 1, 1)),
    "avg_inclusive_padded": ({"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [2, 2], "paddings": [1, 1],
                              "exclusive": False},
                             (3, "avg", 2, 1, False, False)),
    "avg_5x5_stride_3": ({"pooling_type": "avg", "ksize": [5, 5],
                          "strides": [3, 3], "paddings": [0, 0]},
                         (5, "avg", 3, 0)),
    "global_avg": ({"pooling_type": "avg", "ksize": [1, 1],
                    "global_pooling": True}, (1, "avg", 1, 0, True)),
    "global_max": ({"pooling_type": "max", "ksize": [1, 1],
                    "global_pooling": True}, (1, "max", 1, 0, True)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool2d_matches_the_jax_emitter(jx, case):
    """Forward and gradient; the inputs take 5 values only, so most max
    windows hold ties, whose gradient both sides give to the first
    maximum (bit-equal)."""
    attrs, args = POOLS[case]
    x = np.random.RandomState(7).randint(-2, 3, (2, 3, 11, 11)).astype(
        np.float32)
    (xt,) = _leaves(x)
    out = tnn.pool2d(xt, *args)
    cot = _r(*out.shape, seed=8)
    want, (gx,) = _vjp(jx, lambda a: jx.emit("pool2d", {"X": [a]}, attrs,
                                             "Out"), (x,), cot)
    out.backward(torch.from_numpy(cot))
    if "max" in case:
        np.testing.assert_array_equal(out.detach().numpy(), want)
        np.testing.assert_array_equal(xt.grad.numpy(), gx)
    else:
        _close(out, want, label="out")
        _close(xt.grad, gx, label="dx")


def test_pool2d_floors_and_refuses_wide_padding():
    x = torch.zeros(1, 1, 8, 8)
    assert tnn.pool2d(x, 3, "max", 2).shape[-1] == 3      # (8 - 3) // 2 + 1
    with pytest.raises(ValueError, match="half the window"):
        tnn.pool2d(x, 2, "max", 1, 2)
    with pytest.raises(ValueError, match="pooling type"):
        tnn.pool2d(x, 2, "sum")


# -- batch_norm --------------------------------------------------------------

def _bn_inputs(shape, seed=9):
    c = shape[1]
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean = (rng.randn(c) * 0.1).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)
    return x, scale, bias, mean, var


def _jax_bn(jx, x, scale, bias, mean, var, cot, is_test=False,
            program_test=False):
    """(Y, its vjp's (dx, dscale, dbias), MeanOut, VarianceOut)."""
    def fn(a, s, b):
        return jx.emit("batch_norm", {"X": [a], "Scale": [s], "Bias": [b],
                                      "Mean": [jx.jnp.asarray(mean)],
                                      "Variance": [jx.jnp.asarray(var)]},
                       {"is_test": is_test}, "Y", program_test)
    y, grads = _vjp(jx, fn, (x, scale, bias), cot)
    registry = importlib.import_module("paddle_tpu.core.registry")
    full = registry.get_op("batch_norm").emit(
        jx.ctx(program_test),
        {"X": [jx.jnp.asarray(x)], "Scale": [jx.jnp.asarray(scale)],
         "Bias": [jx.jnp.asarray(bias)], "Mean": [jx.jnp.asarray(mean)],
         "Variance": [jx.jnp.asarray(var)]}, {"is_test": is_test})
    return y, grads, full["MeanOut"][0], full["VarianceOut"][0]


@pytest.mark.parametrize("shape", [(8, 6, 5, 5), (8, 6, 1, 1), (8, 12)],
                         ids=["map", "1x1", "2d"])
def test_batch_norm_train_matches_the_jax_emitter(jx, shape):
    """Train mode: outputs, gradients and the running update (which a
    copy storing the unbiased variance or swapping the momentum's weights
    fails)."""
    x, scale, bias, mean, var = _bn_inputs(shape)
    cot = _r(*shape, seed=10)
    y, (gx, gs, gb), mean_out, var_out = _jax_bn(jx, x, scale, bias, mean,
                                                  var, cot)
    xt, st, bt = _leaves(x, scale, bias)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    out = tnn.batch_norm(xt, st, bt, rm, rv)
    out.backward(torch.from_numpy(cot))
    _close(out, y, label="y")
    for got, want, label in ((xt.grad, gx, "dx"), (st.grad, gs, "dscale"),
                             (bt.grad, gb, "dbias")):
        _close(got, want, label=label)
    _close(rm, mean_out, STATS, "mean")
    _close(rv, var_out, STATS, "variance")
    # the controls: F.batch_norm's own running update, as a port that
    # handed it the buffers would store them, fails the same bound. With
    # momentum 0.9 it weighs the batch by 0.9 (the weights swapped);
    # with 0.1 the weights are the JAX op's, the mean agrees and the
    # variance, unbiased, does not.
    def control(momentum):
        cm, cv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
        F.batch_norm(torch.from_numpy(x), cm, cv, training=True,
                     momentum=momentum)
        return cm, cv
    cm, _ = control(0.9)
    with pytest.raises(AssertionError):
        _close(cm, mean_out, STATS, "swapped mean")
    cm, cv = control(0.1)
    _close(cm, mean_out, STATS, "mean")
    with pytest.raises(AssertionError):
        _close(cv, var_out, STATS, "unbiased variance")


@pytest.mark.parametrize("how", ["op", "program"])
def test_batch_norm_test_mode_matches_the_jax_emitter(jx, how):
    """The op's ``is_test`` or the program's test mode: the running
    statistics normalize x and are not updated."""
    x, scale, bias, mean, var = _bn_inputs((4, 5, 3, 3))
    cot = _r(*x.shape, seed=11)
    y, (gx, gs, gb), mean_out, var_out = _jax_bn(
        jx, x, scale, bias, mean, var, cot, is_test=how == "op",
        program_test=how == "program")
    np.testing.assert_array_equal(mean_out, mean)
    xt, st, bt = _leaves(x, scale, bias)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    out = tnn.batch_norm(xt, st, bt, rm, rv, is_test=True)
    out.backward(torch.from_numpy(cot))
    assert np.array_equal(rm.numpy(), mean) and np.array_equal(rv.numpy(),
                                                               var)
    _close(out, y, label="y")
    for got, want, label in ((xt.grad, gx, "dx"), (st.grad, gs, "dscale"),
                             (bt.grad, gb, "dbias")):
        _close(got, want, label=label)


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_bf16_batch_norm_matches_the_jax_low_precision_path(jx, is_test):
    """A bf16 x: fp32 one-pass statistics, the folded normalize in bf16,
    the hand-written backward (``_bn_train_lowp``), fp32 running update."""
    x, scale, bias, mean, var = _bn_inputs((8, 6, 4, 4), seed=12)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    cot = torch.from_numpy(_r(*x.shape, seed=13)).bfloat16()
    xb = jx.jnp.asarray(x, jx.jnp.bfloat16)

    def fn(a, s, b):
        return jx.emit("batch_norm", {"X": [a], "Scale": [s], "Bias": [b],
                                      "Mean": [jx.jnp.asarray(mean)],
                                      "Variance": [jx.jnp.asarray(var)]},
                       {"is_test": is_test}, "Y")
    y, back = jx.jax.vjp(fn, xb, jx.jnp.asarray(scale),
                         jx.jnp.asarray(bias))
    gx, gs, gb = back(jx.jnp.asarray(cot.float().numpy(), jx.jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    st, bt = _leaves(scale, bias)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    out = tnn.batch_norm(xt, st, bt, rm, rv, is_test=is_test)
    out.backward(cot)
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == torch.float32
    _bf16_close(out, y, "y")
    _bf16_close(xt.grad, gx, "dx")
    for got, want, label in ((st.grad, gs, "dscale"),
                             (bt.grad, gb, "dbias")):
        if is_test:     # autodiff of x * k + b: a bf16 sum of 128 terms
            _close(got, want, BF16_SUM, label)
        else:           # the hand-written backward's fp32 sums
            _bf16_close(got, want, label)
    if not is_test:
        full = importlib.import_module("paddle_tpu.core.registry").get_op(
            "batch_norm").emit(jx.ctx(), {
                "X": [xb], "Scale": [jx.jnp.asarray(scale)],
                "Bias": [jx.jnp.asarray(bias)],
                "Mean": [jx.jnp.asarray(mean)],
                "Variance": [jx.jnp.asarray(var)]}, {})
        _close(rm, full["MeanOut"][0], STATS, "mean")
        _close(rv, full["VarianceOut"][0], STATS, "variance")


# -- dropout, downgrade_in_infer ---------------------------------------------

@pytest.mark.parametrize("p", [0.3, 0.5, 0.7])
def test_downgrade_dropout_matches_the_jax_op(jx, p):
    """Training: ``x * mask`` (no upscale), bit-equal to the JAX op given
    the seed the op draws from its step key, passed in directly; test
    mode (the op's ``is_test`` or the program's): ``x * (1 - p)``."""
    x = _r(4, 6, 5, seed=14)
    attrs = {"dropout_prob": p}
    want = jx.emit("dropout", {"X": [jx.jnp.asarray(x)]}, attrs, "Out")
    seed = int(jx.jax.random.randint(jx.ctx().step_key(), (), 0,
                                     2 ** 31 - 1, dtype=jx.jnp.int32))
    got = tnn.dropout(torch.from_numpy(x), p, seed,
                      implementation="downgrade_in_infer")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = got.numpy() != 0
    assert 0 < kept.mean() < 1
    np.testing.assert_array_equal(got.numpy()[kept], x[kept])
    for op_test, program_test in ((True, False), (False, True)):
        want = jx.emit("dropout", {"X": [jx.jnp.asarray(x)]},
                       {**attrs, "is_test": op_test}, "Out", program_test)
        got = tnn.dropout(torch.from_numpy(x), p, 0, is_test=True,
                          implementation="downgrade_in_infer")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    up = tnn.dropout(torch.from_numpy(x), p, 0, is_test=True)
    np.testing.assert_array_equal(up.numpy(), x)
    with pytest.raises(ValueError, match="implementation"):
        tnn.dropout(torch.from_numpy(x), p, 0, implementation="scale")


# -- the glue ops --------------------------------------------------------------

@pytest.mark.parametrize("op, axis, y_shape", [
    ("elementwise_add", 1, (6,)),             # conv bias
    ("elementwise_mul", 0, (2, 6)),           # SE gate
    ("elementwise_add", -1, (2, 6, 4, 4)),    # residual
    ("elementwise_add", -1, (4,)),            # trailing
    ("elementwise_mul", 1, (6, 4)),
])
def test_elementwise_axis_matches_the_jax_emitter(jx, op, axis, y_shape):
    x, y = _r(2, 6, 4, 4, seed=15), _r(*y_shape, seed=16)
    xt, yt = _leaves(x, y)
    fn = getattr(tnn, op)
    out = fn(xt, yt, axis=axis)
    cot = _r(*out.shape, seed=17)
    want, (gx, gy) = _vjp(jx, lambda a, b: jx.emit(
        op, {"X": [a], "Y": [b]}, {"axis": axis}, "Out"), (x, y), cot)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), gx)
    _close(yt.grad, gy, label="dy")           # summed over the broadcast


def test_concat_and_sums_match_the_jax_emitters(jx):
    xs = [_r(2, c, 3, 3, seed=18 + c) for c in (1, 4, 2)]
    want = jx.emit("concat", {"X": [jx.jnp.asarray(a) for a in xs]},
                   {"axis": 1}, "Out")
    got = tnn.concat([torch.from_numpy(a) for a in xs], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    ys = [_r(3, 2, seed=30 + i) for i in range(3)]
    want = jx.emit("sum", {"X": [jx.jnp.asarray(a) for a in ys]}, {}, "Out")
    got = tnn.sums([torch.from_numpy(a) for a in ys])
    np.testing.assert_array_equal(got.numpy(), want)


def test_fc_flattens_a_map_as_the_jax_mul(jx):
    """``fc`` with ``num_flatten_dims=1`` over [N, C, H, W]: the ``mul``
    op's ``x_num_col_dims`` 1, then the bias at axis 1."""
    x, w, b = _r(3, 4, 2, 2, seed=40), _r(16, 5, seed=41), _r(5, seed=42)
    mul = jx.emit("mul", {"X": [jx.jnp.asarray(x)], "Y": [jx.jnp.asarray(w)]},
                  {"x_num_col_dims": 1, "y_num_col_dims": 1}, "Out")
    want = jx.emit("elementwise_add", {"X": [mul], "Y": [jx.jnp.asarray(b)]},
                   {"axis": 1}, "Out")
    got = tnn.fc(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), num_flatten_dims=1)
    _close(got, want)
    got = tnn.fc(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), act="sigmoid", num_flatten_dims=1)
    _close(got, 1.0 / (1.0 + np.exp(-np.asarray(want))))


# -- Momentum and the regularizers ---------------------------------------------

@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_the_jax_op(nesterov):
    from op_test import run_single_op
    p, g = _r(6, 4, seed=50), _r(6, 4, seed=51)
    v = _r(6, 4, seed=52)
    want = run_single_op(
        "momentum", {"Param": {"p": p}, "Grad": {"g": g},
                     "Velocity": {"v": v},
                     "LearningRate": {"lr": np.array([0.05], np.float32)}},
        {"mu": 0.9, "use_nesterov": nesterov},
        out_slots=("ParamOut", "VelocityOut"))
    pt = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = topt.Momentum([pt], 0.05, 0.9, use_nesterov=nesterov)
    pt.grad = torch.from_numpy(g)
    opt.state[pt]["velocity"] = torch.from_numpy(v.copy())
    opt.step()
    _close(pt, want["__out_ParamOut_0"], STATS, "param")
    _close(opt.state[pt]["velocity"], want["__out_VelocityOut_0"], STATS,
           "velocity")
    q = torch.nn.Parameter(torch.zeros(2))
    opt = topt.Momentum([q], 0.05, 0.9)
    opt.step()                                # no gradient: skipped
    assert not opt.state[q]
    q.grad = torch.sparse_coo_tensor(torch.tensor([[0]]), torch.ones(1),
                                     (2,))
    with pytest.raises(ValueError, match="dense"):
        opt.step()


@pytest.mark.parametrize("decay", ["L2", "L1"])
def test_decay_follows_the_jax_program(decay):
    """An ``fc`` trained 3 steps by Momentum (0.9, lr 0.1) with
    ``regularization=L2Decay(0.01)`` / ``L1Decay(0.01)`` against the JAX
    program: the decay reaches every parameter, the bias too, and the
    fetched gradient is the one before decay."""
    import paddle_tpu.fluid as fluid
    from paddle_tpu.fluid import layers
    rng = np.random.RandomState(53)
    xs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = layers.data(name="x", shape=[3], dtype="float32")
        loss = layers.mean(layers.square(layers.fc(xv, size=2)))
        reg = getattr(fluid.regularizer, f"{decay}Decay")(0.01)
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 regularization=reg).minimize(loss)
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(54)
    for n in names:                           # a live bias
        scope.set_var(n, rng.randn(*np.array(scope.find_var(n)).shape)
                      .astype(np.float32))
    init = {n: np.array(scope.find_var(n)) for n in names}
    grads = []
    for x in xs:
        grads.append(exe.run(main, feed={"x": x}, fetch_list=[
            n + "@GRAD" for n in names], scope=scope))
    w = torch.nn.Parameter(torch.from_numpy(init[names[0]]))
    b = torch.nn.Parameter(torch.from_numpy(init[names[1]]))
    opt = topt.Momentum([w, b], 0.1, 0.9, regularization=getattr(
        treg, f"{decay}Decay")(0.01))
    for x, want in zip(xs, grads):
        opt.zero_grad()
        out = tnn.fc(torch.from_numpy(x), w, b)
        tnn.mean(torch.square(out)).backward()
        _close(w.grad, want[0], F32, "w grad")
        _close(b.grad, want[1], F32, "b grad")
        opt.step()
    _close(w, np.array(scope.find_var(names[0])), F32, "w")
    _close(b, np.array(scope.find_var(names[1])), F32, "b")
