"""The port's AMP programs (``paddle_tpu_torch/contrib/mixed_precision.py``
over a ``fluid.Program``, the emitters' AMP branches, ``decorate`` over a
``fluid`` optimizer, ``contrib/float16.py``) against the JAX package's, on
the CPU at small widths.

- The rewrite: every bench builder of the port (mnist, smallnet, alexnet,
  vgg, resnet, se_resnext, googlenet, the Transformer, the stacked LSTM,
  deepfm, machine translation) built by both packages under a fresh
  ``Program`` pair and ``unique_name.guard()``; ``rewrite_program_amp``
  pure, conservative and auto after ``minimize`` on a copy of the built
  desc, and auto before ``minimize`` (inside the builder, so that shape
  inference writes the backward's var dtypes through the tagged
  emitters): the main and startup descs equal as JSON values, the counts
  equal.
- The emitters: each AMP branch of the port (``conv2d``, ``batch_norm`` on
  a bf16 input, ``lookup_table``, ``fused_linear_ce``,
  ``fused_attention_block``, ``mul``, ``matmul``, ``fc``, the elementwise
  binaries, ``conv2d_fusion``) called through ``get_op(...).emit`` with
  the tags as attributes, against the JAX emitter on the same seeded
  inputs: the output, its dtype, and for the products the gradients.
- Programs through the executors: mnist, smallnet and a shallow ResNet
  (the ResNet builder's ``conv_bn_layer`` and ``bottleneck_block``) under
  pure AMP, the tiny Transformer under pure AMP (the JAX fused block on
  its flash branch with the Pallas kernel in interpret mode, the fused
  head on its Pallas kernel: ``PADDLE_TPU_FORCE_PALLAS=1``), the stacked
  LSTM under auto AMP (conservative), each from the JAX startup scope:
  the loss curve, every fetched dtype, the parameters after the steps.
- ``decorate`` over ``fluid.optimizer.SGD`` with dynamic scaling and a
  run of overflowed steps; ``BF16Transpiler`` / ``Float16Transpiler``
  over the predictor of a saved program.

Tolerances, each with its reason:
- ``F32_TOL`` rtol 1e-5 / atol 1e-6: fp32 results of bf16 operands (the
  products exact in fp32 on both sides, their sums in another order), and
  the decorated fp32 curve.
- bf16 results: within one bf16 step (``test_torch_amp._close``), the
  same fp32 value rounded on each side; two for a gradient that crosses
  a bf16 edge and is summed in bf16 on the JAX side and in fp32 here.
- pure AMP image programs: the curve rtol 2e-2, the parameters' moves
  0.15 relative L2 over all of them:
  the bf16 activations round at other points on each side (XLA's CPU
  runtime fuses bf16 elementwise ops and rounds once, its bf16 softmax
  rounds op by op, its bf16 average pools sum in bf16 where PyTorch sums
  in fp32), ~2**-8 of an activation, and at these widths the fp32 port
  lies as far from the JAX AMP run (``tests/test_torch_image_train.py``'s
  ``AMP_TOL``). The emitter tests above hold the bf16 numerics op by op.
  So step 1 is also held where no drift has come in yet
  (:func:`step1_gaps`: the ops whose inputs hold the same bits on both
  sides), in relative L2: the AMP products' outputs within
  ``FIRST_PRODUCT_RTOL`` 1e-4 (both round the same fp32 inputs to bf16
  and sum exact products in fp32; read: at most 2e-6 on the three
  programs), batch norm's ``SavedVariance`` within ``BN_VAR_RTOL`` 5e-4
  (read: 1.8e-4 on the shallow ResNet; with the statistics rounded to
  bf16, a mutation tried outside the repo, 1.6e-3). The control: the
  untagged fp32 program against the same JAX AMP run, whose first
  products lie 2.8e-3 to 2.9e-3 away, must fail the product bound (its
  curve and moves pass the loose bounds: 1.8e-3 and 0.065 at most).
- the pure Transformer: the first loss rtol 2e-4, the curve 1e-3
  (``tests/test_torch_amp.py``'s ``T_FIRST_RTOL`` / ``T_CURVE_RTOL``).
- the conservative LSTM: rtol 1e-4 / atol 1e-5, the JAX package's curve
  bound: past the bf16 products everything is fp32 on both sides.
- the transpiled predictor: the bf16 fetches against the JAX transpiled
  program's at 2 bf16 steps of the largest magnitude, fp16's at rtol
  2e-3.
"""

import contextlib
import dataclasses
import fcntl
import functools
import importlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import ir as jir
from paddle_tpu.fluid import unique_name as junique

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.registry import EmitContext as TCtx
from paddle_tpu_torch.core.registry import get_op as tget_op
from paddle_tpu_torch.fluid import unique_name as tunique

from test_torch_amp import (  # noqa: F401  (jx: a fixture)
    FORCE_PALLAS, _close, _jax_flash_routed, _r, jx)
from test_torch_program_builder import _diffs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-6)
AMP_CURVE_RTOL, AMP_MOVE_TOL = 2e-2, 0.15
FIRST_PRODUCT_RTOL, BN_VAR_RTOL = 1e-4, 5e-4
T_FIRST_RTOL, T_CURVE_RTOL = 2e-4, 1e-3
L_CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
SIDES = {"jax": (jfluid, junique), "port": (tfluid, tunique)}

TINY_T = dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32,
              d_inner=64, n_head=4, n_layer=1)
TINY_L = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2)
# the bench builders at small widths: module, kwargs
BUILDERS = {
    "mnist": ("mnist", {}),
    "smallnet": ("smallnet", {}),
    "alexnet": ("alexnet", dict(image_size=64, class_dim=10)),
    "vgg": ("vgg", dict(image_size=32, class_dim=10)),
    "resnet": ("resnet", dict(image_size=32, class_dim=10)),
    "se_resnext": ("se_resnext", dict(image_size=32, class_dim=10)),
    "googlenet": ("googlenet", dict(image_size=96, class_dim=10)),
    "transformer": ("transformer", dict(TINY_T, fused_attention=True,
                                        fused_head=True)),
    "stacked_dynamic_lstm": ("stacked_dynamic_lstm", TINY_L),
    "deepfm": ("deepfm", dict(num_fields=4, vocab_size=64, embed_dim=8)),
    "machine_translation": ("machine_translation", {}),
}
MODES = {"pure": True, "conservative": False, "auto": None}


# -- builds -------------------------------------------------------------------

def models(side, name):
    pkg = "paddle_tpu" if side == "jax" else "paddle_tpu_torch.fluid"
    return importlib.import_module(f"{pkg}.models.{name}")


def contrib(side, name):
    pkg = "paddle_tpu" if side == "jax" else "paddle_tpu_torch"
    return importlib.import_module(f"{pkg}.contrib.{name}")


@contextlib.contextmanager
def before_minimize(side, rewrite):
    """``rewrite(side)`` on the default main program as the first thing
    every ``Optimizer.minimize`` of ``side`` does, for the duration."""
    cls = importlib.import_module(
        "paddle_tpu.fluid.optimizer" if side == "jax"
        else "paddle_tpu_torch.fluid.optimizer").Optimizer
    real = cls.minimize

    def minimize(self, *a, **kw):
        rewrite(side)
        return real(self, *a, **kw)
    cls.minimize = minimize
    try:
        yield
    finally:
        cls.minimize = real


def build(side, fn, rewrite=None):
    """(main, startup, what ``fn(fluid)`` returned) under a fresh program
    pair and name generator, ``rewrite`` applied before ``minimize``."""
    fluid, unique = SIDES[side]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique.guard(), (
            before_minimize(side, rewrite) if rewrite
            else contextlib.nullcontext()):
        out = fn(fluid)
    return main, startup, out


def builder(name):
    """``fn(fluid)`` building bench builder ``name``; returns the loss."""
    module, kw = BUILDERS[name]

    def fn(fluid):
        side = "jax" if fluid is jfluid else "port"
        return models(side, module).build(**kw)[0]
    return fn


def as_json(program):
    return json.loads(program.desc.serialize_to_string())


SHARED = {}


@pytest.fixture(autouse=True, scope="session")
def shared_builds(tmp_path_factory):
    """Under xdist, :func:`built` keeps its descs in the parent of the
    workers' base temps, which every worker of the session shares."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        SHARED["dir"] = tmp_path_factory.getbasetemp().parent


@functools.lru_cache(maxsize=None)
def built(side, name, before=None):
    """The JSON main and startup descs of builder ``name``, ``before`` a
    rewrite spec applied ahead of ``minimize`` (``"amp"``, ``"nhwc"`` or
    ``"amp+nhwc"``), and what each rewrite returned; once a process, and
    under xdist once a session: one worker builds under a file lock, the
    others read its file."""
    if "dir" not in SHARED:
        return build_json(side, name, before)
    path = SHARED["dir"] / f"built-{side}-{name}-{before}.json"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_text(json.dumps(build_json(side, name, before)))
        return tuple(json.loads(path.read_text()))


def build_json(side, name, before):
    """:func:`built`'s build."""
    counts = []

    def rewrite(side):
        if "amp" in before:
            counts.append(contrib(side, "mixed_precision")
                          .rewrite_program_amp(None))
        if "nhwc" in before:
            counts.append(contrib(side, "layout").rewrite_program_nhwc(None))
    main, startup, _ = build(side, builder(name), rewrite if before else None)
    return json.dumps(as_json(main)), json.dumps(as_json(startup)), counts


def rewritten(side, name, fn):
    """``fn(side, program)`` on a copy of builder ``name``'s main desc ->
    (its JSON after, what ``fn`` returned)."""
    ir = jir if side == "jax" else tir
    desc = ir.ProgramDesc.parse_from_string(built(side, name)[0].encode())
    out = fn(side, types.SimpleNamespace(desc=desc))
    return json.loads(desc.serialize_to_string()), out


# -- the rewrite --------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rewrite_after_minimize_matches_jax(name, mode):
    """The tags on the forward ops and in the ``__vjp__`` snapshots."""
    def fn(side, prog):
        return contrib(side, "mixed_precision").rewrite_program_amp(
            prog, pure=MODES[mode])
    (want, n_jax), (got, n) = (rewritten(s, name, fn)
                               for s in ("jax", "port"))
    assert got == want, _diffs(got, want)
    assert n == n_jax and n > 0


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rewrite_before_minimize_matches_jax(name):
    """Auto AMP before ``minimize``: the backward, the optimizer and every
    var's dtype as each package's shape inference wrote them through the
    tagged emitters, and the startup program."""
    jmain, jstart, jn = built("jax", name, "amp")
    tmain, tstart, tn = built("port", name, "amp")
    assert json.loads(tmain) == json.loads(jmain), _diffs(
        json.loads(tmain), json.loads(jmain))
    assert tstart == jstart or json.loads(tstart) == json.loads(jstart)
    assert tn == jn


def test_auto_chooses_conservative_only_with_a_recurrent_op():
    for name, pure in (("transformer", True), ("resnet", True),
                       ("stacked_dynamic_lstm", False),
                       ("machine_translation", False)):
        got, _ = rewritten("port", name, lambda side, p:
                           tmp.rewrite_program_amp(p))
        keep = [op["attrs"].get("__amp_keep_bf16__", False)
                for op in got["blocks"][0]["ops"]
                if op["attrs"].get("__amp_bf16__")]
        assert keep and all(k == pure for k in keep), name


def test_rewrite_of_the_default_program_bumps_its_version():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tunique.guard():
        builder("mnist")(tfluid)
        v = main.desc.version_token
        n = tmp.rewrite_program_amp()
    assert n == 6 and main.desc.version_token != v   # 3 ops, 3 snapshots


def test_module_branch_is_kept():
    class Sites:
        def op_sites(self):
            return ["conv2d", "elementwise_add", "lookup_table"]
    m = Sites()
    assert tmp.rewrite_program_amp(m) == 2
    assert m.amp["conv2d"] == tmp.AmpPolicy(bf16=True, keep_bf16=True)
    assert m.amp["elementwise_add"].match_dtype


# -- the emitters -------------------------------------------------------------

TAGS = {"pure": {"__amp_bf16__": True, "__amp_keep_bf16__": True},
        "conservative": {"__amp_bf16__": True}}


def _emit(jx, op_type, ins, attrs, slot, grad_of=(), cot_seed=9,
          is_test=False):
    """(JAX output, port output, [(JAX grad, port grad)] of the inputs
    named in ``grad_of``) of one op on numpy ``ins`` {slot: [arrays]}."""
    jins = {k: [jx.jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    tins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    leaves = []
    for k in grad_of:
        tins[k] = [tins[k][0].float().requires_grad_(True)]
        leaves.append(tins[k][0])
    jctx = dataclasses.replace(jx.ctx(), is_test=is_test)
    tout = tget_op(op_type).emit(TCtx(is_test=is_test), tins, attrs)[slot][0]

    def f(*diff):
        d = dict(jins)
        for k, v in zip(grad_of, diff):
            d[k] = [v]
        return jx.get_op(op_type).emit(jctx, d, attrs)[slot][0]
    if not grad_of:
        return f(), tout, []
    jout, vjp = jx.jax.vjp(f, *(jins[k][0] for k in grad_of))
    cot = _r(*jout.shape, seed=cot_seed)
    jgrads = vjp(jx.jnp.asarray(cot).astype(jout.dtype))
    tgrads = torch.autograd.grad(tout, leaves,
                                 torch.from_numpy(cot).to(tout.dtype))
    return jout, tout, list(zip(jgrads, tgrads))


@pytest.mark.parametrize("mode", sorted(TAGS))
def test_conv2d_emitter(jx, mode):
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)]}
    attrs = dict(TAGS[mode], strides=[1, 1], paddings=[1, 1])
    jout, tout, grads = _emit(jx, "conv2d", ins, attrs, "Output",
                              ("Input", "Filter"))
    _close(tout, jout, "bf16", "out")
    for (jg, tg), name in zip(grads, ("dx", "dw")):
        _close(tg, jg, "bf16_max", name, steps=2)


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_emitter_on_a_bf16_input(jx, is_test):
    """A pure conv's bf16 output: fp32 statistics, the folded normalize in
    bf16, the running statistics fp32."""
    c = 4
    ins = {"X": [_r(3, c, 5, 5, seed=3)], "Scale": [_r(c, seed=4) + 1.0],
           "Bias": [_r(c, seed=5)], "Mean": [_r(c, seed=6)],
           "Variance": [np.abs(_r(c, seed=7)) + 0.5]}
    ins["X"] = [torch.from_numpy(ins["X"][0]).bfloat16()]
    jins = {k: [jx.jnp.asarray(v.float().numpy() if isinstance(
        v, torch.Tensor) else v) for v in vs] for k, vs in ins.items()}
    jins["X"] = [jins["X"][0].astype(jx.jnp.bfloat16)]
    jctx = dataclasses.replace(jx.ctx(), is_test=is_test)
    want = jx.get_op("batch_norm").emit(jctx, jins, {})
    got = tget_op("batch_norm").emit(
        TCtx(is_test=is_test),
        {k: [v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
             for v in vs] for k, vs in ins.items()}, {})
    _close(got["Y"][0], want["Y"][0], "bf16", "Y")
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        _close(got[slot][0], want[slot][0], "f32", slot)


@pytest.mark.parametrize("mode", ["pure", "conservative"])
def test_lookup_table_emitter(jx, mode):
    attrs = {"__amp_keep_bf16__": True} if mode == "pure" else {}
    ins = {"W": [_r(10, 4, seed=1)],
           "Ids": [np.array([[1], [3], [0], [3]], np.int64)]}
    jout, tout, _ = _emit(jx, "lookup_table", ins, attrs, "Out")
    _close(tout, jout, "equal", "out")


@pytest.mark.parametrize("mode", sorted(TAGS))
@pytest.mark.parametrize("op_type", ["mul", "matmul"])
def test_product_emitters(jx, op_type, mode):
    if op_type == "mul":
        ins = {"X": [_r(2, 3, 4, seed=1)], "Y": [_r(12, 5, seed=2)]}
        attrs = dict(TAGS[mode], x_num_col_dims=1)
    else:
        ins = {"X": [_r(2, 3, 4, seed=1)], "Y": [_r(2, 5, 4, seed=2)]}
        attrs = dict(TAGS[mode], transpose_Y=True, alpha=0.5)
    jout, tout, grads = _emit(jx, op_type, ins, attrs, "Out", ("X", "Y"))
    _close(tout, jout, "bf16" if mode == "pure" else "f32", "out")
    for (jg, tg), name in zip(grads, ("dx", "dy")):
        _close(tg, jg, "bf16_max", name)


@pytest.mark.parametrize("mode", sorted(TAGS))
def test_fc_emitter(jx, mode):
    ins = {"Input": [_r(2, 3, 4, seed=1)], "W": [_r(4, 5, seed=2)],
           "Bias": [_r(5, seed=3)]}
    attrs = dict(TAGS[mode], in_num_col_dims=2, activation_type="relu")
    jout, tout, grads = _emit(jx, "fc", ins, attrs, "Out", ("Input", "W"))
    _close(tout, jout, "bf16" if mode == "pure" else "f32", "out")
    for (jg, tg), name in zip(grads, ("dx", "dw")):
        _close(tg, jg, "bf16_max", name, steps=2)


@pytest.mark.parametrize("tagged", [True, False])
@pytest.mark.parametrize("op_type", ["elementwise_add", "elementwise_sub",
                                     "elementwise_mul", "elementwise_div",
                                     "elementwise_max", "elementwise_min"])
def test_elementwise_emitters_match_dtype(jx, op_type, tagged):
    """bf16 X, fp32 [C] Y at axis 1: cast down under the tag, promoted
    without it."""
    x = torch.from_numpy(_r(2, 3, 4, seed=1)).bfloat16()
    y = np.abs(_r(3, seed=2)) + 0.5
    attrs = {"axis": 1, **({"__amp_match_dtype__": True} if tagged else {})}
    want = jx.get_op(op_type).emit(jx.ctx(), {
        "X": [jx.jnp.asarray(x.float().numpy()).astype(jx.jnp.bfloat16)],
        "Y": [jx.jnp.asarray(y)]}, attrs)["Out"][0]
    got = tget_op(op_type).emit(TCtx(), {"X": [x],
                                         "Y": [torch.from_numpy(y)]},
                                attrs)["Out"][0]
    assert got.dtype == (torch.bfloat16 if tagged else torch.float32)
    _close(got, want, "bf16" if tagged else "f32", op_type)


@pytest.mark.parametrize("mode", sorted(TAGS))
def test_conv2d_fusion_emitter(jx, mode):
    """The op's tags reach its conv; bias and residual follow its dtype."""
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)],
           "Bias": [_r(4, seed=3)], "ResidualData": [_r(2, 4, 6, 6, seed=4)]}
    attrs = dict(TAGS[mode], strides=[1, 1], paddings=[1, 1],
                 activation="relu")
    jout, tout, _ = _emit(jx, "conv2d_fusion", ins, attrs, "Output")
    _close(tout, jout, "bf16", "out")


@pytest.mark.parametrize("mode", sorted(TAGS))
def test_fused_linear_ce_emitter(jx, monkeypatch, mode):
    """The JAX op on its Pallas kernel in interpret mode (the port's
    function computes the kernel's function): bf16 x and W, fp32 loss."""
    monkeypatch.setenv(FORCE_PALLAS, "1")
    ins = {"X": [_r(16, 8, seed=1)], "W": [_r(8, 24, seed=2)],
           "Label": [np.random.RandomState(3).randint(0, 24, (16, 1))]}
    attrs = dict(TAGS[mode], label_smoothing=0.1)
    jout, tout, grads = _emit(jx, "fused_linear_ce", ins, attrs, "Loss",
                              ("X", "W"))
    _close(tout, jout, "f32", "loss")
    for (jg, tg), name in zip(grads, ("dx", "dw")):
        _close(tg, jg, "bf16_max", name, steps=2)


@pytest.mark.parametrize("mode", sorted(TAGS))
def test_fused_attention_block_emitter(jx, mode):
    """The JAX op's flash branch (the Pallas kernel in interpret mode):
    the projections, flash and Wo in bf16; fp32 at the edge when
    conservative. Each element within a bf16 step of the largest."""
    m, t = 16, 8
    ins = {"Xq": [_r(2, t, m, seed=1)], "Xkv": [_r(2, t, m, seed=2)]}
    for i, n in enumerate(("Wq", "Wk", "Wv", "Wo")):
        ins[n] = [_r(m, m, seed=3 + i, scale=0.3)]
    attrs = dict(TAGS[mode], n_head=2, causal=True, dropout_prob=0.0)
    with _jax_flash_routed() as calls:
        jout, tout, grads = _emit(jx, "fused_attention_block", ins, attrs,
                                  "Out", ("Xq",))
    assert calls
    _close(tout, jout, "bf16_max", "out")
    _close(grads[0][1], grads[0][0], "bf16_max", "dxq", steps=2)


# -- programs through the executors -------------------------------------------

B = 4


def _img(c, h, classes=10, image="data"):
    def feeds(r):
        return {image: r.randn(B, c, h, h).astype(np.float32),
                "label": r.randint(0, classes, (B, 1)).astype(np.int64)}
    return feeds


def shallow_resnet(fluid):
    """The ResNet builder's stem and one bottleneck block (the shortcut a
    conv, 8 -> 16 channels) at 16 px."""
    side = "jax" if fluid is jfluid else "port"
    R, L = models(side, "resnet"), fluid.layers
    img = L.data(name="data", shape=[3, 16, 16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    c = R.conv_bn_layer(img, 8, 3, act="relu")
    c = L.pool2d(c, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    c = R.bottleneck_block(c, 4, stride=1, is_train=True)
    p = L.pool2d(c, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(p, size=10), label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def se_block(fluid):
    """The SE-ResNeXt builder's bottleneck block (grouped conv, the
    squeeze-excitation gate [B, C] at axis 0) over a conv stem at 16 px."""
    side = "jax" if fluid is jfluid else "port"
    S, L = models(side, "se_resnext"), fluid.layers
    img = L.data(name="data", shape=[3, 16, 16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    c = S.conv_bn_layer(img, 8, 3, act="relu")
    c = S.bottleneck_block(c, 8, stride=1, cardinality=4, reduction_ratio=4,
                           is_train=True)
    p = L.pool2d(c, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(p, size=10), label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def inception_block(fluid):
    """The GoogLeNet builder's inception module (four branches concatenated
    on channels) over its conv stem at 16 px."""
    side = "jax" if fluid is jfluid else "port"
    G, L = models(side, "googlenet"), fluid.layers
    img = L.data(name="data", shape=[3, 16, 16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    x = G._conv(img, 8, 3, padding=1)
    x = G.inception(x, 4, 4, 8, 2, 4, 4)
    p = L.pool2d(x, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(p, size=10), label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


PROGRAMS = {
    "mnist": (builder("mnist"), 2, _img(1, 28, image="pixel")),
    "smallnet": (builder("smallnet"), 2, _img(3, 32)),
    "shallow_resnet": (shallow_resnet, 2, _img(3, 16)),
    "se_block": (se_block, 2, _img(3, 16)),
    "inception_block": (inception_block, 2, _img(3, 16)),
}
AMP_PROGRAMS = ("mnist", "smallnet", "shallow_resnet")


def rewrite_with(spec, pure=None):
    """A ``rewrite(side, main)`` applying ``spec`` ("amp", "nhwc",
    "amp+nhwc") after the build, as ``bench.py:291-296`` does."""
    def rewrite(side, main):
        if "amp" in spec:
            contrib(side, "mixed_precision").rewrite_program_amp(main,
                                                                 pure=pure)
        if "nhwc" in spec:
            contrib(side, "layout").rewrite_program_nhwc(main)
    return rewrite


def persistables(main):
    return sorted(n for n, v in main.desc.global_block.vars.items()
                  if v.persistable)


def forward_vars(main):
    """The float outputs of the forward ops (before the first __vjp__)."""
    out = []
    for op in main.desc.global_block.ops:
        if op.type == "__vjp__":
            break
        out += [n for names in op.outputs.values() for n in names
                if main.desc.global_block.var(n).dtype.startswith("float")]
    return out


def forward_ops(main, fwd):
    """(op type, input names, {output slot: fetched output names}) of the
    forward ops, ``fwd`` the fetched vars."""
    out = []
    for op in main.desc.global_block.ops:
        if op.type == "__vjp__":
            break
        out.append((op.type, [n for names in op.inputs.values()
                              for n in names],
                    {slot: [n for n in names if n in fwd]
                     for slot, names in op.outputs.items()}))
    return out


@functools.lru_cache(maxsize=None)
def jax_run(name, spec, jax_ctx=None):
    """The JAX run of program ``name`` rewritten by ``spec``: the scope
    before the steps, the feeds, the losses, the forward vars' dtypes and
    values (fp32) of step 1, the forward ops and the persistables after
    the steps; once a process. Every step fetches the same vars from a
    state put back as host arrays, so the step compiles once (the JAX
    executor's outputs would key a second compile)."""
    fn, steps, feeds_of = PROGRAMS[name]
    main, startup, loss = build("jax", fn)
    rewrite_with(spec)("jax", main)
    rng = np.random.RandomState(sorted(PROGRAMS).index(name))
    feeds = [feeds_of(rng) for _ in range(steps)]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = persistables(main)
    start = {n: np.array(scope.find_var(n)) for n in names}
    fwd = forward_vars(main)
    losses, dtypes, values = [], None, None
    with (jax_ctx() if jax_ctx else contextlib.nullcontext()):
        for i, f in enumerate(feeds):
            for n in names:
                scope.set_var(n, np.array(scope.find_var(n)))
            out = exe.run(main, feed=f, scope=scope,
                          fetch_list=[loss.name] + fwd)
            losses.append(float(np.asarray(out[0])))
            if i == 0:
                dtypes = [str(np.asarray(o).dtype) for o in out[1:]]
                values = {n: np.asarray(o).astype(np.float32)
                          for n, o in zip(fwd, out[1:])}
    after = {n: np.array(scope.find_var(n)).astype(np.float32)
             for n in names}
    return dict(start=start, feeds=feeds, losses=np.asarray(losses),
                dtypes=dtypes, fwd=fwd, values=values,
                ops=forward_ops(main, set(fwd)), after=after,
                loss=loss.name)


def port_run(name, spec, ref):
    """The port's run of program ``name`` rewritten by ``spec`` from the
    JAX run ``ref``'s scope and feeds: the losses, the forward vars'
    dtypes of step 1, the persistables after the steps and the forward
    vars' values (fp32) of step 1."""
    fn = PROGRAMS[name][0]
    main, _, loss = build("port", fn)
    rewrite_with(spec)("port", main)
    assert loss.name == ref["loss"] and forward_vars(main) == ref["fwd"]
    scope = tfluid.Scope()
    for n, a in ref["start"].items():
        scope.set_var(n, torch.from_numpy(a.copy()))
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses, dtypes, values = [], None, None
    for i, f in enumerate(ref["feeds"]):
        out = exe.run(main, feed=f, scope=scope, return_numpy=False,
                      fetch_list=[loss] + ref["fwd"])
        # an NHWC-resident fetch leaves channels-last storage
        assert all(o.is_contiguous() for o in out)
        losses.append(float(out[0]))
        if i == 0:
            dtypes = [str(o.dtype).replace("torch.", "") for o in out[1:]]
            values = {n: o.float().numpy()
                      for n, o in zip(ref["fwd"], out[1:])}
    after = {n: scope.find_var(n).float().numpy() for n in ref["after"]}
    return np.asarray(losses), dtypes, after, values


def step1_gaps(ref, values):
    """{(op type, output slot, var): relative L2 gap to the JAX run} at
    step 1, for the outputs of the forward ops whose inputs hold the same
    bits on both sides (the feeds, the carried parameters, and outputs
    that came out bit-equal): each gap is the op's own, with no drift
    from the ops before it."""
    same = set(ref["feeds"][0]) | set(ref["start"])
    gaps = {}
    for op_type, ins, outs in ref["ops"]:
        if not all(n in same for n in ins):
            continue
        for slot, names in outs.items():
            for n in names:
                got, want = values[n], ref["values"][n]
                if np.array_equal(got, want):
                    same.add(n)
                gaps[(op_type, slot, n)] = float(
                    np.linalg.norm(got - want)
                    / max(np.linalg.norm(want), 1e-30))
    return gaps


def moves_rel_l2(ref, after, params):
    """||port moves - JAX moves|| / ||JAX moves|| over ``params``."""
    d = np.concatenate([(after[n] - ref["after"][n]).ravel() for n in params])
    m = np.concatenate([(ref["after"][n] - ref["start"][n].astype(
        np.float32)).ravel() for n in params])
    return float(np.linalg.norm(d) / np.linalg.norm(m))


def trainable(main_names):
    return [n for n in main_names if n.endswith((".w_0", ".b_0"))
            and "@" not in n]


def first_products(gaps):
    """The gaps of the AMP products among :func:`step1_gaps`."""
    return {k: g for k, g in gaps.items() if k[0] in tmp.AMP_OP_TYPES}


@pytest.mark.parametrize("name", AMP_PROGRAMS)
def test_pure_amp_program_follows_the_jax_executor(name):
    """The curve and the moves (loose: the bf16 drift), then step 1's
    same-input ops tight (``FIRST_PRODUCT_RTOL``, ``BN_VAR_RTOL``), and
    the control: the untagged fp32 program fails the product bound."""
    ref = jax_run(name, "amp")
    losses, dtypes, after, values = port_run(name, "amp", ref)
    assert dtypes == ref["dtypes"]
    assert "bfloat16" in dtypes
    np.testing.assert_allclose(losses, ref["losses"], rtol=AMP_CURVE_RTOL)
    params = trainable(after)
    assert params
    assert all(after[n].dtype == np.float32 for n in params)
    assert moves_rel_l2(ref, after, params) < AMP_MOVE_TOL
    gaps = step1_gaps(ref, values)
    products = first_products(gaps)
    assert products and max(products.values()) <= FIRST_PRODUCT_RTOL, \
        products
    for (op_type, slot, n), gap in gaps.items():
        if (op_type, slot) == ("batch_norm", "SavedVariance"):
            assert gap <= BN_VAR_RTOL, (n, gap)
    fp32 = first_products(step1_gaps(ref, port_run(name, "", ref)[3]))
    assert fp32 and min(fp32.values()) > FIRST_PRODUCT_RTOL, fp32


def _transformer(fluid):
    side = "jax" if fluid is jfluid else "port"
    return models(side, "transformer").build(
        **TINY_T, dropout=0.0, fused_attention=True, fused_head=True)[0]


def _transformer_feeds(r):
    shape = (B, TINY_T["max_len"], 1)
    return {k: r.randint(0, TINY_T["src_vocab"], shape).astype(np.int64)
            for k in ("src_ids", "tgt_ids", "lbl_ids")}


def _lstm(fluid):
    side = "jax" if fluid is jfluid else "port"
    return models(side, "stacked_dynamic_lstm").build(**TINY_L)[0]


def _lstm_feeds(r):
    return {"words": r.randint(0, TINY_L["dict_dim"],
                               (B, TINY_L["max_len"])).astype(np.int64),
            "seq_lens": r.randint(1, TINY_L["max_len"] + 1,
                                  (B,)).astype(np.int32),
            "label": r.randint(0, 2, (B, 1)).astype(np.int64)}


PROGRAMS.update({"transformer": (_transformer, 2, _transformer_feeds),
                 "stacked_dynamic_lstm": (_lstm, 2, _lstm_feeds)})


def test_pure_transformer_program_follows_the_jax_executor(monkeypatch):
    """The fused attention block and the fused head in bf16 on both sides
    (the JAX side through its Pallas kernels in interpret mode)."""
    monkeypatch.setenv(FORCE_PALLAS, "1")
    calls = []

    @contextlib.contextmanager
    def routed():
        with _jax_flash_routed() as c:
            yield
            calls.extend(c)
    ref = jax_run("transformer", "amp", routed)
    assert calls, "the JAX run did not take its flash branch"
    losses, dtypes, after, _ = port_run("transformer", "amp", ref)
    assert dtypes == ref["dtypes"] and "bfloat16" in dtypes
    np.testing.assert_allclose(losses[0], ref["losses"][0],
                               rtol=T_FIRST_RTOL)
    np.testing.assert_allclose(losses, ref["losses"], rtol=T_CURVE_RTOL)


def test_auto_amp_lstm_program_is_conservative_and_follows_jax():
    """``pure=None`` picks conservative (``dynamic_lstm`` is recurrent):
    the products in bf16 with fp32 results, the LSTM in fp32."""
    ref = jax_run("stacked_dynamic_lstm", "amp")
    losses, dtypes, after, _ = port_run("stacked_dynamic_lstm", "amp",
                                        ref)
    assert dtypes == ref["dtypes"] and "bfloat16" not in dtypes
    np.testing.assert_allclose(losses, ref["losses"], **L_CURVE_TOL)
    for n in trainable(after):
        # Adam moves a weight by ~lr whatever its gradient's size: compare
        # each tensor by its norm (its moments hold the gradients, whose
        # bf16-rounded products land on neighbouring bf16 values)
        want = ref["after"][n]
        assert np.linalg.norm(after[n] - want) <= 1e-4 * np.linalg.norm(
            want), n


def _mlp_program(order):
    """fc-relu-fc, the squared error, SGD; pure AMP ``order`` ("before" /
    "after") ``minimize``."""
    def fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=8, act="relu")
        loss = L.mean(L.square(L.elementwise_sub(L.fc(h, size=1), y)))
        if order == "before":
            tmp.rewrite_program_amp(None, pure=True)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        if order == "after":
            tmp.rewrite_program_amp(None, pure=True)
        return loss
    return build("port", fn)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("order", ["before", "after"])
def test_vjp_runs_the_tagged_forward(order, remat):
    """A rewrite before ``minimize`` tags the ops the snapshots copy; one
    after it tags the snapshots (``:220-231``). Either way the recorded
    forward (``grad_ops.record_forward``) and a ``__remat__`` forward
    replayed from its snapshot run the bf16 products: the losses and the
    weights after 2 steps bit-equal those of the rewrite before
    ``minimize`` without remat, and each replay calls the product
    again."""
    from paddle_tpu_torch.ops import nn_ops
    runs = {}
    for key in ((order, remat), ("before", False)):
        main, startup, loss = _mlp_program(key[0])
        vjps = [op for op in main.desc.global_block.ops
                if op.type == "__vjp__" and op.attrs["fwd_op"]["type"]
                == "mul"]
        assert len(vjps) == 2 and all(
            op.attrs["fwd_op"]["attrs"]["__amp_keep_bf16__"] for op in vjps)
        if key[1]:
            for op in vjps:
                op.attrs["fwd_op"]["attrs"]["__remat__"] = True
            main.desc.bump_version()
        scope = tfluid.Scope()
        startup.random_seed = 3
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        r = np.random.RandomState(1)
        calls, real = [], nn_ops.amp_product

        def counted(x, y, keep):
            calls.append(keep)
            return real(x, y, keep)
        losses = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(nn_ops, "amp_product", counted)
            for _ in range(2):
                f = {"x": r.randn(4, 6).astype(np.float32),
                     "y": r.randn(4, 1).astype(np.float32)}
                losses.append(exe.run(main, feed=f, fetch_list=[loss],
                                      scope=scope, return_numpy=False)[0]
                              .float().numpy())
        params = {p.name: scope.find_var(p.name).numpy()
                  for p in main.global_block().all_parameters()}
        runs[key] = (losses, params, calls)
    (losses, params, calls), (want_l, want_p, want_c) = (
        runs[(order, remat)], runs[("before", False)])
    assert want_c == [True] * 4 and calls == [True] * (8 if remat else 4)
    np.testing.assert_array_equal(np.asarray(losses), np.asarray(want_l))
    for n, w in want_p.items():
        np.testing.assert_array_equal(params[n], w, err_msg=n)


# -- decorate over a fluid optimizer ------------------------------------------

def _decorated(fluid, dec_kw, lr):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square(L.elementwise_sub(L.fc(x, size=1), y)))
    side = "jax" if fluid is jfluid else "port"
    contrib(side, "mixed_precision").decorate(
        fluid.optimizer.SGD(learning_rate=lr), **dec_kw).minimize(loss)
    return loss


DECORATE = dict(init_loss_scaling=1024.0, use_dynamic_loss_scaling=True,
                incr_every_n_steps=3, decr_every_n_nan_or_inf=2,
                decr_ratio=0.5)


def _decorate_feeds():
    rng = np.random.RandomState(5)
    feeds = []
    for i in range(9):
        x = rng.rand(2, 4).astype(np.float32)
        if i >= 6:                  # three overflows in a row
            x[0, 0] = np.inf
        feeds.append({"x": x, "y": rng.rand(2, 1).astype(np.float32)})
    return feeds


def test_decorate_program_matches_jax():
    """The desc, the curve, the scale and the counters at every step:
    three clean steps double the scale, one inf step holds it, two in a
    row halve it. An overflowed step's update is NaN on both sides (an
    inf gradient times 0, as the JAX program computes it)."""
    feeds = _decorate_feeds()
    runs = {}
    for side in ("jax", "port"):
        fluid = SIDES[side][0]
        main, startup, loss = build(side, lambda f: _decorated(
            f, DECORATE, 0.05))
        runs[side] = (main, startup, loss)
    (jm, js, jl), (tm, ts, tl) = runs["jax"], runs["port"]
    assert as_json(tm) == as_json(jm), _diffs(as_json(tm), as_json(jm))
    assert as_json(ts) == as_json(js)
    types_ = {op.type for op in tm.desc.global_block.ops}
    assert {"isfinite", "greater_equal", "cast", "assign"} <= types_
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    for n in persistables(jm):
        tscope.set_var(n, torch.from_numpy(np.array(jscope.find_var(n))))
    texe = tfluid.Executor(tfluid.CPUPlace())
    state = ["loss_scaling@AMP", "good_steps@AMP", "bad_steps@AMP"]
    w = next(p.name for p in jm.global_block().all_parameters()
             if p.name.endswith(".w_0"))
    seen = []
    for f in feeds:
        jv = jexe.run(jm, feed=f, scope=jscope, fetch_list=[jl.name])[0]
        tv = texe.run(tm, feed=f, scope=tscope, fetch_list=[tl])[0]
        if np.isfinite(np.asarray(jv)).all():
            np.testing.assert_allclose(tv, jv, **F32_TOL)
        for n in state:
            assert tscope.find_var(n).numpy().tolist() == np.asarray(
                jscope.find_var(n)).tolist(), n
        tw, jw = tscope.find_var(w).numpy(), np.asarray(jscope.find_var(w))
        assert np.isfinite(tw).all() == np.isfinite(jw).all() \
            == np.isfinite(f["x"]).all()
        np.testing.assert_allclose(tw, jw, **F32_TOL)
        seen.append(float(tscope.find_var(state[0]).numpy()[0]))
    assert seen == [1024.0, 1024.0, 2048.0, 2048.0, 2048.0, 4096.0,
                    4096.0, 2048.0, 2048.0], seen


def test_compare_and_isfinite_emitters_match_jax(jx):
    x = np.array([[1.0, 2.0, np.inf], [0.5, 2.0, -1.0]], np.float32)
    y = np.array([1.0, 2.0, 0.0], np.float32)
    for op in ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal"):
        want = jx.get_op(op).emit(jx.ctx(), {"X": [jx.jnp.asarray(x)],
                                             "Y": [jx.jnp.asarray(y)]},
                                  {})["Out"][0]
        got = tget_op(op).emit(TCtx(), {"X": [torch.from_numpy(x)],
                                        "Y": [torch.from_numpy(y)]},
                               {})["Out"][0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), op)
    for v in (x, y):
        want = jx.get_op("isfinite").emit(
            jx.ctx(), {"X": [jx.jnp.asarray(v)]}, {})["Out"][0]
        got = tget_op("isfinite").emit(
            TCtx(), {"X": [torch.from_numpy(v)]}, {})["Out"][0]
        assert got.shape == (1,) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the inference transpilers ------------------------------------------------

def _mlp():
    from paddle_tpu.fluid import layers
    x = layers.data(name="x", shape=[8], dtype="float32")
    hidden = layers.fc(x, size=8, act="relu")
    out = layers.fc(hidden, size=4, act="softmax")
    rng = np.random.RandomState(0)
    return ["x"], [hidden, out], {"x": rng.rand(3, 8).astype(np.float32)}


@pytest.mark.parametrize("cls", ["BF16Transpiler", "Float16Transpiler"])
def test_transpiler_over_the_predictor(cls, tmp_path):
    """``tests/test_contrib.py:11-36``: a saved two-layer MLP whose hidden
    fetch is also read downstream, transpiled in the predictor's scope on
    each side: both fetches come back fp32, every parameter in the
    reduced dtype, the program's desc equal to the JAX one's."""
    from paddle_tpu import inference as jinf
    from paddle_tpu.contrib import float16 as jf16
    from paddle_tpu_torch import inference as tinf
    from paddle_tpu_torch.contrib import float16 as tf16
    from test_torch_predictor import _save
    d = str(tmp_path)
    feeds = _save(d, _mlp)
    jp = jinf.PaddlePredictor(jinf.AnalysisConfig(model_dir=d))
    cfg = tinf.AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    tp = tinf.PaddlePredictor(cfg)
    ref = [np.asarray(o) for o in tp.run(feeds)]
    fetch = tp.get_output_names()
    getattr(jf16, cls)().transpile(jp._program, scope=jp._scope,
                                   feed_names=["x"], fetch_names=fetch)
    getattr(tf16, cls)().transpile(tp._program, scope=tp._scope,
                                   feed_names=["x"], fetch_names=fetch)
    assert as_json(tp._program) == as_json(jp._program)
    dt = {"BF16Transpiler": torch.bfloat16,
          "Float16Transpiler": torch.float16}[cls]
    for n, v in tp._program.desc.global_block.vars.items():
        if v.persistable:
            assert tp._scope.find_var(n).dtype == dt, n
    want = [np.asarray(o) for o in jp.run(feeds)]
    got = [np.asarray(o) for o in tp.run(feeds)]
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.dtype == np.float32
        if cls == "BF16Transpiler":
            _close(torch.from_numpy(g), torch.from_numpy(w), "bf16_max",
                   steps=2)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(g, r, rtol=5e-2, atol=5e-2)


# -- imports ------------------------------------------------------------------

def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch.contrib.mixed_precision as mp\n"
        "import paddle_tpu_torch.contrib.layout as lay\n"
        "import paddle_tpu_torch.contrib.float16\n"
        "import paddle_tpu_torch.fluid as fluid\n"
        "from paddle_tpu_torch.fluid.models import resnet\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup), fluid.unique_name.guard():\n"
        "    resnet.build(image_size=32, class_dim=10)\n"
        "assert mp.rewrite_program_amp(main) > 0\n"
        "assert lay.rewrite_program_nhwc(main) > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
