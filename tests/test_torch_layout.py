"""The port's NHWC layout region (``paddle_tpu_torch/contrib/layout.py``
and the emitters' NHWC branches) against the JAX package's
(``paddle_tpu/contrib/layout.py``), on the CPU at small widths.

- The rewrite: every bench builder (``test_torch_amp_programs.BUILDERS``),
  ``rewrite_program_nhwc`` alone and after ``rewrite_program_amp`` on a
  copy of the built desc (the order of ``bench.py:291-296``), and before
  ``minimize`` (shape inference then runs the tagged emitters on meta
  tensors): the descs equal as JSON values, the counts equal.
- The emitters: ``conv2d``, ``pool2d``, ``batch_norm`` (train and test)
  and ``conv2d_fusion`` at every combination of the region-edge tags,
  and the elementwise binaries' ``__nhwc_bcast__`` / ``__nhwc_bcast_bc__``
  and ``concat``'s ``__nhwc_concat__``, against the JAX emitters on the
  same seeded inputs. A resident input is an NHWC array on the JAX side
  and a channels-last tensor of NCHW shape on the port's; a kept output
  likewise. The port's output is compared after ``permute(0, 2, 3, 1)``
  where the JAX one is NHWC, and its memory format is checked.
- Programs through the executors: mnist, smallnet and the shallow ResNet
  under NHWC and under AMP + NHWC; the SE-ResNeXt block (``bcast_bc``)
  and the inception module (``concat``) under NHWC: every conv of the
  region takes channels-last operands, every forward var fetched comes
  back contiguous. A saved program through the predictor's passes
  (``conv2d_fusion`` with a residual) rewritten AMP + NHWC on both
  sides, as ``bench.py:592-595`` rewrites its inference rows.

Tolerances: fp32 NHWC programs ``TIGHT`` (the curve rtol 1e-4, each
parameter's move 1e-3 relative L2: the JAX rewrite is bit-exact against
its NCHW program in fp32, ``tests/test_contrib.py:300``, and the port's
channels-last convs sum in another order); AMP + NHWC as the AMP
programs of ``test_torch_amp_programs`` (the layout changes no value);
the emitters fp32 rtol 1e-5 / atol 1e-5 (one conv's sums in another
order), bf16 within a bf16 step.
"""

import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.registry import EmitContext as TCtx
from paddle_tpu_torch.core.registry import get_op as tget_op
from paddle_tpu_torch.ops import nn_ops

from test_torch_amp import _close, _r, jx  # noqa: F401
from test_torch_amp_programs import (  # noqa: F401  (shared_builds: a fixture)
    AMP_CURVE_RTOL, AMP_MOVE_TOL, BUILDERS, FIRST_PRODUCT_RTOL, built,
    contrib, first_products, jax_run, moves_rel_l2, port_run, rewritten,
    shared_builds, step1_gaps, trainable)
from test_torch_program_builder import _diffs

TIGHT = dict(curve=1e-4, move=1e-3)
EMIT_TOL = dict(rtol=1e-5, atol=1e-5)
# (in_ready, out_keep) of a tagged op: the rewrite tags an op only where
# one of its edges is resident
EDGES = [(False, True), (True, False), (True, True)]
CL = torch.channels_last


# -- the rewrite --------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True], ids=["nhwc", "amp+nhwc"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rewrite_after_minimize_matches_jax(name, amp):
    """The ops' tags, the resident var descs' ``__nhwc__`` and the
    ``__vjp__`` snapshots' tags."""
    def fn(side, prog):
        if amp:
            contrib(side, "mixed_precision").rewrite_program_amp(prog)
        return contrib(side, "layout").rewrite_program_nhwc(prog)
    (want, n_jax), (got, n) = (rewritten(s, name, fn)
                               for s in ("jax", "port"))
    assert got == want, _diffs(got, want)
    assert n == n_jax


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rewrite_before_minimize_matches_jax(name):
    jmain, jstart, jn = built("jax", name, "nhwc")
    tmain, tstart, tn = built("port", name, "nhwc")
    assert json.loads(tmain) == json.loads(jmain), _diffs(
        json.loads(tmain), json.loads(jmain))
    assert json.loads(tstart) == json.loads(jstart)
    assert tn == jn


def test_regions_of_the_image_builders():
    """What the fixpoint finds: every conv / pool / batch norm of ResNet
    tagged, the SE gates ``bcast_bc``, GoogLeNet's channel concats."""
    def tags(name):
        got, n = rewritten("port", name, lambda side, p: contrib(
            side, "layout").rewrite_program_nhwc(p))
        ops = got["blocks"][0]["ops"]
        return n, [(op["type"], sorted(k for k in op["attrs"]
                                       if k.startswith("__nhwc")))
                   for op in ops if op["type"] != "__vjp__"]
    n, ops = tags("resnet")
    assert n > 0 and all(t for ty, t in ops if ty in (
        "conv2d", "batch_norm", "pool2d"))
    _, ops = tags("se_resnext")
    assert any(t == ["__nhwc_bcast_bc__"] for _, t in ops)
    _, ops = tags("googlenet")
    assert any(ty == "concat" and t == ["__nhwc_concat__"] for ty, t in ops)
    assert tags("transformer")[0] == 0


# -- the emitters -------------------------------------------------------------

def _to_nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _edge_attrs(in_ready, out_keep, **kw):
    return dict(kw, __nhwc__=True, __nhwc_in_ready__=in_ready,
                __nhwc_out_keep__=out_keep)


def _port_in(a, resident):
    t = torch.from_numpy(a)
    return t.contiguous(memory_format=CL) if resident else t


def _check_out(got, want, keep, how="f32"):
    """``got`` (NCHW shape) against the JAX output (NHWC when kept); a kept
    output is channels-last, else contiguous."""
    if keep:
        assert got.is_contiguous(memory_format=CL)
        got = got.permute(0, 2, 3, 1)
    else:
        assert got.is_contiguous()
    if how == "f32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **EMIT_TOL)
    else:
        _close(got.contiguous(), want, how)


def _both(jx, op_type, ins, attrs, data_slot, in_ready, slot, is_test=False):
    """Run the op on each side; the data slot as its residency has it."""
    jins = {k: [jx.jnp.asarray(_to_nhwc(v) if k == data_slot and in_ready
                               else v) for v in vs]
            for k, vs in ins.items()}
    tins = {k: [_port_in(v, in_ready) if k == data_slot
                else torch.from_numpy(v) for v in vs]
            for k, vs in ins.items()}
    jctx = jx.ctx()
    if is_test:
        import dataclasses
        jctx = dataclasses.replace(jctx, is_test=True)
    want = jx.get_op(op_type).emit(jctx, jins, attrs)
    got = tget_op(op_type).emit(TCtx(is_test=is_test), tins, attrs)
    return got[slot][0], want[slot][0]


@pytest.mark.parametrize("in_ready,out_keep", EDGES)
def test_conv2d_nhwc_branch(jx, in_ready, out_keep):
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)]}
    got, want = _both(jx, "conv2d", ins, _edge_attrs(
        in_ready, out_keep, strides=[2, 2], paddings=[1, 1]), "Input",
        in_ready, "Output")
    _check_out(got, want, out_keep)


@pytest.mark.parametrize("pool", ["max", "avg", "global"])
@pytest.mark.parametrize("in_ready,out_keep", EDGES)
def test_pool2d_nhwc_branch(jx, in_ready, out_keep, pool):
    attrs = dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
                 pooling_type="max" if pool == "max" else "avg",
                 global_pooling=pool == "global")
    got, want = _both(jx, "pool2d", {"X": [_r(2, 4, 7, 7, seed=3)]},
                      _edge_attrs(in_ready, out_keep, **attrs), "X",
                      in_ready, "Out")
    _check_out(got, want, out_keep)


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("in_ready,out_keep", EDGES)
def test_batch_norm_nhwc_branch(jx, in_ready, out_keep, is_test):
    c = 4
    ins = {"X": [_r(3, c, 5, 5, seed=3)], "Scale": [_r(c, seed=4) + 1.0],
           "Bias": [_r(c, seed=5)], "Mean": [_r(c, seed=6)],
           "Variance": [np.abs(_r(c, seed=7)) + 0.5]}
    attrs = _edge_attrs(in_ready, out_keep)
    got, want = _both(jx, "batch_norm", ins, attrs, "X", in_ready, "Y",
                      is_test)
    _check_out(got, want, out_keep)
    gm, wm = _both(jx, "batch_norm", ins, attrs, "X", in_ready, "MeanOut",
                   is_test)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **EMIT_TOL)


@pytest.mark.parametrize("resid_ready", [False, True])
@pytest.mark.parametrize("in_ready,out_keep", EDGES)
def test_conv2d_fusion_nhwc_branch(jx, in_ready, out_keep, resid_ready):
    """The residual's own residency (``__nhwc_resid_ready__``) is
    independent of the op's data slot."""
    resid = _r(2, 4, 6, 6, seed=4)
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)], "Bias": [_r(4, seed=3)]}
    attrs = _edge_attrs(in_ready, out_keep, strides=[1, 1], paddings=[1, 1],
                        activation="relu", __nhwc_resid_ready__=resid_ready)
    jins = {k: [jx.jnp.asarray(_to_nhwc(v) if k == "Input" and in_ready
                               else v) for v in vs] for k, vs in ins.items()}
    jins["ResidualData"] = [jx.jnp.asarray(_to_nhwc(resid) if resid_ready
                                           else resid)]
    tins = {k: [_port_in(v, in_ready) if k == "Input"
                else torch.from_numpy(v) for v in vs]
            for k, vs in ins.items()}
    tins["ResidualData"] = [_port_in(resid, resid_ready)]
    want = jx.get_op("conv2d_fusion").emit(jx.ctx(), jins, attrs)
    got = tget_op("conv2d_fusion").emit(TCtx(), tins, attrs)
    _check_out(got["Output"][0], want["Output"][0], out_keep)


def test_untagged_conv2d_fusion_takes_a_resident_residual(jx):
    """``__nhwc_resid_ready__`` on an op outside any region: the JAX op
    transposes the residual back; the port's conv is contiguous."""
    resid = _r(2, 4, 6, 6, seed=4)
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)], "Bias": [_r(4, seed=3)]}
    attrs = dict(strides=[1, 1], paddings=[1, 1], activation="relu",
                 __nhwc_resid_ready__=True)
    jins = {k: [jx.jnp.asarray(v) for v in vs] for k, vs in ins.items()}
    jins["ResidualData"] = [jx.jnp.asarray(_to_nhwc(resid))]
    tins = {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()}
    tins["ResidualData"] = [_port_in(resid, True)]
    want = jx.get_op("conv2d_fusion").emit(jx.ctx(), jins, attrs)
    got = tget_op("conv2d_fusion").emit(TCtx(), tins, attrs)
    _check_out(got["Output"][0], want["Output"][0], False)


@pytest.mark.parametrize("op_type", ["elementwise_add", "elementwise_mul"])
@pytest.mark.parametrize("tag", ["__nhwc_bcast__", "__nhwc_bcast_bc__"])
def test_elementwise_broadcast_tags_need_no_reaim(jx, tag, op_type):
    """The JAX op re-aims Y at the physical last axis of an NHWC X. A
    channels-last X keeps its NCHW shape, so the port's ``axis``
    broadcast (a [C] at axis 1, a [B, C] at axis 0) is already the
    channel broadcast: the port's emitter with the tag equals the JAX
    emitter's NHWC result, and the port's emitter without it."""
    x = _r(2, 4, 3, 5, seed=1)
    y, axis = ((_r(4, seed=2), 1) if tag == "__nhwc_bcast__"
               else (_r(2, 4, seed=2), 0))
    attrs = {"axis": axis, tag: True}
    want = jx.get_op(op_type).emit(jx.ctx(), {
        "X": [jx.jnp.asarray(_to_nhwc(x))], "Y": [jx.jnp.asarray(y)]},
        attrs)["Out"][0]
    tins = {"X": [_port_in(x, True)], "Y": [torch.from_numpy(y)]}
    got = tget_op(op_type).emit(TCtx(), tins, attrs)["Out"][0]
    _check_out(got, want, True)
    plain = tget_op(op_type).emit(TCtx(), tins, {"axis": axis})["Out"][0]
    assert torch.equal(plain, got)


def test_concat_tag_needs_no_reaim(jx):
    """``__nhwc_concat__``: the JAX op concatenates NHWC arrays on their
    last axis; channels-last inputs concatenate on axis 1 into a
    channels-last output."""
    xs = [_r(2, c, 3, 3, seed=c) for c in (2, 3, 4)]
    attrs = {"axis": 1, "__nhwc_concat__": True}
    want = jx.get_op("concat").emit(jx.ctx(), {"X": [
        jx.jnp.asarray(_to_nhwc(x)) for x in xs]}, attrs)["Out"][0]
    got = tget_op("concat").emit(TCtx(), {"X": [_port_in(x, True)
                                                for x in xs]},
                                 attrs)["Out"][0]
    _check_out(got, want, True)


@pytest.mark.parametrize("mode", ["pure", "conservative"])
def test_amp_and_nhwc_tags_together(jx, mode):
    """A conv tagged by both rewrites: bf16 channels-last."""
    ins = {"Input": [_r(2, 3, 6, 6, seed=1)],
           "Filter": [_r(4, 3, 3, 3, seed=2)]}
    amp = {"__amp_bf16__": True}
    if mode == "pure":
        amp["__amp_keep_bf16__"] = True
    got, want = _both(jx, "conv2d", ins, _edge_attrs(
        False, True, paddings=[1, 1], **amp), "Input", False, "Output")
    assert got.dtype == (torch.bfloat16 if mode == "pure" else torch.float32)
    _check_out(got, want, True, how="bf16")


def test_emitters_keep_channels_last_on_meta_tensors():
    """Shape inference runs the tagged emitters on meta tensors."""
    from paddle_tpu_torch import device
    x = torch.empty((2, 3, 6, 6), device="meta")
    w = torch.empty((4, 3, 3, 3), device="meta")
    with device.abstract_evaluation():
        out = tget_op("conv2d").emit(TCtx(device=torch.device("meta")), {
            "Input": [x], "Filter": [w]}, _edge_attrs(
                False, True, paddings=[1, 1], __amp_bf16__=True))["Output"][0]
    assert out.shape == (2, 4, 6, 6) and out.is_contiguous(memory_format=CL)


# -- programs through the executors -------------------------------------------

NHWC_PROGRAMS = ("mnist", "smallnet", "shallow_resnet", "se_block",
                 "inception_block")


@pytest.mark.parametrize("name", NHWC_PROGRAMS)
def test_nhwc_program_follows_the_jax_executor(name):
    """The curve and every parameter's move; every forward var fetched at
    step 1 (``port_run``) came back contiguous, the resident ones too."""
    ref = jax_run(name, "nhwc")
    formats = []
    real = nn_ops.F.conv2d

    def conv2d(x, w, *a, **kw):
        if not x.is_meta:           # shape inference while building
            formats.append(x.is_contiguous(memory_format=CL)
                           and w.is_contiguous(memory_format=CL))
        return real(x, w, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn_ops.F, "conv2d", conv2d)
        losses, dtypes, after, _ = port_run(name, "nhwc", ref)
    assert formats and all(formats)
    assert dtypes == ref["dtypes"] and "bfloat16" not in dtypes
    np.testing.assert_allclose(losses, ref["losses"], rtol=TIGHT["curve"])
    for n in trainable(after):
        assert moves_rel_l2(ref, after, [n]) < TIGHT["move"], n


@pytest.mark.parametrize("name", ("mnist", "smallnet", "shallow_resnet"))
def test_amp_nhwc_program_follows_the_jax_executor(name):
    ref = jax_run(name, "amp+nhwc")
    losses, dtypes, after, values = port_run(name, "amp+nhwc", ref)
    assert dtypes == ref["dtypes"] and "bfloat16" in dtypes
    np.testing.assert_allclose(losses, ref["losses"], rtol=AMP_CURVE_RTOL)
    assert moves_rel_l2(ref, after, trainable(after)) < AMP_MOVE_TOL
    products = first_products(step1_gaps(ref, values))
    assert products and max(products.values()) <= FIRST_PRODUCT_RTOL, \
        products


# -- a saved program through the predictor ------------------------------------

@pytest.mark.parametrize("spec", ["nhwc", "amp+nhwc"])
def test_nhwc_predictor_program_matches_jax(spec, tmp_path_factory):
    """``conv_elementwise_add2_act_fuse_pass``'s program (``conv2d_fusion``
    with a residual) after each predictor's passes, rewritten as
    ``bench.py:592-595`` rewrites its inference rows: the desc equal to
    the JAX one's, the output the JAX predictor's."""
    from test_torch_predictor import _case, _port
    from test_torch_amp_programs import as_json, rewrite_with
    d, feeds, jp = _case("conv_elementwise_add2_act_fuse_pass",
                         tmp_path_factory)
    from paddle_tpu import inference as jinf
    jp = jinf.PaddlePredictor(jinf.AnalysisConfig(model_dir=d))
    tp = _port(d)
    for side, p in (("jax", jp), ("port", tp)):
        rewrite_with(spec)(side, p._program)
    types_ = [op.type for op in tp._program.desc.global_block.ops]
    assert "conv2d_fusion" in types_
    assert as_json(tp._program) == as_json(jp._program)
    fused = [op for op in tp._program.desc.global_block.ops
             if op.type == "conv2d_fusion"]
    assert any(op.attrs.get("__nhwc__") for op in fused)
    want = [np.asarray(o) for o in jp.run(feeds)]
    # a pure-AMP fetch is bf16, which numpy has no dtype for
    got = tp._exe.run(tp._program, feed=feeds, scope=tp._scope,
                      fetch_list=tp.get_output_names(), return_numpy=False)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        if spec == "nhwc":
            np.testing.assert_allclose(g.numpy(), w, **EMIT_TOL)
        else:
            assert g.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
            _close(g, w, "bf16_max", steps=2)
