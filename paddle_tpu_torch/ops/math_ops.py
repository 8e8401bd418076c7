"""Emitters of the linear-algebra, reduction and shape ops (counterpart of
``paddle_tpu/ops/math_ops.py``) over the functions of ``ops/nn_ops.py``:
``mul`` (``:26``), ``matmul`` (``:51``), ``scale`` (``:74``), ``sum``
(``:84``), ``reduce_sum`` (``:115``), ``mean`` (``:122``), ``top_k``
(``:137``), ``reshape`` (``:147``), ``squeeze`` (``:164``), ``transpose``
(``:181``), ``concat`` (``:193``), ``split`` (``:204``), ``slice``
(``:218``), ``cast`` (``:93``), ``squared_l2_norm`` (``:303``, the
global-norm clip's), ``expand`` (``:238``) and ``gather`` (``:245``,
the decoder-LM serving views'). ``mul`` and ``matmul`` read their AMP
tags (``math_ops.py:36-47``, ``:59-65``).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.contrib.mixed_precision import policy_of
from paddle_tpu_torch.core.registry import (TORCH_DTYPES, first, register_op,
                                            single)
from paddle_tpu_torch.ops import nn_ops


@register_op("mul", ref="operators/mul_op.cc")
def _mul(ctx, ins, attrs):
    return single(nn_ops.mul(first(ins, "X"), first(ins, "Y"),
                             attrs.get("x_num_col_dims", 1),
                             attrs.get("y_num_col_dims", 1),
                             policy_of("mul", attrs)))


@register_op("matmul", ref="operators/matmul_op.cc")
def _matmul(ctx, ins, attrs):
    return single(nn_ops.matmul(first(ins, "X"), first(ins, "Y"),
                                transpose_y=attrs.get("transpose_Y", False),
                                amp=policy_of("matmul", attrs),
                                transpose_x=attrs.get("transpose_X", False),
                                alpha=attrs.get("alpha", 1.0)))


@register_op("scale", ref="operators/scale_op.cc")
def _scale(ctx, ins, attrs):
    return single(nn_ops.scale(first(ins, "X"), attrs.get("scale", 1.0),
                               attrs.get("bias", 0.0),
                               attrs.get("bias_after_scale", True)))


@register_op("sum", ref="operators/sum_op.cc")
def _sum(ctx, ins, attrs):
    return single(nn_ops.sums(ins.get("X", [])))


@register_op("reduce_sum", ref="operators/reduce_ops/reduce_sum_op.cc")
def _reduce_sum(ctx, ins, attrs):
    dim = None if attrs.get("reduce_all", False) else attrs.get("dim", [0])
    return single(nn_ops.reduce_sum(first(ins, "X"), dim,
                                    attrs.get("keep_dim", False)))


@register_op("mean", ref="operators/mean_op.cc")
def _mean(ctx, ins, attrs):
    return single(nn_ops.mean(first(ins, "X")))


@register_op("top_k", no_grad=True, ref="operators/top_k_op.cc")
def _top_k(ctx, ins, attrs):
    vals, idx = nn_ops.top_k(first(ins, "X"), attrs.get("k", 1))
    return {"Out": [vals], "Indices": [idx]}


@register_op("reshape", ref="operators/reshape_op.cc")
def _reshape(ctx, ins, attrs):
    return single(nn_ops.reshape(first(ins, "X"),
                                 list(attrs.get("shape", ()))))


@register_op("squeeze", ref="operators/squeeze_op.cc")
def _squeeze(ctx, ins, attrs):
    """Drop the size-1 ``axes`` (all size-1 axes when none are named); a
    named axis of another size raises, as ``jnp.squeeze`` does."""
    x = first(ins, "X")
    axes = attrs.get("axes", [])
    if not axes:
        return single(torch.squeeze(x))
    axes = tuple(a % x.dim() for a in axes)
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"squeeze: axes {axes} of shape {tuple(x.shape)} "
                         f"are not all of size 1")
    return single(torch.squeeze(x, axes))


@register_op("transpose", ref="operators/transpose_op.cc")
def _transpose(ctx, ins, attrs):
    return single(nn_ops.transpose(first(ins, "X"), attrs.get("axis")))


@register_op("concat", ref="operators/concat_op.cc")
def _concat(ctx, ins, attrs):
    """``__nhwc_concat__`` (an NHWC region's channel concat): the JAX op
    re-aims axis 1 at the physical last axis; channels-last inputs keep
    their NCHW shape, so axis 1 stays, and ``torch.cat`` of channels-last
    inputs is channels-last."""
    return single(nn_ops.concat(ins.get("X", []), attrs.get("axis", 0)))


@register_op("slice", ref="operators/slice_op.cc")
def _slice(ctx, ins, attrs):
    return single(nn_ops.slice(first(ins, "Input"), attrs.get("axes", []),
                               attrs.get("starts", []),
                               attrs.get("ends", [])))


@register_op("cast", ref="operators/cast_op.cc")
def _cast(ctx, ins, attrs):
    return single(first(ins, "X").to(
        TORCH_DTYPES[attrs.get("out_dtype", "float32")]))


@register_op("squared_l2_norm", ref="operators/squared_l2_norm_op.cc")
def _squared_l2_norm(ctx, ins, attrs):
    return single(torch.sum(torch.square(first(ins, "X"))))


@register_op("split", ref="operators/split_op.cc")
def _split(ctx, ins, attrs):
    """``num`` equal parts (it must divide the axis, as ``jnp.split``
    requires), or parts of the ``sections`` sizes (the last takes the
    rest)."""
    x = first(ins, "X")
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of {tuple(x.shape)} does "
                             f"not divide into {num} equal parts")
        return {"Out": list(torch.tensor_split(x, num, dim=axis))}
    offsets, at = [], 0
    for s in list(attrs.get("sections", []))[:-1]:
        at += int(s)
        offsets.append(at)
    return {"Out": list(torch.tensor_split(x, offsets, dim=axis))}


@register_op("expand", ref="operators/expand_op.cc")
def _expand(ctx, ins, attrs):
    """``jnp.tile`` (``math_ops.py:238``): ``expand_times`` repeats each
    axis; a shorter list repeats the trailing axes."""
    x = first(ins, "X")
    times = list(attrs.get("expand_times", [1] * x.dim()))
    times = [1] * (x.dim() - len(times)) + times
    return single(x.repeat(*times))


@register_op("gather", ref="operators/gather_op.cc")
def _gather(ctx, ins, attrs):
    """``jnp.take`` along axis 0 of the flattened ``Index``
    (``math_ops.py:245``), with its default mode: a negative index
    counts from the end, and an index still outside the axis gives the
    fill value (NaN for floats, the dtype's least value for signed
    integers, its largest for unsigned ones, True for bool) instead of
    raising. int64 data fills with the int32 least value, the JAX
    package's (64-bit types off, its ids are int32). Nothing is read on
    the host, so it runs on meta tensors."""
    x = first(ins, "X")
    idx = first(ins, "Index").reshape(-1).long()
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    outside = (idx < 0) | (idx >= n)
    out = x.index_select(0, idx.clamp(0, max(n - 1, 0)))
    if x.dtype == torch.bool:
        fill = True
    elif x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.uint8:
        fill = 255
    elif x.dtype == torch.int64:
        fill = torch.iinfo(torch.int32).min
    else:
        fill = torch.iinfo(x.dtype).min
    mask = outside.reshape((-1,) + (1,) * (x.dim() - 1))
    return single(out.masked_fill(mask, fill))
