"""Sequence operators over padded batches (counterpart of
``paddle_tpu/ops/sequence_ops.py``): a batch of variable-length sequences
is ``[B, T, ...]`` plus ``seq_lens`` [B], and every op is a masked dense
computation.

- :func:`sequence_pool` is ``_sequence_pool`` (``:55-108``). SUM, AVERAGE
  and SQRT go to ``ops/kernels/seqpool.py`` ``masked_seqpool`` for every
  shape (an x of rank other than 3 viewed as [B, T, prod(rest)] and back):
  its CUDA kernel on the card, its plain version, the JAX op's refer
  branch (``:75-84``), on the CPU. The JAX op sends these pools to its
  Pallas kernel only at aligned widths; the numbers are the same either
  way. MAX, LAST and FIRST stay in plain torch, as no caller routes them
  to the kernel.
- :func:`sequence_conv` is ``_sequence_conv`` (``:152-181``): the context
  window as shifted copies (im2col), one product with the filter
  (``torch.matmul``, as JAX leaves the einsum to XLA), the result masked.

The rest of the JAX file's ops, each a plain torch function with the
JAX emitter's numerics (no Pallas kernel reaches them): ``sequence_mask``,
``sequence_softmax``, ``sequence_expand`` / ``sequence_expand_as``,
``sequence_concat``, ``sequence_reverse``, ``sequence_slice``,
``sequence_erase``, ``sequence_enumerate``, ``sequence_pad``,
``sequence_unpad``, ``sequence_reshape`` and ``edit_distance``.
``sequence_mask`` gives int32 for an int64 request, as the JAX op does;
an int64 output of another op (from int64 ids) is written int32 in the
program desc by shape inference (``core/shape_inference.py``), as the
JAX package, with 64-bit types off, writes it.

Every op of the program executor (``core/registry.py``) here is a thin
adapter onto the function of its name.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.core.registry import (TORCH_DTYPES, first,
                                            register_op, single)
from paddle_tpu_torch.ops.kernels import seqpool as _seqpool

POOL_TYPES = ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")


def _lens_or_full(seq_lens, b, t, device):
    if seq_lens is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return seq_lens.reshape(-1).to(torch.int32)


def _mask_bt(seq_lens, b, t, device):
    """[B, T] bool validity mask."""
    lens = _lens_or_full(seq_lens, b, t, device)
    return torch.arange(t, device=device)[None, :] < lens[:, None]


def sequence_pool(x: torch.Tensor, seq_lens: Optional[torch.Tensor] = None,
                  pooltype: str = "AVERAGE", return_max_index: bool = False):
    """X [B,T,...] (+ ``seq_lens`` [B]) -> Out [B,...]; zero-length rows
    pool to 0. With ``return_max_index`` (MAX only) also the op's
    ``MaxIndex`` output: the int32 step of each maximum. The gradient of
    MAX splits evenly among equal maxima, as ``jnp.max``'s does."""
    b, t = x.shape[0], x.shape[1]
    pooltype = str(pooltype).upper()
    if return_max_index and pooltype != "MAX":
        raise ValueError("MaxIndex is an output of the MAX pool only")
    lens_i = _lens_or_full(seq_lens, b, t, x.device)
    if pooltype in _seqpool.MODES:
        out = _seqpool.masked_seqpool(x.reshape(b, t, -1), lens_i, pooltype)
        return out.view(b, *x.shape[2:])
    tail = (1,) * (x.dim() - 2)
    mask = _mask_bt(seq_lens, b, t, x.device).reshape(b, t, *tail)
    nonempty = (lens_i > 0).reshape(b, *tail)
    if pooltype == "MAX":
        lowest = torch.finfo(x.dtype).min if x.dtype.is_floating_point \
            else torch.iinfo(x.dtype).min
        masked = torch.where(mask, x, torch.full_like(x, lowest))
        out = torch.where(nonempty, masked.amax(dim=1),
                          torch.zeros_like(x[:, 0]))
        if return_max_index:
            return out, masked.argmax(dim=1).to(torch.int32)
        return out
    if pooltype == "LAST":
        idx = (lens_i.long() - 1).clamp_min(0).reshape(b, 1, *tail)
        out = x.gather(1, idx.expand(b, 1, *x.shape[2:])).squeeze(1)
        return torch.where(nonempty, out, torch.zeros_like(out))
    if pooltype == "FIRST":
        return torch.where(nonempty, x[:, 0], torch.zeros_like(x[:, 0]))
    raise ValueError(f"unknown pooltype {pooltype!r}")


def default_context_start(context_length: int) -> int:
    """The layer's and the op's default ``contextStart``,
    ``-(context_length - 1) // 2`` as Python reads it: the floor of a
    negative half, -1 at length 3 but -2 at length 4
    (``fluid/layers/sequence.py:72``, ``sequence_ops.py:164``)."""
    return -(context_length - 1) // 2


def sequence_conv(x: torch.Tensor, filt: torch.Tensor,
                  seq_lens: Optional[torch.Tensor] = None,
                  context_length: int = 3,
                  context_start: Optional[int] = None) -> torch.Tensor:
    """X [B,T,D], filter [context_length*D, M] -> Out [B,T,M]: step t sees
    the rows t + context_start .. t + context_start + context_length - 1
    of the masked x (zeros outside [0, T) and past each length),
    flattened and multiplied by the filter; the rows past each length are
    0. A bf16 x and an fp32 filter multiply in fp32 and give fp32, as the
    JAX op's ``einsum`` promotes them (``sequence_ops.py:155-180``)."""
    if context_start is None:
        context_start = default_context_start(context_length)
    b, t, d = x.shape
    if filt.shape[0] != context_length * d:
        raise ValueError(f"want filter [{context_length * d}, M], got "
                         f"{tuple(filt.shape)}")
    mask = _mask_bt(seq_lens, b, t, x.device).to(x.dtype)[:, :, None]
    xm = x * mask
    steps = torch.arange(t, device=x.device)
    cols = []
    for k in range(context_length):
        idx = steps + (context_start + k)
        valid = ((idx >= 0) & (idx < t)).to(x.dtype)
        cols.append(xm.index_select(1, idx.clamp(0, t - 1))
                    * valid[None, :, None])
    wide = torch.promote_types(x.dtype, filt.dtype)
    out = torch.matmul(torch.cat(cols, dim=-1).to(wide), filt.to(wide))
    return out * mask


@register_op("sequence_pool",
             ref="operators/sequence_ops/sequence_pool_op.cc")
def _sequence_pool_op(ctx, ins, attrs):
    """The op (``paddle_tpu/ops/sequence_ops.py:55``) over
    :func:`sequence_pool`: ``Out``, and for MAX also ``MaxIndex``."""
    x, lens = first(ins, "X"), first(ins, "SeqLens")
    pooltype = str(attrs.get("pooltype", "AVERAGE")).upper()
    if pooltype == "MAX":
        out, idx = sequence_pool(x, lens, pooltype, return_max_index=True)
        return {"Out": [out], "MaxIndex": [idx]}
    return {"Out": [sequence_pool(x, lens, pooltype)]}


@register_op("sequence_conv",
             ref="operators/sequence_ops/sequence_conv_op.cc; "
                 "math/context_project.h")
def _sequence_conv_op(ctx, ins, attrs):
    """The op (``paddle_tpu/ops/sequence_ops.py:152``) over
    :func:`sequence_conv`: ``contextLength`` (3) and ``contextStart``
    (:func:`default_context_start`)."""
    ctx_len = int(attrs.get("contextLength", 3))
    return single(sequence_conv(
        first(ins, "X"), first(ins, "Filter"), first(ins, "SeqLens"),
        ctx_len, int(attrs.get("contextStart",
                               default_context_start(ctx_len)))))


# -- the rest of the JAX file's sequence ops --------------------------------
#
# Each as the JAX emitter computes it (``paddle_tpu/ops/sequence_ops.py``,
# line of each below). Where the JAX op scatters with ``.at[...].add(...,
# mode="drop")`` to an out-of-range index T (``sequence_concat``,
# ``sequence_erase``), the port scatters into T + 1 slots and drops the
# last one: clamping would write the padding into row T - 1. Token sets
# compare by broadcast (no ``torch.isin``), so that every op runs on meta
# tensors for shape inference.

def sequence_mask(x: torch.Tensor, maxlen: int,
                  out_dtype: str = "int64") -> torch.Tensor:
    """``:38``: lengths X (any shape) -> Y [..., maxlen], 1 below each
    length. An int64 request gives int32, as the JAX op (64-bit types
    off) writes it. ``maxlen`` must be given (>= 0)."""
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static `maxlen` attr (the "
                         "output shape may not depend on the lengths)")
    dtype = TORCH_DTYPES["int32" if out_dtype == "int64" else out_dtype]
    y = torch.arange(maxlen, device=x.device)[None, :] < x.reshape(-1, 1)
    return y.to(dtype).reshape(tuple(x.shape) + (maxlen,))


def sequence_softmax(x: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``:111``: a masked softmax over the time axis of X [B, T] or
    [B, T, 1]; 0 past each length."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    x2 = x.reshape(x.shape[0], x.shape[1]) if squeeze else x
    b, t = x2.shape
    mask = _mask_bt(seq_lens, b, t, x.device)
    z = torch.where(mask, x2, torch.full_like(x2, torch.finfo(x2.dtype).min))
    out = torch.where(mask, torch.softmax(z, dim=1), torch.zeros_like(x2))
    return out.reshape(x.shape) if squeeze else out


def sequence_expand(x: torch.Tensor, y: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``:129`` (and ``sequence_expand_as``, ``:146``): X [B, ...]
    broadcast over Y's time extent, Out [B, T, ...], 0 past each
    length."""
    b, t = x.shape[0], y.shape[1]
    mask = _mask_bt(seq_lens, b, t, x.device).to(x.dtype)
    return x[:, None] * mask.reshape(b, t, *([1] * (x.dim() - 1)))


def sequence_concat(xs: List[torch.Tensor],
                    lens_list: Optional[List] = None):
    """``:184``: each row's valid prefixes of X1, X2, ... one after the
    other along time. -> (Out [B, sum Ti, ...], NewLens [B] int32)."""
    lens_list = lens_list or [None] * len(xs)
    b = xs[0].shape[0]
    t_out = sum(int(x.shape[1]) for x in xs)
    feat = tuple(xs[0].shape[2:])
    tail = (1,) * len(feat)
    dev = xs[0].device
    # slot t_out takes what the JAX op drops
    out = torch.zeros((b, t_out + 1) + feat, dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for x, sl in zip(xs, lens_list):
        t = x.shape[1]
        lens = _lens_or_full(sl, b, t, dev)
        steps = torch.arange(t, device=dev)[None, :]
        valid = steps < lens[:, None]
        dest = torch.where(valid, offset[:, None] + steps,
                           torch.full_like(offset[:, None] + steps, t_out))
        vals = torch.where(valid.reshape(b, t, *tail), x,
                           torch.zeros_like(x))
        out = out.index_put((rows.expand(b, t), dest.long()), vals,
                            accumulate=True)
        offset = offset + lens
    return out[:, :t_out], offset


def sequence_reverse(x: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``:212``: each row's valid prefix reversed; the padding stays."""
    b, t = x.shape[0], x.shape[1]
    lens = _lens_or_full(seq_lens, b, t, x.device)[:, None]
    steps = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(steps < lens, lens - 1 - steps, steps.expand(b, t))
    return _take_steps(x, idx)


def _take_steps(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)`` for idx [B, T'] over every
    trailing dim of x."""
    b, t2 = idx.shape
    tail = x.shape[2:]
    full = idx.long().reshape(b, t2, *([1] * len(tail))).expand(
        b, t2, *tail)
    return x.gather(1, full)


def sequence_slice(x: torch.Tensor, offset: torch.Tensor,
                   length: torch.Tensor):
    """``:227``: row b's steps offset[b] .. offset[b] + length[b] - 1,
    left-aligned, 0 past length[b]. -> (Out [B, T, ...], NewLens =
    Length)."""
    offset = offset.reshape(-1).to(torch.int32)
    length = length.reshape(-1).to(torch.int32)
    b, t = x.shape[0], x.shape[1]
    steps = torch.arange(t, device=x.device)[None, :]
    g = _take_steps(x, (offset[:, None] + steps).clamp(0, t - 1))
    valid = (steps < length[:, None]).reshape(b, t, *([1] * (x.dim() - 2)))
    return torch.where(valid, g, torch.zeros_like(g)), length


def sequence_erase(x: torch.Tensor, tokens,
                   seq_lens: Optional[torch.Tensor] = None):
    """``:245``: X [B, T] ids with the ``tokens`` removed from each valid
    prefix and the rest moved left (pad 0). -> (Out [B, T], NewLens [B]
    int32)."""
    b, t = x.shape
    toks = torch.tensor(list(tokens) or [-(1 << 30)],
                        device=x.device).to(x.dtype)
    valid = _mask_bt(seq_lens, b, t, x.device)
    keep = valid & ~(x[..., None] == toks).any(-1)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    dest = torch.where(keep, pos, torch.full_like(pos, t))
    out = torch.zeros((b, t + 1), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    out = out.index_put((rows, dest.long()),
                        torch.where(keep, x, torch.zeros_like(x)),
                        accumulate=True)
    return out[:, :t], keep.to(torch.int32).sum(dim=1, dtype=torch.int32)


def sequence_enumerate(x: torch.Tensor, win_size: int, pad_value=0,
                       seq_lens: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``:266``: X [B, T] ids -> Out [B, T, win]: the window of ids from
    each step, ``pad_value`` past each length."""
    b, t = x.shape
    lens = _lens_or_full(seq_lens, b, t, x.device)
    steps = (torch.arange(t, device=x.device)[None, :, None]
             + torch.arange(win_size, device=x.device)[None, None, :]
             ).expand(b, t, win_size)
    in_seq = steps < lens[:, None, None]
    g = x.gather(1, steps.reshape(b, -1).clamp(0, t - 1)).reshape(
        b, t, win_size)
    return torch.where(in_seq, g, torch.full_like(g, pad_value))


def sequence_pad(x: torch.Tensor, seq_lens: Optional[torch.Tensor] = None,
                 pad_value=0.0, padded_length: int = -1):
    """``:287``: the steps past each length set to ``pad_value`` (a
    number or a tensor), the time extent padded with zeros or cut to
    ``padded_length`` (when > 0). -> (Out, Length [B] int32, clipped to
    [0, T])."""
    b, t = x.shape[0], x.shape[1]
    if padded_length > 0 and padded_length != t:
        if padded_length > t:
            fill = torch.zeros((b, padded_length - t) + tuple(x.shape[2:]),
                               dtype=x.dtype, device=x.device)
            x = torch.cat([x, fill], dim=1)
        else:
            x = x[:, :padded_length]
        t = padded_length
    mask = _mask_bt(seq_lens, b, t, x.device).reshape(
        b, t, *([1] * (x.dim() - 2)))
    if not isinstance(pad_value, torch.Tensor):
        pad_value = torch.tensor(pad_value, device=x.device)
    out = torch.where(mask, x, pad_value.to(x.dtype).expand(x.shape))
    return out, _lens_or_full(seq_lens, b, t, x.device).clamp(0, t)


def sequence_unpad(x: torch.Tensor, length: torch.Tensor):
    """``:314``: the steps past each length zeroed (the padded tensor and
    its lengths stand for the reference's ragged output). -> (Out,
    Length [B] int32)."""
    b, t = x.shape[0], x.shape[1]
    mask = _mask_bt(length, b, t, x.device).reshape(
        b, t, *([1] * (x.dim() - 2)))
    return (torch.where(mask, x, torch.zeros_like(x)),
            _lens_or_full(length, b, t, x.device))


def sequence_reshape(x: torch.Tensor, new_dim: int,
                     seq_lens: Optional[torch.Tensor] = None):
    """``:328``: [B, T, D] -> [B, T*D // new_dim, new_dim]; the lengths
    scale by D / new_dim. -> (Out, NewLens [B] int32)."""
    b, t, d = x.shape
    out = x.reshape(b, t * d // new_dim, new_dim)
    return out, _lens_or_full(seq_lens, b, t, x.device) * d // new_dim


def edit_distance(hyp: torch.Tensor, ref: torch.Tensor,
                  hyp_lens: Optional[torch.Tensor] = None,
                  ref_lens: Optional[torch.Tensor] = None,
                  normalized: bool = False):
    """``:341``: the Levenshtein distance of each row's hypothesis prefix
    to its reference prefix, by the JAX op's dynamic program (row i of
    the table over the reference positions), fp32. -> (Out [B, 1],
    SequenceNum [1] int32 = B); ``normalized`` divides by the reference
    length (at least 1)."""
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    dev = hyp.device
    hl = _lens_or_full(hyp_lens, b, t1, dev).long()
    rl = _lens_or_full(ref_lens, b, t2, dev).long()
    row = torch.arange(t2 + 1, dtype=torch.float32, device=dev).expand(
        b, t2 + 1)
    rows = [row]
    for i in range(t1):
        sub = (ref != hyp[:, i:i + 1]).to(torch.float32)        # [B, T2]
        left = torch.full((b,), float(i + 1), device=dev)
        cols = [left]
        for j in range(t2):
            left = torch.minimum(torch.minimum(row[:, j + 1] + 1.0,
                                               left + 1.0),
                                 row[:, j] + sub[:, j])
            cols.append(left)
        row = torch.stack(cols, dim=1)
        rows.append(row)
    table = torch.stack(rows)                                # [T1+1, B, T2+1]
    d = table[hl, torch.arange(b, device=dev), rl]
    if normalized:
        d = d / torch.clamp(rl.to(torch.float32), min=1.0)
    return d.reshape(-1, 1), torch.tensor([b], dtype=torch.int32, device=dev)


@register_op("sequence_mask", no_grad=True,
             ref="operators/sequence_ops/sequence_mask_op.cc")
def _sequence_mask_op(ctx, ins, attrs):
    return {"Y": [sequence_mask(first(ins, "X"),
                                int(attrs.get("maxlen", -1)),
                                attrs.get("out_dtype", "int64"))]}


@register_op("sequence_softmax",
             ref="operators/sequence_ops/sequence_softmax_op.cc")
def _sequence_softmax_op(ctx, ins, attrs):
    return single(sequence_softmax(first(ins, "X"), first(ins, "SeqLens")))


@register_op("sequence_expand",
             ref="operators/sequence_ops/sequence_expand_op.cc")
def _sequence_expand_op(ctx, ins, attrs):
    return single(sequence_expand(first(ins, "X"), first(ins, "Y"),
                                  first(ins, "SeqLens")))


@register_op("sequence_expand_as",
             ref="operators/sequence_ops/sequence_expand_as_op.cc")
def _sequence_expand_as_op(ctx, ins, attrs):
    return _sequence_expand_op(ctx, ins, attrs)


@register_op("sequence_concat",
             ref="operators/sequence_ops/sequence_concat_op.cc")
def _sequence_concat_op(ctx, ins, attrs):
    out, lens = sequence_concat(ins.get("X") or [], ins.get("SeqLens"))
    return {"Out": [out], "NewLens": [lens]}


@register_op("sequence_reverse",
             ref="operators/sequence_ops/sequence_reverse_op.h")
def _sequence_reverse_op(ctx, ins, attrs):
    out = sequence_reverse(first(ins, "X"), first(ins, "SeqLens"))
    return {"Y": [out], "Out": [out]}


@register_op("sequence_slice",
             ref="operators/sequence_ops/sequence_slice_op.cc")
def _sequence_slice_op(ctx, ins, attrs):
    out, lens = sequence_slice(first(ins, "X"), first(ins, "Offset"),
                               first(ins, "Length"))
    return {"Out": [out], "NewLens": [lens]}


@register_op("sequence_erase", no_grad=True,
             ref="operators/sequence_ops/sequence_erase_op.cc")
def _sequence_erase_op(ctx, ins, attrs):
    out, lens = sequence_erase(first(ins, "X"), attrs.get("tokens", []),
                               first(ins, "SeqLens"))
    return {"Out": [out], "NewLens": [lens]}


@register_op("sequence_enumerate", no_grad=True,
             ref="operators/sequence_ops/sequence_enumerate_op.cc")
def _sequence_enumerate_op(ctx, ins, attrs):
    return single(sequence_enumerate(
        first(ins, "X"), int(attrs.get("win_size", 2)),
        attrs.get("pad_value", 0), first(ins, "SeqLens")))


@register_op("sequence_pad", ref="operators/sequence_ops/sequence_pad_op.cc")
def _sequence_pad_op(ctx, ins, attrs):
    pv = first(ins, "PadValue")
    out, lens = sequence_pad(
        first(ins, "X"), first(ins, "SeqLens"),
        attrs.get("pad_value", 0.0) if pv is None else pv,
        int(attrs.get("padded_length", -1)))
    return {"Out": [out], "Length": [lens]}


@register_op("sequence_unpad",
             ref="operators/sequence_ops/sequence_unpad_op.cc")
def _sequence_unpad_op(ctx, ins, attrs):
    out, lens = sequence_unpad(first(ins, "X"), first(ins, "Length"))
    return {"Out": [out], "Length": [lens]}


@register_op("sequence_reshape",
             ref="operators/sequence_ops/sequence_reshape_op.cc")
def _sequence_reshape_op(ctx, ins, attrs):
    out, lens = sequence_reshape(first(ins, "X"), int(attrs["new_dim"]),
                                 first(ins, "SeqLens"))
    return {"Out": [out], "NewLens": [lens]}


@register_op("edit_distance", no_grad=True,
             ref="operators/edit_distance_op.cc")
def _edit_distance_op(ctx, ins, attrs):
    d, n = edit_distance(first(ins, "Hyps"), first(ins, "Refs"),
                         first(ins, "HypsLens"), first(ins, "RefsLens"),
                         bool(attrs.get("normalized", False)))
    return {"Out": [d], "SequenceNum": [n]}
