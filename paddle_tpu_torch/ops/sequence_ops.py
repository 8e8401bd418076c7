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

The ``sequence_pool`` and ``sequence_conv`` ops of the program executor
(``core/registry.py``) are thin adapters onto :func:`sequence_pool` and
:func:`sequence_conv`.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.registry import first, register_op, single
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
