"""Sequence operators over padded batches (counterpart of
``paddle_tpu/ops/sequence_ops.py``): a batch of variable-length sequences
is ``[B, T, ...]`` plus ``seq_lens`` [B], and every op is a masked dense
computation.

:func:`sequence_pool` is ``_sequence_pool`` (``:55-108``) as its refer
branch computes it (``:75-107``), in plain torch for every pool type: the
JAX op sends SUM / AVERAGE / SQRT at aligned widths to a Pallas kernel
(``ops/pallas/seqpool.py``), which has no counterpart here yet; MAX, LAST
and FIRST never reach it.
"""

from __future__ import annotations

from typing import Optional

import torch

POOL_TYPES = ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")


def _lens_or_full(seq_lens, b, t, device):
    if seq_lens is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return seq_lens.reshape(-1).to(torch.int32)


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
    tail = (1,) * (x.dim() - 2)
    lens_i = _lens_or_full(seq_lens, b, t, x.device)
    mask = (torch.arange(t, device=x.device)[None, :]
            < lens_i[:, None]).reshape(b, t, *tail)
    fmask = mask.to(x.dtype)
    lens_b = lens_i.to(x.dtype).clamp_min(1).reshape(b, *tail)
    nonempty = (lens_i > 0).reshape(b, *tail)
    if pooltype == "SUM":
        return (x * fmask).sum(dim=1)
    if pooltype == "AVERAGE":
        return (x * fmask).sum(dim=1) / lens_b
    if pooltype == "SQRT":
        return (x * fmask).sum(dim=1) / torch.sqrt(lens_b)
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
