"""Fused LoD operators (counterpart of ``paddle_tpu/ops/lod_ops.py``).

:func:`fused_embedding_seq_pool` is ``_fused_embedding_seq_pool``
(``:199-222``): a table lookup and a sum pool over time in one op. Its
forward is ``ops/kernels/embed_pool.py`` ``fused_embed_seq_pool`` (the
CUDA kernel on the card, the plain version on the CPU), and its gradients
are those the JAX package gives it:

- ``sparse=True``: the row-sparse table gradient of
  ``paddle_tpu/ops/grad_ops.py:72-85``, a sparse COO tensor with one row
  per position of ``ids``, **all B*T of them, masked positions included
  with zero values**. Coalesced (as the port's lazy ``Adam`` does), the
  rows are the distinct ids, as JAX's ``RowSparseGrad.deduped()`` gives
  them; lazy Adam then moves exactly the rows that JAX's moves, the ids
  seen only past a row's length among them.
- ``sparse=False``: the dense scatter-add of ``_embed_pool_bwd``
  (``paddle_tpu/ops/pallas/embed_pool.py:114-127``).

An id outside [0, V) reads the clipped row (the kernel's rule), and its
gradient goes to that row too.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import embed_pool as _embed_pool


class FusedEmbeddingSeqPool(torch.autograd.Function):
    """[B, D] = sum over t < lens[b] of w[ids[b, t]]; differentiable in w
    (sparse or dense gradient), ``ids`` and ``lens`` get none."""

    @staticmethod
    def forward(ctx, w, ids, lens, sparse):
        ctx.save_for_backward(ids, lens)
        ctx.table = (w.shape[0], w.shape[1], w.dtype)
        ctx.sparse = sparse
        return _embed_pool.fused_embed_seq_pool(w, ids, lens)

    @staticmethod
    def backward(ctx, g):
        ids, lens = ctx.saved_tensors
        v, d, dtype = ctx.table
        b, t = ids.shape
        vals = g.to(dtype)[:, None, :].expand(b, t, d)
        if lens is not None:
            mask = torch.arange(t, device=g.device)[None, :] \
                < lens.reshape(-1, 1)
            vals = vals * mask[:, :, None].to(dtype)
        rows = ids.reshape(-1).long().clamp(0, v - 1)
        vals = vals.reshape(b * t, d)
        if ctx.sparse:
            dw = torch.sparse_coo_tensor(rows[None], vals, (v, d),
                                         check_invariants=False)
        else:
            dw = torch.zeros((v, d), dtype=dtype, device=g.device) \
                .index_add_(0, rows, vals)
        return dw, None, None, None


def fused_embedding_seq_pool(w: torch.Tensor, ids: torch.Tensor,
                             seq_lens: Optional[torch.Tensor] = None,
                             sparse: bool = True) -> torch.Tensor:
    """W [V, D], Ids [B, T] (or [B, T, 1]) integers, SeqLens [B] (None:
    every step counts) -> [B, D]."""
    if ids.dim() == 3:
        ids = ids[..., 0]
    return FusedEmbeddingSeqPool.apply(w, ids, seq_lens, bool(sparse))
