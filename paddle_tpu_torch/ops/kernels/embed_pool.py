"""Embedding gather + masked sum pool: the wrapper of the CUDA kernel in
``paddle_tpu_torch/csrc/embed_pool.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/embed_pool.py``:

- :func:`fused_embed_seq_pool` -- ``_embed_pool_impl`` (``:78``): w [V,D],
  ids [B,T] int and lens [B] (None: every t counts) -> [B,D] =
  ``sum_{t < lens[b]} w[clip(ids[b,t], 0, V-1)]``, accumulated in fp32,
  without the [B,T,D] gathered rows on the card.

The clip is the TPU kernel's (``:81``); the JAX op's composed branch
(``paddle_tpu/ops/lod_ops.py:219``, ``w[ids]``) wraps a negative id
instead, so the two branches agree only on ids in [0, V). There is no
backward kernel, as on the TPU: the op's gradients are built in torch
(``paddle_tpu_torch/ops/lod_ops.py``).

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (any V, D, B and T; int32 and
int64 ids and lengths as they are, other integers as int64), which is
built on its first launch; anything else raises. The kernel takes the
tables of every dtype the JAX op's composed branch gathers, as the
seqpool kernel takes them
(``seqpool.kernel_operand``: floats summed in fp32, fp64 in fp64, float8
rounded to its type after every row, integers as int64, unsigned ones to
uint64, complex as its real view; ``seqpool.masked_sum``). ``LAUNCHES``
counts kernel launches; only a kernel launch adds to it.

The kernel splits each row's ids across the warps of one block
(:func:`pool_warps`), each warp summing a contiguous chunk of t, and adds
the warps' sums in warp order: an fp32 (fp64, int64) sum of the same
terms in another order than the plain version's, the same bits on every
run. Float8 tables keep one warp a row, which adds in t order: their
every partial sum is rounded to the type.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build
from paddle_tpu_torch.ops.kernels import seqpool as _seqpool

LAUNCHES = {"embed_pool": 0}
# the warps of a row: the plan the masked sequence pool shares
MAX_WARPS = _seqpool.MAX_WARPS
IDS_PER_WARP = _seqpool.STEPS_PER_WARP
pool_warps = _seqpool.pool_warps

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("embed_pool")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paddle_embed_pool.argtypes = [p, p, i, p, i, p] + [i] * 6 + [p]
        lib.paddle_embed_pool.restype = i
        _lib = lib
    return _lib


def fused_embed_seq_pool_ref(w, ids, lens=None):
    """Plain version of :func:`fused_embed_seq_pool`: the [B,T,D] gathered
    rows, masked and summed over T."""
    unsigned = w.dtype in _seqpool.UNSIGNED
    if unsigned:                        # CUDA gathers no unsigned rows
        w = _seqpool.as_int64(w)
    emb = w[ids.long().clamp(0, w.shape[0] - 1)]
    t = ids.shape[1]
    if lens is None:
        mask = torch.ones(ids.shape, dtype=torch.bool, device=w.device)
    else:
        mask = torch.arange(t, device=w.device)[None, :] < lens.reshape(-1, 1)
    out = _seqpool.masked_sum(emb, mask)
    return out.view(torch.uint64) if unsigned else out


def _check_shapes(w, ids, lens):
    if w.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"want w [V,D] and ids [B,T], got {tuple(w.shape)} "
                         f"and {tuple(ids.shape)}")
    if w.shape[0] == 0 or w.shape[1] == 0 or ids.shape[0] == 0:
        raise ValueError(f"empty pool: w {tuple(w.shape)}, ids "
                         f"{tuple(ids.shape)}")
    for name, t in (("ids", ids), ("lens", lens)):
        if t is not None and (t.dtype.is_floating_point
                              or t.dtype == torch.bool):
            raise ValueError(f"{name} must be integers, got {t.dtype}")
    if lens is not None and lens.numel() != ids.shape[0]:
        raise ValueError(f"want lens [{ids.shape[0]}], got "
                         f"{tuple(lens.shape)}")


def _index_operand(t):
    """Ids or lengths as the kernel reads them: int32 and int64 as they
    are, other integers as int64; contiguous."""
    if t.dtype not in (torch.int32, torch.int64):
        t = t.to(torch.int64)
    return t.contiguous()


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def fused_embed_seq_pool(w, ids, lens: Optional[torch.Tensor] = None):
    """w [V,D], ids [B,T] int, lens [B] int or None -> [B,D] of w's dtype
    (int64 for an integer table)."""
    _check_shapes(w, ids, lens)
    tensors = (w, ids) if lens is None else (w, ids, lens)
    if not _device.uses_kernel(*tensors):
        return fused_embed_seq_pool_ref(w, ids, lens)
    (v, d), (b, t) = w.shape, ids.shape
    if w.is_complex():
        out = fused_embed_seq_pool(torch.view_as_real(w).reshape(v, 2 * d),
                                   ids, lens)
        return torch.view_as_complex(out.view(b, d, 2))
    unsigned = w.dtype in _seqpool.UNSIGNED
    w, code = _seqpool.kernel_operand(w)
    ids = _index_operand(ids)
    lens = None if lens is None else _index_operand(lens.reshape(-1))
    out = torch.empty((b, d), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        err = _kernels().paddle_embed_pool(
            w.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            None if lens is None else lens.data_ptr(),
            int(lens is not None and lens.dtype == torch.int64),
            out.data_ptr(), b, t, v, d, code, pool_warps(t, code),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "fused_embed_seq_pool")
    LAUNCHES["embed_pool"] += 1
    return out.view(torch.uint64) if unsigned else out
