"""Row gather and in-place row scatter of the hot-rows embedding cache:
the wrappers of the CUDA kernels and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/embed_cache.py``, whose two
functions the JAX cache calls once per family (the table and each of its
row-aligned optimizer states):

- :func:`gather_rows` -- ``gather_rows`` (``:58``): cache [R, W], slots
  [K] int32 -> [K, W] = ``cache[min(slot, R - 1)]`` (the write-back read:
  dirty rows lifted off the card before a push to their shard).
- :func:`scatter_rows` -- ``scatter_rows`` (``:110``): ``cache[slots[k]]
  = rows[k]`` IN PLACE for 0 <= slot < R, every other slot dropped (the
  cache's power-of-two bucket padding points at R + 1); returns ``cache``
  itself.

The port's cache moves every family at once: :func:`gather_rows_families`
and :func:`scatter_rows_families` take F caches (1 <= F <= 4), each
[R, W] of one dtype on one device, that share one slot list, with the
rows as one [F, K, W] tensor; on each family they compute what the
functions above compute. On the card all four launch the kernels of
``paddle_tpu_torch/csrc/embed_cache.cu`` (the single-family ones at F 1),
which read each slot once for every family and write through the caches'
own pointers, as the TPU kernel aliases the cache to its output
(``input_output_aliases={2: 0}``): no [R, W] copy.

The JAX package's three tiers disagree on a negative slot (its
``.at[].set(mode="drop")`` wraps -1 onto row R - 1, the Pallas scatter
writes row 0, the interpret-mode gather reads row R - 1); the cache never
issues one. The port clamps a negative gather slot to row 0 and drops a
negative scatter slot, as the TPU kernel's docstring says. Duplicate
in-range scatter slots within one call are outside the contract (their
order is unspecified), and the cache never issues them.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (any dtype and width: the
kernels copy bytes), which is built on its first launch; anything else
raises. ``LAUNCHES`` counts kernel launches, one a call whatever F is;
only a kernel launch adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

MAX_FAMILIES = 4

LAUNCHES = {"gather_rows": 0, "scatter_rows": 0}

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("embed_cache")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.paddle_cache_gather, lib.paddle_cache_scatter):
            fn.argtypes = [p, i, ll, ll, p, ll, p, p]
            fn.restype = i
        _lib = lib
    return _lib


def _check(cache: torch.Tensor, slots: torch.Tensor):
    if cache.dim() != 2:
        raise ValueError(f"cache must be [R, W], got {tuple(cache.shape)}")
    if cache.shape[0] == 0:
        raise ValueError("empty cache")
    if slots.dim() != 1 or slots.dtype != torch.int32:
        raise ValueError(f"slots must be a 1-D int32 tensor, got "
                         f"{tuple(slots.shape)} {slots.dtype}")


def _check_families(caches: Sequence[torch.Tensor], slots: torch.Tensor):
    if not 1 <= len(caches) <= MAX_FAMILIES:
        raise ValueError(f"takes 1 to {MAX_FAMILIES} caches, got "
                         f"{len(caches)}")
    for c in caches:
        _check(c, slots)
        if c.shape != caches[0].shape or c.dtype != caches[0].dtype:
            raise ValueError(f"the caches differ: {tuple(c.shape)} "
                             f"{c.dtype} against {tuple(caches[0].shape)} "
                             f"{caches[0].dtype}")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _pointers(caches: Sequence[torch.Tensor]):
    if not all(c.is_contiguous() for c in caches):
        raise ValueError("the cache kernels take contiguous caches")
    return (ctypes.c_void_p * len(caches))(*(c.data_ptr() for c in caches))


def _gather(caches: Sequence[torch.Tensor], slots: torch.Tensor
            ) -> torch.Tensor:
    """[F, K, W] from the kernel (CUDA tensors, checked)."""
    if not slots.is_contiguous():
        raise ValueError("gather_rows takes contiguous slots")
    r, w = caches[0].shape
    k = slots.shape[0]
    out = torch.empty((len(caches), k, w), dtype=caches[0].dtype,
                      device=slots.device)
    if k == 0 or w == 0:
        return out
    bases = _pointers(caches)
    with torch.cuda.device(slots.device):
        err = _kernels().paddle_cache_gather(
            bases, len(caches), r, w * caches[0].element_size(),
            slots.data_ptr(), k, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def _scatter(caches: Sequence[torch.Tensor], slots: torch.Tensor,
             rows: torch.Tensor):
    """The kernel's in-place scatter of rows [F, K, W] (CUDA, checked)."""
    if not slots.is_contiguous():
        raise ValueError("scatter_rows takes contiguous slots")
    rows = rows.to(caches[0].dtype).contiguous()
    r, w = caches[0].shape
    k = slots.shape[0]
    if k == 0 or w == 0:
        return
    bases = _pointers(caches)
    with torch.cuda.device(slots.device):
        err = _kernels().paddle_cache_scatter(
            bases, len(caches), r, w * caches[0].element_size(),
            slots.data_ptr(), k, rows.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "scatter_rows")
    LAUNCHES["scatter_rows"] += 1


def gather_rows_ref(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: ``cache[slots.clamp(0, R-1)]``."""
    return cache[slots.long().clamp(0, cache.shape[0] - 1)]


def gather_rows(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """cache [R, W], slots [K] int32 -> [K, W] = cache[min(slot, R - 1)]
    (a negative slot reads row 0)."""
    _check(cache, slots)
    if not _device.uses_kernel(cache, slots):
        return gather_rows_ref(cache, slots)
    return _gather([cache], slots)[0]


def gather_rows_families_ref(caches: Sequence[torch.Tensor],
                             slots: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows_families`: the families' plain
    gathers, stacked."""
    return torch.stack([gather_rows_ref(c, slots) for c in caches])


def gather_rows_families(caches: Sequence[torch.Tensor],
                         slots: torch.Tensor) -> torch.Tensor:
    """F caches [R, W] (one dtype), slots [K] int32 -> [F, K, W], row k of
    family f = caches[f][min(slot_k, R - 1)] (a negative slot reads row
    0); one launch on the card."""
    _check_families(caches, slots)
    if not _device.uses_kernel(*caches, slots):
        return gather_rows_families_ref(caches, slots)
    return _gather(caches, slots)


def scatter_rows_ref(cache: torch.Tensor, slots: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_rows`: ``index_copy_`` over the
    slots in [0, R), in place; returns ``cache``."""
    keep = (slots >= 0) & (slots < cache.shape[0])
    return cache.index_copy_(0, slots[keep].long(),
                             rows[keep].to(cache.dtype))


def scatter_rows(cache: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """cache [R, W], slots [K] int32, rows [K, W] -> ``cache`` itself, with
    cache[slots[k]] = rows[k] for every 0 <= slots[k] < R (in place)."""
    _check(cache, slots)
    if rows.dim() != 2 or rows.shape != (slots.shape[0], cache.shape[1]):
        raise ValueError(f"rows must be [{slots.shape[0]}, {cache.shape[1]}]"
                         f", got {tuple(rows.shape)}")
    if not _device.uses_kernel(cache, slots, rows):
        return scatter_rows_ref(cache, slots, rows)
    _scatter([cache], slots, rows[None])
    return cache


def scatter_rows_families_ref(caches: Sequence[torch.Tensor],
                              slots: torch.Tensor, rows: torch.Tensor):
    """Plain version of :func:`scatter_rows_families`: each family's plain
    scatter of its rows, in place; returns ``caches``."""
    for cache, r in zip(caches, rows):
        scatter_rows_ref(cache, slots, r)
    return caches


def scatter_rows_families(caches: Sequence[torch.Tensor],
                          slots: torch.Tensor, rows: torch.Tensor):
    """F caches [R, W] (one dtype), slots [K] int32, rows [F, K, W] ->
    ``caches`` themselves, with caches[f][slots[k]] = rows[f, k] for every
    0 <= slots[k] < R (in place); one launch on the card."""
    _check_families(caches, slots)
    want = (len(caches), slots.shape[0], caches[0].shape[1])
    if rows.dim() != 3 or tuple(rows.shape) != want:
        raise ValueError(f"rows must be {list(want)}, got "
                         f"{tuple(rows.shape)}")
    if not _device.uses_kernel(*caches, slots, rows):
        return scatter_rows_families_ref(caches, slots, rows)
    _scatter(caches, slots, rows)
    return caches

