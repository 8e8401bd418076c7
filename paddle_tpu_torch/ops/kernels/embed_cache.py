"""Row gather and in-place row scatter of the hot-rows embedding cache:
the wrappers of the CUDA kernels and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/embed_cache.py``:

- :func:`gather_rows` -- ``gather_rows`` (``:58``): cache [R, W], slots
  [K] int32 -> [K, W] = ``cache[min(slot, R - 1)]`` (the write-back read:
  dirty rows lifted off the card before a push to their shard). On the
  card it launches ``paddle_gather_rows`` of
  ``paddle_tpu_torch/csrc/paged_attention.cu``, the page gather, whose
  clamp into [0, R - 1] is the same function on the slots >= 0 that the
  cache issues; the port keeps one gather kernel, counted here apart.
- :func:`scatter_rows` -- ``scatter_rows`` (``:110``): ``cache[slots[k]]
  = rows[k]`` IN PLACE for 0 <= slot < R, every other slot dropped (the
  cache's power-of-two bucket padding points at R + 1); returns ``cache``
  itself. The kernel (``paddle_tpu_torch/csrc/embed_cache.cu``) writes
  through the cache tensor's own pointer, as the TPU kernel aliases the
  cache to its output (``input_output_aliases={2: 0}``): no [R, W] copy.

The JAX package's three tiers disagree on a negative slot (its
``.at[].set(mode="drop")`` wraps -1 onto row R - 1, the Pallas scatter
writes row 0, the interpret-mode gather reads row R - 1); the cache never
issues one. The port clamps a negative gather slot to row 0, as the page
gather does, and drops a negative scatter slot, as the TPU kernel's
docstring says. Duplicate in-range scatter slots within one call are
outside the contract (their order is unspecified), and the cache never
issues them.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (any dtype and width: the
kernels copy bytes), which is built on its first launch; anything else
raises. ``LAUNCHES`` counts kernel launches per wrapper; only a kernel
launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build
from paddle_tpu_torch.ops.kernels import paged_attention as _pa

LAUNCHES = {"gather_rows": 0, "scatter_rows": 0}

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("embed_cache")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.paddle_scatter_rows.argtypes = [p, ll, ll, p, ll, p, p]
        lib.paddle_scatter_rows.restype = ctypes.c_int
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


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def gather_rows_ref(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`: ``cache[slots.clamp(0, R-1)]``."""
    return cache[slots.long().clamp(0, cache.shape[0] - 1)]


def gather_rows(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """cache [R, W], slots [K] int32 -> [K, W] = cache[min(slot, R - 1)]
    (a negative slot reads row 0)."""
    _check(cache, slots)
    if not _device.uses_kernel(cache, slots):
        return gather_rows_ref(cache, slots)
    if not (cache.is_contiguous() and slots.is_contiguous()):
        raise ValueError("gather_rows takes contiguous tensors")
    r, w = cache.shape
    k = slots.shape[0]
    out = torch.empty((k, w), dtype=cache.dtype, device=cache.device)
    if k == 0 or w == 0:
        return out
    with torch.cuda.device(cache.device):
        err = _pa._kernels().paddle_gather_rows(
            cache.data_ptr(), r, w * cache.element_size(), slots.data_ptr(),
            k, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


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
    if not (cache.is_contiguous() and slots.is_contiguous()):
        raise ValueError("scatter_rows takes a contiguous cache and slots")
    rows = rows.to(cache.dtype).contiguous()
    r, w = cache.shape
    k = slots.shape[0]
    if k == 0 or w == 0:
        return cache
    with torch.cuda.device(cache.device):
        err = _kernels().paddle_scatter_rows(
            cache.data_ptr(), r, w * cache.element_size(), slots.data_ptr(),
            k, rows.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "scatter_rows")
    LAUNCHES["scatter_rows"] += 1
    return cache
