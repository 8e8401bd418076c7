"""Page-table K/V row gathers of the paged KV cache: the wrappers of the
CUDA kernels in ``paddle_tpu_torch/csrc/paged_attention.cu`` and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. The decode
step reads each slot's K/V through its page table: logical cache
position ``j`` of slot ``b`` lives at flat pool row
``table[b, j // page_size] * page_size + j % page_size`` of the
``[n_pages * page_size, H * D]`` pool view.

- :func:`gather_rows` -- ``pool[rows]``, rows clamped into ``[0, R-1]``
  (page-table sentinels point past the pool; the attention mask zeroes
  whatever the clamped rows hold).
- :func:`gather_rows_dequant` -- the int8 codec read: code rows times
  one fp32 scale per (row, head), as fp32.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel, which is built on its first
launch. ``LAUNCHES`` counts kernel launches per wrapper; only a kernel
launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"gather_rows": 0, "gather_rows_dequant": 0}

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.paddle_gather_rows.argtypes = [p, ll, ll, p, ll, p, p]
        lib.paddle_gather_rows.restype = i
        lib.paddle_gather_rows_dequant.argtypes = [p, p, ll, i, i, p, ll,
                                                   p, p]
        lib.paddle_gather_rows_dequant.restype = i
        _lib = lib
    return _lib


def _check_rows(rows: torch.Tensor):
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be a 1-D int32 tensor, got "
                         f"{tuple(rows.shape)} {rows.dtype}")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def gather_rows_ref(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version: pool [R, W] (any dtype), rows [K] int ->
    [K, W] = pool[clamp(rows, 0, R-1)]."""
    return pool[rows.long().clamp(0, pool.shape[0] - 1)]


def gather_rows(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pool [R, W] fp32/bf16 (any dtype: the kernel copies bytes), rows
    [K] int32 -> [K, W] = pool[clamp(rows, 0, R-1)]."""
    _check_rows(rows)
    if pool.dim() != 2:
        raise ValueError(f"pool must be [R, W], got {tuple(pool.shape)}")
    if not _device.uses_kernel(pool, rows):
        return gather_rows_ref(pool, rows)
    if not (pool.is_contiguous() and rows.is_contiguous()):
        raise ValueError("gather_rows takes contiguous tensors")
    r, w = pool.shape
    k = rows.shape[0]
    out = torch.empty((k, w), dtype=pool.dtype, device=pool.device)
    if k == 0 or w == 0:
        return out
    if r == 0:
        raise ValueError("gather_rows from an empty pool")
    with torch.cuda.device(pool.device):
        err = _kernels().paddle_gather_rows(
            pool.data_ptr(), r, w * pool.element_size(), rows.data_ptr(),
            k, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_rows_dequant_ref(pool: torch.Tensor, scales: torch.Tensor,
                            rows: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version: pool [R, H*Dk] int8 codes, scales [R, H] fp32,
    rows [K] int -> [K, H*Dk] fp32 = codes[r] * scales[r] per head,
    r = clamp(rows, 0, R-1)."""
    r, w = pool.shape
    idx = rows.long().clamp(0, r - 1)
    codes = pool[idx].to(torch.float32).view(-1, heads, w // heads)
    return (codes * scales[idx][:, :, None]).view(-1, w)


def gather_rows_dequant(pool: torch.Tensor, scales: torch.Tensor,
                        rows: torch.Tensor, heads: int) -> torch.Tensor:
    """pool [R, H*Dk] int8, scales [R, H] fp32, rows [K] int32 ->
    [K, H*Dk] fp32, the dequantizing gather of ``kv_codec="int8"``."""
    _check_rows(rows)
    if pool.dim() != 2 or pool.dtype != torch.int8:
        raise ValueError(f"pool must be [R, W] int8, got "
                         f"{tuple(pool.shape)} {pool.dtype}")
    r, w = pool.shape
    if heads < 1 or w % heads:
        raise ValueError(f"row width {w} not divisible by heads {heads}")
    if scales.shape != (r, heads) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be [{r}, {heads}] fp32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if not _device.uses_kernel(pool, scales, rows):
        return gather_rows_dequant_ref(pool, scales, rows, heads)
    if not (pool.is_contiguous() and scales.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("gather_rows_dequant takes contiguous tensors")
    k = rows.shape[0]
    out = torch.empty((k, w), dtype=torch.float32, device=pool.device)
    if k == 0 or w == 0:
        return out
    if r == 0:
        raise ValueError("gather_rows_dequant from an empty pool")
    with torch.cuda.device(pool.device):
        err = _kernels().paddle_gather_rows_dequant(
            pool.data_ptr(), scales.data_ptr(), r, w, heads,
            rows.data_ptr(), k, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "gather_rows_dequant")
    LAUNCHES["gather_rows_dequant"] += 1
    return out
