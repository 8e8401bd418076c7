"""Fused vocabulary projection + label-smoothed softmax cross entropy: the
wrappers of the CUDA kernels in ``paddle_tpu_torch/csrc/fused_ce.cu``,
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``:

- :func:`fused_ce_fwd` -- ``_fwd`` (``:173``): x [N,D] @ w [D,V] with the
  log-sum-exp taken over vocab chunks -> (loss [N], lse [N]) fp32, the
  closed form of ``_fwd_kernel`` (``:82-86``): ``lse - (1 - eps) * z_label
  - eps * sum(z) / V``, rows whose label is ``ignore_index`` at 0.
- :func:`fused_ce_dx` and :func:`fused_ce_dw` -- the TPU's one backward
  kernel (``_vjp_bwd``, ``:222``) as two: dx [N,D] and dW [D,V] from x, w,
  labels, lse and a per-row cotangent g, through ``_dlogits`` (``:90``).
  The TPU kernel carries dx across its sequential vocab axis and writes
  per-row-block dW partials; Hopper blocks run in no order, so a dx block
  owns rows and a dW block owns vocab columns, each recomputing its z.
- :class:`FusedLinearCE` and :func:`fused_linear_ce` -- ``fused_linear_ce``
  (``:208``), loss [N, 1], differentiable in x and w.

The [N, V] logits never reach device memory on the kernel path. The plain
versions materialize them: they are for the CPU and for the comparisons.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32, contiguous, any D: rows
wider than 512 run in chunks of 512 inside the kernels), which is built on
its first launch; anything else raises. ``LAUNCHES``
counts kernel launches per wrapper; only a kernel launch adds to it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"fused_ce_fwd": 0, "fused_ce_dx": 0, "fused_ce_dw": 0}
ROWS_PER_BLOCK = 32                # kP of the kernels
COLS_PER_CHUNK = 64                # kQ of the kernels

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("fused_ce")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_fused_ce_fwd.argtypes = [p] * 6 + [i] * 4 + [f] * 3 + [
            i, p]
        for fn in (lib.paddle_fused_ce_dx, lib.paddle_fused_ce_dw):
            fn.argtypes = [p] * 6 + [i] * 3 + [f] * 2 + [i, p]
        for fn in (lib.paddle_fused_ce_fwd, lib.paddle_fused_ce_dx,
                   lib.paddle_fused_ce_dw):
            fn.restype = i
        _lib = lib
    return _lib


def _consts(eps: float, v: int):
    """The float32 constants of the TPU kernel's formulas, rounded from
    double as the JAX function's Python floats are: ``1 - eps``, ``eps``,
    ``eps / V`` and ``V``."""
    f32 = np.float32
    return (float(f32(1.0 - eps)), float(f32(eps)), float(f32(eps / v)),
            float(f32(v)))


# -- plain versions ----------------------------------------------------------

def _label_logit(z, labels):
    """z[r, labels[r]], 0 where the label is outside [0, V) (the TPU
    kernel's label column then never matches)."""
    v = z.shape[1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    picked = z.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(inside, picked, torch.zeros_like(picked))


def fused_ce_fwd_ref(x, w, labels, eps: float = 0.0,
                     ignore_index: int = -100):
    """Plain version of :func:`fused_ce_fwd`: the whole [N, V] logits."""
    on, eps_f, _, vocab = _consts(eps, w.shape[1])
    z = torch.matmul(x, w).to(torch.float32)
    m = z.amax(dim=1, keepdim=True)
    lse = (m + torch.log(torch.exp(z - m).sum(dim=1, keepdim=True)
                         .clamp_min(1e-30)))[:, 0]
    loss = lse - on * _label_logit(z, labels) - eps_f * z.sum(dim=1) / vocab
    return torch.where(labels == ignore_index, torch.zeros_like(loss),
                       loss), lse


def fused_ce_bwd_ref(x, w, labels, lse, g, eps: float = 0.0,
                     ignore_index: int = -100):
    """Plain version of :func:`fused_ce_dx` and :func:`fused_ce_dw`:
    (dx, dW) through the whole [N, V] dlogits."""
    on, _, off, _ = _consts(eps, w.shape[1])
    z = torch.matmul(x, w).to(torch.float32)
    cols = torch.arange(w.shape[1], device=z.device)
    t = torch.where(cols[None, :] == labels.long()[:, None], on, 0.0) + off
    dz = (torch.exp(z - lse[:, None]) - t) * g[:, None]
    dz = torch.where((labels == ignore_index)[:, None], torch.zeros_like(dz),
                     dz)
    return torch.matmul(dz, w.t()), torch.matmul(x.t(), dz)


# -- wrappers ----------------------------------------------------------------

def _check_shapes(x, w, labels, *rows):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x [N,D] and w [D,V], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    n, d = x.shape
    v = w.shape[1]
    if n == 0 or d == 0 or v == 0:
        raise ValueError(f"empty product {tuple(x.shape)} x {tuple(w.shape)}")
    if labels.shape != (n,):
        raise ValueError(f"want labels [{n}], got {tuple(labels.shape)}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"labels must be integers, got {labels.dtype}")
    for r in rows:
        if r.shape != (n,):
            raise ValueError(f"lse and g must be [{n}], got "
                             f"{tuple(r.shape)}")
    return n, d, v


def _check_kernel_args(name, tensors, ignore_index):
    """What the kernels take: fp32, contiguous, an int32 ignore_index."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if not -2 ** 31 <= ignore_index < 2 ** 31:
        raise ValueError(f"{name}: ignore_index {ignore_index} is not int32")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _labels32(labels):
    return labels.to(torch.int32).contiguous()


def vocab_splits(n: int, v: int, sms: int) -> int:
    """How many blocks share one row tile's vocabulary in the forward: as
    many as keep every SM busy when the row tiles alone cannot, never
    more than the vocab chunks."""
    tiles = -(-n // ROWS_PER_BLOCK)
    chunks = -(-v // COLS_PER_CHUNK)
    return max(1, min(chunks, sms // tiles))


def fused_ce_fwd(x, w, labels, eps: float = 0.0, ignore_index: int = -100):
    """x [N,D], w [D,V], labels [N] int -> (loss [N], lse [N]) fp32."""
    n, d, v = _check_shapes(x, w, labels)
    if not _device.uses_kernel(x, w, labels):
        return fused_ce_fwd_ref(x, w, labels, eps, ignore_index)
    _check_kernel_args("fused_ce_fwd", (x, w), ignore_index)
    on, eps_f, _, vocab = _consts(eps, v)
    lab = _labels32(labels)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = vocab_splits(n, v, sms)
    part = torch.empty((4, splits, n), dtype=torch.float32, device=x.device)
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(x.device):
        err = _kernels().paddle_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), lab.data_ptr(), part.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), n, d, v, splits, on, eps_f,
            vocab, int(ignore_index), torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "fused_ce_fwd")
    LAUNCHES["fused_ce_fwd"] += 1
    return loss, lse


def _bwd(name, x, w, labels, lse, g, eps, ignore_index):
    """dx (``fused_ce_dx``) or dW (``fused_ce_dw``): the kernel on CUDA
    tensors, its share of :func:`fused_ce_bwd_ref` on CPU tensors."""
    n, d, v = _check_shapes(x, w, labels, lse, g)
    if not _device.uses_kernel(x, w, labels, lse, g):
        ref = fused_ce_bwd_ref(x, w, labels, lse, g, eps, ignore_index)
        return ref[0] if name == "fused_ce_dx" else ref[1]
    _check_kernel_args(name, (x, w, lse, g), ignore_index)
    on, _, off, _ = _consts(eps, v)
    out = torch.empty_like(x if name == "fused_ce_dx" else w)
    fn = getattr(_kernels(), f"paddle_{name}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), _labels32(labels).data_ptr(),
                 lse.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, v, on,
                 off, int(ignore_index),
                 torch.cuda.current_stream().cuda_stream)
    _check_launch(err, name)
    LAUNCHES[name] += 1
    return out


def fused_ce_dx(x, w, labels, lse, g, eps: float = 0.0,
                ignore_index: int = -100):
    """dx [N,D] of sum(g * loss) from x, w, labels, lse [N] and g [N]."""
    return _bwd("fused_ce_dx", x, w, labels, lse, g, eps, ignore_index)


def fused_ce_dw(x, w, labels, lse, g, eps: float = 0.0,
                ignore_index: int = -100):
    """dW [D,V] of sum(g * loss) from the same inputs as
    :func:`fused_ce_dx`."""
    return _bwd("fused_ce_dw", x, w, labels, lse, g, eps, ignore_index)


class FusedLinearCE(torch.autograd.Function):
    """loss [N, 1] = fused CE of x @ w; the forward runs
    :func:`fused_ce_fwd` and saves (x, w, labels, lse), the residuals of
    ``_vjp_fwd`` (``:217-219``); the backward runs :func:`fused_ce_dx` and
    :func:`fused_ce_dw`. The labels get no gradient."""

    @staticmethod
    def forward(ctx, x, w, labels, eps, ignore_index):
        loss, lse = fused_ce_fwd(x, w, labels, eps, ignore_index)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.args = (eps, ignore_index)
        return loss[:, None]

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        g = g.reshape(-1).to(torch.float32).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fused_ce_dx(x, w, labels, lse, g, *ctx.args)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_dw(x, w, labels, lse, g, *ctx.args)
        return dx, dw, None, None, None


def fused_linear_ce(x, w, labels, label_smoothing: float = 0.0,
                    ignore_index: int = -100) -> torch.Tensor:
    """x [N, D] @ w [D, V] -> label-smoothed softmax CE loss [N, 1]
    without materializing the [N, V] logits on the card; ``labels`` [N]
    (or [N, 1]) integers."""
    return FusedLinearCE.apply(x.contiguous(), w.contiguous(),
                               labels.reshape(-1), float(label_smoothing),
                               int(ignore_index))
