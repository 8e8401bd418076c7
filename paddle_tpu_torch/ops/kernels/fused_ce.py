"""Fused vocabulary projection + label-smoothed softmax cross entropy: the
wrappers of the CUDA kernels in ``paddle_tpu_torch/csrc/fused_ce.cu``,
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``:

- :func:`fused_ce_fwd` -- ``_fwd`` (``:173``): x [N,D] @ w [D,V] with the
  log-sum-exp taken over vocab tiles -> (loss [N], lse [N]) fp32, the
  closed form of ``_fwd_kernel`` (``:82-86``): ``lse - (1 - eps) * z_label
  - eps * sum(z) / V``, rows whose label is ``ignore_index`` at 0.
- :func:`fused_ce_bwd` -- the TPU's one backward kernel (``_vjp_bwd``,
  ``:222``): (dx [N,D], dW [D,V]) from x, w, labels, lse and a per-row
  cotangent g, through ``_dlogits`` (``:90``), from one recompute of z.
  :func:`fused_ce_dx` and :func:`fused_ce_dw` run the same pass for one
  of the two.
- :class:`FusedLinearCE` and :func:`fused_linear_ce` -- ``fused_linear_ce``
  (``:208``), loss [N, 1], differentiable in x and w.

x and w are fp32, bf16 or fp16, as in the JAX function: z is summed in
fp32 from the promoted operands (``preferred_element_type``), loss and
lse are fp32, dz is rounded to x's dtype where that is narrower than
fp32 (``dz.astype(x.dtype)``, ``:125``) for the two gradient products,
which are summed in fp32 and returned in x's and w's dtype (``:260``).
On the card a mixed pair (bf16 or fp16 beside fp32, or bf16 beside
fp16) widens its narrower operand to fp32 (exact) and runs the fp32
path, whose dz launch rounds dz to x's dtype when x is the narrower.

The [N, V] logits never reach device memory on the kernel path. The plain
versions materialize them: they are for the CPU and for the comparisons.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32, bf16 or fp16,
contiguous, any N, D and V), which is built on its first launch;
anything else raises. ``LAUNCHES`` counts kernel launches per wrapper
(``fused_ce_dx`` and ``fused_ce_dw`` count as ``fused_ce_bwd``); only a
kernel launch adds to it.

Kernel path: each call first copies its operands K-major (transposed
where a product needs it), rows padded to 16 bytes, fp32 split into its
TF32 halves (:func:`split_tf32` is that split's plain version): x and
w^T for the forward, and for the backward also w (for dx) and x^T (for
dW). The backward walks the vocabulary in slabs of :data:`SLAB_COLS`
columns, keeping one slab's dz (in two layouts) as scratch. Scratch at
Transformer-base's head (N 4096, D 512, V 32000, fp32): the operand
copies 2 x (8.4 + 65.5) MB in the forward and 2 x (16.8 + 131) MB in the
backward, dz 4 x 33.6 MB and dW's partial planes 8.4 MB; half of each
copy for bf16 and fp16 (no lo half), which keep dx's fp32 sum in 8.4 MB
more.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILE = 128                         # rows of x, columns of w, a block's tile
# vocab columns of one backward slab (dz, then dx and dW from it): chosen
# by tools/fused_ce_slab_sweep.py on an H100 (PERF.md)
SLAB_COLS = 2048

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("fused_ce")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_fused_ce_prep.argtypes = [i, p, i, i, p, p, i, i, p]
        lib.paddle_fused_ce_fwd.argtypes = (
            [i] + [p, p, i] * 2 + [p] * 4 + [i] * 4 + [f] * 3 + [i, p])
        lib.paddle_fused_ce_bwd.argtypes = (
            [i] + [p, p, i] * 4 + [p] * 3 + [p] * 4 + [i] + [p] * 4
            + [i] * 5 + [f] * 2 + [i, i, p])
        for fn in (lib.paddle_fused_ce_prep, lib.paddle_fused_ce_fwd,
                   lib.paddle_fused_ce_bwd):
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


def padded_ld(cols: int, dtype: torch.dtype) -> int:
    """Values in a row of an operand copy: ``cols`` rounded up to 16
    bytes, the stride TMA takes."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-cols // per) * per


def dw_chunks(n: int, vs: int) -> int:
    """The chunks of N that the backward's dW tiles split into, each as
    deep as a slab is wide (so every tile of its launch does the same
    work): the planes of its partial sums."""
    return -(-n // vs)


def vocab_splits(n: int, v: int, sms: int) -> int:
    """How many blocks share one row tile's vocabulary in the forward: as
    many as keep every SM busy when the row tiles alone cannot, never
    more than the vocab tiles."""
    tiles = -(-n // TILE)
    chunks = -(-v // TILE)
    return max(1, min(chunks, sms // tiles))


# -- plain versions ----------------------------------------------------------

def split_tf32(a: torch.Tensor):
    """Plain version of the prep kernel's fp32 split: (hi, lo) with hi = a
    rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    ``cvt.rna.tf32.f32``) and lo = a - hi rounded the same way, so that
    ``|a - hi - lo| <= 2**-22 * |a|``. Non-finite values pass through as
    hi with lo 0."""
    if a.dtype != torch.float32:
        raise ValueError(f"split_tf32 takes float32, got {a.dtype}")

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(t), r, t)
    hi = rna(a)
    lo = torch.where(torch.isfinite(a), rna(a - hi), torch.zeros_like(a))
    return hi, lo


def _label_logit(z, labels):
    """z[r, labels[r]], 0 where the label is outside [0, V) (the TPU
    kernel's label column then never matches)."""
    v = z.shape[1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    picked = z.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(inside, picked, torch.zeros_like(picked))


def _wide(t):
    """An operand as the products sum it: 16-bit floats in fp32 (their
    products are exact there), fp32 and fp64 as they are."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def _promoted(x, w):
    """x and w as the products sum them, in one dtype: the wider of the
    two after :func:`_wide` (fp32 unless one is fp64)."""
    x, w = _wide(x), _wide(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _logits(x, w):
    return torch.matmul(*_promoted(x, w)).to(torch.float32)


def fused_ce_fwd_ref(x, w, labels, eps: float = 0.0,
                     ignore_index: int = -100):
    """Plain version of :func:`fused_ce_fwd`: the whole [N, V] logits."""
    on, eps_f, _, vocab = _consts(eps, w.shape[1])
    z = _logits(x, w)
    m = z.amax(dim=1, keepdim=True)
    lse = (m + torch.log(torch.exp(z - m).sum(dim=1, keepdim=True)
                         .clamp_min(1e-30)))[:, 0]
    loss = lse - on * _label_logit(z, labels) - eps_f * z.sum(dim=1) / vocab
    return torch.where(labels == ignore_index, torch.zeros_like(loss),
                       loss), lse


def fused_ce_bwd_ref(x, w, labels, lse, g, eps: float = 0.0,
                     ignore_index: int = -100):
    """Plain version of :func:`fused_ce_bwd`: (dx, dW) through the whole
    [N, V] dlogits, rounded to x's dtype for the products, returned in
    x's and w's dtype."""
    on, _, off, _ = _consts(eps, w.shape[1])
    z = _logits(x, w)
    cols = torch.arange(w.shape[1], device=z.device)
    t = torch.where(cols[None, :] == labels.long()[:, None], on, 0.0) + off
    dz = (torch.exp(z - lse[:, None]) - t) * g[:, None]
    dz = torch.where((labels == ignore_index)[:, None], torch.zeros_like(dz),
                     dz)
    if x.dtype not in (torch.float32, torch.float64):
        dz = dz.to(x.dtype)
    xp, wp = _promoted(x, w)
    dz = dz.to(xp.dtype)
    return (torch.matmul(dz, wp.t()).to(x.dtype),
            torch.matmul(xp.t(), dz).to(w.dtype))


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


def _check_kernel_args(name, x, w, rows, ignore_index) -> int:
    """What the kernels take: x and w fp32, bf16 or fp16, lse and g fp32,
    all contiguous, an int32 ignore_index. Returns the operand kind."""
    for t in (x, w):
        if t.dtype not in KINDS:
            raise ValueError(f"{name}: the kernel takes float32, bfloat16 "
                             f"or float16, got {t.dtype}")
    for t in rows:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and g must be float32, got "
                             f"{t.dtype}")
    for t in (x, w, *rows):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if not -2 ** 31 <= ignore_index < 2 ** 31:
        raise ValueError(f"{name}: ignore_index {ignore_index} is not int32")
    return KINDS[x.dtype]


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _labels32(labels):
    return labels.to(torch.int32).contiguous()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def _widened(x, w):
    """A mixed pair as the fp32 path takes it: each operand in fp32
    (exact from bf16 and fp16), contiguous."""
    return x.float().contiguous(), w.float().contiguous()


def prepare(t: torch.Tensor, transpose: bool):
    """The prep kernel: a K-major copy of the contiguous matrix ``t`` (of
    its transpose with ``transpose``), rows padded to 16 bytes, as
    (hi, lo, ld); lo is None for bf16 and fp16."""
    kind = KINDS[t.dtype]
    rows, cols = t.shape
    out_rows, out_cols = (cols, rows) if transpose else (rows, cols)
    ld = padded_ld(out_cols, t.dtype)
    hi = torch.empty((out_rows, ld), dtype=t.dtype, device=t.device)
    lo = torch.empty_like(hi) if kind == 0 else None
    with torch.cuda.device(t.device):
        err = _kernels().paddle_fused_ce_prep(
            kind, t.data_ptr(), rows, cols, hi.data_ptr(), _ptr(lo), ld,
            int(transpose), _stream())
    _check_launch(err, "fused_ce prep")
    return hi, lo, ld


def fused_ce_fwd(x, w, labels, eps: float = 0.0, ignore_index: int = -100):
    """x [N,D], w [D,V], labels [N] int -> (loss [N], lse [N]) fp32."""
    n, d, v = _check_shapes(x, w, labels)
    if not _device.uses_kernel(x, w, labels):
        return fused_ce_fwd_ref(x, w, labels, eps, ignore_index)
    kind = _check_kernel_args("fused_ce_fwd", x, w, (), ignore_index)
    if x.dtype != w.dtype:
        (x, w), kind = _widened(x, w), 0
    on, eps_f, _, vocab = _consts(eps, v)
    lab = _labels32(labels)
    splits = vocab_splits(n, v, _sms(x.device))
    xo, wt = prepare(x, False), prepare(w, True)
    part = torch.empty((4, splits, n), dtype=torch.float32, device=x.device)
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(x.device):
        err = _kernels().paddle_fused_ce_fwd(
            kind, _ptr(xo[0]), _ptr(xo[1]), xo[2], _ptr(wt[0]), _ptr(wt[1]),
            wt[2], lab.data_ptr(), part.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), n, d, v, splits, on, eps_f, vocab,
            int(ignore_index), _stream())
    _check_launch(err, "fused_ce_fwd")
    LAUNCHES["fused_ce_fwd"] += 1
    return loss, lse


def fused_ce_bwd(x, w, labels, lse, g, eps: float = 0.0,
                 ignore_index: int = -100, dx: bool = True,
                 dw: bool = True):
    """(dx [N,D], dW [D,V]) of sum(g * loss) from x, w, labels, lse [N]
    and g [N], from one pass; ``dx=False`` / ``dw=False`` leaves that one
    out (None)."""
    n, d, v = _check_shapes(x, w, labels, lse, g)
    if not (dx or dw):
        raise ValueError("fused_ce_bwd: nothing to compute")
    if not _device.uses_kernel(x, w, labels, lse, g):
        gx, gw = fused_ce_bwd_ref(x, w, labels, lse, g, eps, ignore_index)
        return gx if dx else None, gw if dw else None
    kind = _check_kernel_args("fused_ce_bwd", x, w, (lse, g), ignore_index)
    x_dtype, w_dtype, dz_round = x.dtype, w.dtype, 0
    if x_dtype != w_dtype:
        if x_dtype != torch.float32:
            dz_round = KINDS[x_dtype]           # 1 bf16, 2 fp16
        (x, w), kind = _widened(x, w), 0
    on, _, off, _ = _consts(eps, v)
    vs, dev = SLAB_COLS, x.device
    xo, wt = prepare(x, False), prepare(w, True)
    wo = prepare(w, False) if dx else (None, None, 0)
    xt = prepare(x, True) if dw else (None, None, 0)
    ldn = padded_ld(n, x.dtype)

    def scratch(shape, wanted):     # (hi, lo) of a dz layout
        if not wanted:
            return None, None
        hi = torch.empty(shape, dtype=x.dtype, device=dev)
        return hi, torch.empty_like(hi) if kind == 0 else None
    dz, dzt = scratch((n, vs), dx), scratch((vs, ldn), dw)
    part = torch.empty((dw_chunks(n, vs), d, vs), dtype=torch.float32,
                       device=dev) if dw else None
    gx = torch.empty_like(x) if dx else None
    acc = None
    if dx:
        acc = gx if kind == 0 else torch.empty((n, d), dtype=torch.float32,
                                               device=dev)
    gw = torch.empty_like(w) if dw else None
    with torch.cuda.device(dev):
        err = _kernels().paddle_fused_ce_bwd(
            kind, _ptr(xo[0]), _ptr(xo[1]), xo[2], _ptr(wt[0]), _ptr(wt[1]),
            wt[2], _ptr(wo[0]), _ptr(wo[1]), wo[2], _ptr(xt[0]),
            _ptr(xt[1]), xt[2], _labels32(labels).data_ptr(),
            lse.data_ptr(), g.data_ptr(), _ptr(dz[0]), _ptr(dz[1]),
            _ptr(dzt[0]), _ptr(dzt[1]), ldn, _ptr(part), _ptr(acc),
            _ptr(gx), _ptr(gw), n, d, v, vs, _sms(dev), on, off,
            int(ignore_index), dz_round, _stream())
    _check_launch(err, "fused_ce_bwd")
    LAUNCHES["fused_ce_bwd"] += 1
    return (None if gx is None else gx.to(x_dtype),
            None if gw is None else gw.to(w_dtype))


def fused_ce_dx(x, w, labels, lse, g, eps: float = 0.0,
                ignore_index: int = -100):
    """dx [N,D] of sum(g * loss): :func:`fused_ce_bwd` without dW."""
    return fused_ce_bwd(x, w, labels, lse, g, eps, ignore_index, dw=False)[0]


def fused_ce_dw(x, w, labels, lse, g, eps: float = 0.0,
                ignore_index: int = -100):
    """dW [D,V] of sum(g * loss): :func:`fused_ce_bwd` without dx."""
    return fused_ce_bwd(x, w, labels, lse, g, eps, ignore_index, dx=False)[1]


class FusedLinearCE(torch.autograd.Function):
    """loss [N, 1] = fused CE of x @ w; the forward runs
    :func:`fused_ce_fwd` and saves (x, w, labels, lse), the residuals of
    ``_vjp_fwd`` (``:217-219``); the backward runs :func:`fused_ce_bwd`
    once for the gradients asked for, in x's and w's dtype. The labels get
    no gradient."""

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
        dx, dw = fused_ce_bwd(x, w, labels, lse, g, *ctx.args,
                              dx=ctx.needs_input_grad[0],
                              dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None


def fused_linear_ce(x, w, labels, label_smoothing: float = 0.0,
                    ignore_index: int = -100) -> torch.Tensor:
    """x [N, D] @ w [D, V] -> label-smoothed softmax CE loss [N, 1]
    without materializing the [N, V] logits on the card; ``labels`` [N]
    (or [N, 1]) integers."""
    return FusedLinearCE.apply(x.contiguous(), w.contiguous(),
                               labels.reshape(-1), float(label_smoothing),
                               int(ignore_index))
