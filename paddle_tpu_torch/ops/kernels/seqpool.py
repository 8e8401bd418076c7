"""Masked sequence pool (SUM, AVERAGE, SQRT): the wrapper of the CUDA
kernel in ``paddle_tpu_torch/csrc/seqpool.cu``, its plain PyTorch
version, and the ``torch.autograd.Function`` around them.

Counterpart of ``paddle_tpu/ops/pallas/seqpool.py``:

- :func:`masked_seqpool_fwd` -- ``_masked_seqpool_impl`` (``:79``): x
  [B,T,D] and lens [B] -> [B,D], the fp32 sum over t < lens[b], divided
  by ``max(n, 1)`` (AVERAGE) or ``sqrt(max(n, 1))`` (SQRT).
- :func:`masked_seqpool_bwd` -- ``_seqpool_bwd`` (``:59-73``), in torch as
  there: the output gradient broadcast over T, divided as the forward
  divides, and masked past each length.
- :class:`MaskedSeqPool` and :func:`masked_seqpool` -- ``masked_seqpool``
  (``:48``), differentiable in x.

The TPU kernel also has a MAX branch, which no caller routes to it
(``paddle_tpu/ops/sequence_ops.py:69``) and which has no VJP; MAX, LAST
and FIRST stay in torch (``paddle_tpu_torch/ops/sequence_ops.py``).

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (any B, T and D), which is built
on its first launch; anything else raises. ``LAUNCHES`` counts kernel
launches; only a kernel launch adds to it.

The kernel splits each row's T steps across the warps of one block
(:func:`pool_warps`, the plan it shares with the embedding gather + pool),
each warp summing a contiguous chunk of :func:`pool_chunk` steps in
increasing t, and adds the warps' sums in warp order: an fp32 (fp64,
int64) sum of the same terms in another order than the plain version's.

The kernel takes every dtype the JAX op's refer branch pools
(:func:`kernel_operand`): fp32, fp64, fp16 and bf16 as they are, summed in
fp32 (fp64 for fp64); integers and bool summed in int64, as ``torch.sum``
widens them, their AVERAGE and SQRT that sum divided by the length cast to
x's type (fp32, as the plain version divides); complex x as its real view
of twice the width, which pools the two parts apart, exactly. Unsigned
integers (uint16, uint32, uint64) are summed as the int64 of their bits,
exact modulo 2**64, and pool to uint64 (the reference's own unsigned
type is uint32 without x64); their AVERAGE and SQRT are fp32, as the
reference's. Float8 (e4m3fn, e5m2, e4m3fnuz, e5m2fnuz) is summed in fp32 with every partial
sum rounded to the float8 type, in t order, as the reference's float8
sum on the CPU rounds it (an fp32 sum rounded once differs from it in
about half of the elements), and pools to the same float8 type; its
AVERAGE and SQRT divide by the length rounded to float8 (its root
rounded again) and round the quotient once (:func:`masked_sum`,
:func:`divided`).
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"seqpool": 0}
MODES = {"SUM": 0, "AVERAGE": 1, "SQRT": 2}
# the element types of csrc/pool_elem.cuh, by their codes there
DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.bfloat16: 3, torch.int64: 4, torch.float8_e4m3fn: 5,
          torch.float8_e5m2: 6, torch.float8_e4m3fnuz: 7,
          torch.float8_e5m2fnuz: 8}
FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e4m3fnuz,
          torch.float8_e5m2fnuz)
UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
MAX_WARPS = 8                       # warps of a block, all on one row
STEPS_PER_WARP = 12                 # the least chunk of t worth a warp
ORDERED_CODES = (5, 6, 7, 8)        # float8 dtype codes: t order

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("seqpool")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paddle_seqpool.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.paddle_seqpool.restype = i
        _lib = lib
    return _lib


def pool_warps(t: int, code: int) -> int:
    """The warps that share one row's T steps in the pooling kernels
    (this module's and the embedding gather + pool's): enough that none
    walks more than about ``STEPS_PER_WARP`` of them, at most
    ``MAX_WARPS``; 1 for the float8 types (``ORDERED_CODES``), whose sum
    is taken in t order."""
    if code in ORDERED_CODES:
        return 1
    return max(1, min(MAX_WARPS, -(-t // STEPS_PER_WARP)))


def pool_chunk(t: int, warps: int) -> int:
    """The steps of t that each of ``warps`` warps sums: warp k takes
    [k c, (k + 1) c), cut at the row's length."""
    return -(-t // warps)


def _mode(pooltype: str) -> str:
    ptype = str(pooltype).upper()
    if ptype not in MODES:
        raise ValueError(f"masked_seqpool pools {sorted(MODES)}, got "
                         f"{pooltype!r}")
    return ptype


def _divisor(lens, ptype, like):
    """[B, 1] ``max(n, 1)`` (AVERAGE) or its square root (SQRT); None for
    SUM. For float8 and unsigned ``like`` an fp32 tensor: the length
    rounded to float8 (and its root rounded again), or the length as an
    unsigned value."""
    if ptype == "SUM":
        return None
    if like.dtype in FLOAT8 + UNSIGNED:
        denom = lens.reshape(-1, 1).to(like.dtype).to(torch.float32)
        if like.dtype in FLOAT8:
            denom = denom.clamp_min(1.0)
            return denom if ptype == "AVERAGE" else \
                torch.sqrt(denom).to(like.dtype).to(torch.float32)
        denom = denom.clamp_min(1.0)
        return denom if ptype == "AVERAGE" else torch.sqrt(denom)
    # the length cast to x's type, then at least 1 (jnp.maximum), also for
    # the complex and bool types that clamp_min does not take
    denom = lens.reshape(-1, 1).to(like.dtype)
    small = (denom.real if denom.is_complex() else denom) < 1
    denom = torch.where(small, torch.ones_like(denom), denom)
    return denom if ptype == "AVERAGE" else torch.sqrt(denom)


def masked_sum(x, mask):
    """x [B, T, D] summed over T where mask [B, T] holds: torch's sum
    (integers and bool widened to int64), unsigned integers as the uint64
    of that int64 sum, float8 in fp32 rounded to x's type after every
    step, in t order."""
    if x.dtype in FLOAT8:
        xs = x.to(torch.float32) * mask[:, :, None]
        acc = xs.new_zeros((x.shape[0], x.shape[2]))
        for i in range(x.shape[1]):
            acc = (acc + xs[:, i]).to(x.dtype).to(torch.float32)
        return acc.to(x.dtype)
    if x.dtype in UNSIGNED:
        # summed as the int64 of their bits (CUDA has no arithmetic on the
        # unsigned types): exact modulo 2**64
        return (as_int64(x) * mask[:, :, None]).sum(dim=1).view(torch.uint64)
    return (x * mask[:, :, None].to(x.dtype)).sum(dim=1)


def as_int64(x):
    """An unsigned integer tensor as int64 of the same value modulo 2**64:
    uint64 reinterpreted, uint16 and uint32 widened."""
    return x.view(torch.int64) if x.dtype == torch.uint64 else \
        x.to(torch.int64)


def divided(total, lens, ptype, dtype):
    """``total``, the SUM pool of an x of ``dtype``, divided as the
    reference divides it for AVERAGE and SQRT: float8 in fp32 and rounded
    once, unsigned in fp32, the other types in x's own type (integers and
    bool by true division)."""
    div = _divisor(lens, ptype, torch.empty((), dtype=dtype))
    if div is None:
        return total
    if dtype in FLOAT8:
        return (total.to(torch.float32) / div).to(dtype)
    if dtype in UNSIGNED:
        return total.to(torch.float32) / div
    return total / div


def masked_seqpool_ref(x, lens, pooltype: str = "SUM"):
    """Plain version of :func:`masked_seqpool_fwd`: the masked sum over the
    whole [B, T, D] (the refer branch of ``_sequence_pool``,
    ``paddle_tpu/ops/sequence_ops.py:75-84``)."""
    ptype = _mode(pooltype)
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lens.reshape(-1, 1)
    return divided(masked_sum(x, mask), lens, ptype, x.dtype)


def _check_shapes(x, lens):
    if x.dim() != 3:
        raise ValueError(f"want x [B,T,D], got {tuple(x.shape)}")
    if x.shape[0] == 0 or x.shape[2] == 0:
        raise ValueError(f"empty pool {tuple(x.shape)}")
    if lens.numel() != x.shape[0]:
        raise ValueError(f"want lens [{x.shape[0]}], got "
                         f"{tuple(lens.shape)}")
    if lens.dtype.is_floating_point or lens.dtype == torch.bool:
        raise ValueError(f"lens must be integers, got {lens.dtype}")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def kernel_operand(x):
    """(x as the pooling kernels read it, its dtype code): floats as they
    are, integers and bool widened to int64 (uint64 as its bits),
    contiguous. Raises for a dtype no kernel takes (complex is viewed as
    real by the callers)."""
    if x.dtype in UNSIGNED:
        x = as_int64(x)
    elif not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.int64)
    if x.dtype not in DTYPES:
        raise ValueError(f"the pooling kernels take "
                         f"{[str(k) for k in DTYPES]}, integers and bool "
                         f"(as int64) and complex, got {x.dtype}")
    return x.contiguous(), DTYPES[x.dtype]


def masked_seqpool_fwd(x, lens, pooltype: str = "SUM"):
    """x [B,T,D], lens [B] int -> [B,D] of x's dtype (int64 for the SUM
    of integers, fp32 for their AVERAGE and SQRT)."""
    ptype = _mode(pooltype)
    _check_shapes(x, lens)
    if not _device.uses_kernel(x, lens):
        return masked_seqpool_ref(x, lens, ptype)
    b, t, d = x.shape
    if x.is_complex():
        out = masked_seqpool_fwd(torch.view_as_real(x).reshape(b, t, 2 * d),
                                 lens, ptype)
        return torch.view_as_complex(out.view(b, d, 2))
    if ptype != "SUM" and not x.is_floating_point():
        # integers: the kernel's int64 sum over the length cast to x's own
        # type (true division, as the plain version divides)
        return divided(masked_seqpool_fwd(x, lens, "SUM"), lens, ptype,
                       x.dtype)
    unsigned = x.dtype in UNSIGNED
    x, code = kernel_operand(x)
    lens32 = lens.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((b, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels().paddle_seqpool(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), b, t, d,
            MODES[ptype], code, pool_warps(t, code),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "masked_seqpool")
    LAUNCHES["seqpool"] += 1
    return out.view(torch.uint64) if unsigned else out


def masked_seqpool_bwd(g, lens, t: int, pooltype: str = "SUM"):
    """dx [B,T,D] of :func:`masked_seqpool_fwd` from the output gradient g
    [B,D] (``_seqpool_bwd``)."""
    ptype = _mode(pooltype)
    b, d = g.shape
    mask = torch.arange(t, device=g.device)[None, :] < lens.reshape(-1, 1)
    gx = g[:, None, :].expand(b, t, d)
    div = _divisor(lens, ptype, g)
    if div is not None:
        gx = gx / div[:, :, None]
    return gx * mask[:, :, None].to(g.dtype)


class MaskedSeqPool(torch.autograd.Function):
    """[B,D] pool of x [B,T,D] over t < lens[b]; the forward runs
    :func:`masked_seqpool_fwd` (the kernel on the card), the backward
    :func:`masked_seqpool_bwd` in torch. ``lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, lens, pooltype):
        ctx.save_for_backward(lens)
        ctx.args = (x.shape[1], pooltype)
        return masked_seqpool_fwd(x, lens, pooltype)

    @staticmethod
    def backward(ctx, g):
        (lens,) = ctx.saved_tensors
        return masked_seqpool_bwd(g, lens, *ctx.args), None, None


def masked_seqpool(x, lens, pooltype: str = "SUM") -> torch.Tensor:
    """x [B,T,D], lens [B] int -> [B,D]: SUM, AVERAGE or SQRT over the
    first lens[b] steps of each row, differentiable in x."""
    return MaskedSeqPool.apply(x, lens, _mode(pooltype))
