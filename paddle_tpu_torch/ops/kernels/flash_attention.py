"""Flash attention for training: the wrappers of the CUDA kernels in
``paddle_tpu_torch/csrc/flash_attention.cuh`` (built as
``flash_attention.cu`` and, for q, k, v of mixed dtypes,
``flash_attention_mixed.cu``), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:

- :func:`hash_keep_mask` -- the attention-dropout keep mask (``:53``), a
  murmur-finalizer hash of (seed, b*H + h, query position, key position)
  in uint32 arithmetic, carried here in int64 and cut to 32 bits after
  every step. Bit-equal to the JAX function; the kernels compute the
  same bits, so the forward and both backward passes drop the same
  positions.
- :func:`flash_fwd` -- ``_flash_fwd`` (``:174``): q [BH,Tq,D], k/v
  [BH,Tk,D] -> o [BH,Tq,D], lse [BH,Tq]; on the tensor cores at head
  widths up to 128 (:func:`fwd_kernel`), above in 256-wide SIMT chunks.
- :func:`flash_bwd` -- ``_flash_bwd_impl`` (``:455``): dQ, dK and dV in
  one launch on the tensor cores, from q, k, v, dO, lse, delta =
  rowsum(o * dO) (computed by the caller, ``:471``) and an optional lse
  cotangent; at key lengths above ``BWD_MAX_TK`` or head widths above 128
  it runs :func:`flash_dq` and :func:`flash_dkv`.
- :func:`flash_dq` and :func:`flash_dkv` -- the two kernels of
  ``_flash_bwd_impl`` (``:481``, ``:504``) one by one: dQ, and dK with
  dV (fp32 SIMT kernels, any length and head width).
- :class:`FlashAttention` and :func:`flash_attention` -- ``flash_attention``
  (``:321``) on [B,H,T,D], differentiable in q, k and v.

Conventions of the TPU kernels: scores ``(q . k) * scale``; causal mask
``qpos >= kpos`` with ``qpos = (tk - tq) + query index``, masked score
-1e30; dropout (upscale_in_train) multiplies the softmax numerator and
dP only, so ``lse`` stays dropout-free.

Roundings of the TPU kernels, which the plain versions and the kernels
keep for bf16 and fp16 operands: the scores, their max, sum and lse in
fp32 from the operands as stored (``_masked_scores``, ``:36-50``); p
times the keep factor rounded to v's dtype before p . v (``:133-134``);
dP in fp32; dS rounded to k's dtype for dQ and to q's for dK, p times
the keep factor to dO's for dV; every sum in fp32; o, dq, dk and dv in
the dtypes of q, q, k and v, lse in fp32.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32, bf16 or fp16,
contiguous), which is built on its first launch; anything else raises.
q, k and v (and dO) of one dtype run that dtype's kernels. Of mixed
dtypes, as the JAX function takes them, the wrappers widen them to fp32
(exact) and run the fp32 kernels instantiated to round p and dS to the
narrower dtypes where the plain versions do (``rounds``: one narrow
dtype a rounding point, dO in q's dtype); the outputs come back in the
dtypes above. The kernels take head
widths 32, 64, 128 and 256, and above 256 every multiple of 256 (in
256-wide chunks, each block one chunk of its output tile); the wrappers
zero-pad q, k, v (and dO) along the head width up to the next of these
and slice the padding off o, dq, dk and dv. That is exact: the scale is
passed in, the padded columns add 0 to every score, and the padded
output columns are products with zeros.
``LAUNCHES`` counts kernel launches per wrapper; only a kernel launch
adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_bwd": 0}
HEAD_DIMS = (32, 64, 128, 256)     # one instantiation each; above 256,
CHUNK = 256                        # multiples of the 256-wide chunk
FWD_HEAD_DIMS = (32, 64, 128)      # the forward's tensor-core kernel takes
BWD_HEAD_DIMS = (32, 64, 128)      # flash_bwd's tensor-core kernel takes
BWD_TILE = 64                      # and up to 8 key tiles of 64: a
BWD_MAX_TK = 8 * BWD_TILE          # plane of dQ partials each (scratch
                                   # of C x dQ's size, square in T)
NEG = -1e30                        # _NEG: the masked score
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_MASK32 = 0xFFFFFFFF
_libs = {}                         # "flash_attention", "flash_attention_mixed"
_counts = {}                       # (device, stream) -> flash_bwd's counters


def _head_counts(dev, bh: int) -> torch.Tensor:
    """flash_bwd's counters of finished blocks, at least one a head, for
    the current stream (launches on one stream run in turn): zeros, which
    every launch leaves zero (the last block of a head resets its own)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    counts = _counts.get(key)
    if counts is None or counts.numel() < bh:
        counts = _counts[key] = torch.zeros(max(bh, 4096), dtype=torch.int32,
                                            device=dev)
    return counts


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels(rounds: int = 0):
    """The library of a call: ``flash_attention`` (one storage type,
    ``rounds`` 0) or ``flash_attention_mixed`` (mixed dtypes widened to
    fp32, ``rounds`` non-zero); both export the same functions."""
    name = "flash_attention_mixed" if rounds else "flash_attention"
    if name not in _libs:
        lib = _build.load(name)
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        # bh tq tk d dtype causal scale dropout seed thresh upscale rounds
        # stream
        tail = [i, i, i, i, i, i, f, i, u, u, f, i, p]
        lib.paddle_flash_fwd.argtypes = [p] * 5 + tail
        lib.paddle_flash_dq.argtypes = [p] * 8 + tail
        lib.paddle_flash_dkv.argtypes = [p] * 9 + tail
        lib.paddle_flash_bwd.argtypes = [p] * 12 + tail
        for fn in (lib.paddle_flash_fwd, lib.paddle_flash_dq,
                   lib.paddle_flash_dkv, lib.paddle_flash_bwd):
            fn.restype = i
        _libs[name] = lib
    return _libs[name]


# -- dropout ----------------------------------------------------------------

def dropout_params(dropout_p: float, seed: int) -> Tuple[int, int, float]:
    """(seed bits, threshold, upscale) of the keep test ``hash >=
    threshold``: the threshold ``min(int(p * 2**32), 2**32 - 1)`` in
    double as the JAX function computes it, the upscale
    ``float32(1 / (1 - p))``."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    thresh = min(int(dropout_p * 2.0 ** 32), 2 ** 32 - 1)
    upscale = float(np.float32(1.0 / (1.0 - dropout_p)))
    return int(seed) & _MASK32, thresh, upscale


def hash_keep_mask(seed, bh, qpos, kpos, dropout_p: float) -> torch.Tensor:
    """keep / (1 - p) as float32, broadcast over the integer tensors (or
    ints) ``seed``, ``bh``, ``qpos``, ``kpos`` -- bit-equal to the JAX
    ``hash_keep_mask``."""
    seed_u, thresh, upscale = dropout_params(dropout_p, 0)
    ref = next((t for t in (qpos, kpos, bh, seed)
                if isinstance(t, torch.Tensor)), None)
    dev = ref.device if ref is not None else None

    def u32(t):
        return torch.as_tensor(t, dtype=torch.int64, device=dev) & _MASK32
    x = (((u32(qpos) * 0x9E3779B9) & _MASK32)
         ^ ((u32(kpos) * 0x85EBCA6B) & _MASK32))
    x = x ^ ((u32(seed) + u32(bh) * 0x27D4EB2F) & _MASK32)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    x = x ^ (x >> 16)
    return (x >= thresh).to(torch.float32) * upscale


def _tile_keep(seed, dropout_p, bh, tq, tk, dev) -> torch.Tensor:
    """The [BH, Tq, Tk] keep mask of one attention call."""
    q_off = tk - tq
    return hash_keep_mask(
        seed, torch.arange(bh, device=dev)[:, None, None],
        q_off + torch.arange(tq, device=dev)[None, :, None],
        torch.arange(tk, device=dev)[None, None, :], dropout_p)


# -- plain versions ----------------------------------------------------------

def _sum_type(*tensors) -> torch.dtype:
    """The dtype the plain versions sum in: fp32, or wider if an operand
    is (fp64 in the tests)."""
    out = torch.float32
    for t in tensors:
        out = torch.promote_types(out, t.dtype)
    return out


def _as(t: torch.Tensor, *dtypes) -> torch.Tensor:
    """``t`` rounded through each dtype in turn (``t.to(a).to(b)``)."""
    for dt in dtypes:
        t = t.to(dt)
    return t


def _scores(q, k, causal, scale):
    """[BH, Tq, Tk] scaled scores, summed in fp32 (or wider) from the
    operands as stored, causal positions at -1e30."""
    st = _sum_type(q, k)
    s = torch.matmul(q.to(st), k.to(st).transpose(1, 2)) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = (tk - tq) + torch.arange(tq, device=q.device)
        visible = qpos[:, None] >= torch.arange(tk, device=q.device)[None]
        s = s.masked_fill(~visible, NEG)
    return s


def flash_fwd_ref(q, k, v, causal: bool, scale: float,
                  dropout_p: float = 0.0, seed: int = 0):
    """Plain version of :func:`flash_fwd`: the whole score matrix."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_p > 0:
        p = p * _tile_keep(seed, dropout_p, q.shape[0], q.shape[1],
                           k.shape[1], q.device)
    st = _sum_type(p, v)
    o = torch.matmul(_as(p, v.dtype, st), v.to(st)) / safe_l
    return o.to(q.dtype), (m + torch.log(safe_l))[..., 0]


def _probs_and_dp(q, k, v, dout, lse, causal, scale, dropout_p, seed):
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None].to(s.dtype))
    st = _sum_type(dout, v, p)
    dp = torch.matmul(dout.to(st), v.to(st).transpose(1, 2))
    keep = None
    if dropout_p > 0:
        keep = _tile_keep(seed, dropout_p, q.shape[0], q.shape[1],
                          k.shape[1], q.device)
        dp = dp * keep
    return p, dp, keep


def _ds(p, dp, delta, dlse):
    corr = delta if dlse is None else delta - dlse
    return p * (dp - corr[..., None].to(p.dtype))


def _dq(ds, q, k, scale):
    """dS (rounded to k's dtype) . k, summed in ds's dtype, in q's."""
    st = ds.dtype
    return (torch.matmul(_as(ds, k.dtype, st), k.to(st)) * scale).to(q.dtype)


def _dkv(ds, pm, q, k, v, dout, scale):
    """(dS^T . q, (p keep)^T . dO), dS rounded to q's dtype and p keep to
    dO's, summed in ds's dtype, in k's and v's."""
    st = ds.dtype
    dk = torch.matmul(_as(ds, q.dtype, st).transpose(1, 2), q.to(st)) * scale
    dv = torch.matmul(_as(pm, dout.dtype, st).transpose(1, 2), dout.to(st))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """Plain version of :func:`flash_dq`."""
    p, dp, _ = _probs_and_dp(q, k, v, dout, lse, causal, scale, dropout_p,
                             seed)
    return _dq(_ds(p, dp, delta, dlse), q, k, scale)


def flash_dkv_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """Plain version of :func:`flash_dkv`: (dk, dv)."""
    p, dp, keep = _probs_and_dp(q, k, v, dout, lse, causal, scale,
                                dropout_p, seed)
    pm = p if keep is None else p * keep
    return _dkv(_ds(p, dp, delta, dlse), pm, q, k, v, dout, scale)


def flash_bwd_ref(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """Plain version of :func:`flash_bwd`: (dq, dk, dv), the scores and
    dP computed once."""
    p, dp, keep = _probs_and_dp(q, k, v, dout, lse, causal, scale,
                                dropout_p, seed)
    ds = _ds(p, dp, delta, dlse)
    pm = p if keep is None else p * keep
    return (_dq(ds, q, k, scale), *_dkv(ds, pm, q, k, v, dout, scale))


# -- wrappers ----------------------------------------------------------------

def _check_qkv(q, k, v, causal):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"want q [BH,Tq,D], k/v [BH,Tk,D], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if bh == 0 or tq == 0 or tk == 0:
        raise ValueError(f"empty attention {tuple(q.shape)} x "
                         f"{tuple(k.shape)}")
    if causal and tq > tk:
        raise ValueError(f"causal attention needs tq <= tk (rows before "
                         f"the first key see nothing), got tq {tq}, "
                         f"tk {tk}")
    return bh, tq, tk, d


def _kernel_args(name, operands, rows=()):
    """What the kernels take: q, k, v (and dO) in fp32, bf16 or fp16; lse,
    delta and dlse in fp32; all contiguous and 16-byte aligned. Returns
    the operands as the kernels take them and their dtype code: as given
    where they share one dtype, else widened to fp32 (exact), code 0."""
    for t in operands:
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: the kernels take q, k, v and dO in "
                             f"float32, bfloat16 or float16, got {t.dtype}")
    for t in rows:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: lse, delta and dlse must be float32, "
                             f"got {t.dtype}")
    for t in (*operands, *rows):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes 16-byte aligned "
                             f"tensors")
    if len({t.dtype for t in operands}) == 1:
        return tuple(operands), DTYPES[operands[0].dtype]
    return tuple(t.float() for t in operands), 0


def rounds(name, p=torch.float32, q=torch.float32, k=torch.float32) -> int:
    """The fp32 kernels' rounding code of a mixed call, p + 3 q + 9 k with
    each the dtype's code (0 float32: no rounding): ``p`` the dtype p times
    the keep factor is rounded to (v's in the forward, dO's in the
    backward), ``q`` that of dS before dK (q's), ``k`` that of dS before dQ
    (k's). Instantiated: dO in q's dtype, and one narrow dtype among the
    backward's points."""
    cp, cq, ck = (DTYPES[dt] for dt in (p, q, k))
    if cp != cq and name != "flash_fwd":
        raise ValueError(f"{name}: of mixed dtypes the kernels take dO in "
                         f"q's dtype, got dO {p} and q {q}")
    if cq and ck and cq != ck:
        raise ValueError(f"{name}: of mixed dtypes the kernels round to one "
                         f"of bfloat16 and float16, got q {q} and k {k}")
    return cp + 3 * cq + 9 * ck


def kernel_width(name: str, d: int) -> int:
    """The head width the kernels run at for width ``d``: the least of
    HEAD_DIMS that holds it, above 256 the least multiple of 256."""
    if d < 1:
        raise ValueError(f"{name}: head width {d}")
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // CHUNK) * CHUNK


def padded(width: int, *tensors):
    """The tensors zero-padded along the last axis to ``width``."""
    return tuple(t if t.shape[-1] == width else
                 torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def unpadded(d: int, t: torch.Tensor) -> torch.Tensor:
    """``t`` without the padding past head width ``d``."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_rows(name, bh, tq, *rows):
    for r in rows:
        if r is not None and r.shape != (bh, tq):
            raise ValueError(f"{name}: lse/delta/dlse must be [{bh}, {tq}], "
                             f"got {tuple(r.shape)}")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, causal: bool, scale: float, dropout_p: float = 0.0,
              seed: int = 0):
    """q [BH,Tq,D], k/v [BH,Tk,D] -> (o [BH,Tq,D], lse [BH,Tq] fp32)."""
    bh, tq, tk, d = _check_qkv(q, k, v, causal)
    seed_u, thresh, upscale = dropout_params(dropout_p, seed)
    if not _device.uses_kernel(q, k, v):
        return flash_fwd_ref(q, k, v, causal, scale, dropout_p, seed)
    dtypes = tuple(t.dtype for t in (q, k, v))
    mixed = rounds("flash_fwd", dtypes[2]) if len(set(dtypes)) > 1 else 0
    (q, k, v), code = _kernel_args("flash_fwd", (q, k, v))
    width = kernel_width("flash_fwd", d)
    q, k, v = padded(width, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels(mixed).paddle_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, tk, width, code, int(causal), scale,
            int(dropout_p > 0), seed_u, thresh, upscale, mixed,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return unpadded(d, o).to(dtypes[0]), lse


def flash_dq(q, k, v, dout, lse, delta, causal: bool, scale: float,
             dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """dQ [BH,Tq,D] from q, k, v, dO [BH,Tq,D], lse and delta [BH,Tq]
    (and the lse cotangent ``dlse`` [BH,Tq], if any)."""
    bh, tq, tk, d = _check_qkv(q, k, v, causal)
    _check_rows("flash_dq", bh, tq, lse, delta, dlse)
    seed_u, thresh, upscale = dropout_params(dropout_p, seed)
    rows = [t for t in (lse, delta, dlse) if t is not None]
    if not _device.uses_kernel(q, k, v, dout, *rows):
        return flash_dq_ref(q, k, v, dout, lse, delta, causal, scale,
                            dropout_p, seed, dlse)
    if dout.shape != q.shape:
        raise ValueError(f"flash_dq: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    dtypes = tuple(t.dtype for t in (q, k, v, dout))
    mixed = rounds("flash_dq", k=dtypes[1]) if len(set(dtypes)) > 1 else 0
    (q, k, v, dout), code = _kernel_args("flash_dq", (q, k, v, dout), rows)
    width = kernel_width("flash_dq", d)
    q, k, v, dout = padded(width, q, k, v, dout)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernels(mixed).paddle_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), dq.data_ptr(),
            bh, tq, tk, width, code, int(causal), scale, int(dropout_p > 0),
            seed_u, thresh, upscale, mixed,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return unpadded(d, dq).to(dtypes[0])


def flash_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float,
              dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """(dK, dV) [BH,Tk,D] from the same inputs as :func:`flash_dq`."""
    bh, tq, tk, d = _check_qkv(q, k, v, causal)
    _check_rows("flash_dkv", bh, tq, lse, delta, dlse)
    seed_u, thresh, upscale = dropout_params(dropout_p, seed)
    rows = [t for t in (lse, delta, dlse) if t is not None]
    if not _device.uses_kernel(q, k, v, dout, *rows):
        return flash_dkv_ref(q, k, v, dout, lse, delta, causal, scale,
                             dropout_p, seed, dlse)
    if dout.shape != q.shape:
        raise ValueError(f"flash_dkv: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    dtypes = tuple(t.dtype for t in (q, k, v, dout))
    mixed = rounds("flash_dkv", dtypes[3], dtypes[0]) \
        if len(set(dtypes)) > 1 else 0
    (q, k, v, dout), code = _kernel_args("flash_dkv", (q, k, v, dout), rows)
    width = kernel_width("flash_dkv", d)
    q, k, v, dout = padded(width, q, k, v, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _kernels(mixed).paddle_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), dk.data_ptr(),
            dv.data_ptr(), bh, tq, tk, width, code, int(causal), scale,
            int(dropout_p > 0), seed_u, thresh, upscale, mixed,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return unpadded(d, dk).to(dtypes[1]), unpadded(d, dv).to(dtypes[2])


def fwd_kernel(d: int) -> str:
    """The kernel :func:`flash_fwd` launches on a CUDA tensor at head width
    ``d``: ``"tensor_cores"`` up to width 128 (after padding), else
    ``"simt"`` (the 256-wide tiles, in chunks above 256)."""
    width = kernel_width("flash_fwd", d)
    return "tensor_cores" if width in FWD_HEAD_DIMS else "simt"


def bwd_kernel(tk: int, d: int) -> str:
    """The kernel :func:`flash_bwd` launches on a CUDA tensor for key
    length ``tk`` and head width ``d``: ``"flash_bwd"`` (the tensor-core
    kernel) within its range, else ``"flash_dq+flash_dkv"``."""
    width = kernel_width("flash_bwd", d)
    if width in BWD_HEAD_DIMS and tk <= BWD_MAX_TK:
        return "flash_bwd"
    return "flash_dq+flash_dkv"


def flash_bwd(q, k, v, dout, lse, delta, causal: bool, scale: float,
              dropout_p: float = 0.0, seed: int = 0, dlse=None):
    """(dQ [BH,Tq,D], dK [BH,Tk,D], dV [BH,Tk,D]) from the inputs of
    :func:`flash_dq`: one launch of the tensor-core kernel at key lengths
    up to ``BWD_MAX_TK`` and head widths up to 128, else :func:`flash_dq`
    and :func:`flash_dkv`."""
    bh, tq, tk, d = _check_qkv(q, k, v, causal)
    _check_rows("flash_bwd", bh, tq, lse, delta, dlse)
    seed_u, thresh, upscale = dropout_params(dropout_p, seed)
    rows = [t for t in (lse, delta, dlse) if t is not None]
    if not _device.uses_kernel(q, k, v, dout, *rows):
        return flash_bwd_ref(q, k, v, dout, lse, delta, causal, scale,
                             dropout_p, seed, dlse)
    if dout.shape != q.shape:
        raise ValueError(f"flash_bwd: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    if bwd_kernel(tk, d) != "flash_bwd":
        args = (q, k, v, dout, lse, delta, causal, scale, dropout_p, seed,
                dlse)
        return (flash_dq(*args), *flash_dkv(*args))
    dtypes = tuple(t.dtype for t in (q, k, v, dout))
    mixed = rounds("flash_bwd", dtypes[3], dtypes[0], dtypes[1]) \
        if len(set(dtypes)) > 1 else 0
    (q, k, v, dout), code = _kernel_args("flash_bwd", (q, k, v, dout), rows)
    width = kernel_width("flash_bwd", d)
    q, k, v, dout = padded(width, q, k, v, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # each key tile's share of dQ, summed in tile order by the kernel
    tiles = -(-tk // BWD_TILE)
    dqp = None if tiles == 1 else torch.empty(
        (tiles, bh, tq, width), dtype=torch.float32, device=q.device)
    counts = None if tiles == 1 else _head_counts(q.device, bh)
    with torch.cuda.device(q.device):
        err = _kernels(mixed).paddle_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(dqp), _ptr(counts), bh, tq,
            tk, width, code, int(causal), scale, int(dropout_p > 0), seed_u,
            thresh, upscale, mixed, torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return tuple(unpadded(d, t).to(dt)
                 for t, dt in zip((dq, dk, dv), dtypes))


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) on [BH,T,D]; the forward runs
    :func:`flash_fwd`, the backward :func:`flash_bwd` from the saved (q,
    k, v, o, lse), regenerating the dropout mask from the seed (the
    custom VJP of ``:320-550``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        o, lse = flash_fwd(q, k, v, causal, scale, dropout_p, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        st = _sum_type(o, dout)
        delta = (o.to(st) * dout.to(st)).sum(dim=-1)    # rowsum(o * dO)
        dq, dk, dv = flash_bwd(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """q [B,H,Tq,D], k/v [B,H,Tk,D] -> [B,H,Tq,D]; ``scale`` defaults to
    D**-0.5, ``seed`` (an int32 value) keys the dropout mask. The
    [B*H,T,D] layout the kernels take is a copy when the inputs are not
    contiguous in [B,H,T,D]: ``reshape`` copies them at B > 1 but returns
    a strided view of a [1,T,H,D] transpose at B = 1, so ``contiguous``
    copies that too."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = float(d) ** -0.5
    o = FlashAttention.apply(q.reshape(b * h, tq, d).contiguous(),
                             k.reshape(b * h, tk, d).contiguous(),
                             v.reshape(b * h, tk, d).contiguous(),
                             bool(causal), float(scale), float(dropout_p),
                             int(seed))
    return o.view(b, h, tq, d)
