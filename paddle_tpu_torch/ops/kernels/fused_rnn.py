"""Whole-sequence trainable LSTM: the wrappers of the CUDA kernels in
``paddle_tpu_torch/csrc/fused_rnn.cu``, their plain PyTorch versions, and
the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/fused_rnn.py``:

- :func:`lstm_train_fwd` -- ``_lstm_train_fwd_call`` (``:167``): the cell of
  ``_lstm_train_fwd_kernel`` (``:49-88``) over all T steps, peepholes and
  the length mask inside -> (hidden [T,B,H], cell [T,B,H], h_last [B,H],
  c_last [B,H]); hidden and cell are zero past each row's length, h_last
  and c_last carry the last valid step.
- :func:`lstm_train_bwd` -- ``_lstm_train_vjp_bwd`` (``:224``): the
  reverse-time walk of ``_lstm_train_bwd_kernel`` (``:91-164``), the gates
  recomputed from ``xproj[t]`` and the hidden and cell sequences shifted
  one step behind ``h0, c0`` (``:229-232``) -> (dx [T,B,4H], dw [H,4H],
  dpeep [1,3H], dh0 [B,H], dc0 [B,H]).
- :class:`FusedLSTMTrain` and :func:`fused_lstm_train` --
  ``fused_lstm_train`` (``:203``) with the residuals of
  ``_lstm_train_vjp_fwd`` (``:215-221``).

Layout as there: ``xproj`` [T,B,4H] time-major gate pre-activations
(x @ Wx + b, gate order i, f, c, o), ``w`` [H,4H] recurrent, ``peep``
[1,3H] (W_ic | W_fc | W_oc; zeros without peepholes), ``seq_lens`` [B]
(or [B,1]) integers (T everywhere for no mask), ``h0, c0`` [B,H].

On the card the T steps run inside one cooperative launch each way, the
three matrix products of a step in the kernels' own bodies; a step works
only on the rows still inside their length (:func:`_schedule`). The plain
versions loop over time in PyTorch: they are for the CPU and for the
comparisons; :func:`lstm_train_bwd_plain` is the explicit formulae, not
autograd, so that each kernel output has a plain counterpart.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32, contiguous, H <=
``MAX_H``), which is built on its first launch; anything else raises.
``LAUNCHES`` counts kernel launches per wrapper; only a kernel launch
adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"lstm_train_fwd": 0, "lstm_train_bwd": 0}
MAX_H = 512                        # kMaxH of the kernels

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("fused_rnn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paddle_lstm_train_fwd.argtypes = [p] * 13 + [i] * 3 + [p]
        lib.paddle_lstm_train_bwd.argtypes = [p] * 19 + [i] * 3 + [p]
        for fn in (lib.paddle_lstm_train_fwd, lib.paddle_lstm_train_bwd):
            fn.restype = i
        _lib = lib
    return _lib


# -- plain versions ----------------------------------------------------------

def _cell(xt, h, c, w, w_ic, w_fc, w_oc):
    """One step of ``_lstm_train_fwd_kernel`` (``:63-75``) without the
    mask: (i, f, g, o, c_cand, tanh(c_cand))."""
    hdim = h.shape[-1]
    gates = xt + h @ w
    i = torch.sigmoid(gates[:, :hdim] + c * w_ic)
    f = torch.sigmoid(gates[:, hdim:2 * hdim] + c * w_fc)
    g = torch.tanh(gates[:, 2 * hdim:3 * hdim])
    c_cand = f * c + i * g
    o = torch.sigmoid(gates[:, 3 * hdim:] + c_cand * w_oc)
    return i, f, g, o, c_cand, torch.tanh(c_cand)


def _peepholes(peep, hdim):
    p = peep.reshape(-1)
    return p[:hdim], p[hdim:2 * hdim], p[2 * hdim:]


def _mask(t, seq_lens, like):
    """[B, 1] mask of step t: 1 while t < seq_len."""
    return (t < seq_lens.reshape(-1, 1)).to(like.dtype)


def lstm_train_fwd_plain(xproj, w, peep, seq_lens, h0, c0):
    """Plain version of :func:`lstm_train_fwd`: the cell step by step.
    Differentiable through autograd."""
    peeps = _peepholes(peep, w.shape[0])
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xproj.shape[0]):
        _, _, _, o, c_cand, tanh_c = _cell(xproj[t], h, c, w, *peeps)
        h_cand = o * tanh_c
        m = _mask(t, seq_lens, h_cand)
        h = m * h_cand + (1.0 - m) * h
        c = m * c_cand + (1.0 - m) * c
        hs.append(m * h_cand)
        cs.append(m * c_cand)
    return torch.stack(hs), torch.stack(cs), h, c


def lstm_train_bwd_plain(xproj, w, peep, seq_lens, h0, c0, hidden, cell,
                         dhid, dcell, dhlast, dclast):
    """Plain version of :func:`lstm_train_bwd`: the formulae of
    ``_lstm_train_bwd_kernel`` (``:128-157``) in reverse time."""
    t_len, _, h4 = xproj.shape
    hdim = h4 // 4
    w_ic, w_fc, w_oc = _peepholes(peep, hdim)
    h_prev_seq = torch.cat([h0[None], hidden[:-1]])
    c_prev_seq = torch.cat([c0[None], cell[:-1]])
    dh, dc = dhlast, dclast
    dx = torch.empty_like(xproj)
    dw = torch.zeros_like(w)
    dpeep = torch.zeros(3, hdim, dtype=w.dtype, device=w.device)
    for t in range(t_len - 1, -1, -1):
        h_prev, c_prev = h_prev_seq[t], c_prev_seq[t]
        i, f, g, o, c_cand, tanh_c = _cell(xproj[t], h_prev, c_prev, w,
                                           w_ic, w_fc, w_oc)
        m = _mask(t, seq_lens, h_prev)
        gh = m * (dh + dhid[t])
        gc = m * (dc + dcell[t])
        dgo = gh * tanh_c * o * (1.0 - o)
        dc_cand = gc + gh * o * (1.0 - tanh_c * tanh_c) + dgo * w_oc
        dgi = dc_cand * g * i * (1.0 - i)
        dgf = dc_cand * c_prev * f * (1.0 - f)
        dgg = dc_cand * i * (1.0 - g * g)
        dgates = torch.cat([dgi, dgf, dgg, dgo], dim=1)
        dx[t] = dgates
        dh = (1.0 - m) * dh + dgates @ w.t()
        dc = (1.0 - m) * dc + dc_cand * f + dgi * w_ic + dgf * w_fc
        dw += h_prev.t() @ dgates
        dpeep[0] += (dgi * c_prev).sum(0)
        dpeep[1] += (dgf * c_prev).sum(0)
        dpeep[2] += (dgo * c_cand).sum(0)
    return dx, dw, dpeep.reshape(1, 3 * hdim), dh, dc


# -- wrappers ----------------------------------------------------------------

def _check_shapes(xproj, w, peep, seq_lens, h0, c0):
    if xproj.dim() != 3 or xproj.shape[2] % 4:
        raise ValueError(f"want xproj [T,B,4H], got {tuple(xproj.shape)}")
    t, b, h4 = xproj.shape
    h = h4 // 4
    if t == 0 or b == 0 or h == 0:
        raise ValueError(f"empty sequence batch {tuple(xproj.shape)}")
    if tuple(w.shape) != (h, h4):
        raise ValueError(f"want w [{h},{h4}], got {tuple(w.shape)}")
    if peep.numel() != 3 * h:
        raise ValueError(f"want peep [1,{3 * h}], got {tuple(peep.shape)}")
    if seq_lens.numel() != b:
        raise ValueError(f"want seq_lens [{b}], got {tuple(seq_lens.shape)}")
    if seq_lens.dtype.is_floating_point or seq_lens.dtype == torch.bool:
        raise ValueError(f"seq_lens must be integers, got {seq_lens.dtype}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (b, h):
            raise ValueError(f"want {name} [{b},{h}], got {tuple(s.shape)}")
    return t, b, h


def _check_kernel_args(name, tensors, h):
    """What the kernels take: fp32, contiguous, H <= MAX_H."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if h > MAX_H:
        raise ValueError(f"{name}: hidden width {h} > {MAX_H}")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _schedule(seq_lens, t: int):
    """What the kernels walk: the lengths as int32 [B], the rows in order
    of falling length (int32 [B]) and, per step, how many rows are still
    inside their length (int32 [T]): at step t those are the first
    ``live[t]`` rows of ``order``."""
    lens = seq_lens.reshape(-1).to(torch.int32).contiguous()
    order = torch.argsort(lens, descending=True, stable=True).to(torch.int32)
    steps = torch.arange(t, dtype=torch.int32, device=lens.device)
    live = (lens[None, :] > steps[:, None]).sum(dim=1, dtype=torch.int32)
    return lens, order, live


def lstm_train_fwd(xproj, w, peep, seq_lens, h0, c0):
    """-> (hidden [T,B,H], cell [T,B,H], h_last [B,H], c_last [B,H])."""
    t, b, h = _check_shapes(xproj, w, peep, seq_lens, h0, c0)
    if not _device.uses_kernel(xproj, w, peep, seq_lens, h0, c0):
        return lstm_train_fwd_plain(xproj, w, peep, seq_lens, h0, c0)
    _check_kernel_args("lstm_train_fwd", (xproj, w, peep, h0, c0), h)
    lens, order, live = _schedule(seq_lens, t)
    hidden = torch.empty((t, b, h), dtype=torch.float32, device=xproj.device)
    cell = torch.empty_like(hidden)
    h_last, c_last = torch.empty_like(h0), torch.empty_like(c0)
    carry = torch.empty((2, b, h), dtype=torch.float32, device=xproj.device)
    with torch.cuda.device(xproj.device):
        err = _kernels().paddle_lstm_train_fwd(
            xproj.data_ptr(), w.data_ptr(), peep.data_ptr(), lens.data_ptr(),
            order.data_ptr(), live.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hidden.data_ptr(), cell.data_ptr(), h_last.data_ptr(),
            c_last.data_ptr(), carry.data_ptr(), t, b, h,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "lstm_train_fwd")
    LAUNCHES["lstm_train_fwd"] += 1
    return hidden, cell, h_last, c_last


def lstm_train_bwd(xproj, w, peep, seq_lens, h0, c0, hidden, cell, dhid,
                   dcell, dhlast, dclast):
    """-> (dx [T,B,4H], dw [H,4H], dpeep [1,3H], dh0 [B,H], dc0 [B,H]) from
    the forward's inputs, its hidden and cell sequences and the cotangents
    of its four outputs."""
    t, b, h = _check_shapes(xproj, w, peep, seq_lens, h0, c0)
    for name, s, like in (("hidden", hidden, (t, b, h)),
                          ("cell", cell, (t, b, h)),
                          ("dhid", dhid, (t, b, h)),
                          ("dcell", dcell, (t, b, h)),
                          ("dhlast", dhlast, (b, h)),
                          ("dclast", dclast, (b, h))):
        if tuple(s.shape) != like:
            raise ValueError(f"want {name} {list(like)}, got "
                             f"{tuple(s.shape)}")
    tensors = (xproj, w, peep, h0, c0, hidden, cell, dhid, dcell, dhlast,
               dclast)
    if not _device.uses_kernel(seq_lens, *tensors):
        return lstm_train_bwd_plain(xproj, w, peep, seq_lens, h0, c0, hidden,
                                    cell, dhid, dcell, dhlast, dclast)
    _check_kernel_args("lstm_train_bwd", tensors, h)
    lens, order, live = _schedule(seq_lens, t)
    dx = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dpeep = torch.empty((1, 3 * h), dtype=torch.float32, device=xproj.device)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    with torch.cuda.device(xproj.device):
        err = _kernels().paddle_lstm_train_bwd(
            xproj.data_ptr(), w.data_ptr(), peep.data_ptr(), lens.data_ptr(),
            order.data_ptr(), live.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hidden.data_ptr(), cell.data_ptr(), dhid.data_ptr(),
            dcell.data_ptr(), dhlast.data_ptr(), dclast.data_ptr(),
            dx.data_ptr(), dw.data_ptr(),
            dpeep.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), t, b, h,
            torch.cuda.current_stream().cuda_stream)
    _check_launch(err, "lstm_train_bwd")
    LAUNCHES["lstm_train_bwd"] += 1
    return dx, dw, dpeep, dh0, dc0


class FusedLSTMTrain(torch.autograd.Function):
    """(hidden, cell, h_last, c_last) of the whole sequence; the forward
    runs :func:`lstm_train_fwd` and saves the residuals of
    ``_lstm_train_vjp_fwd`` (``:215-221``: xproj, w, peep, seq_lens, h0,
    c0, hidden, cell); the backward runs :func:`lstm_train_bwd` on the
    cotangents of all four outputs. ``seq_lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, xproj, w, peep, seq_lens, h0, c0):
        out = lstm_train_fwd(xproj, w, peep, seq_lens, h0, c0)
        ctx.save_for_backward(xproj, w, peep, seq_lens, h0, c0, out[0],
                              out[1])
        return out

    @staticmethod
    def backward(ctx, dhid, dcell, dhlast, dclast):
        xproj, w, peep, seq_lens, h0, c0, hidden, cell = ctx.saved_tensors
        with torch.no_grad():
            dx, dw, dpeep, dh0, dc0 = lstm_train_bwd(
                xproj, w, peep, seq_lens, h0, c0, hidden, cell,
                dhid.contiguous(), dcell.contiguous(), dhlast.contiguous(),
                dclast.contiguous())
        return dx, dw, dpeep.reshape(peep.shape), None, dh0, dc0


def fused_lstm_train(xproj, w, peep, seq_lens, h0, c0):
    """Trainable whole-sequence LSTM: xproj [T,B,4H], w [H,4H], peep
    [1,3H], seq_lens [B] integers, h0/c0 [B,H] -> (hidden [T,B,H], cell
    [T,B,H], h_last [B,H], c_last [B,H]), differentiable in xproj, w,
    peep, h0 and c0."""
    return FusedLSTMTrain.apply(xproj.contiguous(), w.contiguous(),
                                peep.contiguous(), seq_lens,
                                h0.contiguous(), c0.contiguous())
