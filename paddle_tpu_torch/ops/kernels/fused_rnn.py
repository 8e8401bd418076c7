"""Whole-sequence trainable LSTM and GRU: the wrappers of the CUDA kernels
in ``paddle_tpu_torch/csrc/fused_rnn.cu``, their plain PyTorch versions,
and the ``torch.autograd.Function`` s that join them.

Counterpart of ``paddle_tpu/ops/pallas/fused_rnn.py``, the LSTM:

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

and the GRU (``:279-454``, gru_op.cc layout):

- :func:`gru_train_fwd` -- ``_gru_train_fwd_call`` (``:376``): the cell of
  ``_gru_train_fwd_kernel`` (``:287-314``) over all T steps, the length
  mask inside -> (hidden [T,B,H], h_last [B,H], rh [T,B,H]); hidden is
  zero past each row's length, h_last carries the last valid step, and
  ``rh = m * r * h_prev`` is a residual of the backward that the TPU
  kernel recomputes instead (the left operand of the candidate's product
  and of ``dw[:, 2H:]``).
- :func:`gru_train_bwd` -- ``_gru_train_vjp_bwd`` (``:416``): the
  reverse-time formulae of ``_gru_train_bwd_kernel`` (``:330-373``) with
  ``h_prev`` the hidden sequence one step behind ``h0`` (``:421-422``) ->
  (dx [T,B,3H], dw [H,3H], dh0 [B,H]).
- :class:`FusedGRUTrain` and :func:`fused_gru_train` -- ``fused_gru_train``
  (``:402``) with the residuals of ``_gru_train_vjp_fwd`` (``:410-413``:
  xproj, w, seq_lens, h0, hidden) and ``rh``.

Layout as there: ``xproj`` [T,B,3H] (gate order u, r, c, bias included),
``w`` [H,3H] (``w_ur = w[:, :2H]``, ``w_c = w[:, 2H:]``), ``seq_lens``,
``h0`` [B,H]; ``h_t = (1 - u) * h + u * c``.

On the card the T steps run inside one cooperative launch each way, the
matrix products of a step in the kernels' own bodies; a step works only
on the rows still inside their length (:func:`_schedule`). The GRU
backward's grid kernel computes the gate pre-activations of every step in
one product before its loop, and both backwards compute ``dw`` in one
product after it on the tensor cores, in the same source. The plain
versions loop over time in PyTorch: they are for the CPU and for the
comparisons;
:func:`lstm_train_bwd_plain` and :func:`gru_train_bwd_plain` are the
explicit formulae, not autograd, so that each kernel output has a plain
counterpart.

Routing (``paddle_tpu_torch.device.uses_kernel``): CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32, contiguous), which is
built on its first launch; anything else raises. Up to H 512 each block
of a kernel keeps its slices of ``w`` in shared memory; above, the
wrapper allocates scratch in device memory for them
(:func:`_scratch`). Above 16 units on every SM (H > 2112 on an H100)
one block per SM walks several groups of 16 units a step, in passes
between the same grid barriers, their slices in that scratch too: every
width takes the one cooperative launch. All four kernels at H <= 512, H a
multiple of 4, run other kernels (:func:`rnn_plan`,
:func:`rnn_kernel_for`): clusters of 2 blocks that split each step's
products by depth (the cluster reads the state, or ``h_prev`` and ``rh``,
once) and exchange partial gates (and gate gradients) through distributed
shared memory, the products on the tensor cores at fp32 accuracy
(3xTF32); the backwards' ``dw`` products run on the tensor cores at every
width.
``LAUNCHES`` counts kernel launches per wrapper; only a kernel launch
adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops.kernels import build as _build

LAUNCHES = {"lstm_train_fwd": 0, "lstm_train_bwd": 0, "gru_train_fwd": 0,
            "gru_train_bwd": 0}
KINDS = {"lstm_train_fwd": 0, "lstm_train_bwd": 1, "gru_train_fwd": 2,
         "gru_train_bwd": 3}         # the kernels' Kind
# the kernels with a cluster kernel (all four), and its grid barriers a step
CLUSTER_BARRIERS = {"lstm_train_fwd": 1, "lstm_train_bwd": 1,
                    "gru_train_fwd": 2, "gru_train_bwd": 2}

CLUSTER = 2                   # blocks of a cluster of the cluster kernel
CLUSTER_UNITS = 4             # hidden units of one of its blocks
CLUSTER_MAX_H = 512           # its widest H (slices of w in shared memory)

_lib = None
_plans = {}
_barriers = {}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("fused_rnn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paddle_lstm_train_fwd.argtypes = ([p] * 15 + [ctypes.c_uint]
                                              + [i] * 4 + [p])
        lib.paddle_lstm_train_bwd.argtypes = ([p] * 22 + [ctypes.c_uint]
                                              + [i] * 4 + [p])
        lib.paddle_rnn_max_clusters.argtypes = [i, i]
        lib.paddle_rnn_max_clusters.restype = i
        lib.paddle_gru_train_fwd.argtypes = ([p] * 11 + [ctypes.c_uint]
                                             + [i] * 4 + [p])
        lib.paddle_gru_train_bwd.argtypes = ([p] * 16 + [ctypes.c_uint]
                                             + [i] * 4 + [p])
        lib.paddle_rnn_scratch_floats.argtypes = [i, i]
        lib.paddle_rnn_scratch_floats.restype = ctypes.c_longlong
        for fn in (lib.paddle_lstm_train_fwd, lib.paddle_lstm_train_bwd,
                   lib.paddle_gru_train_fwd, lib.paddle_gru_train_bwd):
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


def _check_kernel_args(name, tensors):
    """What the kernels take: fp32, contiguous."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_launch(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(name: str, h: int, device):
    """Device scratch for the blocks' slices of ``w`` where the kernel
    keeps them in global memory (H > 512), else None; the kernel says how
    many floats (``paddle_rnn_scratch_floats``)."""
    n = _kernels().paddle_rnn_scratch_floats(KINDS[name], h)
    if n < 0:
        raise RuntimeError(f"{name}: no launch at hidden width {h} on this "
                           f"card (CUDA error {-n})")
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def rnn_plan(h: int, sms: int, max_clusters: int):
    """Which kernel a recurrent kernel (each of the LSTM's and the GRU's
    two directions has a cluster kernel) runs at width ``h`` on a card of
    ``sms`` SMs that holds ``max_clusters`` of that cluster kernel's
    clusters at once (``cudaOccupancyMaxActiveClusters``): the blocks of the
    cluster kernel (ceil(h / ``CLUSTER_UNITS``) rounded up to whole
    clusters of ``CLUSTER``), or None for the grid kernel (H above
    ``CLUSTER_MAX_H`` or not a multiple of 4, or its clusters do not all
    fit)."""
    if h < 1 or h % 4 or h > CLUSTER_MAX_H:
        return None
    blocks = -(-h // (CLUSTER_UNITS * CLUSTER)) * CLUSTER
    return blocks if blocks <= min(sms, max_clusters * CLUSTER) else None


def _plan(name: str, h: int):
    """:func:`rnn_plan` of kernel ``name`` on the current card, asked once
    per width."""
    dev = torch.cuda.current_device()
    key = (dev, name, h)
    if key not in _plans:
        fit = 0
        if 0 < h <= CLUSTER_MAX_H:
            fit = _kernels().paddle_rnn_max_clusters(KINDS[name], h)
        if fit < 0:
            raise RuntimeError(f"{name}: no cluster occupancy at hidden "
                               f"width {h} (CUDA error {-fit})")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _plans[key] = rnn_plan(h, sms, fit)
    return _plans[key]


def _barrier(device):
    """The cluster kernels' grid-barrier counter on the current stream of
    ``device`` and the value the stream's next launch finds in it: a list
    [counter, value], zeroed once when first asked for. A launch adds T x
    blocks for each of its grid barriers a step (the LSTM's kernels one, the
    GRU's two) and the wrapper adds the same to the value, so launches in
    one stream share the counter and none zeroes it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    if key not in _barriers:
        _barriers[key] = [torch.zeros(1, dtype=torch.int32,
                                      device=torch.device("cuda", index)), 0]
    return _barriers[key]


def rnn_kernel_for(name: str, h: int, device) -> dict:
    """The kernel of ``name`` (a key of ``KINDS``) at width ``h`` on
    ``device``, as a run reports it: ``kernel`` "cluster" (with
    ``cluster``, ``units`` and ``blocks``) or "grid"."""
    with torch.cuda.device(device):
        plan = _plan(name, h)
    if plan is None:
        return {"kernel": "grid"}
    return {"kernel": "cluster", "cluster": CLUSTER, "units": CLUSTER_UNITS,
            "blocks": plan}


def _cluster_blocks(name, h, *staged):
    """The plan's blocks, or None where the rows its 16-byte copies stage
    (h0, hidden; the GRU's rh too) are not 16-byte aligned."""
    blocks = _plan(name, h)
    if blocks is not None and any(x.data_ptr() % 16 for x in staged):
        return None
    return blocks


def _advance(bar, base, err, name, t, blocks):
    """The barrier's value after a launch of kernel ``name`` from
    ``base``: T x blocks on for each of its barriers a step, or a new
    counter where the launch failed (its count is unknown)."""
    if err:
        bar[:] = [torch.zeros_like(bar[0]), 0]
    else:
        bar[1] = (base + CLUSTER_BARRIERS[name] * t * blocks) % 2 ** 32


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
    _check_kernel_args("lstm_train_fwd", (xproj, w, peep, h0, c0))
    lens, order, live = _schedule(seq_lens, t)
    hidden = torch.empty((t, b, h), dtype=torch.float32, device=xproj.device)
    cell = torch.empty_like(hidden)
    h_last, c_last = torch.empty_like(h0), torch.empty_like(c0)
    with torch.cuda.device(xproj.device):
        blocks = _cluster_blocks("lstm_train_fwd", h, h0, hidden)
        carry = ws = bar = None
        base = 0
        if blocks is None:
            blocks = 0
            carry = torch.empty((2, b, h), dtype=torch.float32,
                                device=xproj.device)
            ws = _scratch("lstm_train_fwd", h, xproj.device)
        else:
            bar = _barrier(xproj.device)
            base = bar[1]
        err = _kernels().paddle_lstm_train_fwd(
            xproj.data_ptr(), w.data_ptr(), peep.data_ptr(), lens.data_ptr(),
            order.data_ptr(), live.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hidden.data_ptr(), cell.data_ptr(), h_last.data_ptr(),
            c_last.data_ptr(), _ptr(carry), _ptr(ws),
            _ptr(bar[0] if bar else None), base, t, b, h, blocks,
            torch.cuda.current_stream().cuda_stream)
        if bar:
            _advance(bar, base, err, "lstm_train_fwd", t, blocks)
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
    _check_kernel_args("lstm_train_bwd", tensors)
    lens, order, live = _schedule(seq_lens, t)
    dx = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dpeep = torch.empty((1, 3 * h), dtype=torch.float32, device=xproj.device)
    dh0, dc0 = torch.empty_like(h0), torch.empty_like(c0)
    with torch.cuda.device(xproj.device):
        blocks = _cluster_blocks("lstm_train_bwd", h, h0, hidden)
        ws = part = bar = None
        base = 0
        if blocks is None:
            blocks = 0
            ws = _scratch("lstm_train_bwd", h, xproj.device)
        else:
            part = torch.empty((2, blocks // CLUSTER, b, h),
                               dtype=torch.float32, device=xproj.device)
            bar = _barrier(xproj.device)
            base = bar[1]
        err = _kernels().paddle_lstm_train_bwd(
            xproj.data_ptr(), w.data_ptr(), peep.data_ptr(), lens.data_ptr(),
            order.data_ptr(), live.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hidden.data_ptr(), cell.data_ptr(), dhid.data_ptr(),
            dcell.data_ptr(), dhlast.data_ptr(), dclast.data_ptr(),
            dx.data_ptr(), dw.data_ptr(),
            dpeep.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), _ptr(ws),
            _ptr(part), _ptr(bar[0] if bar else None), base, t, b, h,
            blocks,
            torch.cuda.current_stream().cuda_stream)
        if bar:
            _advance(bar, base, err, "lstm_train_bwd", t, blocks)
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


# -- GRU ---------------------------------------------------------------------

def _gates(xt, h, rh, w):
    """u, r, c of ``_gru_train_fwd_kernel`` (``:300-305``) from the step's
    pre-activations, the state and ``rh`` (``r * h``, or None to form it
    here)."""
    hdim = h.shape[-1]
    ur = torch.sigmoid(xt[:, :2 * hdim] + h @ w[:, :2 * hdim])
    u, r = ur[:, :hdim], ur[:, hdim:]
    if rh is None:
        rh = r * h
    c = torch.tanh(xt[:, 2 * hdim:] + rh @ w[:, 2 * hdim:])
    return u, r, c, rh


def gru_train_fwd_plain(xproj, w, seq_lens, h0):
    """Plain version of :func:`gru_train_fwd`: the cell step by step.
    Differentiable through autograd."""
    h = h0
    hs, rhs = [], []
    for t in range(xproj.shape[0]):
        u, _, c, rh = _gates(xproj[t], h, None, w)
        h_cand = (1.0 - u) * h + u * c
        m = _mask(t, seq_lens, h_cand)
        h = m * h_cand + (1.0 - m) * h
        hs.append(m * h_cand)
        rhs.append(m * rh)
    return torch.stack(hs), h, torch.stack(rhs)


def gru_train_bwd_plain(xproj, w, seq_lens, h0, hidden, rh, dhid, dhlast):
    """Plain version of :func:`gru_train_bwd`: the formulae of
    ``_gru_train_bwd_kernel`` (``:346-368``) in reverse time, the gates
    recomputed from ``xproj[t]``, ``h_prev`` and ``rh[t]``."""
    hdim = w.shape[0]
    w_ur, w_c = w[:, :2 * hdim], w[:, 2 * hdim:]
    h_prev_seq = torch.cat([h0[None], hidden[:-1]])
    dh = dhlast
    dx = torch.empty_like(xproj)
    dw = torch.zeros_like(w)
    for t in range(xproj.shape[0] - 1, -1, -1):
        h_prev = h_prev_seq[t]
        u, r, c, _ = _gates(xproj[t], h_prev, rh[t], w)
        m = _mask(t, seq_lens, h_prev)
        gh = m * (dh + dhid[t])
        du = gh * (c - h_prev)
        dc = gh * u
        dgc = dc * (1.0 - c * c)
        d_rh = dgc @ w_c.t()
        dr = d_rh * h_prev
        dgu = du * u * (1.0 - u)
        dgr = dr * r * (1.0 - r)
        dg_ur = torch.cat([dgu, dgr], dim=1)
        dx[t] = torch.cat([dg_ur, dgc], dim=1)
        dh = ((1.0 - m) * dh + gh * (1.0 - u) + d_rh * r
              + dg_ur @ w_ur.t())
        dw[:, :2 * hdim] += h_prev.t() @ dg_ur
        dw[:, 2 * hdim:] += rh[t].t() @ dgc
    return dx, dw, dh


def _check_gru_shapes(xproj, w, seq_lens, h0):
    if xproj.dim() != 3 or xproj.shape[2] % 3:
        raise ValueError(f"want xproj [T,B,3H], got {tuple(xproj.shape)}")
    t, b, h3 = xproj.shape
    h = h3 // 3
    if t == 0 or b == 0 or h == 0:
        raise ValueError(f"empty sequence batch {tuple(xproj.shape)}")
    if tuple(w.shape) != (h, h3):
        raise ValueError(f"want w [{h},{h3}], got {tuple(w.shape)}")
    if seq_lens.numel() != b:
        raise ValueError(f"want seq_lens [{b}], got {tuple(seq_lens.shape)}")
    if seq_lens.dtype.is_floating_point or seq_lens.dtype == torch.bool:
        raise ValueError(f"seq_lens must be integers, got {seq_lens.dtype}")
    if tuple(h0.shape) != (b, h):
        raise ValueError(f"want h0 [{b},{h}], got {tuple(h0.shape)}")
    return t, b, h


def gru_train_fwd(xproj, w, seq_lens, h0):
    """-> (hidden [T,B,H], h_last [B,H], rh [T,B,H])."""
    t, b, h = _check_gru_shapes(xproj, w, seq_lens, h0)
    if not _device.uses_kernel(xproj, w, seq_lens, h0):
        return gru_train_fwd_plain(xproj, w, seq_lens, h0)
    _check_kernel_args("gru_train_fwd", (xproj, w, h0))
    lens, order, live = _schedule(seq_lens, t)
    hidden = torch.empty((t, b, h), dtype=torch.float32, device=xproj.device)
    rh = torch.empty_like(hidden)
    h_last = torch.empty_like(h0)
    with torch.cuda.device(xproj.device):
        blocks = _cluster_blocks("gru_train_fwd", h, h0, hidden, rh)
        ws = bar = None
        base = 0
        if blocks is None:
            blocks = 0
            ws = _scratch("gru_train_fwd", h, xproj.device)
        else:
            bar = _barrier(xproj.device)
            base = bar[1]
        err = _kernels().paddle_gru_train_fwd(
            xproj.data_ptr(), w.data_ptr(), lens.data_ptr(), order.data_ptr(),
            live.data_ptr(), h0.data_ptr(), hidden.data_ptr(),
            h_last.data_ptr(), rh.data_ptr(), _ptr(ws),
            _ptr(bar[0] if bar else None), base, t, b, h, blocks,
            torch.cuda.current_stream().cuda_stream)
        if bar:
            _advance(bar, base, err, "gru_train_fwd", t, blocks)
    _check_launch(err, "gru_train_fwd")
    LAUNCHES["gru_train_fwd"] += 1
    return hidden, h_last, rh


def gru_train_bwd(xproj, w, seq_lens, h0, hidden, rh, dhid, dhlast):
    """-> (dx [T,B,3H], dw [H,3H], dh0 [B,H]) from the forward's inputs,
    its hidden and rh sequences and the cotangents of hidden and h_last."""
    t, b, h = _check_gru_shapes(xproj, w, seq_lens, h0)
    for name, s, like in (("hidden", hidden, (t, b, h)),
                          ("rh", rh, (t, b, h)),
                          ("dhid", dhid, (t, b, h)),
                          ("dhlast", dhlast, (b, h))):
        if tuple(s.shape) != like:
            raise ValueError(f"want {name} {list(like)}, got "
                             f"{tuple(s.shape)}")
    tensors = (xproj, w, h0, hidden, rh, dhid, dhlast)
    if not _device.uses_kernel(seq_lens, *tensors):
        return gru_train_bwd_plain(xproj, w, seq_lens, h0, hidden, rh, dhid,
                                   dhlast)
    _check_kernel_args("gru_train_bwd", tensors)
    lens, order, live = _schedule(seq_lens, t)
    dx = torch.empty_like(xproj)
    dw = torch.empty_like(w)
    dh0 = torch.empty_like(h0)
    with torch.cuda.device(xproj.device):
        blocks = _cluster_blocks("gru_train_bwd", h, h0, hidden, rh)
        ws = part = bar = None
        base = 0
        if blocks is None:
            blocks = 0
            ws = _scratch("gru_train_bwd", h, xproj.device)
        else:
            # the clusters' partials of d_rh and of Dh: [2, H, clusters,
            # B rounded up to 4]
            part = torch.empty((2, h, blocks // CLUSTER, -(-b // 4) * 4),
                               dtype=torch.float32, device=xproj.device)
            bar = _barrier(xproj.device)
            base = bar[1]
        err = _kernels().paddle_gru_train_bwd(
            xproj.data_ptr(), w.data_ptr(), lens.data_ptr(), order.data_ptr(),
            live.data_ptr(), h0.data_ptr(), hidden.data_ptr(), rh.data_ptr(),
            dhid.data_ptr(), dhlast.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            dh0.data_ptr(), _ptr(ws), _ptr(part),
            _ptr(bar[0] if bar else None), base, t, b, h, blocks,
            torch.cuda.current_stream().cuda_stream)
        if bar:
            _advance(bar, base, err, "gru_train_bwd", t, blocks)
    _check_launch(err, "gru_train_bwd")
    LAUNCHES["gru_train_bwd"] += 1
    return dx, dw, dh0


class FusedGRUTrain(torch.autograd.Function):
    """(hidden, h_last) of the whole sequence; the forward runs
    :func:`gru_train_fwd` and saves the residuals of ``_gru_train_vjp_fwd``
    (``:410-413``: xproj, w, seq_lens, h0, hidden) and ``rh``; the backward
    runs :func:`gru_train_bwd` on the cotangents of both outputs (zeros for
    one that gets none). ``seq_lens`` gets no gradient."""

    @staticmethod
    def forward(ctx, xproj, w, seq_lens, h0):
        hidden, h_last, rh = gru_train_fwd(xproj, w, seq_lens, h0)
        ctx.save_for_backward(xproj, w, seq_lens, h0, hidden, rh)
        return hidden, h_last

    @staticmethod
    def backward(ctx, dhid, dhlast):
        xproj, w, seq_lens, h0, hidden, rh = ctx.saved_tensors
        with torch.no_grad():
            dx, dw, dh0 = gru_train_bwd(xproj, w, seq_lens, h0, hidden, rh,
                                        dhid.contiguous(),
                                        dhlast.contiguous())
        return dx, dw, None, dh0


def fused_gru_train(xproj, w, seq_lens, h0):
    """Trainable whole-sequence GRU: xproj [T,B,3H], w [H,3H], seq_lens [B]
    integers, h0 [B,H] -> (hidden [T,B,H], h_last [B,H]), differentiable in
    xproj, w and h0."""
    return FusedGRUTrain.apply(xproj.contiguous(), w.contiguous(), seq_lens,
                               h0.contiguous())
