"""Recurrent operators (counterpart of ``paddle_tpu/ops/rnn_ops.py``).

:func:`dynamic_lstm` is ``_dynamic_lstm`` (``:49-157``): the input
projection is done outside (by ``fc``), so ``x`` is [B, T, 4H] with gate
order i, f, c~, o; the recurrent ``weight`` is [H, 4H]; ``bias`` is [1, 4H]
or, with peepholes, [1, 7H] (the gate bias, then W_ic | W_fc | W_oc);
variable-length rows are padded and masked by ``seq_lens`` [B].

The op's attribute rule (``:98-101``) picks the path: the default cell
(sigmoid gates, tanh cell and candidate) without reverse goes to
``fused_lstm_train`` (``ops/kernels/fused_rnn.py``: the whole-sequence
CUDA kernels on the card, their plain versions on the CPU); a reversed
sequence or other activations go to the step loop of ``:125-153`` in
torch, on either device. The JAX op's further conditions (``:105-107``:
H % 128, B % 8, a VMEM budget) are a TPU's and are not carried over.

:func:`dynamic_gru` is ``_dynamic_gru`` (``:160-219``): ``x`` is
[B, T, 3H] with gate order u, r, c~; the recurrent ``weight`` is [H, 3H]
(``[:, :2H]`` update and reset, ``[:, 2H:]`` candidate); ``bias`` is
[1, 3H]; ``h_t = (1 - u) * h + u * c``. Its attribute rule (``:190-192``)
sends the default cell (sigmoid gates, tanh candidate) without reverse to
``fused_gru_train`` (the whole-sequence CUDA kernels on the card, their
plain versions on the CPU), and a reversed sequence or another activation
to the step loop of ``:205-218``. The alignment and VMEM conditions
(``:194-196``) are not carried over, as for the LSTM.

:func:`lstm_unit` (``:222``) and :func:`gru_unit` (``:239``) are one
step each, plain torch: the JAX ops reach no kernel.

The ``dynamic_lstm``, ``dynamic_gru``, ``lstm_unit`` and ``gru_unit`` ops
of the program executor (``core/registry.py``) are thin adapters onto the
functions of their names.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.registry import first, register_op
from paddle_tpu_torch.ops.kernels import fused_rnn as _fused_rnn

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name):
    return _ACTS[name or "tanh"]


def dynamic_lstm(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 h0: Optional[torch.Tensor] = None,
                 c0: Optional[torch.Tensor] = None,
                 seq_lens: Optional[torch.Tensor] = None,
                 use_peepholes: bool = True, is_reverse: bool = False,
                 gate_activation: str = "sigmoid",
                 cell_activation: str = "tanh",
                 candidate_activation: str = "tanh"):
    """-> (Hidden [B,T,H], Cell [B,T,H], LastHidden [B,H], LastCell [B,H]);
    Hidden and Cell are zero past each row's length, the last states are
    those of each row's last valid step. Peepholes apply only with a
    [1, 7H] bias, as in the JAX op (``:72-73``)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)      # the recurrence runs in fp32 (``:59-66``)
    b, t, h4 = x.shape
    h = h4 // 4
    use_peepholes = bool(use_peepholes) and bias is not None \
        and bias.shape[-1] == 7 * h
    peep = None
    if bias is not None:
        flat = bias.reshape(-1)
        x = x + flat[:4 * h]
        if use_peepholes:
            peep = flat[4 * h:]
    h_init = h0 if h0 is not None else x.new_zeros((b, h))
    c_init = c0 if c0 is not None else x.new_zeros((b, h))
    xt_seq = x.transpose(0, 1)                          # [T, B, 4H]

    if (not is_reverse and gate_activation == "sigmoid"
            and cell_activation == "tanh"
            and candidate_activation == "tanh"):
        peep_arr = (peep.reshape(1, 3 * h).to(x.dtype) if use_peepholes
                    else x.new_zeros((1, 3 * h)))
        lens = (seq_lens.reshape(-1).to(torch.int32) if seq_lens is not None
                else torch.full((b,), t, dtype=torch.int32, device=x.device))
        hid_tm, cell_tm, h_last, c_last = _fused_rnn.fused_lstm_train(
            xt_seq, weight.to(x.dtype), peep_arr, lens, h_init, c_init)
        return (hid_tm.transpose(0, 1), cell_tm.transpose(0, 1), h_last,
                c_last)

    gate_act = _act(gate_activation)
    cell_act = _act(cell_activation)
    cand_act = _act(candidate_activation)
    if use_peepholes:
        w_ic, w_fc, w_oc = peep[:h], peep[h:2 * h], peep[2 * h:]
    hs, cs = [None] * t, [None] * t
    h_prev, c_prev = h_init, c_init
    for step in (range(t - 1, -1, -1) if is_reverse else range(t)):
        gates = xt_seq[step] + h_prev @ weight
        gi, gf = gates[:, :h], gates[:, h:2 * h]
        gc, go = gates[:, 2 * h:3 * h], gates[:, 3 * h:]
        if use_peepholes:
            gi = gi + c_prev * w_ic
            gf = gf + c_prev * w_fc
        c_new = gate_act(gf) * c_prev + gate_act(gi) * cand_act(gc)
        if use_peepholes:
            go = go + c_new * w_oc
        h_new = gate_act(go) * cell_act(c_new)
        if seq_lens is None:
            m = torch.ones((b, 1), dtype=h_new.dtype, device=h_new.device)
        else:
            m = (step < seq_lens.reshape(-1, 1)).to(h_new.dtype)
        h_prev = m * h_new + (1 - m) * h_prev
        c_prev = m * c_new + (1 - m) * c_prev
        hs[step], cs[step] = h_prev * m, c_prev * m
    return (torch.stack(hs, dim=1), torch.stack(cs, dim=1), h_prev, c_prev)


def dynamic_gru(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None,
                seq_lens: Optional[torch.Tensor] = None,
                is_reverse: bool = False, gate_activation: str = "sigmoid",
                activation: str = "tanh"):
    """-> (Hidden [B,T,H], LastHidden [B,H]); Hidden is zero past each
    row's length, LastHidden is each row's last valid state."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)      # the recurrence runs in fp32 (``:170``)
    b, t, h3 = x.shape
    h = h3 // 3
    if bias is not None:
        x = x + bias.reshape(-1)[:3 * h]
    h_init = h0 if h0 is not None else x.new_zeros((b, h))
    xt_seq = x.transpose(0, 1)                          # [T, B, 3H]

    if (not is_reverse and gate_activation == "sigmoid"
            and activation == "tanh"):
        lens = (seq_lens.reshape(-1).to(torch.int32) if seq_lens is not None
                else torch.full((b,), t, dtype=torch.int32, device=x.device))
        hid_tm, h_last = _fused_rnn.fused_gru_train(
            xt_seq, weight.to(x.dtype), lens, h_init)
        return hid_tm.transpose(0, 1), h_last

    gate_act = _act(gate_activation)
    cand_act = _act(activation)
    w_ur, w_c = weight[:, :2 * h], weight[:, 2 * h:]
    hs = [None] * t
    h_prev = h_init
    for step in (range(t - 1, -1, -1) if is_reverse else range(t)):
        xt = xt_seq[step]
        ur = gate_act(xt[:, :2 * h] + h_prev @ w_ur)
        u, r = ur[:, :h], ur[:, h:]
        c = cand_act(xt[:, 2 * h:] + (r * h_prev) @ w_c)
        h_new = (1.0 - u) * h_prev + u * c
        if seq_lens is None:
            m = torch.ones((b, 1), dtype=h_new.dtype, device=h_new.device)
        else:
            m = (step < seq_lens.reshape(-1, 1)).to(h_new.dtype)
        h_prev = m * h_new + (1 - m) * h_prev
        hs[step] = h_prev * m
    return torch.stack(hs, dim=1), h_prev


@register_op("dynamic_lstm", ref="operators/lstm_op.cc; math/lstm_compute.cc")
def _dynamic_lstm_op(ctx, ins, attrs):
    """The op (``paddle_tpu/ops/rnn_ops.py:49``) over :func:`dynamic_lstm`:
    Input [B,T,4H], Weight [H,4H], Bias, optional H0 / C0 and SeqLens ->
    Hidden, Cell, LastHidden, LastCell. ``use_peepholes`` defaults to
    False when the attr is absent, as in the JAX op."""
    hid, cell, h_last, c_last = dynamic_lstm(
        first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias"),
        first(ins, "H0"), first(ins, "C0"), first(ins, "SeqLens"),
        bool(attrs.get("use_peepholes", False)),
        bool(attrs.get("is_reverse", False)),
        attrs.get("gate_activation", "sigmoid"),
        attrs.get("cell_activation", "tanh"),
        attrs.get("candidate_activation", "tanh"))
    return {"Hidden": [hid], "Cell": [cell], "LastHidden": [h_last],
            "LastCell": [c_last]}


@register_op("dynamic_gru", ref="operators/gru_op.cc; math/gru_compute.cc")
def _dynamic_gru_op(ctx, ins, attrs):
    """The op (``paddle_tpu/ops/rnn_ops.py:160``) over :func:`dynamic_gru`:
    Input [B,T,3H], Weight [H,3H], optional Bias [1,3H], H0 and SeqLens
    -> Hidden, LastHidden."""
    hid, h_last = dynamic_gru(
        first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias"),
        first(ins, "H0"), first(ins, "SeqLens"),
        bool(attrs.get("is_reverse", False)),
        attrs.get("gate_activation", "sigmoid"),
        attrs.get("activation", "tanh"))
    return {"Hidden": [hid], "LastHidden": [h_last]}


def lstm_unit(x: torch.Tensor, c_prev: torch.Tensor,
              forget_bias: float = 0.0):
    """One LSTM step (``paddle_tpu/ops/rnn_ops.py:222``): x [B, 4H] the
    projected gates i, f, c~, o (the recurrent term included), c_prev
    [B, H] -> (c, h). Plain torch: the JAX op reaches no kernel."""
    h = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :h])
    f = torch.sigmoid(x[:, h:2 * h] + forget_bias)
    z = torch.tanh(x[:, 2 * h:3 * h])
    o = torch.sigmoid(x[:, 3 * h:])
    c = f * c_prev + i * z
    return c, o * torch.tanh(c)


def gru_unit(x: torch.Tensor, h_prev: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             activation: str = "tanh",
             gate_activation: str = "sigmoid") -> torch.Tensor:
    """One GRU step (``paddle_tpu/ops/rnn_ops.py:239``): x [B, 3H]
    projected, h_prev [B, H], weight [H, 3H], bias [1, 3H] -> h [B, H],
    the cell of :func:`dynamic_gru`. Plain torch: the JAX op reaches no
    kernel."""
    h = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(-1)
    ur = _act(gate_activation)(x[:, :2 * h] + h_prev @ weight[:, :2 * h])
    u, r = ur[:, :h], ur[:, h:]
    c = _act(activation)(x[:, 2 * h:] + (r * h_prev) @ weight[:, 2 * h:])
    return (1.0 - u) * h_prev + u * c


@register_op("lstm_unit", ref="operators/lstm_unit_op.cc")
def _lstm_unit_op(ctx, ins, attrs):
    c, h = lstm_unit(first(ins, "X"), first(ins, "C_prev"),
                     attrs.get("forget_bias", 0.0))
    return {"C": [c], "H": [h]}


@register_op("gru_unit", ref="operators/gru_unit_op.cc")
def _gru_unit_op(ctx, ins, attrs):
    return {"Hidden": [gru_unit(
        first(ins, "Input"), first(ins, "HiddenPrev"), first(ins, "Weight"),
        first(ins, "Bias"), attrs.get("activation", "tanh"),
        attrs.get("gate_activation", "sigmoid"))]}
