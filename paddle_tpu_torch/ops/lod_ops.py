"""Fused LoD operators (counterpart of ``paddle_tpu/ops/lod_ops.py``).

:func:`fused_embedding_seq_pool` is ``_fused_embedding_seq_pool``
(``:199-222``): a table lookup and a sum pool over time in one op. Its
forward is ``ops/kernels/embed_pool.py`` ``fused_embed_seq_pool`` (the
CUDA kernel on the card, the plain version on the CPU), and its gradients
are those the JAX package gives it:

- ``sparse=True``: the row-sparse table gradient of
  ``paddle_tpu/ops/grad_ops.py:72-85``, a sparse COO tensor with one row
  per position of ``ids``, **all B*T of them, masked positions included
  with zero values**. Coalesced (as the port's lazy ``Adam`` does), the
  rows are the distinct ids, as JAX's ``RowSparseGrad.deduped()`` gives
  them; lazy Adam then moves exactly the rows that JAX's moves, the ids
  seen only past a row's length among them.
- ``sparse=False``: the dense scatter-add of ``_embed_pool_bwd``
  (``paddle_tpu/ops/pallas/embed_pool.py:114-127``).

Its op emitter takes the dense gradient: the executor's row-sparse W
gradient comes from the ``__vjp__`` fast path (``ops/grad_ops.py``).

An id outside [0, V) reads the clipped row (the kernel's rule), and its
gradient goes to that row too.

The fused ops that the inference passes write (``fluid/ir_pass.py``), as
the JAX emitters compute them (``lod_ops.py:225-400``), each a function
over the port's ops with a thin op emitter beside it:

- :func:`conv2d_fusion` (``:290``): ``nn_ops.conv2d``, the channel bias,
  the ``ResidualData`` and the activation; its emitter reads the AMP and
  NHWC tags of ``contrib/`` (ROADMAP A1, A6.5) and passes them on to the
  conv.
- :func:`fusion_lstm` (``:357``), :func:`fused_embedding_fc_lstm`
  (``:363``) and :func:`fusion_gru` (``:351``): the gate projection (or
  the pre-multiplied table's rows), then ``rnn_ops.dynamic_lstm`` /
  ``dynamic_gru``, whose whole-sequence kernels run on the card.
- :func:`fusion_seqpool_concat` (``:225``): ``sequence_ops.
  sequence_pool`` of each input (the masked-pool kernel on the card for
  SUM / AVERAGE / SQRT, which divides by ``max(len, 1)`` as the fused
  JAX emitter does), concatenated on axis 1.
- :func:`fusion_seqconv_eltadd_relu` (``:380``): ``sequence_ops.
  sequence_conv``, the bias, relu.
- :func:`fusion_transpose_flatten_concat` (``:276``) and
  :func:`fusion_seqexpand_concat_fc` (``:390``).

An activation name the JAX emitter would pass over raises here.

Two more ops of the JAX file, plain torch with its numerics:
:func:`sequence_scatter` (``:165``; padded ids, clamped as the JAX op
clamps them, add 0) and :func:`lstmp` (``:417``, the LSTM with a
recurrent projection of ``fluid.layers.dynamic_lstmp``: a step loop, as
the JAX op's ``lax.scan``, not the LSTM kernel).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from paddle_tpu_torch.contrib.mixed_precision import policy_of
from paddle_tpu_torch.core.registry import first, register_op, single
from paddle_tpu_torch.ops import nn_ops, rnn_ops, sequence_ops
from paddle_tpu_torch.ops.kernels import embed_pool as _embed_pool


class FusedEmbeddingSeqPool(torch.autograd.Function):
    """[B, D] = sum over t < lens[b] of w[ids[b, t]]; differentiable in w
    (sparse or dense gradient), ``ids`` and ``lens`` get none."""

    @staticmethod
    def forward(ctx, w, ids, lens, sparse):
        ctx.save_for_backward(ids, lens)
        ctx.table = (w.shape[0], w.shape[1], w.dtype)
        ctx.sparse = sparse
        return _embed_pool.fused_embed_seq_pool(w, ids, lens)

    @staticmethod
    def backward(ctx, g):
        ids, lens = ctx.saved_tensors
        v, d, dtype = ctx.table
        b, t = ids.shape
        vals = g.to(dtype)[:, None, :].expand(b, t, d)
        if lens is not None:
            mask = torch.arange(t, device=g.device)[None, :] \
                < lens.reshape(-1, 1)
            vals = vals * mask[:, :, None].to(dtype)
        rows = ids.reshape(-1).long().clamp(0, v - 1)
        vals = vals.reshape(b * t, d)
        if ctx.sparse:
            dw = torch.sparse_coo_tensor(rows[None], vals, (v, d),
                                         check_invariants=False)
        else:
            dw = torch.zeros((v, d), dtype=dtype, device=g.device) \
                .index_add_(0, rows, vals)
        return dw, None, None, None


def fused_embedding_seq_pool(w: torch.Tensor, ids: torch.Tensor,
                             seq_lens: Optional[torch.Tensor] = None,
                             sparse: bool = True) -> torch.Tensor:
    """W [V, D], Ids [B, T] (or [B, T, 1]) integers, SeqLens [B] (None:
    every step counts) -> [B, D]."""
    if ids.dim() == 3:
        ids = ids[..., 0]
    return FusedEmbeddingSeqPool.apply(w, ids, seq_lens, bool(sparse))


# -- the fused ops of the inference passes --------------------------------

_FUSED_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh, "identity": None, "": None, None: None}


def _fused_act(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name not in _FUSED_ACTS:
        raise NotImplementedError(
            f"fused activation {name!r} is not ported (relu, sigmoid, "
            f"tanh, identity)")
    fn = _FUSED_ACTS[name]
    return x if fn is None else fn(x)


def conv2d_fusion(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  activation: str = "relu", stride=1, padding=0,
                  dilation=1, groups: int = 1, amp=None,
                  channels_last: bool = False) -> torch.Tensor:
    """act(conv2d(x, w) + bias [C] on axis 1 + residual), NCHW shapes; the
    bias and the residual cast to the conv's dtype (bf16 under a pure
    ``amp``, whose tags of ``conv2d`` the conv reads). With
    ``channels_last`` the conv and its epilogue run channels-last and the
    residual is made so."""
    out = nn_ops.conv2d(x, w, stride, padding, dilation, groups, amp,
                        channels_last=channels_last)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1).to(out.dtype)
    if residual is not None:
        if channels_last:
            residual = residual.contiguous(memory_format=torch.channels_last)
        out = out + residual.to(out.dtype)
    return _fused_act(out, activation)


def _projection(x: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """[B, T, Din] @ [Din, G*H] -> the gates, as the JAX einsum."""
    return torch.matmul(x, wx)


def fusion_lstm(x, wx, wh, bias=None, h0=None, c0=None, seq_lens=None,
                **lstm_attrs):
    """The gate projection x @ WeightX, then :func:`rnn_ops.dynamic_lstm`
    with the LSTM's own bias -> (Hidden, Cell)."""
    hid, cell, _, _ = rnn_ops.dynamic_lstm(_projection(x, wx), wh, bias, h0,
                                           c0, seq_lens, **lstm_attrs)
    return hid, cell


def fused_embedding_fc_lstm(table, ids, wh, bias=None, h0=None, c0=None,
                            seq_lens=None, **lstm_attrs):
    """Rows of the pre-multiplied table ``table`` [V, 4H] (ids [B, T] or
    [B, T, 1]), then :func:`rnn_ops.dynamic_lstm` -> (Hidden, Cell)."""
    if ids.dim() == 3:
        ids = ids[..., 0]
    hid, cell, _, _ = rnn_ops.dynamic_lstm(table[ids.long()], wh, bias, h0,
                                           c0, seq_lens, **lstm_attrs)
    return hid, cell


def fusion_gru(x, wx, wh, bias=None, h0=None, seq_lens=None, **gru_attrs):
    """The gate projection x @ WeightX plus the bias, then
    :func:`rnn_ops.dynamic_gru` -> Hidden."""
    proj = _projection(x, wx)
    if bias is not None:
        proj = proj + bias.reshape(1, 1, -1)
    hid, _ = rnn_ops.dynamic_gru(proj, wh, None, h0, seq_lens, **gru_attrs)
    return hid


def fusion_seqpool_concat(xs: List[torch.Tensor],
                          seq_lens: Optional[List[torch.Tensor]] = None,
                          pooltype: str = "SUM") -> torch.Tensor:
    """Each [B, T, D] input pooled over time by
    :func:`sequence_ops.sequence_pool` (its lengths, or all T), the
    pools concatenated on axis 1. A zero-length row pools to 0, as the
    JAX emitter's ``max(len, 1)`` divisor gives it."""
    seq_lens = seq_lens or []
    outs = [sequence_ops.sequence_pool(
        x, seq_lens[i] if i < len(seq_lens) else None, pooltype)
        for i, x in enumerate(xs)]
    return torch.cat(outs, dim=1)


def fusion_seqconv_eltadd_relu(x, filt, bias=None, seq_lens=None,
                               context_length: int = 3,
                               context_start: Optional[int] = None):
    """relu(sequence_conv(x) + bias [M])."""
    out = sequence_ops.sequence_conv(x, filt, seq_lens, context_length,
                                     context_start)
    if bias is not None:
        out = out + bias.reshape(1, 1, -1)
    return torch.relu(out)


def fusion_transpose_flatten_concat(xs, trans_axis, flatten_axis: int = 1,
                                    concat_axis: int = 1) -> torch.Tensor:
    """Each input transposed by ``trans_axis``, flattened to 2-D at
    ``flatten_axis``, the results concatenated on ``concat_axis``."""
    outs = []
    for x in xs:
        t = nn_ops.transpose(x, [int(a) for a in trans_axis])
        lead = math.prod(t.shape[:flatten_axis]) if flatten_axis > 0 else 1
        outs.append(t.reshape(lead, -1))
    return torch.cat(outs, dim=concat_axis)


def fusion_seqexpand_concat_fc(xs, w, bias=None,
                               activation: str = "identity"):
    """The sequence xs[0] [B, T, D0] and the rest [B, Di] broadcast over
    T, concatenated on the features, then act(. @ w + bias)."""
    seq = xs[0]
    b, t = seq.shape[0], seq.shape[1]
    parts = [seq] + [x[:, None, :].expand(b, t, x.shape[-1]) for x in xs[1:]]
    out = torch.matmul(torch.cat(parts, dim=-1), w)
    if bias is not None:
        out = out + bias.reshape(1, 1, -1)
    return _fused_act(out, activation)


def _lstm_attrs(attrs):
    """The ``dynamic_lstm`` op's attrs as :func:`rnn_ops.dynamic_lstm`
    takes them (``use_peepholes`` False when absent, as the op)."""
    return dict(use_peepholes=bool(attrs.get("use_peepholes", False)),
                is_reverse=bool(attrs.get("is_reverse", False)),
                gate_activation=attrs.get("gate_activation", "sigmoid"),
                cell_activation=attrs.get("cell_activation", "tanh"),
                candidate_activation=attrs.get("candidate_activation",
                                               "tanh"))


@register_op("fused_embedding_seq_pool",
             ref="operators/fused/fused_embedding_seq_pool_op.cc")
def _fused_embedding_seq_pool_op(ctx, ins, attrs):
    return single(fused_embedding_seq_pool(first(ins, "W"), first(ins, "Ids"),
                                           first(ins, "SeqLens"),
                                           sparse=False))


@register_op("conv2d_fusion", ref="operators/fused/conv_fusion_op.cc")
def _conv2d_fusion_op(ctx, ins, attrs):
    """The op's tags pass on to its conv, as the JAX op passes them
    (``lod_ops.py:290-325``): the AMP ones as the ``conv2d`` policy; under
    ``__nhwc__`` the input enters as ``nhwc_in`` has it, the epilogue
    runs channels-last, ``ResidualData`` is made channels-last unless
    ``__nhwc_resid_ready__`` says it is, and the output leaves as
    ``nhwc_out`` has it. Untagged, a channels-last residual is added to
    the contiguous conv (the layout follows the conv's)."""
    nhwc = bool(attrs.get("__nhwc__"))
    resid = first(ins, "ResidualData")
    if resid is not None and not nhwc \
            and attrs.get("__nhwc_resid_ready__"):
        resid = resid.contiguous()
    out = conv2d_fusion(
        nn_ops.nhwc_in(first(ins, "Input"), attrs), first(ins, "Filter"),
        first(ins, "Bias"), resid, attrs.get("activation", "relu"),
        attrs.get("strides", [1, 1]), attrs.get("paddings", [0, 0]),
        attrs.get("dilations", [1, 1]), attrs.get("groups", 1),
        policy_of("conv2d", attrs), channels_last=nhwc)
    return {"Output": [nn_ops.nhwc_out(out, attrs)]}


@register_op("fusion_lstm", ref="operators/fused/fusion_lstm_op.cc")
def _fusion_lstm_op(ctx, ins, attrs):
    hid, cell = fusion_lstm(
        *(first(ins, n) for n in ("X", "WeightX", "WeightH", "Bias", "H0",
                                  "C0", "SeqLens")), **_lstm_attrs(attrs))
    return {"Hidden": [hid], "Cell": [cell]}


@register_op("fused_embedding_fc_lstm",
             ref="operators/fused/fused_embedding_fc_lstm_op.cc")
def _fused_embedding_fc_lstm_op(ctx, ins, attrs):
    hid, cell = fused_embedding_fc_lstm(
        *(first(ins, n) for n in ("Embeddings", "Ids", "WeightH", "Bias",
                                  "H0", "C0", "SeqLens")),
        **_lstm_attrs(attrs))
    return {"Hidden": [hid], "Cell": [cell]}


@register_op("fusion_gru", ref="operators/fused/fusion_gru_op.cc")
def _fusion_gru_op(ctx, ins, attrs):
    return {"Hidden": [fusion_gru(
        *(first(ins, n) for n in ("X", "WeightX", "WeightH", "Bias", "H0",
                                  "SeqLens")),
        is_reverse=bool(attrs.get("is_reverse", False)),
        gate_activation=attrs.get("gate_activation", "sigmoid"),
        activation=attrs.get("activation", "tanh"))]}


@register_op("fusion_seqpool_concat",
             ref="operators/fused/fusion_seqpool_concat_op.cc")
def _fusion_seqpool_concat_op(ctx, ins, attrs):
    return single(fusion_seqpool_concat(
        ins.get("X", []), ins.get("SeqLens"),
        str(attrs.get("pooltype", "SUM")).upper()))


@register_op("fusion_seqconv_eltadd_relu",
             ref="operators/fused/fusion_seqconv_eltadd_relu_op.cc")
def _fusion_seqconv_eltadd_relu_op(ctx, ins, attrs):
    ctx_len = int(attrs.get("contextLength", 3))
    return single(fusion_seqconv_eltadd_relu(
        first(ins, "X"), first(ins, "Filter"), first(ins, "Bias"),
        first(ins, "SeqLens"), ctx_len,
        int(attrs.get("contextStart",
                      sequence_ops.default_context_start(ctx_len)))))


@register_op("fusion_transpose_flatten_concat",
             ref="operators/fused/fusion_transpose_flatten_concat_op.cc")
def _fusion_transpose_flatten_concat_op(ctx, ins, attrs):
    return single(fusion_transpose_flatten_concat(
        ins.get("X", []), attrs.get("trans_axis", [0, 2, 3, 1]),
        int(attrs.get("flatten_axis", 1)), int(attrs.get("concat_axis", 1))))


@register_op("fusion_seqexpand_concat_fc",
             ref="operators/fused/fusion_seqexpand_concat_fc_op.cc")
def _fusion_seqexpand_concat_fc_op(ctx, ins, attrs):
    return single(fusion_seqexpand_concat_fc(
        ins.get("X", []), first(ins, "FCWeight"), first(ins, "FCBias"),
        attrs.get("fc_activation", "identity")))


def sequence_scatter(x: torch.Tensor, ids: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """``_sequence_scatter`` (``:165-178``): X [B, D], Ids [B, S] (padded
    with -1), Updates [B, S] -> out[b, ids[b, s]] += updates[b, s] over
    the ids >= 0. The padding's ids are clamped into range, as the JAX
    op's are, and add 0 there."""
    valid = ids >= 0
    safe = ids.long().clamp(0, x.shape[1] - 1)
    return x.scatter_add(1, safe, torch.where(valid, updates,
                                              torch.zeros_like(updates)))


def lstmp(x: torch.Tensor, weight: torch.Tensor, proj_weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          h0: Optional[torch.Tensor] = None,
          c0: Optional[torch.Tensor] = None,
          seq_lens: Optional[torch.Tensor] = None):
    """``_lstmp`` (``:417-451``): an LSTM over the projected x [B, T, 4D]
    whose recurrent state is the projection h_t = (o * tanh(c_t)) @
    proj_weight [D, P]; weight [P, 4D]; the bias's first 4D columns are
    added to x (the JAX op uses no peepholes and the default
    activations). A step past a row's length keeps the state. ->
    (Projection [B, T, P], Cell [B, T, D]). A step loop in plain torch,
    not the LSTM kernel: the JAX op is a ``lax.scan``."""
    b, t, d4 = x.shape
    d = d4 // 4
    p = proj_weight.shape[1]
    if bias is not None:
        x = x + bias.reshape(1, 1, -1)[:, :, :d4]
    h = torch.zeros((b, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    c = torch.zeros((b, d), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    hs, cs = [], []
    for step in range(t):
        gates = x[:, step] + h @ weight
        i, f, cc, o = gates.split(d, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h_new = (torch.sigmoid(o) * torch.tanh(c_new)) @ proj_weight
        if seq_lens is not None:
            alive = step < seq_lens.reshape(-1, 1)
            c_new = torch.where(alive, c_new, c)
            h_new = torch.where(alive, h_new, h)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


@register_op("sequence_scatter",
             ref="operators/sequence_ops/sequence_scatter_op.cc")
def _sequence_scatter_op(ctx, ins, attrs):
    return single(sequence_scatter(first(ins, "X"), first(ins, "Ids"),
                                   first(ins, "Updates")))


@register_op("lstmp", ref="operators/lstmp_op.cc")
def _lstmp_op(ctx, ins, attrs):
    proj, cell = lstmp(*(first(ins, n) for n in (
        "Input", "Weight", "ProjWeight", "Bias", "H0", "C0", "SeqLens")))
    return {"Projection": [proj], "Cell": [cell]}
