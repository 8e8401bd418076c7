"""Beam-search decoding (counterpart of ``paddle_tpu/ops/beam_ops.py``).

Beams live in a dense [B, W] lane layout. A finished lane (its last id is
``end_id``) re-emits ``end_id`` at a frozen score, so the lane count never
changes; at step 0 only lane 0 is live (pre-scores ``[0, -1e9, ...]``).

- :func:`beam_step` -- ``_beam_step`` (``:33-50``): one step's selection
  over the flat [B, W*V] candidates. ``lax.top_k`` puts the lower index
  first among equal values; ``torch.topk`` promises no order for ties, so
  the selection is a stable descending sort, which keeps the JAX order.
- :func:`backtrack` -- ``_backtrack`` (``:68-80``): follow the parent
  pointers from the last step back -> tokens [B, W, T].
- :func:`beam_search` and :func:`beam_search_decode` -- the ops
  ``beam_search`` (``:53``) and ``beam_search_decode`` (``:83``) over them.
- :func:`attention_gru_beam_decode` -- ``_attention_gru_beam_decode``
  (``:99-165``): the whole beam loop of the attention-GRU seq2seq model
  (embedding, input projection, GRU step, Luong attention over the encoder
  states, output projection, :func:`beam_step`, lane reorder by parent),
  ``max_len`` steps of plain torch. The JAX op runs the decoder's GRU step
  inline (no Pallas kernel), and so does this loop.

The ops ``beam_search``, ``beam_search_decode`` and
``attention_gru_beam_decode`` of the program executor are thin adapters
onto these functions. Ids and parents come out int32, as from the JAX
ops. Nothing here carries a gradient.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import first, register_op

NEG_INF = -1e9                   # ``_NEG_INF``: a dead lane's score


@torch.no_grad()
def beam_step(pre_ids: torch.Tensor, pre_scores: torch.Tensor,
              scores: torch.Tensor, beam_size: int, end_id: int):
    """pre_ids [B, W] int, pre_scores [B, W], scores [B, W, V] per-lane
    next-token log-probabilities -> (sel_ids [B, K] int32, sel_scores
    [B, K], parent [B, K] int32), K = ``beam_size``."""
    b, w, v = scores.shape
    finished = pre_ids == end_id
    cand = pre_scores[:, :, None] + scores
    # a finished lane's only candidate is end_id, at its score unchanged
    cand = torch.where(finished[:, :, None],
                       torch.full_like(cand, NEG_INF), cand)
    cand[:, :, end_id] = torch.where(finished, pre_scores,
                                     cand[:, :, end_id])
    sel_scores, flat_idx = torch.sort(cand.reshape(b, w * v), dim=1,
                                      descending=True, stable=True)
    sel_scores, flat_idx = sel_scores[:, :beam_size], flat_idx[:, :beam_size]
    parent = torch.div(flat_idx, v, rounding_mode="floor")
    return ((flat_idx % v).to(torch.int32), sel_scores,
            parent.to(torch.int32))


@torch.no_grad()
def backtrack(ids_seq: torch.Tensor, par_seq: torch.Tensor) -> torch.Tensor:
    """ids_seq, par_seq [T, B, W] -> tokens [B, W, T] (int32): lane k's
    sentence is read from the last step back through the parents."""
    t_len, b, w = ids_seq.shape
    ptr = torch.arange(w, device=ids_seq.device).expand(b, w)
    toks = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        toks[t] = ids_seq[t].gather(1, ptr)
        ptr = par_seq[t].long().gather(1, ptr)
    return torch.stack(toks, dim=2).to(torch.int32)


def beam_search(pre_ids, pre_scores, scores, beam_size: int, end_id: int):
    """The ``beam_search`` op: -> (SelectedIds, SelectedScores,
    ParentIdx)."""
    return beam_step(pre_ids.to(torch.int32), pre_scores, scores,
                     int(beam_size), int(end_id))


def beam_search_decode(ids, parent_idx, scores=None):
    """The ``beam_search_decode`` op: Ids, ParentIdx [T, B, W] (and the
    final lane Scores [B, W]) -> (SentenceIds [B, W, T], SentenceScores or
    None)."""
    return backtrack(ids.long(), parent_idx.long()), scores


@torch.no_grad()
def attention_gru_beam_decode(enc, h0, emb, proj_w, proj_b, gru_w, gru_b,
                              attn_w, out_w, out_b, beam_size: int,
                              max_len: int, start_id: int, end_id: int):
    """enc [B, T, H] encoder states, h0 [B, H] the decoder's first state,
    emb [V, E], proj_w [E, 3H], proj_b [3H], gru_w [H, 3H], gru_b [1, 3H],
    attn_w [2H, H], out_w [H, V], out_b [V] -> (SentenceIds [B, W,
    max_len] int32, SentenceScores [B, W])."""
    b, _, hdim = enc.shape
    v = out_w.shape[1]
    w = int(beam_size)
    enc_t = enc.repeat_interleave(w, dim=0)                 # [B*W, T, H]
    h = h0.repeat_interleave(w, dim=0)                      # [B*W, H]
    pre_ids = torch.full((b, w), start_id, dtype=torch.int32,
                         device=enc.device)
    pre_scores = torch.full((b, w), NEG_INF, dtype=enc.dtype,
                            device=enc.device)
    pre_scores[:, 0] = 0.0
    scale = torch.sqrt(torch.tensor(float(hdim), dtype=enc.dtype))
    lane0 = torch.arange(b, device=enc.device)[:, None] * w
    ids_seq, par_seq = [], []
    for _ in range(int(max_len)):
        x = emb[pre_ids.reshape(-1).long()]                 # [B*W, E]
        g = x @ proj_w + proj_b + gru_b.reshape(-1)
        ur = torch.sigmoid(g[:, :2 * hdim] + h @ gru_w[:, :2 * hdim])
        u, r = ur[:, :hdim], ur[:, hdim:]
        c = torch.tanh(g[:, 2 * hdim:] + (r * h) @ gru_w[:, 2 * hdim:])
        h_new = (1.0 - u) * h + u * c
        attn = torch.softmax(
            torch.einsum("bh,bth->bt", h_new, enc_t) / scale.to(enc.device),
            dim=-1)
        ctx = torch.einsum("bt,bth->bh", attn, enc_t)
        h_att = torch.tanh(torch.cat([h_new, ctx], dim=1) @ attn_w)
        logp = torch.log_softmax(h_att @ out_w + out_b, dim=-1)
        ids, pre_scores, parent = beam_step(pre_ids, pre_scores,
                                            logp.reshape(b, w, v), w, end_id)
        # each lane's state follows its parent
        h = h_new[(lane0 + parent.long()).reshape(-1)]
        pre_ids = ids
        ids_seq.append(ids)
        par_seq.append(parent)
    return backtrack(torch.stack(ids_seq), torch.stack(par_seq)), pre_scores


@register_op("beam_search", no_grad=True,
             ref="operators/beam_search_op.cc BeamSearch::operator()")
def _beam_search_op(ctx, ins, attrs):
    """``:53``: PreIds, PreScores [B, W], Scores [B, W, V] ->
    SelectedIds, SelectedScores, ParentIdx."""
    ids, sc, parent = beam_search(first(ins, "PreIds"),
                                  first(ins, "PreScores"),
                                  first(ins, "Scores"),
                                  attrs["beam_size"], attrs["end_id"])
    return {"SelectedIds": [ids], "SelectedScores": [sc],
            "ParentIdx": [parent]}


@register_op("beam_search_decode", no_grad=True,
             ref="operators/beam_search_decode_op.cc BeamSearchDecoder")
def _beam_search_decode_op(ctx, ins, attrs):
    """``:83``: Ids, ParentIdx [T, B, W] (and Scores [B, W]) ->
    SentenceIds [B, W, T] (and SentenceScores)."""
    sent, scores = beam_search_decode(first(ins, "Ids"),
                                      first(ins, "ParentIdx"),
                                      first(ins, "Scores"))
    outs = {"SentenceIds": [sent]}
    if scores is not None:
        outs["SentenceScores"] = [scores]
    return outs


@register_op("attention_gru_beam_decode", no_grad=True,
             ref="capability: RecurrentGradientMachine beam generation "
                 "(legacy/gserver/gradientmachines/RecurrentGradientMachine"
                 ".cpp) + beam_search_op.cc, fused into one loop")
def _attention_gru_beam_decode_op(ctx, ins, attrs):
    """``:99``: EncOut, H0, Emb, ProjW, ProjB, GruW, GruB, AttnW, OutW,
    OutB -> SentenceIds [B, W, max_len] int32, SentenceScores [B, W]."""
    sent, scores = attention_gru_beam_decode(
        *(first(ins, n) for n in ("EncOut", "H0", "Emb", "ProjW", "ProjB",
                                  "GruW", "GruB", "AttnW", "OutW", "OutB")),
        beam_size=int(attrs["beam_size"]), max_len=int(attrs["max_len"]),
        start_id=int(attrs["start_id"]), end_id=int(attrs["end_id"]))
    return {"SentenceIds": [sent], "SentenceScores": [scores]}
