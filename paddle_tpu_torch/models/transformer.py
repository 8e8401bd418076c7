"""The transformer family (counterpart of
``paddle_tpu/models/transformer.py``): the decoder-only LM of the
serving path (``decoder_lm``, ``:228``) and the encoder-decoder
Transformer-base of the training path (``transformer``, ``:135``, and
``build``, ``:701``).

One :class:`DecoderLM` holds the weights; its views are methods, named
as the JAX modes:

- :meth:`DecoderLM.full` -- logits over a whole sequence with dense
  causal attention, recomputed from scratch (the JAX ``"full"`` mode:
  the parity oracle).
- :meth:`DecoderLM.prefill` / :meth:`DecoderLM.decode` -- the wave
  engine's pair: a batch of prompts at one prompt bucket, whose K/V land
  in a fresh :class:`ContiguousKVCache` of the batch's rows, then one
  token a row over that cache; both return logits (``"prefill"``,
  ``"decode"``).
- :meth:`DecoderLM.prefill_slot` / :meth:`DecoderLM.decode_slot` /
  :meth:`DecoderLM.decode_verify` -- the slot engine over the contiguous
  pool (the reference's default KV layout): one request's prompt into
  its slot's whole ``[cache_len, H, D]`` row, then one token (or, to
  verify, a ``[n_slots, K+1]`` window) for every slot, sampled on the
  device (``"prefill_slot"``, ``"decode_slot"``, ``"decode_verify"``).
- :meth:`DecoderLM.prefill_paged` / :meth:`DecoderLM.decode_paged` /
  :meth:`DecoderLM.decode_verify_paged` -- the same three over the paged
  pool: K/V read and written through the ``[n_slots, max_pages]`` page
  table, the prompt's rows through the request's page lease.

Each decode view is its verify view's window of one. The contiguous
views attend over the cache as it lies; the paged ones gather the pages
first, then attend through the same function, so in fp32 the two layouts
give the same bits. The caches (:class:`ContiguousKVCache`,
:class:`PagedKVCache`) belong to the serving engine, which passes them
to the views; :func:`validate_slots` and :func:`paged_geometry` check
their shape through the geometry record the program views use
(``analysis/contracts.py`` ``validate_geometry``). Weights come from a
JAX checkpoint through ``models/convert.py``; one :class:`DecoderLM`
serves every engine. The same model as serving programs
(``decoder_lm``, ``build_decoder_lm_programs``, ``slot_modes``) is
``paddle_tpu_torch/fluid/models/transformer.py``, re-exported here at
the JAX import path.

Training: :func:`build` makes a :class:`Transformer` (its ``forward``
is the mean label-smoothed loss of ``build``'s graph) and its
:class:`~paddle_tpu_torch.optimizer.Adam`. With ``fused_attention`` every
attention runs :func:`~paddle_tpu_torch.ops.attention_block.
fused_attention_block`, whose flash kernels run on the card; without it,
the composed matmul/softmax/dropout graph of ``multi_head_attention``.
With ``fused_head`` the vocabulary projection and the loss are one
:func:`~paddle_tpu_torch.ops.nn_ops.fused_linear_ce`, whose fused-CE
kernels run on the card; without it, the head's matmul and
``softmax_with_cross_entropy``.
Scope weights carry across with ``convert.transformer_params_from_jax``.
The training program of the same model (``build``'s ops and descs) is
``paddle_tpu_torch/fluid/models/transformer.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import learning_rate_scheduler as lrs
from paddle_tpu_torch.analysis.contracts import validate_geometry
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ops import attention_block as ab
from paddle_tpu_torch.ops import kv_attention as kva
from paddle_tpu_torch.ops import nn_ops

KV_CODECS = ("none", "bf16", "int8")
_STORE_DTYPES = {"none": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


def position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal table [max_len, d_model] (transformer.py:35)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * i / d_model)
    enc = np.zeros((max_len, d_model))
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc.astype(np.float32)


def _slot_prechecks(n_slots, spec_k):
    """The port's own checks before the shared record: a pool of at
    least one slot, and an explicit ``spec_k`` of at least 1 (the
    record takes a falsy ``spec_k`` as its default of 4)."""
    if not n_slots or int(n_slots) < 1:
        raise ValueError(f"slot serving needs n_slots >= 1, got {n_slots}")
    if spec_k is not None and int(spec_k) < 1:
        raise ValueError(f"spec_k {spec_k} < 1 -- the verify view "
                         f"needs at least one drafted token")


def validate_slots(prompt_len: int, cache_len: int, n_slots: int,
                   spec_k: Optional[int] = None):
    """Validate a slot pool of either layout through the serving
    geometry record (``analysis/contracts.py`` ``validate_geometry``, the
    one the program views use): ``n_slots >= 1``, ``prompt_len <=
    cache_len``, and ``spec_k``, the verify window's drafted tokens
    (None: no verify view), at least 1 with its K+1 window inside the
    generated region ``cache_len - prompt_len`` plus the row of the last
    committed token. Returns (n_slots, spec_k) as ints (spec_k may stay
    None)."""
    _slot_prechecks(n_slots, spec_k)
    g = validate_geometry(
        "decode_verify" if spec_k is not None else "decode_slot",
        prompt_len, int(cache_len) - int(prompt_len), cache_len=cache_len,
        n_slots=n_slots, spec_k=spec_k)
    return g.n_slots, g.spec_k


@dataclass(frozen=True)
class PagedGeometry:
    """The paged pool's geometry: ``n_pages`` pages of ``page_size``
    rows per layer, ``max_pages = cache_len / page_size`` table entries
    per slot, K/V stored per ``kv_codec``; ``spec_k`` drafted tokens a
    verify window (None: the engine decodes one token a step)."""
    cache_len: int
    n_slots: int
    page_size: int
    n_pages: int
    max_pages: int
    kv_codec: str
    spec_k: Optional[int] = None

    @property
    def store_dtype(self) -> torch.dtype:
        return _STORE_DTYPES[self.kv_codec]


def paged_geometry(prompt_len: int, cache_len: int, n_slots: int,
                   page_size: Optional[int] = None,
                   n_pages: Optional[int] = None,
                   kv_codec: str = "none",
                   spec_k: Optional[int] = None) -> PagedGeometry:
    """Validate and complete a paged geometry through the serving
    geometry record: the slot pool as :func:`validate_slots` checks it;
    ``page_size`` (default 4) must divide ``cache_len``; ``n_pages``
    defaults to the contiguous pool's capacity ``n_slots * max_pages``
    and must hold at least one whole request."""
    _slot_prechecks(n_slots, spec_k)
    g = validate_geometry(
        "decode_verify_paged" if spec_k is not None else "decode_paged",
        prompt_len, int(cache_len) - int(prompt_len), cache_len=cache_len,
        n_slots=n_slots, page_size=page_size, n_pages=n_pages,
        kv_codec=kv_codec, spec_k=spec_k)
    return PagedGeometry(g.cache_len, g.n_slots, g.page_size, g.n_pages,
                         g.max_pages, g.kv_codec, g.spec_k)


class ContiguousKVCache:
    """Per-layer contiguous caches: K and V ``[n, cache_len, H, D]``
    fp32, row ``b`` the cache of batch row (slot) ``b``. The slot engine
    keeps one of ``n_slots`` rows, zero-filled (:meth:`zeros`), that its
    views update in place; the wave engine's prefill returns a fresh one
    of its batch's rows. fp32 only: the reference keeps no codec for the
    contiguous layout (``analysis/contracts.py:184-185``)."""

    def __init__(self, k, v):
        self.k, self.v = list(k), list(v)
        self.n, self.cache_len = self.k[0].shape[:2]

    @classmethod
    def zeros(cls, n: int, cache_len: int, n_layer: int, n_head: int,
              head_dim: int, device: torch.device) -> "ContiguousKVCache":
        shape = (int(n), int(cache_len), n_head, head_dim)

        def planes():
            return [torch.zeros(shape, dtype=torch.float32, device=device)
                    for _ in range(n_layer)]
        return cls(planes(), planes())


class PagedKVCache:
    """Per-layer paged pools, zero-filled: K and V ``[n_pages,
    page_size, H, D]`` in the codec's storage dtype, plus ``[n_pages,
    page_size, H]`` fp32 scale planes for int8. The views update them in
    place."""

    def __init__(self, geometry: PagedGeometry, n_layer: int, n_head: int,
                 head_dim: int, device: torch.device):
        g = geometry
        self.geometry = g
        shape = (g.n_pages, g.page_size, n_head, head_dim)

        def planes(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=device)
                    for _ in range(n_layer)]
        self.k = planes(shape, g.store_dtype)
        self.v = planes(shape, g.store_dtype)
        if g.kv_codec == "int8":
            self.ks = planes(shape[:3], torch.float32)
            self.vs = planes(shape[:3], torch.float32)
        else:
            self.ks = self.vs = [None] * n_layer


class DecoderLayer(nn.Module):
    """Pre-norm block: attention then FFN, each added to the residual.
    Weight layouts follow the JAX scope: [in, out] matrices."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__()
        m, i = d_model, d_inner
        self.ln1_scale = nn.Parameter(torch.ones(m))
        self.ln1_bias = nn.Parameter(torch.zeros(m))
        self.wq = nn.Parameter(torch.zeros(m, m))
        self.wk = nn.Parameter(torch.zeros(m, m))
        self.wv = nn.Parameter(torch.zeros(m, m))
        self.wo = nn.Parameter(torch.zeros(m, m))
        self.ln2_scale = nn.Parameter(torch.ones(m))
        self.ln2_bias = nn.Parameter(torch.zeros(m))
        self.ffn1_w = nn.Parameter(torch.zeros(m, i))
        self.ffn1_b = nn.Parameter(torch.zeros(i))
        self.ffn2_w = nn.Parameter(torch.zeros(i, m))
        self.ffn2_b = nn.Parameter(torch.zeros(m))

    def forward(self, x, attend):
        """``attend(x_normed, wq, wk, wv, wo)`` is the view's attention."""
        a = nn_ops.layer_norm(x, self.ln1_scale, self.ln1_bias)
        x = x + attend(a, self.wq, self.wk, self.wv, self.wo)
        f = nn_ops.layer_norm(x, self.ln2_scale, self.ln2_bias)
        h = nn_ops.fc(f, self.ffn1_w, self.ffn1_b, act="relu")
        return x + nn_ops.fc(h, self.ffn2_w, self.ffn2_b)


class DecoderLM(nn.Module):
    """Decoder-only LM at the widths of ``decoder_lm``: token embedding
    times sqrt(d_model) plus the sinusoidal position table (sized
    ``cache_len``), ``n_layer`` pre-norm blocks, final layer norm, and
    an untied vocabulary head. The weights start as zeros (layer-norm
    scales as ones): load them with ``load_state_dict``, e.g. from
    ``models.convert.params_from_jax``. Runs on ``device`` (``cuda``
    unless ``"cpu"`` is asked for)."""

    def __init__(self, vocab: int, d_model: int, d_inner: int, n_head: int,
                 n_layer: int, cache_len: int, device=None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} not divisible by n_head "
                             f"{n_head}")
        self.vocab, self.d_model, self.d_inner = vocab, d_model, d_inner
        self.n_head, self.n_layer = n_head, n_layer
        self.cache_len = int(cache_len)
        self.emb = nn.Parameter(torch.zeros(vocab, d_model))
        self.layers = nn.ModuleList(DecoderLayer(d_model, d_inner)
                                    for _ in range(n_layer))
        self.lnf_scale = nn.Parameter(torch.ones(d_model))
        self.lnf_bias = nn.Parameter(torch.zeros(d_model))
        self.head_w = nn.Parameter(torch.zeros(d_model, vocab))
        self.register_buffer(
            "pos_enc",
            torch.from_numpy(position_encoding(self.cache_len, d_model)),
            persistent=False)
        self.requires_grad_(False)
        self.to(_device.resolve(device))

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def new_cache(self, geometry: PagedGeometry) -> PagedKVCache:
        if geometry.cache_len != self.cache_len:
            raise ValueError(f"geometry cache_len {geometry.cache_len} != "
                             f"model cache_len {self.cache_len}")
        return PagedKVCache(geometry, self.n_layer, self.n_head,
                            self.d_model // self.n_head, self.device)

    def contiguous_cache(self, n: int) -> ContiguousKVCache:
        """A zero-filled contiguous cache of ``n`` rows of ``cache_len``
        positions (the slot pool), on the model's device."""
        return ContiguousKVCache.zeros(n, self.cache_len, self.n_layer,
                                       self.n_head,
                                       self.d_model // self.n_head,
                                       self.device)

    def _embed(self, ids: torch.Tensor, positions: torch.Tensor):
        """ids [B, T] -> emb[ids] * sqrt(M) + pe[positions]."""
        # ids [..., 1]: the table keeps the ids' shape at any T, 1 too
        x = nn_ops.scale(nn_ops.lookup_table(self.emb, ids[..., None]),
                         self.d_model ** 0.5)
        return x + nn_ops.lookup_table(self.pos_enc, positions[..., None])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = nn_ops.layer_norm(x, self.lnf_scale, self.lnf_bias)
        return nn_ops.fc(x, self.head_w)

    @torch.no_grad()
    def full(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, T] (T <= cache_len) -> logits [B, T, V] under dense
        causal attention -- the recompute oracle."""
        ids = ids.to(self.device)
        t = ids.shape[1]
        x = self._embed(ids, torch.arange(t, device=self.device))
        h = self.n_head
        for layer in self.layers:
            x = layer(x, lambda a, wq, wk, wv, wo:
                      kva.causal_prefill(a, wq, wk, wv, wo, h)[0])
        return self._logits(x)

    def _to_device(self, *feeds):
        """Host feeds to the model's device, all before the view enqueues
        any kernel: a copy from pageable host memory waits for the
        stream, so a copy after the layers would stall their launch."""
        return [f.to(self.device) for f in feeds]

    def _layers(self, x, attend):
        """Every block over ``x``; ``attend(i, a, wq, wk, wv, wo)`` is
        layer ``i``'s attention."""
        for i, layer in enumerate(self.layers):
            x = layer(x, lambda *a, i=i: attend(i, *a))
        return x

    # -- the wave engine's views (transformer.py:298-310, :405-440) ------
    @torch.no_grad()
    def prefill(self, ids):
        """ids [B, P] (prompts right-padded to the bucket P) -> (logits
        [B, P, V], a fresh :class:`ContiguousKVCache` of B rows holding
        the prompts' K/V in positions < P and zeros beyond)."""
        (ids,) = self._to_device(ids)
        p = ids.shape[1]
        x = self._embed(ids, torch.arange(p, device=self.device))
        ks, vs = [], []

        def attend(i, a, wq, wk, wv, wo):
            out, k, v = kva.kv_attention_prefill(a, wq, wk, wv, wo,
                                                 self.n_head, self.cache_len)
            ks.append(k)
            vs.append(v)
            return out
        logits = self._logits(self._layers(x, attend))
        return logits, ContiguousKVCache(ks, vs)

    @torch.no_grad()
    def decode(self, tok, pos, seq_len, gen_start, active,
               cache: ContiguousKVCache) -> torch.Tensor:
        """One decode step of a wave: tok [B, 1] (each row's last token),
        pos/seq_len/gen_start/active [B, 1] (cache write index, true
        prompt length, first generated position, live flag) over the
        wave's ``cache`` -> logits [B, 1, V]. Rows with active 0 write
        nothing."""
        geom = kva.slot_geometry(pos, seq_len, gen_start, active, None, 1,
                                 cache.n, cache.cache_len, self.device)
        logits, _ = self._window(tok, pos, seq_len, gen_start, 1,
                                 self._slot_attend(cache, geom))
        return logits

    # -- the slot views: contiguous pool, then paged ----------------------
    def _slot_attend(self, cache: ContiguousKVCache, geom):
        def attend(i, a, wq, wk, wv, wo):
            return kva.verify_slot_layer(a, wq, wk, wv, wo, cache.k[i],
                                         cache.v[i], geom, self.n_head)
        return attend

    def _paged_attend(self, cache: PagedKVCache, geom):
        codec = cache.geometry.kv_codec

        def attend(i, a, wq, wk, wv, wo):
            return kva.verify_paged_layer(a, wq, wk, wv, wo, cache.k[i],
                                          cache.v[i], cache.ks[i],
                                          cache.vs[i], geom, self.n_head,
                                          codec)
        return attend

    def _prefill_sample(self, ids, seq_len, seed, temperature, top_k,
                        attend) -> torch.Tensor:
        """The slot prefills' body: ids [1, P], the first token sampled
        at the prompt's last true position by ``token_sample``."""
        dev = self.device
        last = seq_len.reshape(-1).long() - 1
        ids, last, seed, temperature, top_k = self._to_device(
            ids.reshape(1, -1), last, seed, temperature, top_k)
        p = ids.shape[1]
        x = self._layers(self._embed(ids, torch.arange(p, device=dev)),
                         attend)
        logits = self._logits(x[0, last])                    # [1, V]
        return kva.token_sample(logits, temperature, top_k, seed,
                                torch.zeros_like(seed))

    @torch.no_grad()
    def prefill_slot(self, ids, seq_len, slot, seed, temperature, top_k,
                     cache: ContiguousKVCache) -> torch.Tensor:
        """ids [1, P] (a prompt right-padded to its bucket P), seq_len
        [1, 1] (its true length), slot [1, 1] (the pool row it takes),
        seed/temperature/top_k [1, 1] -> the first generated token [1, 1],
        sampled at the prompt's last true position. Overwrites the slot's
        whole row of ``cache`` in place: the prompt's K/V, zeros
        beyond."""
        write = kva.slot_write(slot, cache.n, cache.cache_len, self.device)

        def attend(i, a, wq, wk, wv, wo):
            return kva.prefill_slot_layer(a, wq, wk, wv, wo, cache.k[i],
                                          cache.v[i], write, self.n_head)
        return self._prefill_sample(ids, seq_len, seed, temperature, top_k,
                                    attend)

    @torch.no_grad()
    def prefill_paged(self, ids, seq_len, page_rows, seed, temperature,
                      top_k, cache: PagedKVCache) -> torch.Tensor:
        """ids [1, P] (a prompt right-padded to its bucket P), seq_len
        [1, 1] (its true length), page_rows [P, 1] (the flat pool row of
        each position; sentinels skip prefix-shared pages), seed/
        temperature/top_k [1, 1] -> the first generated token [1, 1],
        sampled at the prompt's last true position. Writes the prompt's
        K/V into ``cache`` in place."""
        g = cache.geometry
        write = kva.RowWrite.of(page_rows, g.n_pages * g.page_size,
                                self.device)

        def attend(i, a, wq, wk, wv, wo):
            return kva.prefill_paged_layer(
                a, wq, wk, wv, wo, cache.k[i], cache.v[i], cache.ks[i],
                cache.vs[i], write, self.n_head, g.kv_codec)
        return self._prefill_sample(ids, seq_len, seed, temperature, top_k,
                                    attend)

    def _window(self, tok, pos, seq_len, gen_start, k1: int, attend,
                *feeds):
        """The decode and verify views' body: tok [S, K1] at window
        position ``i``'s semantic position, seq_len + generated-so-far +
        i = seq_len + pos - gen_start + i (prompts are right-padded to
        their bucket, the cache row is storage only). Clamped: a free
        slot's is -1, and positions past win_len may run past the cache;
        neither is committed. Returns (logits [S, K1, V], ``feeds`` on
        the device)."""
        s = tok.reshape(-1, k1).shape[0]
        sem = (seq_len.reshape(-1, 1).long() + pos.reshape(-1, 1).long()
               - gen_start.reshape(-1, 1).long()
               + torch.arange(k1, device=pos.device))
        sem = sem.clamp(0, self.cache_len - 1)
        tok, sem, *feeds = self._to_device(tok.reshape(s, k1), sem, *feeds)
        x = self._layers(self._embed(tok, sem), attend)
        return self._logits(x), feeds

    def _sample_window(self, tok, pos, seq_len, gen_start, seed,
                       sample_step, temperature, top_k,
                       attend) -> torch.Tensor:
        """Every window position's token [S, K1], sampled by
        ``token_sample`` from its (seed, sample_step) draw."""
        s, k1 = sample_step.shape
        logits, (seed, sample_step, temperature, top_k) = self._window(
            tok, pos, seq_len, gen_start, k1, attend, seed, sample_step,
            temperature, top_k)
        out = kva.token_sample(logits.reshape(s * k1, -1),
                               temperature.reshape(-1, 1),
                               top_k.reshape(-1, 1), seed.reshape(-1, 1),
                               sample_step.reshape(-1, 1))
        return out.view(s, k1)

    @torch.no_grad()
    def decode_slot(self, tok, pos, seq_len, gen_start, active, seed,
                    sample_step, temperature, top_k,
                    cache: ContiguousKVCache) -> torch.Tensor:
        """One decode step over every slot of the contiguous pool: the
        feeds of :meth:`decode_paged` without the page table -> next
        tokens [S, 1]. The verify view's window of one."""
        return self.decode_verify(tok, pos, seq_len, gen_start, active,
                                  None, seed, sample_step, temperature,
                                  top_k, cache)

    @torch.no_grad()
    def decode_verify(self, tok, pos, seq_len, gen_start, active, win_len,
                      seed, sample_step, temperature, top_k,
                      cache: ContiguousKVCache) -> torch.Tensor:
        """One speculative verify step over every slot of the contiguous
        pool: the feeds of :meth:`decode_verify_paged` without the page
        table -> the token sampled at every window position [S, K1].
        Window positions < win_len of live slots write their K/V rows
        (inside the cache); the rest ride along masked."""
        geom = kva.slot_geometry(pos, seq_len, gen_start, active, win_len,
                                 sample_step.shape[1], cache.n,
                                 cache.cache_len, self.device)
        return self._sample_window(tok, pos, seq_len, gen_start, seed,
                                   sample_step, temperature, top_k,
                                   self._slot_attend(cache, geom))

    @torch.no_grad()
    def decode_paged(self, tok, pos, seq_len, gen_start, active, seed,
                     sample_step, temperature, top_k, page_table,
                     cache: PagedKVCache) -> torch.Tensor:
        """One decode step over every slot: tok [S, 1] (each slot's last
        token), pos/seq_len/gen_start/active [S, 1] (cache write index,
        true prompt length, first generated position, live flag),
        seed/sample_step/temperature/top_k [S, 1] (sampling state),
        page_table [S, max_pages] -> next tokens [S, 1]. Inactive slots
        ride along masked: their pages are not written. The verify
        view's window of one."""
        return self.decode_verify_paged(tok, pos, seq_len, gen_start,
                                        active, None, seed, sample_step,
                                        temperature, top_k, page_table,
                                        cache)

    @torch.no_grad()
    def decode_verify_paged(self, tok, pos, seq_len, gen_start, active,
                            win_len, seed, sample_step, temperature, top_k,
                            page_table, cache: PagedKVCache) -> torch.Tensor:
        """One speculative verify step over every slot: tok [S, K1] (each
        slot's last committed token, then its drafts), pos/seq_len/
        gen_start/active/win_len [S, 1] (the cache row of window position
        0, true prompt length, first generated position, live flag,
        valid window positions; win_len None: all K1), seed/sample_step/
        temperature/top_k [S, K1] (the sampling state of each window
        position: sample_step[b, i] = gen_count[b] + i), page_table
        [S, max_pages] -> the token sampled at every window position
        [S, K1]. Window positions < win_len of live slots write their
        K/V rows; the rest ride along masked."""
        g = cache.geometry
        geom = kva.verify_geometry(page_table, pos, seq_len, gen_start,
                                   active, win_len, sample_step.shape[1],
                                   g.n_pages, g.page_size, self.device)
        return self._sample_window(tok, pos, seq_len, gen_start, seed,
                                   sample_step, temperature, top_k,
                                   self._paged_attend(cache, geom))


# ---------------------------------------------------------------------------
# Transformer-base training (transformer.py:45-177, :701-770)
# ---------------------------------------------------------------------------

class AttentionWeights(nn.Module):
    """The four [M, M] projections of one attention, [in, out] layout."""

    def __init__(self, d_model: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.zeros(d_model, d_model)))


def multi_head_attention(x_q, x_kv, w: AttentionWeights, n_head: int,
                         mask=None, dropout_p: float = 0.0, seed: int = 0,
                         amp=None):
    """The composed attention of ``multi_head_attention`` (``:72-93``):
    projections, q scaled by D**-0.5, ``q k^T`` (+ the additive mask),
    softmax, dropout on the weights (``upscale_in_train``), ``w v``,
    heads merged, ``Wo``; its ``mul``, ``matmul`` and mask add under
    ``amp``. No kernel: the card-side oracle of the fused block."""
    b, tq, m = x_q.shape
    tk = x_kv.shape[1]
    h, d = n_head, m // n_head

    def split_heads(x, wt, t):                       # [B,T,M] -> [B,H,T,D]
        return nn_ops.fc(x, wt, amp=amp).view(b, t, h, d).transpose(1, 2)
    q = nn_ops.scale(split_heads(x_q, w.wq, tq), d ** -0.5)
    k, v = split_heads(x_kv, w.wk, tk), split_heads(x_kv, w.wv, tk)
    logits = nn_ops.matmul(q, k, transpose_y=True, amp=amp)  # [B,H,Tq,Tk]
    if mask is not None:
        logits = nn_ops.elementwise_add(logits, mask, amp)
    weights = nn_ops.softmax(logits)
    if dropout_p:
        weights = nn_ops.dropout(weights, dropout_p, seed)
    ctx = nn_ops.matmul(weights, v, amp=amp).transpose(1, 2) \
        .reshape(b, tq, m)
    return nn_ops.fc(ctx, w.wo, amp=amp)


class _FFN(nn.Module):
    def __init__(self, d_model: int, d_inner: int):
        super().__init__()
        self.ffn1_w = nn.Parameter(torch.zeros(d_model, d_inner))
        self.ffn1_b = nn.Parameter(torch.zeros(d_inner))
        self.ffn2_w = nn.Parameter(torch.zeros(d_inner, d_model))
        self.ffn2_b = nn.Parameter(torch.zeros(d_model))


class EncoderLayer(_FFN):
    """``encoder_layer`` (``:111``): pre-norm self-attention, then FFN."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__(d_model, d_inner)
        self.ln1_scale = nn.Parameter(torch.ones(d_model))
        self.ln1_bias = nn.Parameter(torch.zeros(d_model))
        self.attn = AttentionWeights(d_model)
        self.ln2_scale = nn.Parameter(torch.ones(d_model))
        self.ln2_bias = nn.Parameter(torch.zeros(d_model))


class Seq2SeqDecoderLayer(_FFN):
    """``decoder_layer`` (``:120``): pre-norm causal self-attention,
    cross-attention over the encoder output, then FFN."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__(d_model, d_inner)
        self.ln1_scale = nn.Parameter(torch.ones(d_model))
        self.ln1_bias = nn.Parameter(torch.zeros(d_model))
        self.self_attn = AttentionWeights(d_model)
        self.ln2_scale = nn.Parameter(torch.ones(d_model))
        self.ln2_bias = nn.Parameter(torch.zeros(d_model))
        self.cross_attn = AttentionWeights(d_model)
        self.ln3_scale = nn.Parameter(torch.ones(d_model))
        self.ln3_bias = nn.Parameter(torch.zeros(d_model))


class Transformer(nn.Module):
    """The encoder-decoder of ``transformer`` (``:135``) with the loss of
    ``build``: ``forward(src_ids, tgt_ids, lbl_ids)`` -> the mean over
    every position of the label-smoothed softmax cross entropy of the
    vocabulary head ``head_w``: the head's matmul and
    ``softmax_with_cross_entropy``, or with ``fused_head`` the one op
    ``fused_linear_ce`` over the flattened decoder output (``build``,
    ``:721-731``). ``logits`` is the same either way.

    Dropout (``dropout > 0``, in training mode) follows the JAX graph:
    after each embedding, on each sublayer's output before its residual
    add, inside the FFN, and on the attention weights. Every site draws
    a fresh int32 seed from ``generator`` (a CPU ``torch.Generator``;
    torch's default one when None) on each forward, and the counter-hash
    masks of the JAX ops turn it into keep bits. Weights start from the
    port's own initialization (``reset_parameters``); parity runs load
    the JAX scope instead (``convert.transformer_params_from_jax``).

    ``amp`` holds the AMP tags of each op type (empty: fp32), which
    ``contrib.mixed_precision.rewrite_program_amp`` sets from
    :meth:`op_sites`; every op of the forward reads its own."""

    def __init__(self, src_vocab: int, tgt_vocab: int, max_len: int,
                 d_model: int = 512, d_inner: int = 2048, n_head: int = 8,
                 n_layer: int = 6, dropout: float = 0.1,
                 label_smooth_eps: float = 0.1,
                 fused_attention: bool = False, device=None,
                 generator: Optional[torch.Generator] = None,
                 fused_head: bool = False):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} not divisible by n_head "
                             f"{n_head}")
        self.src_vocab, self.tgt_vocab = int(src_vocab), int(tgt_vocab)
        self.max_len, self.d_model, self.d_inner = int(max_len), d_model, \
            d_inner
        self.n_head, self.n_layer = n_head, n_layer
        self.dropout_p = float(dropout)
        self.label_smooth_eps = float(label_smooth_eps)
        self.fused_attention = bool(fused_attention)
        self.fused_head = bool(fused_head)
        self.generator = generator
        self.amp = {}
        m = d_model
        self.src_emb = nn.Parameter(torch.zeros(src_vocab, m))
        self.encoder = nn.ModuleList(EncoderLayer(m, d_inner)
                                     for _ in range(n_layer))
        self.enc_ln_scale = nn.Parameter(torch.ones(m))
        self.enc_ln_bias = nn.Parameter(torch.zeros(m))
        self.tgt_emb = nn.Parameter(torch.zeros(tgt_vocab, m))
        self.decoder = nn.ModuleList(Seq2SeqDecoderLayer(m, d_inner)
                                     for _ in range(n_layer))
        self.dec_ln_scale = nn.Parameter(torch.ones(m))
        self.dec_ln_bias = nn.Parameter(torch.zeros(m))
        self.head_w = nn.Parameter(torch.zeros(m, tgt_vocab))
        self.register_buffer(
            "pos_enc", torch.from_numpy(position_encoding(max_len, m)),
            persistent=False)
        causal = np.triu(np.full((max_len, max_len), -1e9, np.float32), k=1)
        self.register_buffer("causal_mask",
                             torch.from_numpy(causal)[None, None],
                             persistent=False)
        self.reset_parameters()
        self.to(_device.resolve(device))

    @property
    def device(self) -> torch.device:
        return self.src_emb.device

    def op_sites(self):
        """The op type of each site of ``build``'s forward that the AMP
        rewrite reads (the AMP op types, the elementwise binaries and
        ``lookup_table``), one entry a site."""
        add = "elementwise_add"
        if self.fused_attention:
            attn, self_attn = ["fused_attention_block"], \
                ["fused_attention_block"]
        else:
            attn = ["mul"] * 3 + ["matmul"] * 2 + ["mul"]
            self_attn = ["mul"] * 3 + ["matmul", add, "matmul", "mul"]
        ffn = ["mul", add, "mul", add]
        embed = ["lookup_table", add]
        enc = attn + [add] + ffn + [add]
        dec = self_attn + [add] + attn + [add] + ffn + [add]
        head = ["fused_linear_ce"] if self.fused_head else ["mul"]
        return (embed + enc * self.n_layer + embed + dec * self.n_layer
                + head)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Embeddings ~ N(0, d_model**-0.5) (as ``build`` names them),
        matrices Xavier-uniform, biases 0, layer-norm scales 1."""
        for name, p in self.named_parameters():
            if name.endswith("_emb"):
                p.normal_(0.0, self.d_model ** -0.5, generator=generator)
            elif p.dim() == 2:
                bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                p.uniform_(-bound, bound, generator=generator)
            elif name.endswith("_scale"):
                p.fill_(1.0)
            else:
                p.zero_()

    # -- dropout ------------------------------------------------------------
    def _dropping(self) -> bool:
        return self.training and self.dropout_p > 0

    def _seed(self) -> int:
        gen = self.generator if self.generator is not None \
            else torch.default_generator
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))

    def _dropout(self, x):
        if not self._dropping():
            return x
        return nn_ops.dropout(x, self.dropout_p, self._seed())

    # -- blocks -------------------------------------------------------------
    def _attention(self, x_q, x_kv, w: AttentionWeights, causal: bool):
        p = self.dropout_p if self._dropping() else 0.0
        seed = self._seed() if p else 0
        if self.fused_attention:
            return ab.fused_attention_block(x_q, x_kv, w.wq, w.wk, w.wv,
                                            w.wo, self.n_head, causal, p,
                                            seed, self.amp)
        t = x_q.shape[1]
        mask = self.causal_mask[:, :, :t, :t] if causal else None
        return multi_head_attention(x_q, x_kv, w, self.n_head, mask, p,
                                    seed, self.amp)

    def _ffn(self, layer: _FFN, x):
        h = nn_ops.fc(x, layer.ffn1_w, layer.ffn1_b, act="relu",
                      amp=self.amp)
        return nn_ops.fc(self._dropout(h), layer.ffn2_w, layer.ffn2_b,
                         amp=self.amp)

    def _residual(self, x, sub):
        return nn_ops.elementwise_add(x, self._dropout(sub), self.amp)

    def _embed(self, emb, ids):
        x = nn_ops.scale(nn_ops.lookup_table(emb, ids[..., None],
                                             amp=self.amp),
                         self.d_model ** 0.5)
        return self._dropout(nn_ops.elementwise_add(
            x, self.pos_enc[:ids.shape[1]], self.amp))

    def encode(self, src):
        x = self._embed(self.src_emb, src)
        for layer in self.encoder:
            a = nn_ops.layer_norm(x, layer.ln1_scale, layer.ln1_bias)
            x = self._residual(x, self._attention(a, a, layer.attn, False))
            f = nn_ops.layer_norm(x, layer.ln2_scale, layer.ln2_bias)
            x = self._residual(x, self._ffn(layer, f))
        return nn_ops.layer_norm(x, self.enc_ln_scale, self.enc_ln_bias)

    def decode(self, tgt, enc):
        x = self._embed(self.tgt_emb, tgt)
        for layer in self.decoder:
            a = nn_ops.layer_norm(x, layer.ln1_scale, layer.ln1_bias)
            x = self._residual(x, self._attention(a, a, layer.self_attn,
                                                  True))
            c = nn_ops.layer_norm(x, layer.ln2_scale, layer.ln2_bias)
            x = self._residual(x, self._attention(c, enc, layer.cross_attn,
                                                  False))
            f = nn_ops.layer_norm(x, layer.ln3_scale, layer.ln3_bias)
            x = self._residual(x, self._ffn(layer, f))
        return nn_ops.layer_norm(x, self.dec_ln_scale, self.dec_ln_bias)

    def _decoded(self, src_ids, tgt_ids) -> torch.Tensor:
        """[B, T, 1] (or [B, T]) ids -> the decoder output [B, T, M]."""
        dev = self.device
        src = src_ids.to(dev).reshape(src_ids.shape[0], -1)
        tgt = tgt_ids.to(dev).reshape(tgt_ids.shape[0], -1)
        if max(src.shape[1], tgt.shape[1]) > self.max_len:
            raise ValueError(f"sequence longer than max_len {self.max_len}")
        return self.decode(tgt, self.encode(src))

    def logits(self, src_ids, tgt_ids) -> torch.Tensor:
        """[B, T, 1] (or [B, T]) ids -> [B, T, tgt_vocab] logits."""
        return nn_ops.fc(self._decoded(src_ids, tgt_ids), self.head_w,
                         amp=self.amp)

    def forward(self, src_ids, tgt_ids, lbl_ids) -> torch.Tensor:
        """The scalar training loss of one batch: feeds [B, T, 1] int."""
        eps = self.label_smooth_eps if self.training else 0.0
        label = lbl_ids.to(self.device).reshape(-1, 1)
        if self.fused_head:
            dec = self._decoded(src_ids, tgt_ids)
            loss = nn_ops.fused_linear_ce(dec.reshape(-1, self.d_model),
                                          self.head_w, label, eps,
                                          amp=self.amp)
        else:
            loss = nn_ops.softmax_with_cross_entropy(
                self.logits(src_ids, tgt_ids).reshape(-1, self.tgt_vocab),
                label, label_smoothing=eps)
        return nn_ops.mean(loss)


def build(is_train: bool = True, src_vocab: int = 32000,
          tgt_vocab: int = 32000, max_len: int = 128, d_model: int = 512,
          d_inner: int = 2048, n_head: int = 8, n_layer: int = 6,
          dropout: float = 0.1, lr: float = 1e-4, warmup: int = 4000,
          label_smooth_eps: float = 0.1, fused_attention: bool = False,
          fused_head: bool = False, lr_scheduler: str = "const",
          device=None, generator: Optional[torch.Generator] = None):
    """Transformer-base training (``build``, ``:701``), with its
    defaults: returns ``(model, optimizer)``. ``model(src_ids, tgt_ids,
    lbl_ids)`` is the loss; the optimizer is the JAX package's Adam
    (beta1 0.9, beta2 0.997, epsilon 1e-9) at ``lr`` (``"const"``) or
    under the Noam schedule with ``lr`` as its multiplier (``"noam"``,
    ``warmup`` steps). ``fused_head`` makes the loss one
    ``fused_linear_ce``. ``is_train=False`` gives the evaluation model
    (no dropout, no smoothing) and no optimizer. Runs on ``device``
    (``cuda`` unless ``"cpu"`` is asked for)."""
    model = Transformer(src_vocab, tgt_vocab, max_len, d_model, d_inner,
                        n_head, n_layer, dropout if is_train else 0.0,
                        label_smooth_eps if is_train else 0.0,
                        fused_attention, device, generator, fused_head)
    if not is_train:
        return model.eval(), None
    if lr_scheduler == "noam":
        if lr < 1e-2:
            raise ValueError(
                f"lr_scheduler='noam' interprets lr as the Noam multiplier "
                f"(use ~1.0); lr={lr} would give a peak rate of "
                f"~{lr * d_model ** -0.5 * warmup ** -0.5:.1e}")
        rate = lrs.noam_decay(d_model, warmup, learning_rate=lr)
    elif lr_scheduler == "const":
        rate = lr
    else:
        raise ValueError(f"unknown lr_scheduler {lr_scheduler!r} "
                         f"(expected 'const' or 'noam')")
    return model.train(), Adam(model.parameters(), learning_rate=rate,
                               beta1=0.9, beta2=0.997, epsilon=1e-9)


_PROGRAM_VIEWS = ("decoder_lm", "build_decoder_lm_programs", "slot_modes")


def __getattr__(name):
    """The serving programs at the JAX import path
    (``paddle_tpu.models.transformer``): ``decoder_lm``,
    ``build_decoder_lm_programs`` and ``slot_modes`` live in
    ``paddle_tpu_torch/fluid/models/transformer.py``, which imports this
    module, so they are resolved on first use."""
    if name in _PROGRAM_VIEWS:
        from paddle_tpu_torch.fluid.models import transformer as _programs
        return getattr(_programs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
