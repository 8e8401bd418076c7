"""Serving engines of the decoder LM (counterpart of
``paddle_tpu/serving/engine.py``): the wave engine
:class:`GenerativeModel` and the in-flight slot engines
:class:`ContiguousSlotGenerativeModel` and
:class:`PagedSlotGenerativeModel`.

The wave engine serves a whole coalesced batch at once: one prefill at
the prompt bucket of its longest prompt and the batch bucket of its
size, then decode steps until the batch's budget is spent. Its
``full_forward_generate`` recomputes the ``full`` view for every token:
the baseline the KV cache is measured against.

The slot engines' decode step is ONE call over a fixed ``[n_slots]``
batch where each slot carries its own cache geometry and sampling
state. Requests JOIN a free slot mid-flight (``admit`` prefills the
prompt at its prompt bucket and samples the first token on the device)
and LEAVE on EOS or their token budget (``step`` reports the leave and
frees the slot): there is no wave barrier.

The contiguous layout (the reference's default, ``make_slot_model``'s
too) gives each slot a whole ``[cache_len, H, D]`` row per layer; the
views attend over the pool as it lies. The paged layout addresses each
slot's cache through a per-slot page table into one shared
``[n_pages, page_size, H, D]`` pool per layer. Admission is gated by
FREE PAGES for the request's span (prompt bucket + token budget) instead
of a whole worst-case row, and requests with a common prompt prefix
share its full pages through the refcounted radix tree of
``serving/kv_pool.py``. The paged decode step reads every slot's K/V
through the page-gather kernels (``ops/kernels/paged_attention.py``).

Sampling is greedy when ``temperature <= 0`` or ``top_k == 1``, else
temperature/top-k Gumbel sampling keyed only by the per-request seed and
the token index, so a sampled stream replays identically. The wave
engine is greedy: it takes the argmax on the device and brings only the
tokens to the host.

Speculative decoding (a slot engine built with ``spec_k``): each step a
drafter proposes up to K next tokens per slot from its committed
history (:class:`NgramDrafter`, :class:`ModelDrafter`, or any object
with ``propose(tokens, k)``), ONE verify dispatch scores every slot's
``[K+1]`` window and samples each window position on the device, and
each slot commits the longest prefix of drafts that equal those samples
plus one more token. The samples are what sequential decoding would
emit, so the streams are the non-speculative engine's, token for token.

Thread discipline: one dispatcher at a time; ``admit``/``step``/
``release``/``generate`` are not internally locked (the model server
drives each engine from its one scheduler thread).

Telemetry, where the reference's engines update it: the serving
families of ``serving/metrics.py`` (``paddle_serving_prefills_total``,
``_slot_admissions_total``, ``_tokens_generated_total``,
``_decode_steps_total``, ``_decode_slot_occupancy_ratio``,
``_slot_evictions_total{cause}``, ``_spec_proposed_tokens_total``,
``_spec_accepted_tokens_total``, ``_tokens_per_step``; the page pool's
``paddle_kv_*``), labelled by the engine's ``name``; the span
``serving.prefill@{bucket}`` around each prefill, under the caller's
trace context; the fault site ``serving.dispatch`` before each model
call. The families are the only counters: a caller holding an engine
reads ``Family.labels(model=engine.name)`` (a delta where an earlier
engine shared the name), as the reference's callers do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.models import transformer as _tf
from paddle_tpu_torch.observability import trace_context as tctx
from paddle_tpu_torch.serving import bucketing, kv_pool
from paddle_tpu_torch.serving import metrics as smetrics
from paddle_tpu_torch.utils import faults


class PromptTooLongError(ValueError):
    """Admission rejection: the prompt exceeds the largest prompt
    bucket."""


class SlotExhaustedError(RuntimeError):
    """No free decode slot (or, paged, too few free pages) -- the caller
    must wait for a leave, or shed."""


LAYOUTS = ("contiguous", "paged")


def _prompt_bucket(length: int, buckets) -> int:
    """Smallest prompt bucket >= ``length`` (``serving/engine.py:361``)."""
    b = bucketing.bucket_for(length, buckets)
    if b is None:
        raise PromptTooLongError(
            f"prompt of length {length} exceeds the prompt bucket "
            f"{buckets[-1]}")
    return b


class GenerativeModel:
    """Prefill + KV-cache decode serving, a wave a batch
    (``serving/engine.py:220-570``): the whole coalesced batch decodes to
    completion, the control arm the slot engines are measured against.
    One prefill at the prompt bucket of the wave's longest prompt (a
    LADDER of ``prompt_buckets``: mixed lengths pad to the nearest bucket
    instead of the longest) and the batch bucket of its size
    (``policy``, default ``BucketPolicy()``), its K/V in a fresh
    :class:`~paddle_tpu_torch.models.transformer.ContiguousKVCache` of
    the bucket's rows; then one decode step a token over that cache.
    Greedy: the argmax is taken on the device and only the ``[B]``
    tokens come to the host, one copy a step. ``model.cache_len`` minus
    the largest prompt bucket is the token budget."""

    def __init__(self, name: str, model: _tf.DecoderLM,
                 prompt_buckets: Sequence[int],
                 policy: Optional[bucketing.BucketPolicy] = None):
        self.name = name
        self.model = model
        self.policy = policy or bucketing.BucketPolicy()
        self.prompt_buckets = bucketing.ladder(prompt_buckets)
        self.prompt_len = self.prompt_buckets[-1]
        self.cache_len = model.cache_len
        if self.prompt_len > self.cache_len:
            raise ValueError(f"prompt bucket {self.prompt_len} > cache_len "
                             f"{self.cache_len}")
        self.max_new = self.cache_len - self.prompt_len

    def prompt_bucket_for(self, length: int) -> int:
        return _prompt_bucket(length, self.prompt_buckets)

    # -- the two dispatches ----------------------------------------------
    def _prefill(self, ids: np.ndarray, lens: np.ndarray):
        """ids [B, P], lens [B] (true lengths) -> (the greedy first
        tokens [B] on the host, taken at each row's ``len - 1``, and the
        wave's cache)."""
        dev = self.model.device
        last = torch.from_numpy(lens - 1).to(dev)
        faults.inject("serving.dispatch")
        logits, cache = self.model.prefill(torch.from_numpy(ids))
        rows = torch.arange(len(lens), device=dev)
        return logits[rows, last].argmax(-1).cpu().numpy(), cache

    def _decode(self, cache, tok: np.ndarray, pos: int, lens: np.ndarray,
                p_len: int) -> np.ndarray:
        """One decode step of every row at cache row ``pos`` (generated
        rows from ``p_len`` on) -> the greedy next tokens [B] on the
        host."""
        b = len(tok)

        def col(v):
            return torch.from_numpy(np.asarray(v, np.int64).reshape(b, 1))
        faults.inject("serving.dispatch")
        logits = self.model.decode(col(tok), col(np.full(b, pos)), col(lens),
                                   col(np.full(b, p_len)),
                                   col(np.ones(b)), cache)
        return logits[:, 0].argmax(-1).cpu().numpy()

    def _budget(self, max_new: Optional[int]) -> int:
        max_new = self.max_new if max_new is None else int(max_new)
        if max_new > self.max_new:
            raise ValueError(f"max_new {max_new} exceeds the cache budget "
                             f"{self.max_new}")
        return max_new

    def _batch(self, prompts):
        """(lens [n], the batch bucket, its lens padded by repeating the
        last)."""
        lens = np.array([len(p) for p in prompts], np.int64)
        bucket = self.policy.bucket_for(len(prompts))
        return lens, bucket, bucketing.pad_rows(lens, bucket)

    def warmup(self) -> Dict[str, int]:
        """Dispatch every (batch bucket x prompt bucket) prefill and the
        decode step at each batch bucket once (``serving/engine.py:
        385-419``), so first-use costs land here. Returns the count
        dispatched."""
        n = 0
        for bucket in self.policy.batch_buckets:
            lens = np.ones(bucket, np.int64)
            for p in self.prompt_buckets:
                tok, cache = self._prefill(np.zeros((bucket, p), np.int64),
                                           lens)
                n += 1
            self._decode(cache, tok, self.prompt_len, lens, self.prompt_len)
            n += 1
        return {"dispatched": n}

    # -- generation ------------------------------------------------------
    def generate(self, prompts: Sequence, max_new: Optional[int] = None
                 ) -> List[np.ndarray]:
        """Greedy-decode ``max_new`` tokens for each prompt (1-D int
        arrays no longer than the largest prompt bucket): one prefill and
        ``max_new - 1`` decode steps at ``pos = p_len + s``,
        ``gen_start = p_len`` (``serving/engine.py:468-520``)."""
        max_new = self._budget(max_new)
        n = len(prompts)
        lens, bucket, blens = self._batch(prompts)
        p_len = self.prompt_bucket_for(int(lens.max()) if n else 1)
        ids = np.zeros((bucket, p_len), np.int64)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = np.asarray(p, np.int64)
        with tctx.span(f"serving.prefill@{p_len}", model=self.name,
                       rows=bucket):
            tok, cache = self._prefill(ids, blens)
        smetrics.PREFILLS.labels(model=self.name).inc()
        out = [tok]
        for s in range(max_new - 1):
            tok = self._decode(cache, tok, p_len + s, blens, p_len)
            smetrics.DECODE_STEPS.labels(model=self.name).inc()
            out.append(tok)
        smetrics.TOKENS_GENERATED.labels(model=self.name).inc(n * max_new)
        toks = np.stack(out, axis=1)            # [bucket, max_new]
        return [toks[i] for i in range(n)]

    def full_forward_generate(self, prompts: Sequence,
                              max_new: Optional[int] = None
                              ) -> List[np.ndarray]:
        """The O(T)-per-token baseline (``serving/engine.py:522-551``): a
        fresh ``full`` forward over ``prompt_len + max_new`` positions for
        every emitted token, on the same weights."""
        max_new = self._budget(max_new)
        n = len(prompts)
        lens, bucket, blens = self._batch(prompts)
        seq = np.zeros((bucket, self.cache_len), np.int64)
        for i, p in enumerate(prompts):
            seq[i, :len(p)] = np.asarray(p, np.int64)
        dev = self.model.device
        rows = torch.arange(bucket, device=dev)
        last = torch.from_numpy(blens - 1).to(dev)
        out = []
        for s in range(max_new):
            logits = self.model.full(torch.from_numpy(seq))
            out.append(logits[rows, last + s].argmax(-1).cpu().numpy())
            # each row's token right after its current end
            seq[np.arange(bucket), blens + s] = out[-1]
        toks = np.stack(out, axis=1)
        return [toks[i] for i in range(n)]

    def decode_flops(self, bucket: Optional[int] = None,
                     step: int = 0) -> int:
        """The FLOPs of one decode step at ``bucket`` rows and generated
        position ``step`` (one prefill first, for a cache of that
        bucket), as ``torch.utils.flop_counter.FlopCounterMode`` counts
        them: the matrix products only, where the reference's
        ``analyzed_flops`` counts every op of the executable. The shapes
        do not depend on the step, so neither does the count."""
        bucket = bucket or self.policy.batch_buckets[0]
        p = self.prompt_len
        lens = np.full(bucket, p, np.int64)
        tok, cache = self._prefill(np.zeros((bucket, p), np.int64), lens)
        with FlopCounterMode(display=False) as fc:
            self._decode(cache, tok, p + int(step), lens, p)
        return fc.get_total_flops()

    def full_forward_flops(self, bucket: Optional[int] = None) -> int:
        """The FLOPs of one ``full`` forward over ``prompt_len + max_new``
        positions at ``bucket`` rows, counted as :meth:`decode_flops`."""
        bucket = bucket or self.policy.batch_buckets[0]
        ids = torch.zeros((bucket, self.cache_len), dtype=torch.int64)
        with FlopCounterMode(display=False) as fc:
            self.model.full(ids)
        return fc.get_total_flops()


# -- speculative-decoding drafters ----------------------------------------
#
# A drafter proposes up to K next tokens for one slot from its COMMITTED
# token history (prompt + accepted generations). The verify dispatch then
# scores the whole window at once and the engine keeps the longest prefix
# whose drafts match what the model would have emitted sequentially --
# the accept rule is exact-match against the on-device samples, which is
# LOSSLESS for greedy and for seeded sampling alike (token_sample's
# Gumbel noise is a pure function of (seed, step, vocab index), so the
# sequential stream is a deterministic function of the logits -- matching
# it bit-for-bit is the only way a draft survives).

class NgramDrafter:
    """Model-free prompt-lookup drafting (``serving/engine.py:590``):
    match the last n-gram of the slot's committed tokens against earlier
    positions in the same history and propose the tokens that followed
    the most recent match. Host-side and no device memory -- the
    profitable regime is output that re-quotes its own context (code,
    structured text, greedy cycles), where acceptance approaches the
    full window."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))

    def propose(self, tokens, k: int):
        n_tok = len(tokens)
        if k <= 0 or n_tok < self.min_ngram + 1:
            return []
        toks = list(tokens)
        # the drafter runs on the hot serving path once per slot per
        # verify step -- encode the history once and let bytes.rfind do
        # the suffix search at C speed instead of a python scan
        lo, hi = min(toks), max(toks)
        if 0 <= lo and hi < 256:
            enc, width = (lambda t: bytes(t)), 1
        elif 0 <= lo and hi < (1 << 16):
            enc = lambda t: np.asarray(t, np.uint16).tobytes()
            width = 2
        else:
            enc = lambda t: np.asarray(t, np.uint32).tobytes()
            width = 4
        buf = enc(toks)
        # self-extending lookup: when the matched continuation runs out
        # before filling the window (the match sat near the end of the
        # history), re-match against history + drafts-so-far -- on
        # repetitive streams this walks the repeating span and fills
        # the full K instead of stalling at the history frontier
        drafts: list = []
        while len(drafts) < k:
            got = self._lookup(buf, toks, width, k - len(drafts))
            if not got:
                break
            drafts.extend(got)
            toks.extend(got)
            buf += enc(got)
        return drafts

    def _lookup(self, buf, toks, width: int, k: int):
        n_tok = len(toks)
        for n in range(min(self.max_ngram, n_tok - 1),
                       self.min_ngram - 1, -1):
            tail = buf[(n_tok - n) * width:]
            # most recent earlier occurrence of the suffix n-gram:
            # restrict the search window so the match ends before the
            # tail itself, and re-search on token misalignment
            j = buf.rfind(tail, 0, (n_tok - 1) * width)
            while j >= 0 and j % width:
                j = buf.rfind(tail, 0, j + len(tail) - 1)
            if j >= 0:
                cont = toks[j // width + n:j // width + n + k]
                if cont:
                    return cont
        return []


class ModelDrafter:
    """The draft-model arm (``serving/engine.py:653``): greedy
    continuations from a (smaller) :class:`~paddle_tpu_torch.models.
    transformer.DecoderLM`, its ``full`` view recomputed once per
    drafted token over ``cache_len`` positions (the span of the JAX
    ``full`` view, ``prompt_len + max_new``). Useful where histories do
    not repeat themselves (:class:`NgramDrafter`'s blind spot); the
    accept rule is unchanged, so a poor draft model costs only
    acceptance, never correctness."""

    def __init__(self, model: _tf.DecoderLM):
        self.model = model

    def propose(self, tokens, k: int):
        m = self.model
        t_total = m.cache_len
        # greedy continuation needs room for k drafts after the context
        ctx = list(tokens)[-(t_total - k):] if k < t_total else []
        if k <= 0 or not ctx:
            return []
        seq = np.zeros((1, t_total), np.int64)
        seq[0, :len(ctx)] = ctx
        drafts = []
        for i in range(k):
            logits = m.full(torch.from_numpy(seq))
            tok = int(logits[0, len(ctx) - 1 + i].argmax(-1))
            drafts.append(tok)
            seq[0, len(ctx) + i] = tok
        return drafts


class SlotGenerativeModel:
    """The slot lifecycle shared by the KV layouts: host mirror of the
    per-slot state, admission, the decode step, release and
    ``generate``. A layout subclass names its model views (``PREFILL``,
    ``DECODE``, ``VERIFY``), passes its cache to them (``_view_state``)
    and supplies the capacity hooks (``_reserve_capacity``,
    ``_admit_feeds``, ``_release_capacity``):
    :class:`ContiguousSlotGenerativeModel` and
    :class:`PagedSlotGenerativeModel`. With ``spec_k`` set, ``step`` is
    draft -> verify -> commit over a ``[n_slots, spec_k + 1]`` window."""

    PREFILL: str = ""
    DECODE: str = ""
    VERIFY: str = ""

    def __init__(self, name: str, model: _tf.DecoderLM,
                 prompt_buckets: Sequence[int], n_slots: int,
                 spec_k: Optional[int] = None, drafter=None):
        self.name = name
        self.model = model
        self.prompt_buckets = bucketing.ladder(prompt_buckets)
        self.prompt_len = self.prompt_buckets[-1]
        self.n_slots = int(n_slots)
        # what a server reads for the most prompts one request may carry
        # (``max_rows``) and reports as ``buckets`` (serving/engine.py:740)
        self.policy = bucketing.BucketPolicy((self.n_slots,))
        self.cache_len = model.cache_len
        self.max_new = self.cache_len - self.prompt_len
        self.spec_k = int(spec_k) if spec_k else 0
        self.drafter = drafter if drafter is not None else NgramDrafter()
        # host mirror of the per-slot device state
        s = self.n_slots
        self._active = np.zeros(s, bool)
        self._tok = np.zeros(s, np.int64)        # last emitted token
        self._seq = np.zeros(s, np.int64)        # true prompt length
        self._gen0 = np.zeros(s, np.int64)       # prompt bucket (gen start)
        self._gen_count = np.zeros(s, np.int64)  # tokens emitted so far
        self._seed = np.zeros(s, np.int64)
        self._temp = np.zeros(s, np.float32)
        self._topk = np.zeros(s, np.int64)
        self._budget = np.zeros(s, np.int64)
        self._eos: List[Optional[int]] = [None] * s
        # committed-token history per slot (prompt + accepted tokens):
        # what the drafter proposes from
        self._hist: List[List[int]] = [[] for _ in range(s)]

    # -- layout hooks ----------------------------------------------------
    def _view_state(self) -> dict:
        """Extra keyword arguments of every view call (the cache)."""
        return {}

    def _admit_feeds(self, slot: int, p_len: int) -> dict:
        """The layout-specific prefill feed: WHERE the prompt's KV rows
        land."""
        raise NotImplementedError

    def _reserve_capacity(self, slot: int, prompt, p_len: int,
                          budget: int):
        """Admission-time capacity hook; raises SlotExhaustedError when
        the layout cannot hold the request."""

    def _release_capacity(self, slot: int):
        """Failure twin of :meth:`_reserve_capacity`: undo the
        reservation when the prefill raises before the slot goes live
        (``release`` never runs for such a slot)."""

    # -- plumbing --------------------------------------------------------
    def _dispatch(self, view: str, feeds: Dict[str, np.ndarray]
                  ) -> np.ndarray:
        """Call a model view on host feeds; returns its tokens on the
        host (the one wait for the device per call)."""
        args = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in feeds.items()}
        faults.inject("serving.dispatch")
        out = getattr(self.model, view)(**args, **self._view_state())
        return out.cpu().numpy().reshape(-1)

    def prompt_bucket_for(self, length: int) -> int:
        return _prompt_bucket(length, self.prompt_buckets)

    def free_count(self) -> int:
        return int((~self._active).sum())

    def active_count(self) -> int:
        return int(self._active.sum())

    def occupancy(self) -> float:
        return self.active_count() / float(self.n_slots)

    def _decode_feeds(self) -> Dict[str, np.ndarray]:
        return {"tok": self._tok[:, None],
                "pos": (self._gen0 + self._gen_count - 1)[:, None],
                "seq_len": self._seq[:, None],
                "gen_start": self._gen0[:, None],
                "active": self._active.astype(np.int64)[:, None],
                "seed": self._seed[:, None],
                "sample_step": self._gen_count[:, None],
                "temperature": self._temp[:, None],
                "top_k": self._topk[:, None]}

    def _verify_feeds(self, tok_w=None, win_len=None
                      ) -> Dict[str, np.ndarray]:
        """The verify dispatch's feeds (``serving/engine.py:833-857``).
        The sampling feeds are per WINDOW POSITION: sample_step[b, i] =
        gen_count[b] + i, so position i draws exactly the (seed, step)
        noise the sequential engine would at that emission, and a
        rejected position's draw is derived again next dispatch."""
        s, k1 = self.n_slots, self.spec_k + 1
        if tok_w is None:
            tok_w = np.zeros((s, k1), np.int64)
            tok_w[:, 0] = self._tok
        if win_len is None:
            win_len = np.ones((s, 1), np.int64)
        steps = self._gen_count[:, None] + np.arange(k1, dtype=np.int64)
        return {"tok": tok_w,
                "pos": (self._gen0 + self._gen_count - 1)[:, None],
                "seq_len": self._seq[:, None],
                "gen_start": self._gen0[:, None],
                "active": self._active.astype(np.int64)[:, None],
                "win_len": win_len,
                "seed": np.tile(self._seed[:, None], (1, k1)),
                "sample_step": steps,
                "temperature": np.tile(self._temp[:, None], (1, k1)),
                "top_k": np.tile(self._topk[:, None], (1, k1))}

    def _prefill_feeds(self, p_len: int) -> Dict[str, np.ndarray]:
        return {"ids": np.zeros((1, p_len), np.int64),
                **self._admit_feeds(0, p_len),
                "seq_len": np.ones((1, 1), np.int64),
                "seed": np.zeros((1, 1), np.int64),
                "temperature": np.zeros((1, 1), np.float32),
                "top_k": np.zeros((1, 1), np.int64)}

    def warmup(self) -> Dict[str, int]:
        """Dispatch every prefill bucket, the decode step and (with
        ``spec_k``) the verify step once with nothing live, so first-use
        costs -- building the kernels, allocator growth -- land here and
        not on the first request. The decode and verify steps write no
        cache row (no slot is active). The paged prefills write none
        either (every row a sentinel); the contiguous prefills write slot
        0's row, which is harmless: an admission overwrites its slot's
        whole row."""
        n = 0
        for p in self.prompt_buckets:
            self._dispatch(self.PREFILL, self._prefill_feeds(p))
            n += 1
        self._dispatch(self.DECODE, self._decode_feeds())
        n += 1
        if self.spec_k:
            self._dispatch(self.VERIFY, self._verify_feeds())
            n += 1
        self.reset()
        return {"dispatched": n}

    # -- slot lifecycle --------------------------------------------------
    def admit(self, prompt, *, seed: int = 0, temperature: float = 0.0,
              top_k: int = 0, max_new: Optional[int] = None,
              eos_id: Optional[int] = None
              ) -> Tuple[int, int, Optional[str]]:
        """JOIN: prefill ``prompt`` into a free slot (nearest prompt
        bucket) and sample its first token on the device. Returns
        (slot, first_token, done_cause); done_cause is None while the
        request stays in flight, or 'eos'/'max_new' when the first token
        already finished it (the slot is then freed again)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        length = len(prompt)
        if length < 1:
            raise ValueError("empty prompt")
        if length > self.prompt_len:
            raise PromptTooLongError(
                f"prompt of length {length} exceeds the prompt bucket "
                f"{self.prompt_len}")
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise SlotExhaustedError(
                f"model {self.name!r}: all {self.n_slots} decode slots "
                f"are in flight (free_slots=0, "
                f"active_slots={self.n_slots})")
        slot = int(free[0])
        p_len = self.prompt_bucket_for(length)
        budget = self.max_new if max_new is None else int(max_new)
        # generated rows land from gen_start = p_len; the last fed-back
        # token writes at p_len + budget - 2, inside the cache
        if budget < 1 or budget > self.cache_len - p_len:
            raise ValueError(
                f"max_new {budget} outside the cache budget "
                f"(1..{self.cache_len - p_len} for a prompt padded to "
                f"bucket {p_len})")
        self._reserve_capacity(slot, prompt, p_len, budget)
        ids = np.zeros((1, p_len), np.int64)
        ids[0, :length] = prompt
        # the span is named by the prompt bucket the admission landed on,
        # under the admitting request's trace (the scheduler activates it)
        try:
            with tctx.span(f"serving.prefill@{p_len}", model=self.name,
                           slot=slot):
                tok = self._dispatch(self.PREFILL, {
                    "ids": ids,
                    **self._admit_feeds(slot, p_len),
                    "seq_len": np.asarray([[length]], np.int64),
                    "seed": np.asarray([[int(seed)]], np.int64),
                    "temperature": np.asarray([[float(temperature)]],
                                              np.float32),
                    "top_k": np.asarray([[int(top_k)]], np.int64)})
        except BaseException:
            self._release_capacity(slot)
            raise
        smetrics.PREFILLS.labels(model=self.name).inc()
        smetrics.SLOT_ADMISSIONS.labels(model=self.name).inc()
        smetrics.TOKENS_GENERATED.labels(model=self.name).inc()
        first = int(tok[0])
        self._active[slot] = True
        self._tok[slot] = first
        self._seq[slot] = length
        self._gen0[slot] = p_len
        self._gen_count[slot] = 1
        self._hist[slot] = [int(t) for t in prompt] + [first]
        self._seed[slot] = int(seed)
        self._temp[slot] = float(temperature)
        self._topk[slot] = int(top_k)
        self._budget[slot] = budget
        self._eos[slot] = eos_id
        done = None
        if eos_id is not None and first == eos_id:
            done = "eos"
        elif budget <= 1:
            done = "max_new"
        if done:
            self.release(slot, cause=done)
        else:
            smetrics.SLOT_OCCUPANCY.labels(model=self.name).set(
                self.occupancy())
        return slot, first, done

    def step(self) -> List[Tuple[int, int, Optional[str]]]:
        """One dispatch over the WHOLE pool (free slots ride along
        masked). Returns (slot, token, done_cause) events in commit
        order; slots that hit EOS or their token budget are released.
        Without ``spec_k`` this is one decode call, one token a live
        slot; with it, draft -> verify -> commit (:meth:`_step_verify`),
        up to ``spec_k + 1`` tokens a slot."""
        live = np.flatnonzero(self._active)
        if live.size == 0:
            return []
        if self.spec_k:
            return self._step_verify(live)
        out = self._dispatch(self.DECODE, self._decode_feeds())
        smetrics.DECODE_STEPS.labels(model=self.name).inc()
        smetrics.TOKENS_GENERATED.labels(model=self.name).inc(int(live.size))
        per_step = smetrics.TOKENS_PER_STEP.labels(model=self.name)
        events = []
        for slot in live:
            slot = int(slot)
            tok = int(out[slot])
            self._tok[slot] = tok
            self._gen_count[slot] += 1
            self._hist[slot].append(tok)
            per_step.observe(1.0)
            eos = self._eos[slot]
            done = None
            if eos is not None and tok == eos:
                done = "eos"
            elif self._gen_count[slot] >= self._budget[slot]:
                done = "max_new"
            if done:
                self.release(slot, cause=done)
            events.append((slot, tok, done))
        smetrics.SLOT_OCCUPANCY.labels(model=self.name).set(
            self.occupancy())
        return events

    def _step_verify(self, live) -> List[Tuple[int, int, Optional[str]]]:
        """Draft -> verify -> commit (``serving/engine.py:1109-1188``).
        Window position 0 carries the slot's last committed token
        (writing its K/V row again with the same values), positions
        1..K the drafts; the token sampled at position i is the one the
        sequential engine would emit at step gen_count + i given the
        window's prefix, so draft i survives iff it equals sample i - 1,
        and the commit is the accepted prefix plus one more token. An
        EOS inside the window ends the request there."""
        s, k1 = self.n_slots, self.spec_k + 1
        tok_w = np.zeros((s, k1), np.int64)
        tok_w[:, 0] = self._tok
        win_len = np.ones((s, 1), np.int64)
        drafts: Dict[int, List[int]] = {}
        proposed = 0
        for slot in live:
            slot = int(slot)
            # a window commits at most accepted + 1 tokens: never draft
            # past the remaining budget, nor past the cache's end (the
            # admission invariant makes the budget cap the binding one)
            remaining = int(self._budget[slot] - self._gen_count[slot])
            pos0 = int(self._gen0[slot] + self._gen_count[slot] - 1)
            kq = min(self.spec_k, remaining - 1, self.cache_len - 1 - pos0)
            d: List[int] = []
            if kq > 0:
                d = [int(t) for t in
                     self.drafter.propose(self._hist[slot], kq)][:kq]
            drafts[slot] = d
            tok_w[slot, 1:1 + len(d)] = d
            win_len[slot, 0] = 1 + len(d)
            proposed += len(d)
        out = self._dispatch(self.VERIFY,
                             self._verify_feeds(tok_w, win_len))
        out = out.reshape(s, k1)
        smetrics.DECODE_STEPS.labels(model=self.name).inc()
        smetrics.SPEC_PROPOSED.labels(model=self.name).inc(proposed)
        per_step = smetrics.TOKENS_PER_STEP.labels(model=self.name)
        accepted = committed = 0
        events = []
        for slot in live:
            slot = int(slot)
            d = drafts[slot]
            t = out[slot]
            a = 0
            while a < len(d) and d[a] == int(t[a]):
                a += 1
            accepted += a
            eos = self._eos[slot]
            done = None
            n_commit = 0
            for tok in (int(x) for x in t[:a + 1]):
                n_commit += 1
                self._tok[slot] = tok
                self._gen_count[slot] += 1
                self._hist[slot].append(tok)
                if eos is not None and tok == eos:
                    done = "eos"
                elif self._gen_count[slot] >= self._budget[slot]:
                    done = "max_new"
                events.append((slot, tok, done))
                if done:
                    break
            committed += n_commit
            per_step.observe(float(n_commit))
            if done:
                self.release(slot, cause=done)
        smetrics.SPEC_ACCEPTED.labels(model=self.name).inc(accepted)
        smetrics.TOKENS_GENERATED.labels(model=self.name).inc(committed)
        smetrics.SLOT_OCCUPANCY.labels(model=self.name).set(
            self.occupancy())
        return events

    def release(self, slot: int, cause: str = "cancelled"):
        """LEAVE: free ``slot`` for the next admission."""
        if not self._active[slot]:
            return
        self._active[slot] = False
        self._eos[slot] = None
        smetrics.SLOT_EVICTIONS.labels(model=self.name, cause=cause).inc()
        smetrics.SLOT_OCCUPANCY.labels(model=self.name).set(
            self.occupancy())

    def reset(self):
        self._active[:] = False
        self._gen_count[:] = 0
        self._eos = [None] * self.n_slots
        smetrics.SLOT_OCCUPANCY.labels(model=self.name).set(0.0)

    def generate(self, prompts: Sequence, max_new=None, temperature=0.0,
                 top_k=0, seeds: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None) -> List[np.ndarray]:
        """Admit every prompt (queuing past ``n_slots`` until slots
        free) and step the pool until all are done. ``max_new``,
        ``temperature`` and ``top_k`` are one value for every request or
        a sequence with one per prompt. Assumes exclusive use of the
        pool."""
        n = len(prompts)

        def per_request(v):
            return list(v) if isinstance(v, (list, tuple, np.ndarray)) \
                else [v] * n
        budgets, temps, topks = (per_request(v)
                                 for v in (max_new, temperature, top_k))
        pending = list(range(n))[::-1]
        collected: Dict[int, list] = {i: [] for i in range(n)}
        slot2idx: Dict[int, int] = {}
        while pending or slot2idx:
            while pending and self.free_count() > 0:
                i = pending.pop()
                slot, first, done = self.admit(
                    prompts[i],
                    seed=int(seeds[i]) if seeds is not None else 0,
                    temperature=temps[i], top_k=topks[i],
                    max_new=budgets[i], eos_id=eos_id)
                collected[i].append(first)
                if not done:
                    slot2idx[slot] = i
            for slot, tok, done in self.step():
                i = slot2idx.get(slot)
                if i is None:
                    continue
                collected[i].append(tok)
                if done:
                    del slot2idx[slot]
        return [np.asarray(collected[i], np.int64) for i in range(n)]


class ContiguousSlotGenerativeModel(SlotGenerativeModel):
    """Slot engine over the CONTIGUOUS KV pool (``serving/engine.py:687``,
    the reference's default layout): each slot owns one whole
    ``[cache_len, H, D]`` row of an fp32 ``[n_slots, cache_len, H, D]``
    cache per layer. An admission needs only a free slot: its prefill
    overwrites the slot's whole row (zeros beyond the prompt), so a
    reused slot never leaks its earlier occupant's keys. The views
    attend over the pool as it lies: no page gather runs."""

    PREFILL = "prefill_slot"
    DECODE = "decode_slot"
    VERIFY = "decode_verify"

    def __init__(self, name: str, model: _tf.DecoderLM,
                 prompt_buckets: Sequence[int], n_slots: int,
                 spec_k: Optional[int] = None, drafter=None):
        super().__init__(name, model, prompt_buckets, n_slots, spec_k,
                         drafter)
        self.cache = model.contiguous_cache(self.n_slots)

    def _view_state(self) -> dict:
        return {"cache": self.cache}

    def _admit_feeds(self, slot: int, p_len: int):
        """Prefill feed: the slot index (its whole cache row)."""
        return {"slot": np.asarray([[slot]], np.int64)}


class PagedSlotGenerativeModel(SlotGenerativeModel):
    """Slot engine over a PAGED KV pool: the decode view reads each
    slot's K/V through a ``[n_slots, max_pages]`` page table into one
    shared pool per layer. Admission acquires
    ``ceil((prompt_bucket + budget) / page_size)`` pages from
    :class:`~paddle_tpu_torch.serving.kv_pool.PagePool`; full pages of
    the TRUE prompt are shared with earlier requests carrying the same
    token prefix (the prefill skips their writes through sentinel rows;
    the boundary page is always private)."""

    PREFILL = "prefill_paged"
    DECODE = "decode_paged"
    VERIFY = "decode_verify_paged"

    def __init__(self, name: str, model: _tf.DecoderLM,
                 geometry: _tf.PagedGeometry,
                 prompt_buckets: Sequence[int], drafter=None):
        super().__init__(name, model, prompt_buckets, geometry.n_slots,
                         geometry.spec_k, drafter)
        g = geometry
        self.geometry = g
        self.n_pages, self.page_size = g.n_pages, g.page_size
        self.max_pages = g.max_pages
        self.cache = model.new_cache(g)
        self.pool = kv_pool.PagePool(self.n_pages, self.page_size,
                                     model=self.name)
        # write-row sentinel: one past the flat pool -> the write drops
        self._row_sentinel = self.n_pages * self.page_size
        # host page-table mirror; n_pages is the TABLE sentinel (gather
        # rows land past the pool and are clamped, then masked)
        self._table = np.full((self.n_slots, self.max_pages),
                              self.n_pages, np.int64)
        self._pending_rows: Optional[np.ndarray] = None

    def _view_state(self) -> dict:
        return {"cache": self.cache}

    def free_pages(self) -> int:
        return self.pool.free_count()

    def _decode_feeds(self):
        feeds = SlotGenerativeModel._decode_feeds(self)
        feeds["page_table"] = self._table.copy()
        return feeds

    def _verify_feeds(self, tok_w=None, win_len=None):
        feeds = SlotGenerativeModel._verify_feeds(self, tok_w, win_len)
        feeds["page_table"] = self._table.copy()
        return feeds

    def _admit_feeds(self, slot: int, p_len: int):
        """Prefill feed: the flat pool row of each prompt position, or
        the drop sentinel where the page is SHARED with the radix tree
        (its K/V is resident and bit-identical by construction). With
        no reservation pending (warmup) every row is a sentinel."""
        rows = self._pending_rows
        self._pending_rows = None
        if rows is None:
            rows = np.full((p_len, 1), self._row_sentinel, np.int64)
        return {"page_rows": rows}

    def _reserve_capacity(self, slot, prompt, p_len, budget):
        # no draft headroom even under speculation: _step_verify caps
        # each window at remaining - 1 drafts, so verify writes never
        # pass row p_len + budget - 1. An engine drafting a FULL window
        # at the max_new boundary would need spec_k more rows here.
        span = self.pool.span_for(p_len + budget)
        try:
            pages, n_shared = self.pool.acquire(
                slot, [int(t) for t in prompt], span)
        except kv_pool.PagesExhaustedError as e:
            raise SlotExhaustedError(
                f"model {self.name!r}: page pool cannot cover a "
                f"{span}-page admission (free_pages="
                f"{self.pool.free_count()}, evictable_cached="
                f"{self.pool.cached_count()}, pages_total="
                f"{self.n_pages}, free_slots={self.free_count()}, "
                f"active_slots={self.active_count()})") from e
        ps = self.page_size
        idx = np.arange(p_len)
        rows = np.asarray(pages, np.int64)[idx // ps] * ps + idx % ps
        rows[idx < n_shared * ps] = self._row_sentinel
        self._pending_rows = rows[:, None]
        self._table[slot, :] = self.n_pages
        self._table[slot, :span] = pages

    def _release_capacity(self, slot):
        """A prefill died after acquire: abort the lease (its inserted
        tree pages were never written), scrub the slot's table row, and
        drop unconsumed write rows."""
        self.pool.abort(slot)
        self._table[slot, :] = self.n_pages
        self._pending_rows = None

    def release(self, slot: int, cause: str = "cancelled"):
        if self._active[slot]:
            self.pool.release(slot)
            self._table[slot, :] = self.n_pages
        SlotGenerativeModel.release(self, slot, cause=cause)

    def reset(self):
        self.pool.reset()
        self._table[:] = self.n_pages
        self._pending_rows = None
        SlotGenerativeModel.reset(self)


def make_slot_model(name: str, model: _tf.DecoderLM, *, n_slots: int,
                    prompt_buckets: Sequence[int], layout: str = "contiguous",
                    page_size: Optional[int] = None,
                    n_pages: Optional[int] = None, kv_codec: str = "none",
                    spec_k: Optional[int] = None, drafter=None,
                    device=None) -> SlotGenerativeModel:
    """Build the slot engine over ``model`` for a KV ``layout``
    (``serving/engine.py:1384``; ``transformer.py:617`` ``slot_modes``):
    ``n_slots`` decode slots, prompts padded to ``prompt_buckets`` (the
    largest is the longest prompt; ``model.cache_len`` minus it is the
    token budget). ``"contiguous"`` (the default, as the reference's
    ``FLAGS_kv_cache_layout``) gives each slot a whole fp32 cache row;
    the paged-only arguments raise ``ValueError`` there, so no caller
    changes layout silently. ``"paged"`` pools ``n_pages`` pages of
    ``page_size`` rows (default: room for every slot's worst case)
    stored per ``kv_codec`` ('none' | 'bf16' | 'int8'). With ``spec_k``
    the engine decodes speculatively: each step ``drafter`` (default
    :class:`NgramDrafter`) proposes up to ``spec_k`` tokens a slot and
    one verify dispatch checks them. The model is moved to ``device``
    (``cuda`` unless ``"cpu"`` is asked for) and the caches are
    allocated there."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    model.to(_device.resolve(device))
    buckets = bucketing.ladder(prompt_buckets)
    if layout == "paged":
        geometry = _tf.paged_geometry(buckets[-1], model.cache_len, n_slots,
                                      page_size, n_pages, kv_codec, spec_k)
        return PagedSlotGenerativeModel(name, model, geometry, buckets,
                                        drafter)
    paged_only = [k for k, v in (("page_size", page_size),
                                 ("n_pages", n_pages)) if v is not None]
    if kv_codec != "none":
        paged_only.append(f"kv_codec={kv_codec!r}")
    if paged_only:
        raise ValueError(f"{', '.join(paged_only)}: paged-only arguments; "
                         f"the contiguous pool is fp32 rows, no pages "
                         f"(pass layout='paged')")
    n_slots, spec_k = _tf.validate_slots(buckets[-1], model.cache_len,
                                         n_slots, spec_k)
    return ContiguousSlotGenerativeModel(name, model, buckets, n_slots,
                                         spec_k, drafter)
