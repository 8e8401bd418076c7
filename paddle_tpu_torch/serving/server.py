"""The model server of the port (the port's own copy of
``paddle_tpu/serving/server.py``): N engines, a bounded admission queue
each, a wave batcher (or, for slot engines, an in-flight scheduler) per
engine, and a JSON/TCP front end -- the reference's wire, byte for byte,
so the reference's ``ServingClient`` reaches this server and this
package's client reaches the reference's.

Request lifecycle:

    client -> [admission: queue-depth bound -> typed shed]
           -> per-model queue
           -> batcher thread: coalesce compatible requests up to the
              largest batch bucket (continuous batching: the batch is
              formed from whatever is QUEUED when the engine frees up,
              not from a fixed time window)
           -> engine dispatch on a batch bucket (pad-and-slice)
           -> per-request latency observed, futures fulfilled

A hosted slot engine (``SlotGenerativeModel``: the contiguous or paged
layout, plain or speculative) gets the IN-FLIGHT scheduler instead: one
loop that admits queued prompts into free decode slots (one prefill
each), steps the whole pool by one dispatch per iteration, observes
TTFT / inter-token latencies, and reaps slots on EOS / max-tokens /
cancel -- a request joins a RUNNING decode instead of waiting for a
wave to drain. ``cancel`` (in-process or over the wire) frees a
request's slots within one decode step; the RPC handler cancels a
generation whose client hung up mid-stream. A paged engine can run out
of PAGES with slots still free: the prompt goes back to the queue's
head and is admitted after the next leave.

Admission control: ``max_queue_depth`` bounds each model's queue;
beyond it ``submit`` raises :class:`RequestShedError` (over the wire:
``ok=false, kind="shed"`` -- a TYPED rejection the client surfaces
without retry).

At-most-once: every request carries a ``request_id``; the server keeps
a bounded idempotency cache of settled responses plus the in-flight
future map, so a client retry (after a lost reply) either joins the
in-flight request or is answered from the cache.
``paddle_serving_requests_applied_total`` counts only real executions.

The wire: one JSON object per line, arrays as base64(tobytes) + dtype +
shape. Fault sites ``serving.handle`` and ``serving.reply``
(``utils/faults.py``) inject delays, errors and lost replies
deterministically.

Threads and the card. Each hosted engine runs on its own scheduler
thread, and only there: the server itself never touches a tensor (it
calls the engine's ``admit`` / ``step`` / ``release`` / ``generate`` /
``infer`` and moves numpy arrays). That thread is safe for PyTorch
because the state PyTorch keeps per thread is state the engines either
set or do not need: grad mode is thread-local, and the model views are
``@torch.no_grad()`` (``models/transformer.py``); the current CUDA
stream is thread-local, and the page-gather kernels launch on
``torch.cuda.current_stream()`` of the calling thread
(``ops/kernels/paged_attention.py``), which is the same default stream
every other op of that thread uses, so a step's kernels stay in order
with no second stream; the current device is thread-local, so the
thread makes its engine's device current first (:func:`_bind_device`);
and the first launch of a kernel builds it under ``build.load``'s lock
(``ops/kernels/build.py``).

``ModelServer(oom_exit=True)`` is the replica host's setting
(``serving/replica.py``): a dispatch OOM (``observability.memory.
is_oom_error``: ``torch.cuda.OutOfMemoryError``, ``MemoryError``) kills
the process with exit code 42 and no reply, after writing the memdump
the router classifies the death by (:meth:`_HostedModel._fatal_oom`).

Port differences: ``add_model`` takes no ``aot_dir``; the ``metricz``
wire method returns the port registry's ``snapshot()``. ``SERVING_ENV``
keeps its name.
"""

from __future__ import annotations

import base64
import json
import os
import socket as socket_module
import socketserver
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.observability import trace_context as tctx
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.serving import bucketing
from paddle_tpu_torch.serving import metrics as smetrics
from paddle_tpu_torch.serving.engine import (PromptTooLongError,
                                             SlotExhaustedError,
                                             SlotGenerativeModel)
from paddle_tpu_torch.utils import faults

SERVING_ENV = "PADDLE_SERVING"


class RequestShedError(RuntimeError):
    """Typed admission rejection: the model's queue is at its depth
    bound. NOT a connectivity error — clients must not blind-retry it
    (back off / spill instead)."""


class ModelNotFoundError(KeyError):
    pass


class RequestCancelledError(RuntimeError):
    """The generation was cancelled before completion — by an explicit
    ``cancel`` call or by the server noticing the requesting client hung
    up mid-stream. Its decode slots were freed for the next admission."""


class ReplicaDrainingError(RequestShedError):
    """Typed admission rejection for a DRAINING replica (wire kind
    ``"draining"``): the server stopped admitting new work so its
    in-flight requests can settle before a clean exit. Retries of
    already-admitted request_ids still dedup/join — only NEW work is
    turned away, so a router fails it over to another replica."""


def encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def decode_array(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]),
                      dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()


class _Future:
    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("kind", "request_id", "feeds", "prompts", "max_new",
                 "rows", "signature", "future", "t_enqueue",
                 "temperature", "top_k", "seed", "eos_id", "ctx")

    def __init__(self, kind: str, request_id: str, rows: int,
                 feeds=None, prompts=None, max_new=None, signature=None,
                 temperature=0.0, top_k=0, seed=None, eos_id=None):
        self.kind = kind                    # "infer" | "generate"
        self.request_id = request_id
        self.feeds = feeds
        self.prompts = prompts
        self.max_new = max_new
        self.rows = rows
        self.signature = signature
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = seed                    # None -> derived per prompt
        self.eos_id = eos_id
        self.future = _Future()
        self.t_enqueue = time.perf_counter()
        # distributed trace identity: the RPC handler's (or in-process
        # caller's) context — every lifecycle span of this request
        # parents here, so the client's request span contains them all.
        # None when tracing is off (one boolean check).
        self.ctx = tctx.current_or_new()


def _bind_device(engine):
    """Make the engine's CUDA device current on the calling (scheduler)
    thread: the current device is thread-local, and a kernel wrapper
    launches on the current stream of the CURRENT device. A no-op for
    an engine on the CPU or without a model (a stub)."""
    dev = getattr(getattr(engine, "model", None), "device", None)
    if getattr(dev, "type", None) == "cuda":
        import torch
        torch.cuda.set_device(dev)


class _HostedModel:
    """One model's queue + batcher thread + idempotency cache."""

    def __init__(self, name: str, engine, max_queue_depth: int,
                 linger_s: float, dedup_capacity: int = 1024,
                 oom_exit: bool = False):
        self.name = name
        self.engine = engine
        self.oom_exit = bool(oom_exit)
        self.max_queue_depth = int(max_queue_depth)
        self.linger_s = float(linger_s)
        self.queue: deque = deque()
        self.cond = threading.Condition()
        self.running = True
        self.draining = False
        self.inflight: Dict[str, _Request] = {}
        self.settled: "OrderedDict[str, tuple]" = OrderedDict()
        self.dedup_capacity = dedup_capacity
        self.thread = threading.Thread(
            target=self._thread_main, daemon=True,
            name=f"paddle-serving-{name}")
        self.thread.start()

    def _thread_main(self):
        _bind_device(self.engine)
        self._loop()

    def _loop(self):
        self._batch_loop()

    def cancel(self, request_id: str) -> bool:
        """Cancellation is only meaningful on the in-flight scheduler
        (_SlotHostedModel); the wave batcher runs requests to
        completion."""
        return False

    @property
    def max_rows(self) -> int:
        return self.engine.policy.max_batch

    # -- admission -------------------------------------------------------
    def submit(self, req: _Request) -> _Future:
        with tctx.span("serving.admission", ctx=req.ctx,
                       model=self.name, request_id=req.request_id):
            return self._submit(req)

    def _submit(self, req: _Request) -> _Future:
        with self.cond:
            # at-most-once: a retry of a settled request answers from
            # the cache; a retry of an in-flight one joins its future
            hit = self.settled.get(req.request_id)
            if hit is not None:
                fut = _Future()
                kind, payload = hit
                if kind == "exc":
                    fut.set_exception(payload)
                else:
                    fut.set_result(payload)
                return fut
            live = self.inflight.get(req.request_id)
            if live is not None:
                return live.future
            # the drain gate sits AFTER the dedup checks: a sticky
            # retry of an admitted request still joins/answers on a
            # draining replica; only NEW work is turned away
            if self.draining:
                smetrics.REQUESTS.labels(model=self.name,
                                         outcome="drained").inc()
                raise ReplicaDrainingError(
                    f"model {self.name!r} is draining; request refused")
            if len(self.queue) >= self.max_queue_depth:
                smetrics.REQUESTS.labels(model=self.name,
                                         outcome="shed").inc()
                raise RequestShedError(
                    f"model {self.name!r} queue at depth bound "
                    f"{self.max_queue_depth}; request shed")
            self.queue.append(req)
            self.inflight[req.request_id] = req
            smetrics.QUEUE_DEPTH.labels(model=self.name).set(
                len(self.queue))
            self.cond.notify()
        return req.future

    # -- batching --------------------------------------------------------
    def _take_wave(self) -> List[_Request]:
        """Block for the first request, linger briefly for company, then
        drain every queued request compatible with the first (same kind
        and feed signature) up to the largest bucket's rows — the
        continuous-batching coalesce step."""
        with self.cond:
            while self.running and not self.queue:
                self.cond.wait(timeout=0.1)
            if not self.running:
                return []
        trace_on = _tracing.active()
        t_coalesce = time.perf_counter() if trace_on else 0.0
        if self.linger_s > 0:
            time.sleep(self.linger_s)
        wave: List[_Request] = []
        rows = 0
        with self.cond:
            head = self.queue[0]
            while self.queue:
                req = self.queue[0]
                if req.kind != head.kind \
                        or req.signature != head.signature \
                        or (wave and rows + req.rows > self.max_rows):
                    break
                self.queue.popleft()
                wave.append(req)
                rows += req.rows
            smetrics.QUEUE_DEPTH.labels(model=self.name).set(
                len(self.queue))
        # admission-to-dispatch: the queueing delay the depth gauge
        # can't show, plus a retroactive per-request queue_wait span
        now = time.perf_counter()
        for r in wave:
            smetrics.QUEUE_WAIT.labels(model=self.name).observe(
                now - r.t_enqueue)
            tctx.record_span("serving.queue_wait", r.t_enqueue, now,
                             ctx=r.ctx, model=self.name)
        if trace_on and wave:
            _tracing.default_tracer().record(
                "serving.coalesce", t_coalesce, now,
                args={"model": self.name, "requests": len(wave),
                      "rows": rows})
        return wave

    def _batch_loop(self):
        while self.running:
            try:
                wave = self._take_wave()
            except Exception:
                continue
            if not wave:
                continue
            try:
                if wave[0].kind == "infer":
                    self._run_infer_wave(wave)
                else:
                    self._run_generate_wave(wave)
            except BaseException as e:   # engine error: fail the wave
                if self._is_fatal_oom(e):
                    self._fatal_oom(e)   # never returns
                self._settle_all(wave, exc=e)

    def _fatal_oom(self, exc: BaseException):
        """Die WITHOUT replying (``oom_exit`` replicas only): an OOM is
        deterministic under the same config, so settling the wave with
        an error hands every queued client a non-retryable failure and
        leaves the process to OOM again on the next dispatch. Dropping
        the connections instead means no request was acked-failed -- a
        router fails the ids over to a survivor, and the supervisor
        finds the memdump and replaces this replica with a
        smaller-footprint config. Runs on the scheduler thread: the
        memdump is fsynced and the flight recorder's black box closed
        before ``os._exit`` (which skips the interpreter's and CUDA's
        teardown on purpose)."""
        from paddle_tpu_torch.observability import flight_recorder
        from paddle_tpu_torch.observability import memory as obs_memory
        obs_memory.oom_dump(exc, program=self.name)
        flight_recorder.note("serving_oom_exit", model=self.name,
                             error=str(exc))
        flight_recorder.shutdown()
        os._exit(42)

    def _is_fatal_oom(self, exc: BaseException) -> bool:
        if not self.oom_exit:
            return False
        from paddle_tpu_torch.observability import memory as obs_memory
        return obs_memory.is_oom_error(exc)

    def _run_infer_wave(self, wave: List[_Request]):
        names = list(wave[0].feeds)
        merged = {n: np.concatenate(
            [np.asarray(r.feeds[n]) for r in wave], axis=0)
            for n in names}
        rows = sum(r.rows for r in wave)
        bucket = (self.engine.policy.bucket_for(rows)
                  if rows <= self.max_rows else self.max_rows)
        smetrics.BATCH_OCCUPANCY.labels(model=self.name).set(
            min(1.0, rows / bucket))
        smetrics.BATCHES.labels(model=self.name).inc()
        smetrics.REQUESTS_APPLIED.labels(model=self.name).inc(len(wave))
        outs = self.engine.infer(merged)
        row0 = 0
        for r in wave:
            part = [o[row0:row0 + r.rows] if np.ndim(o) >= 1 else o
                    for o in outs]
            row0 += r.rows
            self._settle(r, result=part)

    def _run_generate_wave(self, wave: List[_Request]):
        prompts: List[np.ndarray] = []
        for r in wave:
            prompts.extend(r.prompts)
        rows = len(prompts)
        bucket = self.engine.policy.bucket_for(rows)
        smetrics.BATCH_OCCUPANCY.labels(model=self.name).set(
            min(1.0, rows / bucket))
        smetrics.BATCHES.labels(model=self.name).inc()
        smetrics.REQUESTS_APPLIED.labels(model=self.name).inc(len(wave))
        max_new = max(r.max_new for r in wave)
        toks = self.engine.generate(prompts, max_new=max_new)
        # the wave yields no token before it drains: TTFT == settle time
        # (the honest control-arm number the slot scheduler is measured
        # against in tools/serve_bench.py)
        now = time.perf_counter()
        i = 0
        for r in wave:
            smetrics.TTFT.labels(model=self.name).observe(
                now - r.t_enqueue)
            part = [t[:r.max_new] for t in toks[i:i + len(r.prompts)]]
            i += len(r.prompts)
            self._settle(r, result=part)

    # -- settlement ------------------------------------------------------
    def _settle(self, req: _Request, result=None,
                exc: Optional[BaseException] = None):
        t0 = time.perf_counter()
        outcome = "error" if exc is not None else "ok"
        # exemplar: the trace_id rides the latency sample into its
        # bucket, so a p99 outlier is one lookup from its causal trace
        smetrics.REQUEST_LATENCY.labels(model=self.name).observe(
            t0 - req.t_enqueue,
            exemplar=req.ctx.trace_id if req.ctx is not None else None)
        smetrics.REQUESTS.labels(model=self.name, outcome=outcome).inc()
        with self.cond:
            self.inflight.pop(req.request_id, None)
            self.settled[req.request_id] = (
                ("exc", exc) if exc is not None else ("ok", result))
            while len(self.settled) > self.dedup_capacity:
                self.settled.popitem(last=False)
        # span recorded BEFORE the future resolves: its interval closes
        # strictly inside the caller's request span, and a client that
        # returns the moment the future settles never races the record
        tctx.record_span("serving.settle", t0, time.perf_counter(),
                         ctx=req.ctx, model=self.name, outcome=outcome)
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(result)

    def _settle_all(self, wave: List[_Request], exc: BaseException):
        for r in wave:
            self._settle(r, exc=exc)

    def drained(self) -> bool:
        with self.cond:
            return not self.queue and not self.inflight

    def stop(self):
        with self.cond:
            self.running = False
            self.cond.notify_all()
        self.thread.join(timeout=5)


class _GenStream:
    """One in-flight generate request on the slot scheduler: which
    prompts still wait for a slot, which slots it owns, and the tokens
    collected so far."""

    __slots__ = ("req", "pending", "tokens", "slot2pi", "last_tok_t",
                 "cancelled")

    def __init__(self, req: _Request):
        self.req = req
        self.pending = deque(enumerate(req.prompts))   # (prompt_idx, p)
        self.tokens: Dict[int, list] = {}
        self.slot2pi: Dict[int, int] = {}              # slot -> prompt_idx
        self.last_tok_t: Dict[int, float] = {}
        self.cancelled = False

    def done(self) -> bool:
        return not self.pending and not self.slot2pi


class _SlotHostedModel(_HostedModel):
    """In-flight scheduler for a :class:`SlotGenerativeModel`: ONE loop
    that (1) reaps cancelled streams (slots freed within one step),
    (2) admits queued prompts into free slots — each admission is a
    prefill + the request's first token, so TTFT is bounded by queue
    wait + prefill, not by the running decode's length — and (3) steps
    the whole pool one token, settling requests as their last slot
    leaves. Admission, decode, and settlement interleave freely: this is
    continuous batching at token granularity."""

    def __init__(self, name: str, engine, max_queue_depth: int,
                 linger_s: float, dedup_capacity: int = 1024,
                 oom_exit: bool = False):
        # scheduler state lives on the scheduler thread; create it
        # BEFORE super() starts the thread
        self._streams: Dict[str, _GenStream] = {}
        self._slot_owner: Dict[int, tuple] = {}
        self.sched_steps = 0
        self.sched_slot_steps = 0       # occupied slot-steps (occupancy)
        super().__init__(name, engine, max_queue_depth, linger_s,
                         dedup_capacity, oom_exit=oom_exit)

    # -- cancellation ----------------------------------------------------
    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight generation. Queued requests
        settle immediately; in-flight ones are flagged and their slots
        freed by the scheduler within one decode step."""
        with self.cond:
            stream = self._streams.get(request_id)
            if stream is not None and not stream.cancelled:
                stream.cancelled = True
                self.cond.notify()
                return True
            for i, req in enumerate(self.queue):
                if req.request_id == request_id:
                    del self.queue[i]
                    smetrics.QUEUE_DEPTH.labels(model=self.name).set(
                        len(self.queue))
                    self._settle(req, exc=RequestCancelledError(
                        f"request {request_id!r} cancelled while "
                        f"queued"))
                    return True
        return False

    def _reap_cancelled(self):
        for rid in [r for r, s in self._streams.items() if s.cancelled]:
            stream = self._streams.pop(rid)
            for slot in list(stream.slot2pi):
                self.engine.release(slot, cause="cancelled")
                self._slot_owner.pop(slot, None)
            self._settle(stream.req, exc=RequestCancelledError(
                f"request {rid!r} cancelled mid-generation; "
                f"{len(stream.slot2pi)} slot(s) freed"))

    # -- admission (join) ------------------------------------------------
    def _next_admission(self) -> Optional[_GenStream]:
        # finish partially admitted streams before starting new ones
        for stream in self._streams.values():
            if stream.pending and not stream.cancelled:
                return stream
        with self.cond:
            while self.queue:
                req = self.queue.popleft()
                smetrics.QUEUE_DEPTH.labels(model=self.name).set(
                    len(self.queue))
                if req.kind != "generate":
                    self._settle(req, exc=TypeError(
                        "slot-scheduled models serve generate "
                        "requests only"))
                    continue
                now = time.perf_counter()
                smetrics.QUEUE_WAIT.labels(model=self.name).observe(
                    now - req.t_enqueue)
                tctx.record_span("serving.queue_wait", req.t_enqueue,
                                 now, ctx=req.ctx, model=self.name)
                stream = _GenStream(req)
                self._streams[req.request_id] = stream
                # execution starts here — the at-most-once witness
                smetrics.REQUESTS_APPLIED.labels(model=self.name).inc()
                return stream
        return None

    def _fail_stream(self, stream: _GenStream, exc: BaseException):
        self._streams.pop(stream.req.request_id, None)
        for slot in list(stream.slot2pi):
            self.engine.release(slot, cause="error")
            self._slot_owner.pop(slot, None)
        self._settle(stream.req, exc=exc)

    def _admit(self):
        while self.engine.free_count() > 0:
            stream = self._next_admission()
            if stream is None:
                return
            pi, prompt = stream.pending.popleft()
            req = stream.req
            seed = (req.seed + pi if req.seed is not None
                    else (hash(req.request_id) + pi) & 0x7FFFFFFF)
            try:
                # admit under the request's context: the engine's
                # prefill@bucket span parents into this request's trace
                with tctx.activate(req.ctx):
                    slot, first, done = self.engine.admit(
                        prompt, seed=seed, temperature=req.temperature,
                        top_k=req.top_k, max_new=req.max_new,
                        eos_id=req.eos_id)
            except SlotExhaustedError:
                # paged engines can run out of PAGES while slots remain
                # free (free_count() gates only slots); the request is
                # fine — put the prompt back and retry after a leave
                stream.pending.appendleft((pi, prompt))
                return
            except BaseException as e:
                if self._is_fatal_oom(e):
                    self._fatal_oom(e)     # never returns
                self._fail_stream(stream, e)
                continue
            now = time.perf_counter()
            smetrics.TTFT.labels(model=self.name).observe(
                now - req.t_enqueue)
            stream.tokens[pi] = [first]
            stream.last_tok_t[pi] = now
            if done:
                self._maybe_settle(stream)
            else:
                stream.slot2pi[slot] = pi
                self._slot_owner[slot] = (stream, pi)

    # -- settlement (leave) ----------------------------------------------
    def _maybe_settle(self, stream: _GenStream):
        if not stream.done():
            return
        self._streams.pop(stream.req.request_id, None)
        result = [np.asarray(stream.tokens.get(pi, []), np.int64)
                  for pi in range(len(stream.req.prompts))]
        self._settle(stream.req, result=result)

    # -- the scheduler loop ----------------------------------------------
    def _loop(self):
        engine = self.engine
        while self.running:
            try:
                self._reap_cancelled()
                self._admit()
                if engine.active_count() == 0:
                    with self.cond:
                        if not self.queue:
                            self.cond.wait(timeout=0.05)
                    continue
                # one flag check per pool step, not per token: the
                # disabled path pays a single boolean
                trace_on = tctx.active()
                t_step = time.perf_counter() if trace_on else 0.0
                try:
                    events = engine.step()
                except BaseException as e:
                    if self._is_fatal_oom(e):
                        self._fatal_oom(e)  # never returns
                    for stream in list(self._streams.values()):
                        self._fail_stream(stream, e)
                    continue
                self.sched_steps += 1
                self.sched_slot_steps += len(events)
                smetrics.BATCHES.labels(model=self.name).inc()
                now = time.perf_counter()
                for slot, tok, done in events:
                    owner = self._slot_owner.get(slot)
                    if owner is None:
                        continue
                    stream, pi = owner
                    stream.tokens[pi].append(tok)
                    if trace_on:
                        # retroactive per-slot decode-step span under
                        # the owning request's trace
                        tctx.record_span(
                            "serving.decode_step", t_step, now,
                            ctx=stream.req.ctx, slot=slot,
                            model=self.name)
                    smetrics.INTER_TOKEN.labels(
                        model=self.name).observe(
                        now - stream.last_tok_t[pi])
                    stream.last_tok_t[pi] = now
                    if done:
                        del self._slot_owner[slot]
                        del stream.slot2pi[slot]
                        self._maybe_settle(stream)
            except Exception:
                # never let the scheduler die; back off so a
                # persistent bookkeeping error can't hot-spin the
                # thread, then re-evaluate from the maps
                time.sleep(0.05)
                continue

    def mean_occupancy(self) -> float:
        """Occupied slot-steps / total slot-steps since start — the
        bench's aggregate slot-occupancy figure."""
        if self.sched_steps == 0:
            return 0.0
        return self.sched_slot_steps / float(
            self.sched_steps * self.engine.n_slots)


class ModelServer:
    """Host N engines behind queues + batchers; optionally behind the
    JSON/TCP front end (``serve()``). The observability scrape endpoint
    (FLAGS_metrics_port, observability/exporters.py) exports every
    serving family — start it with
    ``observability.exporters.ensure_started()``."""

    def __init__(self, linger_s: float = 0.002,
                 max_queue_depth: int = 64, oom_exit: bool = False):
        self._models: Dict[str, _HostedModel] = {}
        self._default_linger = linger_s
        self._default_depth = max_queue_depth
        # oom_exit=True (the replica-host setting): a dispatch OOM
        # kills the process WITHOUT replying instead of settling the
        # wave with errors -- the supervisor's memdump-witnessed
        # replace path, see _HostedModel._fatal_oom
        self._oom_exit = bool(oom_exit)
        self._rpc: Optional["_RpcServer"] = None
        self._rpc_thread = None
        # replica lifecycle (docs/serving.md "Deployment"): readiness
        # flips true only after warmup so a router never sends traffic
        # to a still-warming replica; draining refuses new
        # admissions while in-flight work settles; the exit event lets a
        # replica host block until a drain RPC asks it to leave.
        self._ready = threading.Event()
        self._draining = False
        self._exit = threading.Event()

    # -- lifecycle (readyz / drain) --------------------------------------
    @property
    def ready(self) -> bool:
        """True once :meth:`mark_ready` ran and no drain started —
        the ``readyz`` answer a router gates traffic on."""
        return self._ready.is_set() and not self._draining

    @property
    def draining(self) -> bool:
        return self._draining

    def mark_ready(self):
        """Flip readiness true — call AFTER every hosted engine is
        warmed (``serve()`` does it for the common in-process path;
        a replica serves first with ``ready=False``, warms, then
        marks)."""
        self._ready.set()

    def begin_drain(self):
        """Stop admission on every hosted model (new submits get a
        typed ``kind="draining"`` shed); already-admitted requests keep
        running to settlement."""
        self._draining = True
        for m in self._models.values():
            with m.cond:
                m.draining = True
                m.cond.notify_all()

    def drain(self, timeout_s: float = 60.0) -> tuple:
        """Begin drain, then wait for every model's queue AND in-flight
        map to empty. Returns ``(drained, duration_s)`` — duration is
        what the ``paddle_router_drain_duration_seconds`` histogram
        observes on the router side."""
        t0 = time.perf_counter()
        self.begin_drain()
        deadline = t0 + float(timeout_s)
        while time.perf_counter() < deadline:
            if all(m.drained() for m in self._models.values()):
                return True, time.perf_counter() - t0
            time.sleep(0.01)
        return (all(m.drained() for m in self._models.values()),
                time.perf_counter() - t0)

    def request_exit(self):
        self._exit.set()

    def wait_exit(self, timeout: Optional[float] = None) -> bool:
        """Block until a ``drain`` RPC (or :meth:`request_exit`) asked
        this process to leave — the replica host's main-loop wait."""
        return self._exit.wait(timeout)

    # -- hosting ---------------------------------------------------------
    def add_model(self, engine, max_queue_depth: Optional[int] = None,
                  linger_s: Optional[float] = None,
                  warmup: bool = True):
        """Host an engine: a slot engine (``SlotGenerativeModel``, either
        layout, with or without ``spec_k``) gets the in-flight scheduler;
        anything else with ``name``, ``policy``, ``warmup`` and
        ``infer`` / ``generate`` (the wave ``GenerativeModel``) gets the
        wave batcher. Warmup runs HERE (cold start pays the first
        dispatches -- kernel builds, allocator growth; steady state pays
        none).

        Port difference: no ``aot_dir`` -- the reference loads serialized
        executables there; eager PyTorch has none to load."""
        name = engine.name
        if name in self._models:
            raise ValueError(f"model {name!r} already hosted")
        if warmup:
            engine.warmup()
        hosted_cls = (_SlotHostedModel
                      if isinstance(engine, SlotGenerativeModel)
                      else _HostedModel)
        self._models[name] = hosted_cls(
            name, engine,
            self._default_depth if max_queue_depth is None
            else max_queue_depth,
            self._default_linger if linger_s is None else linger_s,
            oom_exit=self._oom_exit)
        return self._models[name]

    def model(self, name: str) -> _HostedModel:
        m = self._models.get(name)
        if m is None:
            raise ModelNotFoundError(
                f"no model {name!r}; hosted: {sorted(self._models)}")
        return m

    def models(self) -> List[str]:
        return sorted(self._models)

    # -- in-process API (also the RPC handler's substrate) ---------------
    def submit_infer(self, model: str, feeds: Dict[str, np.ndarray],
                     request_id: Optional[str] = None) -> _Future:
        m = self.model(model)
        rows = int(np.shape(feeds[next(iter(feeds))])[0])
        if rows > m.max_rows:
            raise RequestShedError(
                f"request batch {rows} exceeds the largest bucket "
                f"{m.max_rows}; split the request")
        req = _Request("infer", request_id or uuid.uuid4().hex, rows,
                       feeds={n: np.asarray(v) for n, v in feeds.items()},
                       signature=bucketing.FeedSignature.of(feeds))
        return m.submit(req)

    def submit_generate(self, model: str, prompts: Sequence,
                        max_new: int,
                        request_id: Optional[str] = None,
                        temperature: float = 0.0, top_k: int = 0,
                        seed: Optional[int] = None,
                        eos_id: Optional[int] = None) -> _Future:
        """Queue a generation. Sampling knobs ride on the request
        (honored by slot-scheduled models; the wave batcher is greedy
        and rejects non-greedy submits): ``temperature <= 0`` or
        ``top_k == 1`` is exact greedy; ``seed`` makes a sampled stream
        reproducible across retries AND server restarts (prompt i uses
        seed + i); ``eos_id`` ends a stream early, freeing its slot."""
        m = self.model(model)
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        if len(prompts) > m.max_rows:
            raise RequestShedError(
                f"{len(prompts)} prompts exceed the largest bucket "
                f"{m.max_rows}; split the request")
        max_allowed = getattr(m.engine, "max_new", None)
        if max_allowed is not None and max_new > max_allowed:
            raise ValueError(f"max_new {max_new} exceeds the model's "
                             f"cache budget {max_allowed}")
        sampled = float(temperature) > 0.0 and int(top_k) != 1
        if (sampled or eos_id is not None or seed is not None) \
                and not isinstance(m, _SlotHostedModel):
            # reject rather than silently ignore: the wave batcher
            # decodes every request to its full budget with no EOS
            # reaping and no sampling state
            raise ValueError(
                f"model {model!r} is wave-scheduled (greedy, no "
                f"eos/seed); host a SlotGenerativeModel for on-device "
                f"sampling and EOS early-leave")
        req = _Request("generate", request_id or uuid.uuid4().hex,
                       len(prompts), prompts=prompts,
                       max_new=int(max_new), signature="generate",
                       temperature=temperature, top_k=top_k, seed=seed,
                       eos_id=eos_id)
        return m.submit(req)

    def cancel(self, model: str, request_id: str) -> bool:
        """Cancel a queued or in-flight generation on a slot-scheduled
        model; its slots are freed within one decode step. Returns
        whether anything was cancelled."""
        return self.model(model).cancel(request_id)

    def infer(self, model: str, feeds, request_id=None,
              timeout: Optional[float] = 60.0):
        return self.submit_infer(model, feeds, request_id).result(timeout)

    def generate(self, model: str, prompts, max_new: int,
                 request_id=None, timeout: Optional[float] = 120.0,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None, eos_id: Optional[int] = None):
        return self.submit_generate(
            model, prompts, max_new, request_id,
            temperature=temperature, top_k=top_k, seed=seed,
            eos_id=eos_id).result(timeout)

    def stats(self) -> dict:
        out = {}
        for name, m in self._models.items():
            with m.cond:
                depth = len(m.queue)
                inflight = len(m.inflight)
            row = {
                "queue_depth": depth, "inflight": inflight,
                "max_queue_depth": m.max_queue_depth,
                "buckets": list(m.engine.policy.batch_buckets),
                "kind": type(m.engine).__name__}
            if isinstance(m, _SlotHostedModel):
                row.update({
                    "n_slots": m.engine.n_slots,
                    "active_slots": m.engine.active_count(),
                    "sched_steps": m.sched_steps,
                    "mean_slot_occupancy": round(m.mean_occupancy(), 4)})
            out[name] = row
        return out

    # -- RPC front end ---------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0,
              ready: bool = True) -> str:
        """Bind the JSON/TCP front end (ephemeral port by default);
        returns the endpoint string. ``ready=False`` serves the wire
        (so ``readyz`` answers) WITHOUT flipping readiness — the
        replica path: serve, warm up, then :meth:`mark_ready`."""
        self._rpc = _RpcServer((host, port), _RpcHandler)
        self._rpc.model_server = self          # type: ignore[attr-defined]
        self._rpc_thread = threading.Thread(
            target=self._rpc.serve_forever,
            kwargs={"poll_interval": 0.05}, daemon=True,
            name="paddle-serving-rpc")
        self._rpc_thread.start()
        if ready:
            self.mark_ready()
        host, port = self._rpc.server_address[:2]
        return f"{host}:{port}"

    @property
    def endpoint(self) -> Optional[str]:
        if self._rpc is None:
            return None
        host, port = self._rpc.server_address[:2]
        return f"{host}:{port}"

    def stop(self):
        if self._rpc is not None:
            self._rpc.shutdown()
            self._rpc.server_close()
            if self._rpc_thread is not None:
                self._rpc_thread.join(timeout=5)
            self._rpc = None
        for m in self._models.values():
            m.stop()


class _RpcServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


# error kinds a client maps back to typed exceptions (ordered isinstance
# scan: subclasses BEFORE their bases)
_ERROR_KINDS = {
    ReplicaDrainingError: "draining",
    RequestShedError: "shed",
    # CAPACITY shed (no free slot / not enough free KV pages — the
    # message carries the counts), distinct from the queue-depth shed
    # above: a router should retry it on a less-loaded replica rather
    # than back off the whole fleet
    SlotExhaustedError: "exhausted",
    ModelNotFoundError: "not_found",
    RequestCancelledError: "cancelled",
    PromptTooLongError: "bad_request",
    ValueError: "bad_request",
    TimeoutError: "timeout",
}


class _ClientGone(Exception):
    """The requesting client hung up mid-request; nothing to reply to."""


class _RpcHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: ModelServer = self.server.model_server  # type: ignore
        while True:
            try:
                line = self.rfile.readline()
            except (ConnectionError, OSError):
                return
            if not line:
                return
            try:
                req = json.loads(line)
                # adopt the caller's trace context (no-op when the
                # message carries none); every span below — admission,
                # queue_wait, prefill@bucket, decode_step, settle —
                # parents under the CLIENT's request span
                ctx = tctx.extract(req)
                with tctx.activate(ctx if ctx is not None
                                   else tctx.current()):
                    with tctx.span("serving.handle",
                                   method=str(req.get("method"))) as hs:
                        faults.inject("serving.handle")
                        resp = self._dispatch(server, req)
                        if hs is not None and isinstance(resp, dict) \
                                and resp.get("ok"):
                            # request_id ↔ trace_id mapping back to the
                            # client (the exemplar lookup recipe)
                            resp.setdefault("trace_id", hs.trace_id)
            except _ClientGone:
                return
            except Exception as e:
                kind = "error"
                for klass, k in _ERROR_KINDS.items():
                    if isinstance(e, klass):
                        kind = k
                        break
                resp = {"ok": False, "kind": kind,
                        "error": f"{type(e).__name__}: {e}"}
            # a drain reply asks the host process to exit AFTER the
            # response is on the wire (never leaked into the reply)
            exit_after = isinstance(resp, dict) and \
                bool(resp.pop("_exit", False))
            try:
                # a fault here models the mid-request kill: the request
                # EXECUTED but the reply is lost — the client's retry
                # with the same request_id must dedup server-side
                faults.inject("serving.reply")
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except (ConnectionError, OSError, BrokenPipeError):
                return
            finally:
                if exit_after:
                    server.request_exit()

    def _client_gone(self) -> bool:
        """Peek the connection: readable-with-no-bytes means the client
        hung up (our protocol is strict request/response, so nothing
        legitimate arrives while a reply is pending)."""
        import select
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket_module.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _dispatch(self, server: ModelServer, req: dict) -> dict:
        method = req.get("method")
        if method == "ping":
            return {"ok": True, "pong": True}
        if method == "models":
            return {"ok": True, "models": server.models()}
        if method == "stats":
            return {"ok": True, "stats": server.stats()}
        if method == "readyz":
            # distinct from the scrape endpoint's /healthz liveness:
            # ready means "warmed AND not draining" — safe for traffic
            import os as _os
            return {"ok": True, "ready": server.ready,
                    "draining": server.draining,
                    "models": server.models(), "pid": _os.getpid()}
        if method == "drain":
            ok, duration = server.drain(
                timeout_s=float(req.get("timeout_s", 60.0)))
            resp = {"ok": True, "drained": bool(ok),
                    "duration_s": duration}
            if req.get("exit", True):
                resp["_exit"] = True       # popped before the reply
            return resp
        if method == "metricz":
            # over-the-wire registry snapshot: the chaos suite's
            # counter witness without an HTTP scrape port per replica
            from paddle_tpu_torch.observability import metrics as obs_metrics
            return {"ok": True,
                    "metrics": obs_metrics.default_registry().snapshot()}
        if method == "infer":
            feeds = {n: decode_array(d)
                     for n, d in (req.get("feeds") or {}).items()}
            outs = server.infer(req["model"], feeds,
                                request_id=req.get("req_id"))
            return {"ok": True,
                    "outputs": [encode_array(np.asarray(o))
                                for o in outs]}
        if method == "generate":
            req_id = req.get("req_id") or uuid.uuid4().hex
            fut = server.submit_generate(
                req["model"],
                [np.asarray(p, np.int64) for p in req["prompts"]],
                max_new=int(req.get("max_new", 1)), request_id=req_id,
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                seed=req.get("seed"), eos_id=req.get("eos_id"))
            deadline = time.monotonic() + 120.0
            while True:
                try:
                    toks = fut.result(timeout=0.05)
                    break
                except TimeoutError:
                    if time.monotonic() > deadline:
                        # nobody will read a later reply on this
                        # request/response wire — free its slots too
                        server.cancel(req["model"], req_id)
                        raise
                    # a client killed mid-generation must not keep
                    # burning its decode slots: cancel so the slots
                    # free within one step (chaos-tested)
                    if self._client_gone():
                        server.cancel(req["model"], req_id)
                        raise _ClientGone()
            return {"ok": True,
                    "tokens": [np.asarray(t).tolist() for t in toks]}
        if method == "cancel":
            ok = server.cancel(req["model"], req["req_id"])
            return {"ok": True, "cancelled": bool(ok)}
        return {"ok": False, "kind": "bad_request",
                "error": f"unknown method {method!r}"}
