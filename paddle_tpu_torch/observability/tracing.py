"""Structured host-side tracing (the port's own copy of
``paddle_tpu/observability/tracing.py``): a lock-protected,
thread-id-aware span recorder with a context-manager / decorator API and
chrome-trace export.

Two always-cheap layers:
- **event aggregates** -- per-name {calls, total, min, max}, updated on
  every :func:`span` exit (a dict update under one lock);
- **span records** -- (name, t0, t1, tid, args) appended only while the
  tracer is *enabled* (``start()``/``stop()``), bounded by ``max_spans``;
  drops count into ``paddle_trace_dropped_spans_total``.

Spans carry an optional **trace identity** (trace_id / span_id /
parent_id from ``observability.trace_context``), and
:meth:`Tracer.span` auto-parents under the thread's current
:class:`TraceContext`, so the server's spans nest under the client's
request span across the wire. **Sinks** -- callables invoked with each
finished :class:`Span` outside the tracer lock -- see every span while
attached; spans are constructed when the tracer is enabled OR a sink is
attached. The first :func:`active` call starts the span spool and the
flight recorder from their flags (``FLAGS_trace_spool_dir``,
``FLAGS_flight_recorder_dir``), so a process the router spawns turns
capture on from its environment.

Export: :func:`to_chrome_trace` emits the chrome://tracing JSON dict,
which Perfetto opens natively -- the host side of the timeline; the
device side comes from ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.observability import metrics as _metrics

DROPPED_SPANS = _metrics.counter(
    "paddle_trace_dropped_spans_total",
    "Spans dropped on the tracer ring's max_spans bound — a non-zero "
    "value means the in-memory timeline is truncated (raise max_spans "
    "or export more often); attached sinks still saw them")


@dataclass
class Span:
    name: str
    start_s: float            # time.perf_counter() timebase
    end_s: float
    tid: int                  # real thread id (threading.get_ident())
    args: Optional[dict] = None
    # distributed identity (None for purely local spans)
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclass
class _EventStat:
    calls: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0


class Tracer:
    """Thread-safe span recorder. One process-default instance
    (:func:`default_tracer`) backs both ``fluid.profiler`` and the
    ``observability`` API, so spans from either land on one timeline."""

    def __init__(self, max_spans: int = 200_000):
        self._lock = threading.Lock()
        self._events: Dict[str, _EventStat] = {}
        self._spans: List[Span] = []
        self._dropped = 0
        self._dropped_warned = False
        self._enabled = False
        self._sinks: List[Callable[[Span], None]] = []
        self.max_spans = int(max_spans)

    # -- control ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def start(self):
        self._enabled = True

    def stop(self):
        self._enabled = False

    def active(self) -> bool:
        """True when spans are being captured (ring enabled or any sink
        attached) — the cheap gate hot paths check before building span
        arguments."""
        return self._enabled or bool(self._sinks)

    def add_sink(self, sink: Callable[[Span], None]):
        """Attach a per-span callback (spool writer, flight recorder).
        Called OUTSIDE the tracer lock; exceptions are swallowed — a
        broken sink must not take down the traced code."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[Span], None]):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def reset(self):
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._dropped = 0
            self._dropped_warned = False

    # -- recording -------------------------------------------------------
    def record(self, name: str, start_s: float, end_s: float,
               tid: Optional[int] = None, args: Optional[dict] = None,
               trace=None):
        """Record one finished span: aggregates always, the span record
        while enabled (ring) or sinks are attached (spool / flight
        recorder). ``trace`` is an optional
        ``trace_context.TraceContext`` giving the span its distributed
        identity. Safe from any thread."""
        dt = end_s - start_s
        sp = None
        sinks = ()
        dropped = first_drop = False
        with self._lock:
            e = self._events.get(name)
            if e is None:
                e = self._events[name] = _EventStat()
            e.calls += 1
            e.total += dt
            if dt < e.min:
                e.min = dt
            if dt > e.max:
                e.max = dt
            if self._enabled or self._sinks:
                sp = Span(
                    name, start_s, end_s,
                    tid if tid is not None else threading.get_ident(),
                    args,
                    trace.trace_id if trace is not None else None,
                    trace.span_id if trace is not None else None,
                    trace.parent_id if trace is not None else None)
                if self._enabled:
                    if len(self._spans) < self.max_spans:
                        self._spans.append(sp)
                    else:
                        self._dropped += 1
                        dropped = True
                        if not self._dropped_warned:
                            self._dropped_warned = first_drop = True
                sinks = tuple(self._sinks)
        # metric/warning/sinks outside the lock: none of them may block
        # (or re-enter) the recording path
        if dropped:
            DROPPED_SPANS.inc()
            if first_drop:
                warnings.warn(
                    f"tracer ring full ({self.max_spans} spans): further "
                    f"spans are dropped and counted in "
                    f"paddle_trace_dropped_spans_total", RuntimeWarning,
                    stacklevel=3)
        if sp is not None:
            for cb in sinks:
                try:
                    cb(sp)
                except Exception:
                    pass

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """``with tracer.span("step"): ...`` — RAII span + aggregate.

        While capturing, the span auto-parents under the thread's
        current :class:`TraceContext` (and exposes itself as current for
        the block), so spans nest causally across process boundaries
        once an RPC layer activated the caller's context."""
        ctx = token = tc = None
        if self._enabled or self._sinks:
            from paddle_tpu_torch.observability import trace_context as tc
            parent = tc.current()
            if parent is not None:
                ctx = parent.child()
                token = tc.attach(ctx)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if token is not None:
                tc.detach(token)
            self.record(name, t0, t1, args=args or None, trace=ctx)

    def trace(self, name_or_fn=None):
        """Decorator form: ``@tracer.trace`` or ``@tracer.trace("name")``."""
        def deco(fn, name=None):
            label = name or f"{fn.__module__}.{fn.__qualname__}"

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)
            return wrapper

        if callable(name_or_fn):
            return deco(name_or_fn)
        return lambda fn: deco(fn, name_or_fn)

    # -- reading ---------------------------------------------------------
    def event_stats(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"calls": e.calls, "total": e.total,
                        "min": e.min, "max": e.max}
                    for n, e in self._events.items()}

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped

    # -- export ----------------------------------------------------------
    def to_chrome_trace(self, pid: int = 0) -> dict:
        """chrome://tracing / Perfetto JSON ('X' complete events, µs)."""
        events = []
        for s in self.spans():
            ev = {"name": s.name, "cat": "host", "ph": "X",
                  "ts": s.start_s * 1e6, "dur": s.duration_s * 1e6,
                  "pid": pid, "tid": s.tid}
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str, pid: int = 0):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid), f)


_DEFAULT = Tracer()
_autostart_done = False


def default_tracer() -> Tracer:
    return _DEFAULT


def _autostart_from_flags():
    """One-shot: attach the span spool / flight recorder when their
    flags are set (how a spawned replica -- which cannot call our Python
    API before main -- turns capture on via env)."""
    global _autostart_done
    _autostart_done = True
    from paddle_tpu_torch.observability import flight_recorder, spool
    spool.maybe_start_from_flags()
    flight_recorder.maybe_start_from_flags()


def active() -> bool:
    """One cheap check for hot paths: is ANY span capture on (tracer
    ring, spool, flight recorder)? The first call consults the
    spool / flight flags so flag-configured processes start capturing
    lazily."""
    if not _autostart_done:
        _autostart_from_flags()
    return _DEFAULT._enabled or bool(_DEFAULT._sinks)


def add_sink(sink: Callable[[Span], None]) -> None:
    _DEFAULT.add_sink(sink)


def remove_sink(sink: Callable[[Span], None]) -> None:
    _DEFAULT.remove_sink(sink)


def span(name: str, **args):
    """Module-level convenience on the default tracer:
    ``with tracing.span("serving.handle"): ...``"""
    return _DEFAULT.span(name, **args)


def trace(name_or_fn=None):
    """``@tracing.trace`` / ``@tracing.trace("name")`` on the default
    tracer."""
    return _DEFAULT.trace(name_or_fn)
