"""Cross-process trace context (the port's own copy of
``paddle_tpu/observability/trace_context.py``): a W3C-traceparent-style
:class:`TraceContext` (trace_id / span_id / parent_id) carried in a
``contextvars.ContextVar`` and injected into / extracted from the JSON
wire messages of the serving client and server
(``serving/client.py``, ``serving/server.py``).

The server extracts the caller's context, activates it for the handling
thread, and every span recorded inside -- admission, queue wait,
``serving.prefill@{bucket}``, decode steps, settle -- becomes a child of
the client's request span.

Wire format: one extra JSON key ``"traceparent":
"00-<32 hex trace_id>-<16 hex span_id>-01"``, added only while a
context is ACTIVE, so with tracing off the wire bytes are unchanged.
The two wires (the reference's and the port's) are the same, so a
reference client and a port server trace into one tree.

Hot path: :func:`active` is one boolean check when tracing is off;
:func:`span` then yields at once.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from dataclasses import dataclass
from typing import Optional

from paddle_tpu_torch.observability import tracing as _tracing

TRACEPARENT_KEY = "traceparent"
_VERSION = "00"
_FLAGS = "01"            # sampled


@dataclass(frozen=True)
class TraceContext:
    """One node of the causal tree: which trace this execution belongs
    to (``trace_id``), which span is currently open (``span_id``), and
    that span's parent (``parent_id``; None at the trace root)."""

    trace_id: str                       # 32 hex chars
    span_id: str                        # 16 hex chars
    parent_id: Optional[str] = None     # 16 hex chars or None

    def child(self) -> "TraceContext":
        """Fresh span under this one (same trace)."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def to_traceparent(self) -> str:
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS}"


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def new_trace() -> TraceContext:
    """Start a new trace (root context, no parent)."""
    return TraceContext(_new_trace_id(), _new_span_id(), None)


def from_traceparent(header: str) -> Optional[TraceContext]:
    """Parse ``"00-<trace>-<span>-01"``; None on anything malformed
    (a hostile or stale peer must never break request handling)."""
    try:
        parts = str(header).split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id, _ = parts
        int(trace_id, 16)
        int(span_id, 16)
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        return TraceContext(trace_id, span_id, None)
    except (ValueError, AttributeError):
        return None


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("paddle_trace_context", default=None)


def current() -> Optional[TraceContext]:
    """The context active on THIS thread/task (None outside any trace)."""
    return _CURRENT.get()


def attach(ctx: Optional[TraceContext]):
    """Set the current context; returns the token for :func:`detach`."""
    return _CURRENT.set(ctx)


def detach(token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """``with activate(extract(msg)): ...`` — scope a context (or None)
    to a block; always restores the previous one."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


# -- wire inject / extract ----------------------------------------------

def inject(msg: dict) -> dict:
    """Stamp the ACTIVE context into an outgoing JSON message (in
    place). No-op without an active context — the wire stays
    byte-identical when tracing is off."""
    ctx = _CURRENT.get()
    if ctx is not None:
        msg[TRACEPARENT_KEY] = ctx.to_traceparent()
    return msg


def extract(msg: dict) -> Optional[TraceContext]:
    """Parse the caller's context out of an incoming message (None when
    absent/malformed). Activate it to parent this process's spans under
    the caller's span: ``with activate(extract(req)): handle(req)``."""
    header = msg.get(TRACEPARENT_KEY) if isinstance(msg, dict) else None
    if not header:
        return None
    return from_traceparent(header)


# -- span recording under the context -----------------------------------

def active() -> bool:
    """True when spans are being captured anywhere (tracer ring started
    or a sink attached) — the one-flag check hot
    paths gate on."""
    return _tracing.active()


@contextlib.contextmanager
def span(name: str, ctx: Optional[TraceContext] = None, **args):
    """Record a span under ``ctx`` (default: the current context; a new
    root trace when none is active). The block runs with the span's own
    context current, so nested spans and injected RPCs parent to it.

    One boolean check and an immediate yield when tracing is off."""
    if not _tracing.active():
        yield None
        return
    parent = ctx if ctx is not None else _CURRENT.get()
    child = parent.child() if parent is not None else new_trace()
    token = _CURRENT.set(child)
    t0 = time.perf_counter()
    try:
        yield child
    finally:
        _CURRENT.reset(token)
        _tracing.default_tracer().record(
            name, t0, time.perf_counter(),
            args=args or None, trace=child)


# the serving client wraps each logical RPC in this: a root
# span when the caller isn't traced yet, a child span when it is —
# either way the traceparent injected INSIDE the block carries this
# span's id, so the server's spans parent under the client's.
client_span = span


def record_span(name: str, start_s: float, end_s: float,
                ctx: Optional[TraceContext] = None, **args) -> None:
    """Retroactively record a span that already happened (queue wait,
    decode step) as a child of ``ctx`` — for lifecycle phases measured
    by timestamps rather than wrapped in a with-block."""
    if not _tracing.active():
        return
    child = ctx.child() if ctx is not None else new_trace()
    _tracing.default_tracer().record(name, start_s, end_s,
                                     args=args or None, trace=child)


def current_or_new() -> Optional[TraceContext]:
    """The current context, or a fresh root when tracing is active but
    no caller context exists (an untraced client talking to a traced
    server still gets a server-side trace). None when tracing is off."""
    ctx = _CURRENT.get()
    if ctx is not None:
        return ctx
    if not _tracing.active():
        return None
    return new_trace()
