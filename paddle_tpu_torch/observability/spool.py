"""Per-process span spool (the port's own copy of
``paddle_tpu/observability/spool.py``): append-only, crash-tolerant
JSONL.

The tracer's in-memory ring dies with the process -- useless exactly
when a replica is SIGKILLed mid-request. The spool is the durable half:
a :class:`SpanSpool` attaches to the tracer as a sink and appends every
finished span to ``FLAGS_trace_spool_dir/<role>.<pid>.jsonl``, one JSON
object per line, ``flush()``ed per span -- after a kill the file is
complete up to the last whole line (a torn final line is skipped by the
reader). ``tools/trace_collect.py`` merges the spools of a directory,
the reference's processes' and the port's alike, into one Perfetto
trace.

File layout (the reference's, key for key):
- line 1 is a ``{"k": "meta", ...}`` header naming the role, pid and the
  process's wall-clock anchor;
- every other line is ``{"k": "span", "name", "ts", "dur", "tid",
  "trace_id", "span_id", "parent_id", "args"}`` with ``ts``/``dur`` in
  wall-clock MICROSECONDS -- spans are perf_counter-based in memory, so
  each process converts through one anchor captured at import
  (``wall = perf + _PERF_TO_WALL``) and cross-process timestamps land
  on a shared axis without clock negotiation.

Enable per process with ``FLAGS_trace_spool_dir`` (+ optional
``FLAGS_trace_role``) -- how the router's replica children inherit
capture via env -- or programmatically via :func:`ensure_started`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

# one wall<->perf anchor per process, captured as early as possible so
# every span this process ever spools converts identically
_PERF_TO_WALL = time.time() - time.perf_counter()


def wall_us(perf_s: float) -> float:
    """perf_counter seconds -> wall-clock microseconds (shared axis)."""
    return (perf_s + _PERF_TO_WALL) * 1e6


def default_role() -> str:
    """FLAGS_trace_role, else the script basename, else 'proc'."""
    from paddle_tpu_torch import flags
    role = flags.get("trace_role")
    if role:
        return role
    argv0 = os.path.basename(sys.argv[0] or "")
    if argv0.endswith(".py"):
        argv0 = argv0[:-3]
    return argv0 or "proc"


class SpanSpool:
    """Append-only span writer; usable directly as a tracer sink."""

    def __init__(self, directory: str, role: Optional[str] = None):
        self.role = role or default_role()
        self.pid = os.getpid()
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory,
                                 f"{self.role}.{self.pid}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        self._write({"k": "meta", "role": self.role, "pid": self.pid,
                     "argv": sys.argv[:4],
                     "start_wall_us": wall_us(time.perf_counter())})

    def _write(self, obj: dict):
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()      # crash tolerance: every line durable

    def __call__(self, span) -> None:
        """Tracer sink entry point (observability.tracing.Span)."""
        rec = {"k": "span", "name": span.name,
               "ts": wall_us(span.start_s),
               "dur": max(0.0, span.end_s - span.start_s) * 1e6,
               "tid": span.tid}
        if span.trace_id:
            rec["trace_id"] = span.trace_id
            rec["span_id"] = span.span_id
            if span.parent_id:
                rec["parent_id"] = span.parent_id
        if span.args:
            rec["args"] = span.args
        self._write(rec)

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.close()


_SPOOL: Optional[SpanSpool] = None
_lock = threading.Lock()


def ensure_started(directory: Optional[str] = None,
                   role: Optional[str] = None) -> Optional[SpanSpool]:
    """Start (once) the process spool and attach it to the default
    tracer. With no ``directory``, falls back to FLAGS_trace_spool_dir
    (returns None when that is empty too)."""
    global _SPOOL
    with _lock:
        if _SPOOL is not None:
            return _SPOOL
        if directory is None:
            from paddle_tpu_torch import flags
            directory = flags.get("trace_spool_dir")
        if not directory:
            return None
        _SPOOL = SpanSpool(directory, role)
    from paddle_tpu_torch.observability import tracing
    tracing.add_sink(_SPOOL)
    return _SPOOL


def maybe_start_from_flags() -> None:
    """tracing.active()'s one-time autostart hook."""
    ensure_started()


def current() -> Optional[SpanSpool]:
    return _SPOOL


def shutdown() -> None:
    """Detach and close the process spool (every line is already
    flushed, so no atexit hook is needed)."""
    global _SPOOL
    with _lock:
        sp, _SPOOL = _SPOOL, None
    if sp is not None:
        from paddle_tpu_torch.observability import tracing
        tracing.remove_sink(sp)
        sp.close()
