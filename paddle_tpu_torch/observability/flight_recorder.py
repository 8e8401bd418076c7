"""Crash flight recorder (the port's own copy of
``paddle_tpu/observability/flight_recorder.py``): a black box for
processes that die.

It keeps a bounded per-process ring of recent events -- finished spans
(tracer sink), metric counter deltas, fault-site fires (``utils.faults``
observer), explicit notes (breaker opens, replica deaths) -- and
persists it two ways:

- **dump**: ``<dir>/<role>.<pid>.dump.json``, written atomically
  (tmp + rename) on unhandled exception, SIGTERM, or a fault-injection
  fire -- one readable artifact: the ring, a metrics snapshot, and the
  fault-site counters at death;
- **black box**: ``<dir>/<role>.<pid>.blackbox.jsonl``, every event
  appended and ``flush()``ed immediately. SIGKILL gives no hook, but
  flushed lines are in the kernel page cache and survive process death.

Enable with ``FLAGS_flight_recorder_dir`` (capacity via
``FLAGS_flight_recorder_capacity``) or :func:`ensure_started`. The
SIGTERM handler dumps, restores the previous disposition, and re-kills
itself so the exit status stays honest. Hot-path cost when disabled:
zero (nothing is registered anywhere).

Port difference: a dump's ``memory`` block is the card's allocator
census (``observability/memory.py`` :func:`~paddle_tpu_torch.
observability.memory.device_census`), not the reference's scope census,
which is not ported.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from paddle_tpu_torch.observability.spool import default_role, wall_us


class FlightRecorder:
    """Bounded event ring + always-flushed black box + atomic dump."""

    # sample metric deltas into the ring every N recorded events, so a
    # dump carries counter movement without per-event snapshot cost
    METRICS_EVERY = 32

    def __init__(self, directory: str, role: Optional[str] = None,
                 capacity: int = 256):
        self.role = role or default_role()
        self.pid = os.getpid()
        os.makedirs(directory, exist_ok=True)
        stem = os.path.join(directory, f"{self.role}.{self.pid}")
        self.dump_path = stem + ".dump.json"
        self.blackbox_path = stem + ".blackbox.jsonl"
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._bb = open(self.blackbox_path, "a", encoding="utf-8")
        self._since_metrics = 0
        self._last_counters = self._counter_values()
        self._event("start", argv=sys.argv[:4])

    # -- event intake ----------------------------------------------------
    def _event(self, kind: str, **fields):
        rec = {"t": wall_us(time.perf_counter()), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._bb.closed:
                return
            self._ring.append(rec)
            self._bb.write(line + "\n")
            self._bb.flush()     # must survive SIGKILL
            self._since_metrics += 1
            sample = self._since_metrics >= self.METRICS_EVERY
            if sample:
                self._since_metrics = 0
        if sample and kind != "metrics":
            self._sample_metrics()

    def __call__(self, span) -> None:
        """Tracer sink: every finished span becomes a ring event."""
        f = {"name": span.name, "ts": wall_us(span.start_s),
             "dur_us": max(0.0, span.end_s - span.start_s) * 1e6}
        if span.trace_id:
            f["trace_id"] = span.trace_id
            f["span_id"] = span.span_id
        if span.args:
            f["args"] = span.args
        self._event("span", **f)

    def on_fault(self, site: str, mode: str) -> None:
        """utils.faults observer -- recorded BEFORE the fault's effect,
        so the black box names the kill point even when the fault ends
        the process. Also dumps (re-dumps overwrite, so the newest fire
        wins)."""
        self._event("fault", site=site, mode=mode)
        try:
            self.dump("fault")
        except Exception:
            pass

    def note(self, what: str, **fields) -> None:
        """Explicit breadcrumb (breaker opened, replica died...)."""
        self._event("note", what=what, **fields)

    def _counter_values(self) -> dict:
        from paddle_tpu_torch.observability import metrics
        out = {}
        for fam in metrics.default_registry().families():
            if fam.kind not in ("counter", "gauge"):
                continue
            for values, child in fam.children().items():
                key = fam.name + (":" + ",".join(values) if values else "")
                out[key] = child.value
        return out

    def _sample_metrics(self):
        now = self._counter_values()
        delta = {k: v - self._last_counters.get(k, 0.0)
                 for k, v in now.items()
                 if v != self._last_counters.get(k, 0.0)}
        self._last_counters = now
        if delta:
            self._event("metrics", delta=delta)

    # -- dumping ---------------------------------------------------------
    def dump(self, reason: str) -> str:
        """Write the dump atomically; returns its path. Re-dumping
        overwrites (later = closer to death = better)."""
        with self._lock:
            ring = list(self._ring)
        from paddle_tpu_torch.observability import metrics
        from paddle_tpu_torch.utils import faults
        doc = {"role": self.role, "pid": self.pid, "reason": reason,
               "wall_us": wall_us(time.perf_counter()),
               "events": ring,
               "metrics": metrics.default_registry().snapshot(),
               "faults": faults.stats()}
        try:
            from paddle_tpu_torch.observability import memory
            doc["memory"] = memory.device_census()
        except Exception:
            pass
        tmp = self.dump_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dump_path)
        return self.dump_path

    def close(self):
        with self._lock:
            if not self._bb.closed:
                self._bb.close()


_REC: Optional[FlightRecorder] = None
_lock = threading.Lock()
_prev_excepthook = None
_prev_sigterm = None


def _excepthook(exc_type, exc, tb):
    rec = _REC
    if rec is not None:
        try:
            rec._event("exception", exc_type=exc_type.__name__,
                       message=str(exc)[:500])
            rec.dump("exception")
        except Exception:
            pass
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def _sigterm(signum, frame):
    rec = _REC
    if rec is not None:
        try:
            rec._event("sigterm")
            rec.dump("sigterm")
        except Exception:
            pass
    # restore the previous disposition and re-kill: the process must
    # still die *of SIGTERM* (wait status, not a clean exit code)
    signal.signal(signal.SIGTERM,
                  _prev_sigterm if callable(_prev_sigterm)
                  else signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def ensure_started(directory: Optional[str] = None,
                   role: Optional[str] = None,
                   capacity: Optional[int] = None
                   ) -> Optional[FlightRecorder]:
    """Start (once) the process flight recorder: open the black box,
    attach the tracer sink + fault observer, install the excepthook and
    (main thread only) the SIGTERM dumper. Falls back to
    FLAGS_flight_recorder_dir / FLAGS_flight_recorder_capacity."""
    global _REC, _prev_excepthook, _prev_sigterm
    with _lock:
        if _REC is not None:
            return _REC
        from paddle_tpu_torch import flags
        if directory is None:
            directory = flags.get("flight_recorder_dir")
        if not directory:
            return None
        if capacity is None:
            capacity = flags.get("flight_recorder_capacity")
        _REC = FlightRecorder(directory, role, capacity)
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        try:
            _prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:       # not the main thread
            _prev_sigterm = None
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.utils import faults
    tracing.add_sink(_REC)
    faults.add_observer(_REC.on_fault)
    return _REC


def maybe_start_from_flags() -> None:
    """tracing.active()'s one-time autostart hook."""
    ensure_started()


def current() -> Optional[FlightRecorder]:
    return _REC


def note(what: str, **fields) -> None:
    """Breadcrumb into the recorder when one is running (else no-op --
    one attribute read on the disabled path)."""
    rec = _REC
    if rec is not None:
        rec.note(what, **fields)


def dump(reason: str) -> Optional[str]:
    rec = _REC
    return rec.dump(reason) if rec is not None else None


def shutdown() -> None:
    """Detach hooks and close (tests, and a replica on its way out)."""
    global _REC
    with _lock:
        rec, _REC = _REC, None
    if rec is None:
        return
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.utils import faults
    tracing.remove_sink(rec)
    faults.remove_observer(rec.on_fault)
    if sys.excepthook is _excepthook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
    try:
        if signal.getsignal(signal.SIGTERM) is _sigterm:
            signal.signal(signal.SIGTERM,
                          _prev_sigterm if _prev_sigterm is not None
                          else signal.SIG_DFL)
    except ValueError:
        pass
    rec.close()
