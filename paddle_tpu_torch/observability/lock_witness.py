"""Runtime lock-order witness (the port's own copy of
``paddle_tpu/observability/lock_witness.py``).

Every instrumented lock is an :class:`ObservedLock`; under
``FLAGS_lock_witness`` each acquisition records, per thread, the stack
of locks already held and adds held->acquiring edges to one global
order graph. An edge that closes a cycle is a **witnessed inversion**:
two threads interleaving those two call sites can deadlock, even if
this run got lucky.

On a violation the witness

- increments ``paddle_lock_witness_violations_total``,
- notes the event in the flight recorder with BOTH stacks -- the Python
  stack acquiring in the reversed order now, and the stack recorded
  when the forward edge was first witnessed -- and triggers a dump
  (``FLAGS_flight_recorder_dir``), so a crash artifact names the two
  call sites to reorder,
- keeps the record in :func:`violations` for in-process assertions.

The wrapper is always safe to construct: with the flag off, ``acquire``
costs one flag lookup over the bare ``threading.Lock``. Construct
instrumented locks via :func:`make_lock`::

    self._pool_lock = lock_witness.make_lock("Router._pool_lock")

Witness bookkeeping runs under its own plain (never-observed) lock and
never raises into the caller. (The reference's static twin, the
concurrency lint of ``analysis/concurrency.py``, is not ported.)
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch import flags

# (held, acquiring) -> first-witness record: the stack + thread that
# established the order
_EDGES: Dict[Tuple[str, str], dict] = {}
_VIOLATIONS: List[dict] = []
_STATE_LOCK = threading.Lock()      # plain on purpose: guards the graph
_HELD = threading.local()           # .stack: per-thread held lock names


def declare_metrics():
    """Get-or-create the violation counter (the exporters' catalog
    imports this module so a scrape shows it at zero)."""
    from paddle_tpu_torch.observability import metrics as obs_metrics
    return obs_metrics.counter(
        "paddle_lock_witness_violations_total",
        "lock-order inversions witnessed at runtime by ObservedLock "
        "(FLAGS_lock_witness): an acquisition whose held->acquiring "
        "edge closes a cycle in the observed lock-order graph")


def _held_stack() -> List[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _path_exists(src: str, dst: str) -> bool:
    """True when src reaches dst in the witnessed order graph
    (_STATE_LOCK held by the caller)."""
    stack, seen = [src], set()
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        for (a, b) in _EDGES:
            if a == cur:
                stack.append(b)
    return False


def _record_violation(held: str, acquiring: str, prior: dict,
                      stack_now: str):
    rec = {"held": held, "acquiring": acquiring,
           "thread": threading.current_thread().name,
           "stack_now": stack_now,
           "prior_thread": prior.get("thread"),
           "prior_stack": prior.get("stack")}
    with _STATE_LOCK:
        _VIOLATIONS.append(rec)
    try:
        declare_metrics().inc()
    except Exception:
        pass
    try:
        from paddle_tpu_torch.observability import flight_recorder
        flight_recorder.note(
            "lock_witness_violation", held=held, acquiring=acquiring,
            thread=rec["thread"], stack_now=stack_now,
            prior_thread=rec["prior_thread"],
            prior_stack=rec["prior_stack"])
        flight_recorder.dump("lock_witness")
    except Exception:
        pass


class ObservedLock:
    """A ``threading.Lock`` wrapper feeding the global
    lock-order witness when ``FLAGS_lock_witness`` is on. Supports the
    context-manager protocol plus ``acquire``/``release``/``locked``,
    so it drops in anywhere a plain lock object is stored."""

    def __init__(self, name: str):
        self.name = str(name)
        self._inner = threading.Lock()

    def __repr__(self):
        return f"ObservedLock({self.name!r})"

    # -- witnessing -------------------------------------------------------
    def _witness(self, held: List[str]):
        try:
            acquiring = self.name
            if acquiring in held:
                return                       # reentrant / same-name class
            stack_now = None
            for h in reversed(held):
                edge = (h, acquiring)
                with _STATE_LOCK:
                    known = edge in _EDGES
                    # a cycle exists iff the new edge's head already
                    # reaches its tail through witnessed edges
                    cyclic = (not known
                              and _path_exists(acquiring, h))
                    if not known:
                        if stack_now is None:
                            stack_now = "".join(
                                traceback.format_stack(limit=16)[:-2])
                        _EDGES[edge] = {
                            "stack": stack_now,
                            "thread":
                                threading.current_thread().name}
                    prior = dict(_EDGES.get((acquiring, h)) or {})
                if cyclic:
                    if not prior:
                        # the reverse order was witnessed transitively;
                        # name the first edge of the return path we have
                        with _STATE_LOCK:
                            for (a, b), info in _EDGES.items():
                                if a == acquiring:
                                    prior = dict(info)
                                    break
                    _record_violation(h, acquiring, prior,
                                      stack_now or "".join(
                                          traceback.format_stack(
                                              limit=16)[:-2]))
        except Exception:
            pass                             # the witness never raises

    # -- lock protocol ----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        witnessing = False
        try:
            witnessing = bool(flags.get("lock_witness"))
        except Exception:
            pass
        if witnessing:
            self._witness(_held_stack())
        got = self._inner.acquire(blocking, timeout)
        if got and witnessing:
            _held_stack().append(self.name)
        return got

    def release(self):
        self._inner.release()
        stack = getattr(_HELD, "stack", None)
        if stack and self.name in stack:
            # remove the most recent acquisition of this name
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


def make_lock(name: str) -> ObservedLock:
    """An instrumented lock for a known lock site. Cheap when
    FLAGS_lock_witness is off (one flag lookup per acquire)."""
    return ObservedLock(name)


def violations() -> List[dict]:
    """Witnessed inversions so far (each names both locks, both threads
    and both stacks). Tests assert this stays empty."""
    with _STATE_LOCK:
        return list(_VIOLATIONS)


def edges() -> Dict[Tuple[str, str], dict]:
    """The witnessed lock-order graph (copy)."""
    with _STATE_LOCK:
        return {k: dict(v) for k, v in _EDGES.items()}


def reset():
    """Clear the witnessed graph and violation list (tests)."""
    with _STATE_LOCK:
        _EDGES.clear()
        _VIOLATIONS.clear()


# the witness's own metric family exists from first import, so the
# exporter catalog can preregister it by importing this module
try:
    declare_metrics()
except Exception:
    pass
