"""Resilience policy of the port's RPC clients (the port's own copy of
``paddle_tpu/distributed/resilience.py``):

* :class:`RetryPolicy` -- exponential backoff with **full jitter**
  (sleep U(0, min(cap, base * 2^n))), bounded by BOTH an attempt count
  and a wall-clock deadline, and idempotency-aware: a callable signals
  "this failure may already have been applied server-side" by wrapping
  the error in :class:`Unretryable`, and the policy re-raises it at once
  instead of resending.
* :class:`CircuitBreaker` -- closed -> open after N consecutive
  failures -> half-open probe after a cooldown -> closed on success.

Clock, sleep and rng are injectable so tests run in virtual time with
deterministic jitter.

Port difference: the reference notes a breaker trip in the flight
recorder, which the port does not have yet; the trip is counted in
``paddle_breaker_opens_total`` as there.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

from paddle_tpu_torch.observability import metrics as _metrics

# control-plane resilience telemetry (docs/observability.md): `what` /
# `name` labels carry the operation/breaker tag callers already pass
# (bounded, enum-like strings — never ids or endpoints)
RETRY_ATTEMPTS = _metrics.counter(
    "paddle_retry_attempts_total",
    "Retries performed by RetryPolicy.call (one per backoff sleep)",
    labelnames=("what",))
RETRY_EXHAUSTED = _metrics.counter(
    "paddle_retry_exhausted_total",
    "RetryPolicy budgets spent (RetryError raised)", labelnames=("what",))
UNRETRYABLE = _metrics.counter(
    "paddle_unretryable_total",
    "Failures surfaced immediately because the effect may already have "
    "applied (Unretryable escape hatch)", labelnames=("what",))
BREAKER_STATE = _metrics.gauge(
    "paddle_breaker_state",
    "CircuitBreaker state: 0 closed, 1 half-open, 2 open. One logical "
    "breaker per name: same-named instances share the child "
    "(last-writer-wins) — give concurrent breakers distinct names",
    labelnames=("name",))
BREAKER_OPENS = _metrics.counter(
    "paddle_breaker_opens_total",
    "Times a CircuitBreaker tripped open", labelnames=("name",))

_STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}


class RetryError(Exception):
    """Retry budget exhausted. ``__cause__`` is the last attempt's error;
    ``attempts``/``elapsed_s`` record how much budget was spent."""

    def __init__(self, msg: str, attempts: int, elapsed_s: float):
        super().__init__(msg)
        self.attempts = attempts
        self.elapsed_s = elapsed_s


class Unretryable(Exception):
    """Wrapper a callable raises to force :meth:`RetryPolicy.call` to
    re-raise ``cause`` immediately — the idempotency escape hatch for
    ops whose effect may already have landed (e.g. a gradient push whose
    connection died after the send: resending could apply it twice)."""

    def __init__(self, cause: BaseException):
        super().__init__(repr(cause))
        self.cause = cause


class RetryPolicy:
    """Deadline- and attempt-bounded exponential backoff with full jitter.

    ``max_attempts=0`` means unbounded attempts (the deadline governs);
    ``deadline_s=None`` means no wall-clock bound (attempts govern).
    At least one bound should be finite.
    """

    def __init__(self, max_attempts: int = 5, base_delay_s: float = 0.05,
                 max_delay_s: float = 1.0,
                 deadline_s: Optional[float] = 30.0,
                 retryable: Tuple[Type[BaseException], ...] = (
                     ConnectionError, OSError, TimeoutError),
                 jitter: bool = True,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if max_attempts == 0 and deadline_s is None:
            raise ValueError("RetryPolicy needs a finite max_attempts or "
                             "deadline_s (or both)")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = deadline_s
        self.retryable = tuple(retryable)
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry #`attempt` (1-based): full jitter under an
        exponentially growing cap."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap) if self.jitter else cap

    def call(self, fn: Callable, what: str = "operation",
             on_retry: Optional[Callable[[int, BaseException, float],
                                         None]] = None):
        """Run ``fn()`` under the policy. Raises :class:`RetryError` (with
        the last error as ``__cause__``) once the budget is spent; raises
        the wrapped cause immediately for :class:`Unretryable`; any
        non-retryable exception propagates untouched on first occurrence.
        """
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except Unretryable as u:
                UNRETRYABLE.labels(what=what).inc()
                raise u.cause
            except self.retryable as e:
                elapsed = self._clock() - start
                delay = self.backoff_s(attempt)
                out_of_attempts = (self.max_attempts
                                   and attempt >= self.max_attempts)
                out_of_time = (self.deadline_s is not None
                               and elapsed + delay > self.deadline_s)
                if out_of_attempts or out_of_time:
                    RETRY_EXHAUSTED.labels(what=what).inc()
                    raise RetryError(
                        f"{what} failed after {attempt} attempt(s) over "
                        f"{elapsed:.2f}s: {e!r}", attempt, elapsed) from e
                RETRY_ATTEMPTS.labels(what=what).inc()
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                self._sleep(delay)


class CircuitOpenError(ConnectionError):
    """Fast-fail: the breaker is open; the protected peer is presumed
    down until the cooldown elapses."""


class CircuitBreaker:
    """Minimal 3-state breaker (closed / open / half-open), thread-safe.

    N *consecutive* failures open the circuit; while open every call
    fast-fails with :class:`CircuitOpenError`; after ``reset_timeout_s``
    the next call runs as a half-open probe — success closes the
    circuit, failure re-opens it and restarts the cooldown.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "default"):
        """``name`` tags this breaker's telemetry (the
        ``paddle_breaker_state`` gauge / ``paddle_breaker_opens_total``
        counter label) — a short enum-like tag, not an endpoint."""
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._publish_state()

    def _publish_state(self):
        BREAKER_STATE.labels(name=self.name).set(
            _STATE_CODE[self._state])

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._publish_state()
        return self._state

    def allow(self) -> bool:
        with self._lock:
            return self._state_locked() != self.OPEN

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._publish_state()

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if (self._failures >= self.failure_threshold
                    or self._state == self.HALF_OPEN):
                was_open = self._state == self.OPEN
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._publish_state()
                if not was_open:
                    BREAKER_OPENS.labels(name=self.name).inc()

    def call(self, fn: Callable):
        if not self.allow():
            with self._lock:
                remaining = max(
                    0.0, self.reset_timeout_s
                    - (self._clock() - self._opened_at))
                n = self._failures
            raise CircuitOpenError(
                f"circuit open after {n} consecutive failures; "
                f"probe allowed in {remaining:.2f}s")
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result
