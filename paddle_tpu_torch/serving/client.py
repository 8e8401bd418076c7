"""Serving client of the port (the port's own copy of
``paddle_tpu/serving/client.py``): the resilience kit wrapped around the
wire protocol of ``serving/server.py``. It speaks the reference's wire,
so it reaches the reference's ``ModelServer`` too.

Every RPC runs under a :class:`~paddle_tpu_torch.distributed.resilience.
RetryPolicy` (full-jitter exponential backoff, bounded by attempts AND
deadline) with each attempt gated by a :class:`CircuitBreaker` -- a dead
server fast-fails callers after the threshold instead of absorbing
every client's full retry budget.

At-most-once for non-idempotent submits: the client mints ONE
``request_id`` per logical call and resends it verbatim on every retry;
the server's idempotency cache answers a retry of an already-executed
request from the cache, so a reply lost to a dropped connection never
re-executes the work (witness: ``paddle_serving_requests_applied_total``).

Typed rejections cross the wire as ``ok=false, kind=...`` and surface
as the matching exception -- raised through
:class:`~paddle_tpu_torch.distributed.resilience.Unretryable`, so a shed
(:class:`RequestShedError`) or a cancellation is NOT retried even under
a caller-widened ``retryable`` tuple. The default
:class:`CircuitBreaker` is keyed PER ENDPOINT (process-shared).

Fault sites ``serving.rpc.send`` / ``serving.rpc.recv`` (``utils/faults.py``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import uuid
from typing import Dict, Optional, Sequence

import numpy as np

from paddle_tpu_torch.distributed.resilience import (CircuitBreaker,
                                                     RetryError, RetryPolicy,
                                                     Unretryable)
from paddle_tpu_torch.observability import trace_context as tctx
from paddle_tpu_torch.serving.server import (SERVING_ENV, ModelNotFoundError,
                                             RequestCancelledError,
                                             RequestShedError, decode_array,
                                             encode_array)
from paddle_tpu_torch.utils import faults


class ServingUnavailableError(ConnectionError):
    """The serving endpoint could not be reached within the retry
    budget; carries the endpoint and the attempts made."""

    def __init__(self, endpoint: str, attempts: int, elapsed_s: float,
                 last: BaseException):
        super().__init__(
            f"serving endpoint {endpoint} unavailable after {attempts} "
            f"attempt(s) over {elapsed_s:.2f}s (last error: {last!r})")
        self.endpoint = endpoint
        self.attempts = attempts


class ServingRequestError(RuntimeError):
    """The server executed (or rejected) the request and reported a
    non-retryable application error."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


_TYPED = {
    "shed": RequestShedError,
    "not_found": ModelNotFoundError,
    "cancelled": RequestCancelledError,
    "draining": RequestShedError,
}


# one logical breaker per ENDPOINT, shared by every client of that
# endpoint in the process: a dead replica fast-fails its own callers
# without opening the circuit for the whole service. The registry is
# bounded by the set of endpoints the process talks to.
_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def _breaker_for(endpoint: str) -> CircuitBreaker:
    with _breakers_lock:
        b = _breakers.get(endpoint)
        if b is None:
            b = CircuitBreaker(failure_threshold=5, reset_timeout_s=5.0,
                               name=f"serving:{endpoint}")
            _breakers[endpoint] = b
        return b


class ServingClient:
    """One persistent connection; reconnect-with-backoff under the retry
    policy; breaker-gated attempts. ``readyz``, ``drain`` and
    ``metricz`` are plain wire calls, as the reference's router and
    tests make them: ``client._call({"method": "readyz"})``."""

    def __init__(self, endpoint: Optional[str] = None,
                 timeout_s: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        endpoint = endpoint or os.environ.get(SERVING_ENV)
        if not endpoint:
            raise ValueError(
                f"no serving endpoint: pass one or set {SERVING_ENV}")
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout_s
        self._retry = retry_policy or RetryPolicy(
            max_attempts=8, base_delay_s=0.02, max_delay_s=0.5,
            deadline_s=30.0,
            retryable=(ConnectionError, OSError, json.JSONDecodeError))
        # default: the process-shared per-endpoint breaker — one bad
        # replica opens ITS circuit, not the whole service's
        self._breaker = breaker or _breaker_for(f"{host}:{int(port)}")
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._lock = threading.Lock()
        # trace_id of the last successful RPC (the server returns the
        # request_id↔trace_id mapping): feed it to the exemplar lookup
        # recipe / grep it in the merged tools/trace_collect.py trace
        self.last_trace_id: Optional[str] = None

    # -- wire ------------------------------------------------------------
    def _connect(self):
        self._close_sock()
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._rfile = s.makefile("rb")

    def _close_sock(self):
        for obj in (self._rfile, self._sock):
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
        self._sock = self._rfile = None

    def _call(self, req: dict) -> dict:
        # the client-side request span: one per LOGICAL call (retries
        # included), with the traceparent injected while it is current —
        # every server-side span of this request parents under it, so
        # the merged trace shows the client span containing the server's
        # admission → prefill → decode → settle. No-op when tracing off.
        with tctx.client_span(f"serving.{req.get('method')}"):
            tctx.inject(req)
            resp = self._call_locked(req)
        tid = resp.get("trace_id")
        if tid:
            self.last_trace_id = tid
        return resp

    def _call_locked(self, req: dict) -> dict:
        def raw_attempt():
            try:
                if self._sock is None:
                    self._connect()
                faults.inject("serving.rpc.send")
                self._sock.sendall((json.dumps(req) + "\n").encode())
                faults.inject("serving.rpc.recv")
                line = self._rfile.readline()
                if not line:
                    raise ConnectionError("server closed connection")
                return json.loads(line)
            except (ConnectionError, OSError, json.JSONDecodeError):
                self._close_sock()    # next attempt re-dials
                raise

        def attempt():
            # breaker gates every attempt: once open, callers fast-fail
            # (CircuitOpenError is a ConnectionError — the retry policy
            # backs off through the cooldown instead of hammering)
            resp = self._breaker.call(raw_attempt)
            if not resp.get("ok"):
                # typed application replies are Unretryable: the server
                # ANSWERED — resubmitting a shed ignores backpressure,
                # and resubmitting a cancelled request silently revives
                # work the caller already gave up on. RetryPolicy
                # re-raises the cause immediately (and counts it in
                # paddle_unretryable_total) even under a caller-supplied
                # retryable tuple broad enough to match these.
                kind = resp.get("kind", "error")
                exc = _TYPED.get(kind, ServingRequestError)
                if exc is ServingRequestError:
                    raise Unretryable(
                        ServingRequestError(kind, resp.get("error", "")))
                raise Unretryable(exc(resp.get("error", "")))
            return resp

        with self._lock:
            try:
                return self._retry.call(
                    attempt, what=f"serving.{req.get('method')}")
            except RetryError as e:
                raise ServingUnavailableError(
                    f"{self._addr[0]}:{self._addr[1]}", e.attempts,
                    e.elapsed_s, e.__cause__) from e.__cause__

    # -- API -------------------------------------------------------------
    def ping(self) -> bool:
        try:
            return bool(self._call({"method": "ping"}).get("pong"))
        except Exception:
            return False

    def models(self) -> list:
        return self._call({"method": "models"})["models"]

    def stats(self) -> dict:
        return self._call({"method": "stats"})["stats"]

    def infer(self, model: str, feeds: Dict[str, np.ndarray],
              request_id: Optional[str] = None) -> list:
        """One inference batch. The request_id is minted ONCE and reused
        across retries — at-most-once application server-side."""
        req_id = request_id or uuid.uuid4().hex
        resp = self._call({
            "method": "infer", "model": model, "req_id": req_id,
            "feeds": {n: encode_array(np.asarray(v))
                      for n, v in feeds.items()}})
        return [decode_array(d) for d in resp["outputs"]]

    def generate(self, model: str, prompts: Sequence,
                 max_new: int,
                 request_id: Optional[str] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: Optional[int] = None,
                 eos_id: Optional[int] = None) -> list:
        """Generation with optional on-device sampling (slot-scheduled
        models): temperature<=0 or top_k==1 is exact greedy; a given
        ``seed`` replays the same stream across retries AND server
        restarts; ``eos_id`` ends streams early (their decode slots
        free immediately)."""
        req_id = request_id or uuid.uuid4().hex
        msg = {
            "method": "generate", "model": model, "req_id": req_id,
            "prompts": [np.asarray(p, np.int64).reshape(-1).tolist()
                        for p in prompts],
            "max_new": int(max_new),
            "temperature": float(temperature), "top_k": int(top_k)}
        if seed is not None:
            msg["seed"] = int(seed)
        if eos_id is not None:
            msg["eos_id"] = int(eos_id)
        resp = self._call(msg)
        return [np.asarray(t, np.int64) for t in resp["tokens"]]

    def cancel(self, model: str, request_id: str) -> bool:
        """Cancel a queued or in-flight generation; its decode slots
        free within one step."""
        resp = self._call({"method": "cancel", "model": model,
                           "req_id": request_id})
        return bool(resp.get("cancelled"))

    def close(self):
        with self._lock:
            self._close_sock()
