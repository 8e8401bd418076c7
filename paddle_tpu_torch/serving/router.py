"""Replicated serving of the port (the port's own copy of
``paddle_tpu/serving/router.py``): a health-checked router fronting N
single-model ``ModelServer`` replica processes.

One router process speaks the existing JSON/TCP wire protocol on BOTH
sides: clients connect to it exactly as they would to a bare server
(``ServingClient`` needs no changes), and it forwards each request to a
replica spawned from a ``serving.replica`` spec — supervised with
restart-with-backoff and crash-loop detection, the `tools/launch.py`
process idioms promoted into a long-lived supervisor. The wire is the
reference's, byte for byte, on both sides: the reference's
``ServingClient`` reaches this router, and the reference's router can
front the port's servers.

Routing is request-id STICKY: a request_id maps to one replica for its
lifetime, so client retries land on the same per-process idempotency
cache and at-most-once semantics survive the extra hop. Failover is the
one deliberate exception: when the sticky replica is dead (its
per-replica :class:`CircuitBreaker` open, its connection refused, or it
answers ``kind="draining"``), the request has by construction NOT been
acked-applied to the client — re-dispatching the same request_id to a
survivor is safe, and requests that WERE applied on the dead replica
either already answered or are lost with their TCP connection (the
client's retry re-executes on the survivor under the same request_id,
which is the at-most-once contract: at most once PER replica that
answers).

Replica lifecycle (serving/replica.py): the wire serves immediately but
``readyz`` stays false until warmup/AOT-load completes — the router
never routes to a still-compiling replica; ``drain`` stops admission
and settles in-flight work before a clean exit — ``restart_replica`` /
``rolling_restart`` use it to
replace replicas one at a time under live load with zero non-shed
failures.

The pool is ELASTIC (``serving/autoscaler.py`` closes the loop):
``scale_up`` appends fresh slots, ``scale_down`` retires one via the
same graceful drain rolling restarts use, and slot indexes are
monotonic — never reused — so sticky entries and per-replica metrics
stay unambiguous across scale events. Replica deaths are classified:
a ``<role>.<pid>.memdump.json`` in the slot's flight-recorder dir
(``observability/memory.py``'s OOM forensics) marks the death
``cause="oom"`` and the slot respawns ONCE with the registered
fallback spec instead of re-entering the restart/quarantine loop (an
OOM is deterministic under the same config — respawning it can only
crash-loop). Crash-loop quarantine is no longer terminal: a FAILED
slot retries after a backed-off cooldown, and a sustained healthy
period resets the whole restart ledger.

Telemetry: ``paddle_router_replica_up`` (per-slot routing
eligibility), ``paddle_router_replica_state{replica,state}``
(one-hot lifecycle), ``paddle_router_replica_inflight`` /
``paddle_router_replica_queue_depth`` (the autoscaler's congestion
view — polled via the stats RPC, never object internals),
``paddle_router_failovers_total{cause}``,
``paddle_router_drain_duration_seconds``,
``paddle_router_replica_restarts_total{cause}``,
``paddle_router_requests_total{outcome}``; trace spans ``router.route``
stitch the client → router → replica chain in the merged
``tools/trace_collect.py`` trace; failovers and crash-loop verdicts
land in the flight recorder.

Port difference: a supervised slot spawns ``python -m
paddle_tpu_torch.serving.replica`` (the reference spawns its own
package's replica), so a spec must carry the port's ``weights`` (and
``device``) keys (``serving/replica.py``).
"""

from __future__ import annotations

import json
import os
import signal
import socket as socket_module
import socketserver
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional

from paddle_tpu_torch.distributed.resilience import (CircuitBreaker,
                                                     CircuitOpenError)
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability import trace_context as tctx
from paddle_tpu_torch.serving import metrics as smetrics

ROUTER_ENV = "PADDLE_ROUTER"

# replica states (the supervisor's view; `ready` is the only routable
# one for NEW request_ids — `draining` still serves sticky retries)
STARTING, READY, DRAINING, DOWN, FAILED = (
    "starting", "ready", "draining", "down", "failed")
_STATES = (STARTING, READY, DRAINING, DOWN, FAILED)


class _Replica:
    """One pool slot: the (re)spawned process, its endpoint, its
    breaker, and the supervisor bookkeeping. ``gen`` bumps on every
    endpoint change so cached per-thread sockets to the old process
    are never reused against the new one."""

    def __init__(self, index: int, endpoint: Optional[str] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 spec: Optional[dict] = None):
        self.index = index
        self.endpoint = endpoint
        self.state = STARTING
        self.spec = spec                   # per-slot spec override
        self.proc: Optional[subprocess.Popen] = None
        self.endpoint_file: Optional[str] = None
        self.flight_dir: Optional[str] = None   # child's recorder dir
        self.gen = 0
        self.inflight = 0
        self.queue_depth = 0               # replica-reported (polled)
        self.lock = lock_witness.make_lock("_Replica.lock")
        self.restart_times: deque = deque(maxlen=16)
        self.restart_at = 0.0              # next supervised respawn time
        self.backoff_s = 0.0
        self.failed_at = 0.0               # quarantine entry time
        self.quarantines = 0               # quarantine episodes so far
        self.ready_since = 0.0             # for the sustained-healthy reset
        self.oom_replaced = False          # fallback spec already applied
        self.retiring = False              # scale_down owns this slot
        self.last_exit: Optional[dict] = None
        self._stats_at = 0.0               # last stats-poll time
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            reset_timeout_s=breaker_reset_s,
            name=f"router-replica-{index}")
        self._tl = threading.local()       # per-thread socket cache
        # through set_state so the one-hot state gauge is born correct
        self.set_state(STARTING if endpoint is None else READY)

    # -- wire ------------------------------------------------------------
    def _dial(self, timeout: float):
        host, port = self.endpoint.rsplit(":", 1)
        s = socket_module.create_connection((host, int(port)),
                                            timeout=timeout)
        s.setsockopt(socket_module.IPPROTO_TCP,
                     socket_module.TCP_NODELAY, 1)
        self._tl.sock = s
        self._tl.rfile = s.makefile("rb")
        self._tl.gen = self.gen

    def close_cached(self):
        sock = getattr(self._tl, "sock", None)
        if sock is not None:
            for obj in (self._tl.rfile, sock):
                try:
                    obj.close()
                except OSError:
                    pass
        self._tl.sock = self._tl.rfile = None

    def exchange(self, payload: dict, timeout: float) -> dict:
        """One request/response on this thread's cached connection;
        any wire error closes the socket and propagates (the router's
        failover loop decides what happens next)."""
        if getattr(self._tl, "sock", None) is not None \
                and getattr(self._tl, "gen", -1) != self.gen:
            self.close_cached()            # endpoint changed underneath
        try:
            if getattr(self._tl, "sock", None) is None:
                if not self.endpoint:
                    raise ConnectionError(
                        f"replica {self.index} has no endpoint yet")
                self._dial(timeout)
            self._tl.sock.settimeout(timeout)
            self._tl.sock.sendall(
                (json.dumps(payload) + "\n").encode())
            line = self._tl.rfile.readline()
            if not line:
                raise ConnectionError(
                    f"replica {self.index} closed the connection")
            return json.loads(line)
        except (ConnectionError, OSError, json.JSONDecodeError):
            self.close_cached()
            raise

    def set_state(self, state: str):
        with self.lock:
            prev = self.state
            self.state = state
            if state == READY and prev != READY:
                self.ready_since = time.monotonic()
        smetrics.ROUTER_REPLICA_UP.labels(
            replica=str(self.index)).set(1.0 if state == READY else 0.0)
        for s in _STATES:
            smetrics.ROUTER_REPLICA_STATE.labels(
                replica=str(self.index),
                state=s).set(1.0 if s == state else 0.0)

    def retire_gauges(self):
        """Zero every per-replica gauge when the slot leaves the pool —
        a scraped fleet must not show a ghost replica as up."""
        lbl = str(self.index)
        smetrics.ROUTER_REPLICA_UP.labels(replica=lbl).set(0.0)
        smetrics.ROUTER_REPLICA_INFLIGHT.labels(replica=lbl).set(0.0)
        smetrics.ROUTER_REPLICA_QUEUE_DEPTH.labels(replica=lbl).set(0.0)
        for s in _STATES:
            smetrics.ROUTER_REPLICA_STATE.labels(
                replica=lbl, state=s).set(0.0)


class Router:
    """Route requests across a replica pool; supervise the pool.

    Two modes:

    * **supervised** — ``Router(spec=..., replicas=N, workdir=...)``
      spawns N ``python -m paddle_tpu_torch.serving.replica`` processes and
      owns their lifecycle (readyz gating, restart-with-backoff,
      crash-loop detection, drain-based rolling restart);
    * **attached** — ``Router(endpoints=[...])`` fronts externally
      managed servers: routing, stickiness, breakers, and failover all
      work, but restarts are refused (nothing to respawn).

    ``specs=[...]`` (supervised) gives each initial slot its own spec
    — heterogeneous pools, and the chaos harness's per-slot fault
    plans via a spec-level ``"env"`` dict. The pool is elastic:
    :meth:`scale_up` / :meth:`scale_down` grow and drain-shrink it
    (serving/autoscaler.py drives them from metrics), and
    ``oom_fallback`` names the smaller-footprint spec a
    memdump-witnessed OOM death is replaced with.
    """

    def __init__(self, spec: Optional[dict] = None, replicas: int = 0,
                 endpoints: Optional[List[str]] = None,
                 workdir: Optional[str] = None,
                 specs: Optional[List[dict]] = None,
                 request_timeout_s: float = 120.0,
                 route_deadline_s: float = 30.0,
                 ready_timeout_s: float = 600.0,
                 drain_timeout_s: float = 60.0,
                 grace_s: float = 10.0,
                 restart_backoff_base_s: float = 0.25,
                 restart_backoff_max_s: float = 8.0,
                 crash_loop_window_s: float = 30.0,
                 crash_loop_limit: int = 5,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 sticky_capacity: int = 4096,
                 quarantine_cooldown_s: float = 30.0,
                 quarantine_backoff_max: float = 8.0,
                 healthy_reset_s: float = 30.0,
                 oom_fallback=None,
                 stats_poll_interval_s: float = 0.25):
        if endpoints is None and not specs \
                and (spec is None or replicas <= 0):
            raise ValueError("Router needs endpoints=[...], "
                             "specs=[...], or spec=... with replicas>=1")
        self._spec = spec if spec is not None \
            else (specs[0] if specs else None)
        self._workdir = workdir
        self._request_timeout = float(request_timeout_s)
        self._route_deadline = float(route_deadline_s)
        self._ready_timeout = float(ready_timeout_s)
        self._drain_timeout = float(drain_timeout_s)
        self._grace = float(grace_s)
        self._backoff_base = float(restart_backoff_base_s)
        self._backoff_max = float(restart_backoff_max_s)
        self._crash_window = float(crash_loop_window_s)
        self._crash_limit = int(crash_loop_limit)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset = float(breaker_reset_s)
        self._quarantine_cooldown = float(quarantine_cooldown_s)
        self._quarantine_backoff_max = float(quarantine_backoff_max)
        self._healthy_reset = float(healthy_reset_s)
        self._oom_fallback = oom_fallback
        self._stats_poll = float(stats_poll_interval_s)
        self._supervised = endpoints is None
        if self._supervised:
            slot_specs = list(specs) if specs else [spec] * replicas
            n = len(slot_specs)
        else:
            n = len(endpoints)
            slot_specs = [None] * n
        self._replicas = [
            _Replica(i, None if self._supervised else endpoints[i],
                     breaker_threshold=breaker_threshold,
                     breaker_reset_s=breaker_reset_s,
                     spec=slot_specs[i])
            for i in range(n)]
        self._by_index = {r.index: r for r in self._replicas}
        self._next_index = n
        self._pool_lock = lock_witness.make_lock("Router._pool_lock")
        self._sticky: "OrderedDict[str, int]" = OrderedDict()
        self._sticky_capacity = int(sticky_capacity)
        self._sticky_lock = lock_witness.make_lock("Router._sticky_lock")
        self._running = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._restart_lock = lock_witness.make_lock(
            "Router._restart_lock")
        self._rpc: Optional["_RouterRpcServer"] = None
        self._rpc_thread = None

    # -- pool supervision ------------------------------------------------
    def start(self):
        """Spawn (supervised mode) / probe (attached mode) the pool and
        start the monitor thread. Does NOT wait for readiness — use
        :meth:`wait_ready`."""
        if self._running:
            return self
        # __lint_suppress__: ccy-unlocked-shared-write -- start/stop run on the control thread; the monitor loop only READS this bool and tolerates one stale poll tick
        self._running = True
        if self._supervised:
            if self._workdir is None:
                import tempfile
                self._workdir = tempfile.mkdtemp(prefix="paddle-router-")
            os.makedirs(self._workdir, exist_ok=True)
            for r in self._replicas:
                self._spawn(r)
        else:
            for r in self._replicas:
                self._probe(r)
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="paddle-router-mon")
        self._monitor_thread.start()
        return self

    def _spawn(self, r: _Replica):
        """Start (or restart) the replica process for slot ``r``."""
        spec = r.spec if r.spec is not None else self._spec
        r.endpoint_file = os.path.join(
            self._workdir, f"replica{r.index}.endpoint")
        try:
            os.remove(r.endpoint_file)
        except OSError:
            pass
        env = dict(os.environ)
        env.setdefault("FLAGS_trace_role", "replica")
        # OOM-forensics rendezvous: every child gets a flight-recorder
        # dir, so a replica that dies of OOM leaves its
        # <role>.<pid>.memdump.json where _monitor_one can find it
        r.flight_dir = env.setdefault(
            "FLAGS_flight_recorder_dir",
            os.path.join(self._workdir, f"replica{r.index}-flight"))
        for k, v in (spec.get("env") or {}).items():
            env[k] = str(v)                # per-slot spec env wins
        r.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
             "--spec-json", json.dumps(spec),
             "--endpoint-file", r.endpoint_file,
             "--replica-id", str(r.index)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env)
        with r.lock:
            r.endpoint = None
            r.gen += 1
        r.set_state(STARTING)

    def _probe(self, r: _Replica, timeout: float = 1.0) -> Optional[dict]:
        """One-shot readyz probe on its own short-lived connection (the
        monitor thread must never block the routing path's sockets)."""
        if not r.endpoint:
            return None
        try:
            host, port = r.endpoint.rsplit(":", 1)
            with socket_module.create_connection(
                    (host, int(port)), timeout=timeout) as s:
                s.sendall(b'{"method": "readyz"}\n')
                f = s.makefile("rb")
                line = f.readline()
            resp = json.loads(line) if line else None
        except (ConnectionError, OSError, json.JSONDecodeError,
                ValueError):
            return None
        if resp and resp.get("ok"):
            return resp
        return None

    def _monitor(self):
        """The supervisor loop: readyz-gate STARTING replicas, detect
        deaths, restart with capped backoff, declare crash loops (and
        let them out of quarantine after the cooldown)."""
        while self._running:
            for r in list(self._replicas):
                try:
                    self._monitor_one(r)
                except Exception:
                    pass                   # the supervisor never dies
            time.sleep(0.05)

    def _find_memdump(self, r: _Replica, pid) -> Optional[str]:
        """The dead replica's ``<role>.<pid>.memdump.json`` (written by
        observability.memory.oom_dump on its way down), if any — the
        witness that classifies this death ``cause="oom"``."""
        if not r.flight_dir or pid is None \
                or not os.path.isdir(r.flight_dir):
            return None
        suffix = f".{pid}.memdump.json"
        try:
            names = os.listdir(r.flight_dir)
        except OSError:
            return None
        for n in sorted(names):
            if n.endswith(suffix):
                return os.path.join(r.flight_dir, n)
        return None

    def _monitor_one(self, r: _Replica):
        now = time.monotonic()
        if r.retiring:
            return                         # scale_down owns this slot
        if self._supervised:
            alive = r.proc is not None and r.proc.poll() is None
            if not alive and r.state not in (DOWN, FAILED):
                code = r.proc.poll() if r.proc is not None else None
                pid = r.proc.pid if r.proc is not None else None
                r.set_state(DOWN)
                with r.lock:
                    r.gen += 1             # poison cached sockets
                memdump = self._find_memdump(r, pid)
                if memdump and not r.oom_replaced:
                    # memdump-witnessed OOM: replace with the smaller-
                    # footprint fallback spec instead of re-entering the
                    # restart/quarantine loop — an OOM is deterministic
                    # under the same config, so respawning it unchanged
                    # can only crash-loop. One replacement per slot: a
                    # second OOM (the fallback itself too big) falls
                    # through to crash accounting below.
                    r.last_exit = {"code": code, "cause": "oom",
                                   "memdump": memdump}
                    flight_recorder.note("replica_oom", replica=r.index,
                                         code=code, memdump=memdump)
                    fb = self._oom_fallback
                    with r.lock:
                        if fb is not None:
                            base = (r.spec if r.spec is not None
                                    else self._spec)
                            r.spec = (fb(base) if callable(fb)
                                      else dict(fb))
                        r.oom_replaced = True
                        r.restart_times.clear()  # not crash-loop evidence
                        r.backoff_s = 0.0
                    self._sticky_clear_replica(r.index)
                    smetrics.ROUTER_RESTARTS.labels(cause="oom").inc()
                    self._spawn(r)
                    return
                cause = "oom" if memdump else "crash"
                r.last_exit = {"code": code, "cause": cause,
                               "memdump": memdump}
                flight_recorder.note("replica_down",
                                     replica=r.index, code=code)
                if memdump:
                    smetrics.ROUTER_RESTARTS.labels(cause="oom").inc()
                # crash-loop detection over the restart window
                r.restart_times.append(now)
                recent = [t for t in r.restart_times
                          if now - t <= self._crash_window]
                if len(recent) >= self._crash_limit:
                    r.set_state(FAILED)
                    with r.lock:
                        r.failed_at = now
                        r.quarantines += 1
                    flight_recorder.note("replica_crash_loop",
                                         replica=r.index,
                                         restarts=len(recent),
                                         quarantines=r.quarantines)
                    return
                with r.lock:
                    r.backoff_s = min(self._backoff_max,
                                      max(self._backoff_base,
                                          r.backoff_s * 2.0))
                    r.restart_at = now + r.backoff_s
                return
            if r.state == FAILED:
                # quarantine is a COOLDOWN, not a verdict: after a
                # backed-off wait the slot gets another chance — a
                # transient cause (bad node, upstream outage) should not
                # cost the fleet a slot forever. Repeat offenders wait
                # exponentially longer.
                if self._quarantine_cooldown > 0:
                    wait = self._quarantine_cooldown * min(
                        self._quarantine_backoff_max,
                        2.0 ** max(0, r.quarantines - 1))
                    if now - r.failed_at >= wait:
                        with r.lock:
                            r.restart_times.clear()
                            r.backoff_s = 0.0
                        smetrics.ROUTER_RESTARTS.labels(
                            cause="quarantine_retry").inc()
                        flight_recorder.note("replica_quarantine_retry",
                                             replica=r.index,
                                             quarantines=r.quarantines)
                        self._spawn(r)
                return
            if r.state == DOWN:
                if now >= r.restart_at:
                    smetrics.ROUTER_RESTARTS.labels(cause="crash").inc()
                    self._spawn(r)
                return
            if r.state == STARTING and alive:
                if r.endpoint is None and r.endpoint_file \
                        and os.path.exists(r.endpoint_file):
                    with open(r.endpoint_file) as f:
                        ep = f.read().strip()
                    if ep:
                        with r.lock:
                            r.endpoint = ep
                            r.gen += 1
                if r.endpoint:
                    resp = self._probe(r)
                    if resp and resp.get("ready"):
                        with r.lock:
                            r.backoff_s = 0.0
                        r.breaker.record_success()
                        r.set_state(READY)
                        flight_recorder.note("replica_ready",
                                             replica=r.index,
                                             endpoint=r.endpoint)
                return
            if r.state in (READY, DRAINING):
                self._healthy_check(r, now)
                self._poll_replica_stats(r, now)
        else:
            resp = self._probe(r)
            if resp is None:
                if r.state == READY:
                    r.set_state(DOWN)
            elif resp.get("ready") and r.state != READY:
                r.breaker.record_success()
                r.set_state(READY)
            elif resp.get("draining") and r.state == READY:
                r.set_state(DRAINING)
            if r.state in (READY, DRAINING):
                self._poll_replica_stats(r, now)

    def _healthy_check(self, r: _Replica, now: float):
        """A sustained healthy period wipes the restart ledger: old
        crashes stop counting toward the next crash-loop verdict and
        the quarantine backoff resets."""
        if self._healthy_reset <= 0 or r.state != READY \
                or not r.ready_since:
            return
        if now - r.ready_since < self._healthy_reset:
            return
        if r.restart_times or r.quarantines or r.backoff_s:
            with r.lock:
                r.restart_times.clear()
                r.backoff_s = 0.0
                r.quarantines = 0
            flight_recorder.note("replica_healthy_reset",
                                 replica=r.index)

    def _poll_replica_stats(self, r: _Replica, now: float):
        """Throttled ``stats`` RPC on a short-lived connection: the
        per-replica queue-depth/inflight gauges the autoscaler (and a
        scrape) reads — metrics snapshots, never object internals."""
        if self._stats_poll <= 0 or now - r._stats_at < self._stats_poll:
            return
        r._stats_at = now
        if not r.endpoint:
            return
        try:
            host, port = r.endpoint.rsplit(":", 1)
            with socket_module.create_connection(
                    (host, int(port)), timeout=1.0) as s:
                s.sendall(b'{"method": "stats"}\n')
                line = s.makefile("rb").readline()
            resp = json.loads(line) if line else None
        except (ConnectionError, OSError, json.JSONDecodeError,
                ValueError):
            return
        if not (resp and resp.get("ok")):
            return
        depth = sum(int(m.get("queue_depth", 0))
                    for m in (resp.get("stats") or {}).values())
        r.queue_depth = depth
        lbl = str(r.index)
        smetrics.ROUTER_REPLICA_QUEUE_DEPTH.labels(
            replica=lbl).set(float(depth))
        smetrics.ROUTER_REPLICA_INFLIGHT.labels(
            replica=lbl).set(float(r.inflight))

    def wait_ready(self, min_ready: Optional[int] = None,
                   timeout_s: Optional[float] = None) -> bool:
        """Block until ``min_ready`` replicas (default: all non-failed)
        pass readyz."""
        deadline = time.monotonic() + (
            self._ready_timeout if timeout_s is None else timeout_s)
        while time.monotonic() < deadline:
            states = [r.state for r in list(self._replicas)]
            need = (len([s for s in states if s != FAILED])
                    if min_ready is None else min_ready)
            if need > 0 and \
                    len([s for s in states if s == READY]) >= need:
                return True
            if need == 0:
                return False               # the whole pool crash-looped
            time.sleep(0.05)
        return False

    # -- routing ---------------------------------------------------------
    def _sticky_get(self, req_id: Optional[str]) -> Optional[int]:
        if not req_id:
            return None
        with self._sticky_lock:
            idx = self._sticky.get(req_id)
            if idx is not None:
                # LRU refresh: an id still being routed (client retries,
                # failover re-dispatch) must outlive newer one-shot ids,
                # or eviction silently un-sticks an active request
                self._sticky.move_to_end(req_id)
            return idx

    def _sticky_set(self, req_id: Optional[str], index: int):
        if not req_id:
            return
        with self._sticky_lock:
            self._sticky[req_id] = index
            self._sticky.move_to_end(req_id)
            while len(self._sticky) > self._sticky_capacity:
                self._sticky.popitem(last=False)

    def _sticky_clear_replica(self, index: int):
        with self._sticky_lock:
            for rid in [k for k, v in self._sticky.items()
                        if v == index]:
                del self._sticky[rid]

    def _pick(self, req_id: Optional[str],
              exclude: set) -> Optional[_Replica]:
        """Sticky target if it can still answer (READY, or DRAINING —
        a draining replica still dedups admitted request_ids); else the
        least-inflight READY replica, recorded as the new sticky
        assignment."""
        idx = self._sticky_get(req_id)
        if idx is not None and idx not in exclude:
            r = self._by_index.get(idx)
            if r is not None and r.state in (READY, DRAINING):
                return r
            smetrics.ROUTER_FAILOVERS.labels(cause="dead_sticky").inc()
            flight_recorder.note("failover", request_id=req_id,
                                 cause="dead_sticky", replica=idx)
        pool = list(self._replicas)
        candidates = [r for r in pool
                      if r.state == READY and r.index not in exclude
                      and r.breaker.allow()]
        if not candidates:
            # half-open probes excluded above; allow a breaker-gated
            # READY replica as last resort so the probe can happen
            candidates = [r for r in pool
                          if r.state == READY
                          and r.index not in exclude]
        if not candidates:
            return None
        r = min(candidates, key=lambda c: c.inflight)
        self._sticky_set(req_id, r.index)
        return r

    def route(self, req: dict) -> dict:
        """The failover loop: pick → forward → on wire error / open
        breaker / draining reply, re-dispatch the SAME request_id to
        another replica until the route deadline."""
        req_id = req.get("req_id")
        deadline = time.monotonic() + self._route_deadline
        exclude: set = set()
        last_err = "no replica available"
        with tctx.span("router.route",
                       method=str(req.get("method")),
                       request_id=str(req_id)):
            payload = dict(req)
            tctx.inject(payload)           # replica parents under us
            while time.monotonic() < deadline:
                r = self._pick(req_id, exclude)
                if r is None:
                    if exclude:
                        exclude.clear()    # full cycle: retry everyone
                    time.sleep(0.02)
                    continue
                try:
                    with r.lock:
                        r.inflight += 1
                    try:
                        resp = r.breaker.call(
                            lambda: r.exchange(payload,
                                               self._request_timeout))
                    finally:
                        with r.lock:
                            r.inflight -= 1
                except CircuitOpenError as e:
                    last_err = repr(e)
                    self._failover(req_id, r, "breaker_open")
                    exclude.add(r.index)
                    continue
                except (ConnectionError, OSError,
                        json.JSONDecodeError) as e:
                    last_err = repr(e)
                    self._failover(req_id, r, "conn_error")
                    exclude.add(r.index)
                    continue
                if not resp.get("ok") and \
                        resp.get("kind") == "draining":
                    # the drain gate sits AFTER the dedup checks, so a
                    # draining reply proves this request_id was never
                    # admitted there — re-dispatching is safe
                    last_err = "replica draining"
                    self._failover(req_id, r, "draining")
                    exclude.add(r.index)
                    continue
                smetrics.ROUTER_REQUESTS.labels(
                    outcome="ok" if resp.get("ok")
                    else "typed_error").inc()
                # which pool slot answered: ops can correlate a reply
                # with `router_stats` / the chaos harness knows whom
                # to kill to exercise the sticky path
                resp.setdefault("routed_replica", r.index)
                return resp
        smetrics.ROUTER_REQUESTS.labels(outcome="unavailable").inc()
        return {"ok": False, "kind": "unavailable",
                "error": f"no replica answered within "
                         f"{self._route_deadline:.1f}s "
                         f"(last: {last_err})"}

    def _failover(self, req_id, r: _Replica, cause: str):
        smetrics.ROUTER_FAILOVERS.labels(cause=cause).inc()
        flight_recorder.note("failover", request_id=req_id,
                             cause=cause, replica=r.index)
        with self._sticky_lock:
            if self._sticky.get(req_id) == r.index:
                del self._sticky[req_id]

    # -- drain / rolling restart -----------------------------------------
    def restart_replica(self, index: int, cause: str = "rolling",
                        spec: Optional[dict] = None) -> dict:
        """Drain + replace ONE replica: refuse unless another replica is
        READY (zero-downtime invariant), drain RPC (SIGTERM fallback),
        wait for a clean exit (SIGKILL after the grace window), respawn,
        wait for readyz. ``spec`` swaps the slot's config on the way
        back up (the autoscaler's proactive-replace path). Returns a
        summary dict."""
        if not self._supervised:
            return {"ok": False, "kind": "bad_request",
                    "error": "attached mode: the router does not own "
                             "these processes"}
        r = self._by_index.get(int(index))
        if r is None:
            return {"ok": False, "kind": "bad_request",
                    "error": f"no replica {index} in the pool"}
        with self._restart_lock:
            others_ready = any(o.state == READY for o in self._replicas
                               if o.index != index)
            if not others_ready:
                return {"ok": False, "kind": "unavailable",
                        "error": f"refusing to restart replica {index}: "
                                 f"no other replica is ready"}
            r.set_state(DRAINING)
            t0 = time.monotonic()
            drained = False
            duration = 0.0
            try:
                # __lint_suppress__: ccy-blocking-under-lock -- _restart_lock exists to serialize whole drain+respawn sequences; it is never taken on the request path
                resp = r.exchange({"method": "drain",
                                   "timeout_s": self._drain_timeout,
                                   "exit": True},
                                  timeout=self._drain_timeout + 5.0)
                drained = bool(resp.get("drained"))
                duration = float(resp.get("duration_s", 0.0))
            except (ConnectionError, OSError, json.JSONDecodeError):
                # no drain reply: fall back to SIGTERM (the replica's
                # handler drains before exiting)
                if r.proc is not None and r.proc.poll() is None:
                    r.proc.terminate()
            smetrics.ROUTER_DRAIN_DURATION.observe(
                duration if duration > 0
                else time.monotonic() - t0)
            if r.proc is not None:
                try:
                    # __lint_suppress__: ccy-blocking-under-lock -- bounded-by-grace wait inside the serialized restart sequence, off the request path
                    r.proc.wait(timeout=self._grace)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    # __lint_suppress__: ccy-blocking-under-lock -- post-kill reap, bounded by grace; restart sequence is serialized by design
                    r.proc.wait(timeout=self._grace)
            self._sticky_clear_replica(index)
            with r.lock:
                r.gen += 1
            r.restart_times.clear()        # an ORDERED restart is not
            r.backoff_s = 0.0              # crash-loop evidence
            if spec is not None:
                r.spec = spec
                r.oom_replaced = False     # fresh config, fresh budget
            smetrics.ROUTER_RESTARTS.labels(cause=cause).inc()
            flight_recorder.note("replica_restart", replica=index,
                                 cause=cause, drained=drained)
            self._spawn(r)
            deadline = time.monotonic() + self._ready_timeout
            while time.monotonic() < deadline:
                if r.state == READY:
                    return {"ok": True, "replica": index,
                            "drained": drained,
                            "drain_duration_s": duration,
                            "ready_after_s": round(
                                time.monotonic() - t0, 3)}
                if r.state == FAILED:
                    break
                # __lint_suppress__: ccy-blocking-under-lock -- readiness poll of the restart sequence itself; holding _restart_lock here IS the serialization contract
                time.sleep(0.05)
            return {"ok": False, "kind": "error", "replica": index,
                    "error": f"replica {index} did not pass readyz "
                             f"after restart"}

    def rolling_restart(self) -> dict:
        """Drain + replace every replica, one at a time, under live
        load — each slot is only restarted once its predecessor is
        READY again."""
        results = []
        for r in list(self._replicas):
            out = self.restart_replica(r.index, cause="rolling")
            results.append(out)
            if not out.get("ok"):
                return {"ok": False, "kind": "error",
                        "results": results,
                        "error": f"rolling restart stopped at replica "
                                 f"{r.index}"}
        return {"ok": True, "results": results}

    # -- elastic pool (serving/autoscaler.py drives these) ---------------
    def set_oom_fallback(self, spec):
        """Register the smaller-footprint spec (or ``callable(old_spec)
        -> new_spec``) a memdump-witnessed OOM death is replaced with."""
        self._oom_fallback = spec

    def scale_up(self, count: int = 1, spec: Optional[dict] = None,
                 endpoints: Optional[List[str]] = None) -> dict:
        """Grow the pool. Supervised: spawn ``count`` fresh replicas
        (``spec`` overrides the slot template). Attached: adopt the
        given ``endpoints``. Slot indexes are monotonic — never reused
        — so sticky entries and per-replica metric labels stay
        unambiguous across scale events."""
        added = []
        with self._pool_lock:
            if self._supervised:
                for _ in range(max(1, int(count))):
                    r = _Replica(
                        self._next_index,
                        breaker_threshold=self._breaker_threshold,
                        breaker_reset_s=self._breaker_reset,
                        spec=spec if spec is not None else self._spec)
                    self._next_index += 1
                    self._by_index[r.index] = r
                    self._replicas.append(r)
                    if self._running:
                        self._spawn(r)
                    added.append(r.index)
            else:
                if not endpoints:
                    return {"ok": False, "kind": "bad_request",
                            "error": "attached mode: scale_up needs "
                                     "endpoints=[...] to adopt"}
                for ep in endpoints:
                    r = _Replica(
                        self._next_index, endpoint=ep,
                        breaker_threshold=self._breaker_threshold,
                        breaker_reset_s=self._breaker_reset)
                    self._next_index += 1
                    self._by_index[r.index] = r
                    self._replicas.append(r)
                    added.append(r.index)
        flight_recorder.note("fleet_scale_up", replicas=added,
                             size=len(self._replicas))
        return {"ok": True, "added": added,
                "size": len(self._replicas)}

    def scale_down(self, index: Optional[int] = None) -> dict:
        """Shrink the pool by ONE replica via graceful drain — the
        rolling-restart-proven path. Victim: ``index``, else the
        highest-index READY replica (LIFO, so the static floor keeps
        its original slots). Refuses to remove the last READY replica.
        Sticky entries pointing at the victim are cleared AFTER the
        drain settles, so admitted request_ids keep deduping on it
        until the end. Works in attached mode too (the external server
        is drained but not exited — decommission, not kill)."""
        with self._restart_lock:
            with self._pool_lock:
                if index is None:
                    ready = [r for r in self._replicas
                             if r.state == READY]
                    victim = (max(ready, key=lambda r: r.index)
                              if ready else None)
                    if victim is None:
                        return {"ok": False, "kind": "unavailable",
                                "error": "no ready replica to remove"}
                else:
                    victim = self._by_index.get(int(index))
                    if victim is None:
                        return {"ok": False, "kind": "bad_request",
                                "error": f"no replica {index} in "
                                         f"the pool"}
                others_ready = any(
                    o.state == READY for o in self._replicas
                    if o.index != victim.index)
                if not others_ready:
                    return {"ok": False, "kind": "unavailable",
                            "error": f"refusing to remove replica "
                                     f"{victim.index}: no other "
                                     f"replica is ready"}
                victim.retiring = True     # the monitor hands it over
            t0 = time.monotonic()
            victim.set_state(DRAINING)
            drained = False
            duration = 0.0
            try:
                # __lint_suppress__: ccy-blocking-under-lock -- scale_down shares _restart_lock with restart_replica to serialize topology changes; never on the request path
                resp = victim.exchange(
                    {"method": "drain",
                     "timeout_s": self._drain_timeout,
                     "exit": self._supervised},
                    timeout=self._drain_timeout + 5.0)
                drained = bool(resp.get("drained"))
                duration = float(resp.get("duration_s", 0.0))
            except (ConnectionError, OSError, json.JSONDecodeError):
                if self._supervised and victim.proc is not None \
                        and victim.proc.poll() is None:
                    victim.proc.terminate()
            smetrics.ROUTER_DRAIN_DURATION.observe(
                duration if duration > 0 else time.monotonic() - t0)
            if self._supervised and victim.proc is not None:
                try:
                    # __lint_suppress__: ccy-blocking-under-lock -- bounded-by-grace reap inside the serialized scale-down sequence
                    victim.proc.wait(timeout=self._grace)
                except subprocess.TimeoutExpired:
                    victim.proc.kill()
                    try:
                        # __lint_suppress__: ccy-blocking-under-lock -- post-kill reap, bounded by grace; topology changes are serialized by design
                        victim.proc.wait(timeout=self._grace)
                    except subprocess.TimeoutExpired:
                        pass
            self._sticky_clear_replica(victim.index)
            victim.close_cached()
            with self._pool_lock:
                self._replicas = [r for r in self._replicas
                                  if r.index != victim.index]
                self._by_index.pop(victim.index, None)
            victim.retire_gauges()
            flight_recorder.note("fleet_scale_down",
                                 replica=victim.index, drained=drained,
                                 size=len(self._replicas))
            return {"ok": True, "removed": victim.index,
                    "drained": drained, "drain_duration_s": duration,
                    "size": len(self._replicas)}

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        pool = list(self._replicas)
        reps = []
        for r in pool:
            reps.append({
                "index": r.index, "state": r.state,
                "endpoint": r.endpoint, "inflight": r.inflight,
                "queue_depth": r.queue_depth,
                "breaker": r.breaker.state,
                "pid": (r.proc.pid if r.proc is not None
                        and r.proc.poll() is None else None),
                "restarts": len(r.restart_times),
                "quarantines": r.quarantines,
                "last_exit": r.last_exit})
        with self._sticky_lock:
            sticky = len(self._sticky)
        return {"supervised": self._supervised, "replicas": reps,
                "sticky_entries": sticky,
                "size": len(pool),
                "ready": sum(1 for r in pool if r.state == READY)}

    @property
    def ready(self) -> bool:
        return any(r.state == READY for r in self._replicas)

    # -- RPC front end ---------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Bind the router's JSON/TCP front end; clients speak to it
        exactly as to a bare ModelServer."""
        self._rpc = _RouterRpcServer((host, port), _RouterRpcHandler)
        self._rpc.router = self            # type: ignore[attr-defined]
        self._rpc_thread = threading.Thread(
            target=self._rpc.serve_forever,
            kwargs={"poll_interval": 0.05}, daemon=True,
            name="paddle-router-rpc")
        self._rpc_thread.start()
        host, port = self._rpc.server_address[:2]
        return f"{host}:{port}"

    @property
    def endpoint(self) -> Optional[str]:
        if self._rpc is None:
            return None
        host, port = self._rpc.server_address[:2]
        return f"{host}:{port}"

    def stop(self, terminate_replicas: bool = True):
        # __lint_suppress__: ccy-unlocked-shared-write -- shutdown flag flip; the monitor loop reads it unlocked and exits within one poll tick
        self._running = False
        if self._rpc is not None:
            self._rpc.shutdown()
            self._rpc.server_close()
            if self._rpc_thread is not None:
                self._rpc_thread.join(timeout=5)
            self._rpc = None
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
            self._monitor_thread = None
        if self._supervised and terminate_replicas:
            for r in list(self._replicas):
                if r.proc is not None and r.proc.poll() is None:
                    r.proc.terminate()
            deadline = time.monotonic() + self._grace
            for r in list(self._replicas):
                if r.proc is None:
                    continue
                remaining = max(0.1, deadline - time.monotonic())
                try:
                    r.proc.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    try:
                        r.proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass
        for r in self._replicas:
            r.close_cached()


class _RouterRpcServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _RouterRpcHandler(socketserver.StreamRequestHandler):
    """Same line protocol as serving/server.py's handler. Router admin
    methods (``router_*``), ``ping`` and ``readyz`` answer locally;
    everything else rides the failover loop."""

    def handle(self):
        router: Router = self.server.router  # type: ignore[attr-defined]
        while True:
            try:
                line = self.rfile.readline()
            except (ConnectionError, OSError):
                return
            if not line:
                return
            try:
                req = json.loads(line)
                ctx = tctx.extract(req)
                with tctx.activate(ctx if ctx is not None
                                   else tctx.current()):
                    resp = self._dispatch(router, req)
            except Exception as e:
                resp = {"ok": False, "kind": "error",
                        "error": f"{type(e).__name__}: {e}"}
            try:
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
            except (ConnectionError, OSError, BrokenPipeError):
                return

    def _dispatch(self, router: Router, req: dict) -> dict:
        method = req.get("method")
        if method == "ping":
            return {"ok": True, "pong": True, "role": "router"}
        if method == "readyz":
            return {"ok": True, "ready": router.ready,
                    "role": "router", "pid": os.getpid(),
                    "replicas": [r.state
                                 for r in list(router._replicas)]}
        if method == "router_stats":
            return {"ok": True, "stats": router.stats()}
        if method == "router_restart":
            return router.restart_replica(int(req["replica"]))
        if method == "router_rolling_restart":
            return router.rolling_restart()
        if method == "router_scale_up":
            return router.scale_up(count=int(req.get("count", 1)),
                                   spec=req.get("spec"),
                                   endpoints=req.get("endpoints"))
        if method == "router_scale_down":
            idx = req.get("replica")
            return router.scale_down(
                index=None if idx is None else int(idx))
        if method == "router_replace":
            return router.restart_replica(
                int(req["replica"]),
                cause=str(req.get("cause", "replace")),
                spec=req.get("spec"))
        return router.route(req)


def main(argv=None) -> int:
    import argparse
    from paddle_tpu_torch import flags
    ap = argparse.ArgumentParser(
        description="health-checked router over ModelServer replicas")
    ap.add_argument("--spec", default=None,
                    help="replica spec JSON file (supervised mode)")
    ap.add_argument("--spec-json", default=None,
                    help="the spec inline (wins over --spec)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated replica endpoints "
                         "(attached mode; disables supervision)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="endpoint-file rendezvous dir "
                         "(default: a fresh tempdir)")
    ap.add_argument("--endpoint-file", default=None,
                    help="atomically write the ROUTER endpoint here")
    args = ap.parse_args(argv)

    if not flags.get("trace_role"):
        flags.set("trace_role", "router")

    spec = None
    if args.spec_json:
        spec = json.loads(args.spec_json)
    elif args.spec:
        with open(args.spec) as f:
            spec = json.load(f)
    endpoints = (args.endpoints.split(",") if args.endpoints else None)

    router = Router(spec=spec, replicas=args.replicas,
                    endpoints=endpoints, workdir=args.workdir)
    router.start()
    endpoint = router.serve(host=args.host, port=args.port)
    # mirror the wire readyz on the HTTP scrape endpoint (when
    # FLAGS_metrics_port enables one): ready while ANY replica is —
    # the same truth the wire answers
    from paddle_tpu_torch.observability import exporters
    exporters.set_ready_probe(lambda: router.ready)
    exporters.ensure_started()
    if args.endpoint_file:
        tmp = args.endpoint_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(endpoint)
        os.replace(tmp, args.endpoint_file)

    stop = threading.Event()

    def _leave(signum, frame):
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _leave)
        except ValueError:
            pass
    router.wait_ready(min_ready=1)
    print(f"READY {endpoint}", flush=True)
    stop.wait()
    router.stop()
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.observability import spool
    spool.shutdown()
    fr.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
