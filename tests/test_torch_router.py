"""The PyTorch port's router (``paddle_tpu_torch/serving/router.py``),
fast tier: the port's counterparts of every case of tests/test_router.py
-- attached-mode routing over in-process port ``ModelServer``s
(stickiness, failover, draining, breaker gating, zero-downtime
refusals), the replica lifecycle protocol (readyz vs healthz, the drain
RPC) and the client's resilience satellites (typed replies are
Unretryable; the default breaker is keyed per endpoint) -- and the one
wire both ways: the JAX ``ServingClient`` through the port's router,
and the JAX router attached to port servers.

Everything here runs against BARE servers (no model is loaded), as the
reference's file does; the spawned replicas are tests/test_torch_replica.py's,
the chaos scenarios (SIGKILL under load, rolling restart, the merged
trace) ``chip_smoke.py`` phase 21's. The router families are
process-wide: counts are read as deltas.
"""

import json
import socket
import threading
import time

import pytest

from paddle_tpu.serving import client as jcli
from paddle_tpu.serving import router as jrouter

from paddle_tpu_torch.distributed.resilience import (CircuitBreaker,
                                                     RetryPolicy)
from paddle_tpu_torch.serving import client as sclient
from paddle_tpu_torch.serving import metrics as smetrics
from paddle_tpu_torch.serving.client import ServingClient
from paddle_tpu_torch.serving.router import Router
from paddle_tpu_torch.serving.server import (ModelServer,
                                             RequestCancelledError,
                                             RequestShedError)


def _call(endpoint, req, timeout=5.0):
    host, port = endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        line = s.makefile("rb").readline()
    assert line, f"{endpoint} closed the connection"
    return json.loads(line)


def _wait(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def _attached_pair(router_cls=Router, **router_kw):
    a, b = ModelServer(), ModelServer()
    ea, eb = a.serve(), b.serve()
    router = router_cls(endpoints=[ea, eb], **router_kw)
    router.start()
    router.wait_ready(timeout_s=10)
    return a, b, router


# -- replica lifecycle protocol (readyz / drain over the wire) -----------

def test_readyz_distinct_from_healthz():
    """:57 -- readyz is the ROUTING gate: false while serving during
    warmup, true after mark_ready, false again while draining."""
    srv = ModelServer()
    ep = srv.serve(ready=False)           # the replica startup shape
    try:
        assert _call(ep, {"method": "ping"}).get("pong")      # alive
        rz = _call(ep, {"method": "readyz"})
        assert rz["ok"] and rz["ready"] is False
        srv.mark_ready()
        assert _call(ep, {"method": "readyz"})["ready"] is True
        srv.begin_drain()
        rz = _call(ep, {"method": "readyz"})
        assert rz["ready"] is False and rz["draining"] is True
    finally:
        srv.stop()


def test_drain_rpc_settles_and_requests_exit():
    """:77 -- the drain RPC reports drained + duration, and (exit=True)
    asks the process loop to exit AFTER the reply is written."""
    srv = ModelServer()
    ep = srv.serve()
    try:
        resp = _call(ep, {"method": "drain", "timeout_s": 5.0,
                          "exit": False})
        assert resp["ok"] and resp["drained"] is True
        assert resp["duration_s"] >= 0.0
        assert not srv.wait_exit(timeout=0.05), "exit=False must not exit"
        resp = _call(ep, {"method": "drain", "timeout_s": 5.0})
        assert resp["ok"] and resp["drained"] is True
        assert srv.wait_exit(timeout=5.0), "exit=True requests exit"
    finally:
        srv.stop()


# -- attached-mode routing ----------------------------------------------

def test_sticky_routing_keeps_request_id_on_one_replica():
    a, b, router = _attached_pair()
    try:
        r1 = router.route({"method": "models", "req_id": "req-1"})
        assert r1["ok"]
        first = r1["routed_replica"]
        for _ in range(5):
            r = router.route({"method": "models", "req_id": "req-1"})
            assert r["ok"] and r["routed_replica"] == first, \
                "same request id must stay on its replica (dedup cache)"
        assert router.stats()["sticky_entries"] >= 1
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_failover_redispatches_same_request_id_to_survivor():
    """Kill the sticky replica: the SAME request id must complete on the
    survivor, with the failover accounted by cause."""
    a, b, router = _attached_pair()
    servers = {0: a, 1: b}
    fail0 = sum(c.value for c in
                smetrics.ROUTER_FAILOVERS.children().values())
    try:
        r1 = router.route({"method": "models", "req_id": "req-f"})
        assert r1["ok"]
        victim = r1["routed_replica"]
        servers.pop(victim).stop()         # replica death
        # in-process stop() leaves established handler connections
        # briefly alive: wait for the health probe's verdict
        _wait(lambda: router.stats()["replicas"][victim]["state"]
              == "down", msg="monitor to mark the dead replica down")
        r2 = router.route({"method": "models", "req_id": "req-f"})
        assert r2["ok"], r2
        assert r2["routed_replica"] != victim
        fail1 = sum(c.value for c in
                    smetrics.ROUTER_FAILOVERS.children().values())
        assert fail1 - fail0 >= 1, "failover must be counted"
    finally:
        router.stop(terminate_replicas=False)
        for s in servers.values():
            s.stop()


def test_draining_replica_stops_receiving_new_requests():
    a, b, router = _attached_pair()
    try:
        a.begin_drain()
        _wait(lambda: router.stats()["replicas"][0]["state"] == "draining",
              msg="monitor to see the draining readyz")
        for i in range(4):
            r = router.route({"method": "models", "req_id": f"new-{i}"})
            assert r["ok"] and r["routed_replica"] == 1, r
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_all_replicas_down_is_typed_unavailable():
    a, b, router = _attached_pair(route_deadline_s=0.4)
    try:
        a.stop()
        b.stop()
        _wait(lambda: router.stats()["ready"] == 0,
              msg="monitor to see both replicas down")
        r = router.route({"method": "models", "req_id": "doomed"})
        assert not r["ok"] and r["kind"] == "unavailable", r
    finally:
        router.stop(terminate_replicas=False)


def test_attached_mode_refuses_restarts():
    a, b, router = _attached_pair()
    try:
        r = router.restart_replica(0)
        assert not r["ok"], r
        r = router.rolling_restart()
        assert not r["ok"], r
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_router_front_end_speaks_the_serving_protocol():
    a, b, router = _attached_pair()
    ep = router.serve()
    cl = ServingClient(ep)
    try:
        assert cl.ping()
        assert cl.models() == []
        rz = _call(ep, {"method": "readyz"})
        assert rz["ok"] and rz["role"] == "router" and rz["ready"]
        st = _call(ep, {"method": "router_stats"})["stats"]
        assert len(st["replicas"]) == 2 and st["supervised"] is False
    finally:
        cl.close()
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


# -- the wire both ways ---------------------------------------------------

def test_jax_client_through_the_port_router():
    """The JAX package's ``ServingClient`` pointed at the port's router
    is none the wiser: ping, models, stats, and a sticky request id."""
    a, b, router = _attached_pair()
    ep = router.serve()
    cl = jcli.ServingClient(ep)
    try:
        assert cl.ping()
        assert cl.models() == []
        assert isinstance(cl.stats(), dict)
        r1 = router.route({"method": "models", "req_id": "x-1"})
        r2 = _call(ep, {"method": "models", "req_id": "x-1"})
        assert r1["ok"] and r2["ok"]
        assert r2["routed_replica"] == r1["routed_replica"]
    finally:
        cl.close()
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_jax_router_attached_to_port_servers():
    """The JAX package's router fronts port ``ModelServer``s: readyz
    gating, sticky routing, draining and failover over the port's
    wire."""
    a, b, router = _attached_pair(router_cls=jrouter.Router)
    try:
        assert router.stats()["ready"] == 2
        r1 = router.route({"method": "models", "req_id": "j-1"})
        assert r1["ok"] and r1["models"] == []
        victim = r1["routed_replica"]
        (a, b)[victim].begin_drain()
        _wait(lambda: router.stats()["replicas"][victim]["state"]
              == "draining", msg="the JAX monitor to see the port drain")
        r2 = router.route({"method": "models", "req_id": "j-2"})
        assert r2["ok"] and r2["routed_replica"] != victim, r2
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


# -- client resilience satellites ---------------------------------------

def _canned_server(reply: dict):
    """A one-trick wire server: every request gets ``reply``; returns
    (endpoint, hit counter, closer)."""
    hits = [0]
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    host, port = lsock.getsockname()
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            with conn:
                f = conn.makefile("rb")
                while True:
                    line = f.readline()
                    if not line:
                        break
                    hits[0] += 1
                    conn.sendall((json.dumps(reply) + "\n").encode())

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def close():
        stop.set()
        lsock.close()

    return f"{host}:{port}", hits, close


@pytest.mark.parametrize("kind,exc", [
    ("cancelled", RequestCancelledError),
    ("shed", RequestShedError),
    ("draining", RequestShedError),
])
def test_typed_replies_are_unretryable(kind, exc):
    """A typed rejection is an ANSWER: even under a caller-widened
    retryable tuple the client raises after exactly one attempt."""
    ep, hits, close = _canned_server(
        {"ok": False, "kind": kind, "error": f"typed {kind}"})
    try:
        cl = ServingClient(
            ep,
            retry_policy=RetryPolicy(
                max_attempts=6, base_delay_s=0.001, max_delay_s=0.002,
                deadline_s=5.0,
                retryable=(Exception,)),         # maximally widened
            breaker=CircuitBreaker(failure_threshold=100,
                                   reset_timeout_s=0.1))
        with pytest.raises(exc):
            cl.stats()
        assert hits[0] == 1, \
            f"typed {kind!r} reply must not be retried (hits={hits[0]})"
        cl.close()
    finally:
        close()


def test_client_breaker_is_keyed_per_endpoint():
    b1 = sclient._breaker_for("10.0.0.1:7001")
    b2 = sclient._breaker_for("10.0.0.1:7001")
    b3 = sclient._breaker_for("10.0.0.2:7001")
    assert b1 is b2
    assert b1 is not b3
    for _ in range(b1.failure_threshold):
        b1.record_failure()
    assert not b1.allow(), "threshold failures open the breaker"
    assert b3.allow(), "a different endpoint's breaker stays closed"
