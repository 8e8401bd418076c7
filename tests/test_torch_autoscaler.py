"""The PyTorch port's autoscaler (``paddle_tpu_torch/serving/autoscaler.py``)
and the router's supervisor, fast tier: the port's counterparts of every
case of tests/test_autoscaler.py except ``test_kube_gen_job_serving_mode``
(it loads ``tools/kube_gen_job.py``, a tool of the JAX side) -- the
control law (hysteresis + cooldown, never flaps) driven deterministically
through ``Autoscaler.step(now=...)`` against fake fleets; the windowed
queue-wait p99 source (restart-proof delta clamping); bin-packing that
REFUSES over-budget placements from MEM_r01-style footprints; the
supervisor's quarantine cooldown / healthy reset and memdump-witnessed
OOM-replace classification (fake processes, no spawning); scale-down
edge cases over attached in-process port ``ModelServer``s; and the kube
rendering of the desired state, which asks for the card.

Nothing here builds a model or spawns a replica (tests/test_torch_replica.py
does). The router and autoscaler families are process-wide: the cases
read them as deltas or after their own step.
"""

import json
import time

import pytest

from paddle_tpu_torch import flags
from paddle_tpu_torch.serving import metrics as smetrics
from paddle_tpu_torch.serving.autoscaler import (Autoscaler,
                                                 AutoscalePolicy,
                                                 PlacementError,
                                                 RouterSource, bin_pack,
                                                 peak_bytes_of,
                                                 plan_placement,
                                                 render_kube,
                                                 validate_host)
from paddle_tpu_torch.serving.router import (_STATES, DOWN, FAILED, READY,
                                             STARTING, Router)
from paddle_tpu_torch.serving.server import ModelServer

def _wait(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


# -- control-law fakes ----------------------------------------------------

class _FakeRouter:
    """Counts scale actions; size/ready track them like a real pool."""

    def __init__(self, size=2):
        self.size = size
        self.ready = size
        self.ups = 0
        self.downs = 0
        self.fallback = None

    def set_oom_fallback(self, spec):
        self.fallback = spec

    def scale_up(self, count=1, spec=None, endpoints=None):
        self.size += 1
        self.ready += 1
        self.ups += 1
        return {"ok": True, "added": [self.size - 1], "size": self.size}

    def scale_down(self, index=None):
        self.size -= 1
        self.ready -= 1
        self.downs += 1
        return {"ok": True, "removed": self.size, "drained": True,
                "size": self.size}


class _FakeSource:
    """A scriptable signal: set .p99/.depth between steps."""

    def __init__(self, router):
        self.router = router
        self.p99 = 0.0
        self.depth = 0

    def poll(self, now=None, slo_s=0.0):
        return {"fleet": {}, "size": self.router.size,
                "ready": self.router.ready, "queue_depth": self.depth,
                "p99": self.p99, "attainment": 1.0}


def _autoscaler(router, **policy_kw):
    policy_kw.setdefault("slo_queue_wait_p99_s", 0.1)
    policy_kw.setdefault("breach_window_s", 1.0)
    policy_kw.setdefault("clear_window_s", 2.0)
    policy_kw.setdefault("cooldown_s", 5.0)
    policy_kw.setdefault("min_replicas", 1)
    policy_kw.setdefault("max_replicas", 3)
    pol = AutoscalePolicy(**policy_kw)
    return Autoscaler(router=router, policy=pol,
                      source=_FakeSource(router))


def test_scale_up_needs_sustained_breach_then_cooldown():
    """One blip never scales; a breach held past breach_window_s adds
    exactly one replica; the cooldown then gags the loop even though
    the breach persists — no step-function pile-on."""
    r = _FakeRouter(size=2)
    asc = _autoscaler(r, max_replicas=4)
    asc.source.p99 = 0.5                   # breach from the start
    assert asc.step(now=0.0)["action"] == "hold"     # breach noted
    assert asc.step(now=0.5)["action"] == "hold"     # not sustained yet
    out = asc.step(now=1.2)                # 1.2s >= breach_window 1.0
    assert out["action"] == "scale_up" and r.ups == 1
    # still breaching, but inside cooldown_s=5 of the action at t=1.2
    assert asc.step(now=3.0)["action"] == "hold"
    assert r.ups == 1
    # cooldown over AND re-sustained breach -> second scale-up
    out = asc.step(now=7.0)
    assert out["action"] == "scale_up" and r.ups == 2 and r.size == 4


def test_scale_up_respects_max_replicas():
    r = _FakeRouter(size=3)
    asc = _autoscaler(r, max_replicas=3)
    asc.source.p99 = 9.9
    for t in (0.0, 2.0, 9.0, 20.0):
        assert asc.step(now=t)["action"] == "hold"
    assert r.ups == 0, "at max_replicas the breach must not scale"


def test_scale_down_needs_sustained_clear_and_empty_queues():
    r = _FakeRouter(size=3)
    asc = _autoscaler(r)
    asc.source.p99 = 0.0
    asc.source.depth = 2                   # clear p99 but queued work
    assert asc.step(now=0.0)["action"] == "hold"
    assert asc.step(now=5.0)["action"] == "hold"
    assert r.downs == 0, "a non-empty queue must block scale-down"
    asc.source.depth = 0
    assert asc.step(now=6.0)["action"] == "hold"     # clear starts NOW
    out = asc.step(now=8.5)                # 2.5s >= clear_window 2.0
    assert out["action"] == "scale_down" and r.downs == 1
    assert out["drained"] is True, "scale-down must ride the drain path"
    # size=2 -> min=1: one more sustained-clear cycle allowed ...
    out = asc.step(now=20.0)
    assert asc.step(now=23.0)["action"] == "scale_down"
    # ... then the floor holds forever
    for t in (30.0, 40.0, 60.0):
        assert asc.step(now=t)["action"] == "hold"
    assert r.size == 1 and r.downs == 2


def test_scale_down_factor_is_hysteresis_not_slo():
    """p99 UNDER the SLO but above SLO*factor is neither breach nor
    clear: the loop holds forever — the dead band that kills flap."""
    r = _FakeRouter(size=2)
    asc = _autoscaler(r, scale_down_factor=0.5)      # clear <= 0.05
    asc.source.p99 = 0.08                  # 0.05 < p99 <= 0.1
    for t in (0.0, 3.0, 10.0, 60.0):
        assert asc.step(now=t)["action"] == "hold"
    assert r.ups == 0 and r.downs == 0


def test_oscillating_signal_never_flaps():
    """A signal bouncing across the SLO every poll resets both windows
    each time — zero actions no matter how long it runs."""
    r = _FakeRouter(size=2)
    asc = _autoscaler(r)
    for i in range(40):
        asc.source.p99 = 0.5 if i % 2 == 0 else 0.0
        asc.step(now=i * 0.4)              # dt < both windows
    assert r.ups == 0 and r.downs == 0, "the loop flapped"
    assert not asc.decisions


def test_scale_down_refused_when_only_one_ready():
    """ready <= 1 blocks scale-down regardless of the signal — the
    zero-downtime invariant outranks the policy."""
    r = _FakeRouter(size=2)
    r.ready = 1                            # one replica down/booting
    asc = _autoscaler(r)
    asc.source.p99 = 0.0
    asc.step(now=0.0)
    assert asc.step(now=10.0)["action"] == "hold"
    assert r.downs == 0


def test_attach_arms_the_router_oom_fallback():
    r = _FakeRouter()
    small = {"model": {"kind": "saved", "buckets": [1]}}
    Autoscaler(router=r, policy=AutoscalePolicy(oom_fallback=small))
    assert r.fallback == small


def test_step_exports_decision_and_fleet_gauges():
    r = _FakeRouter(size=2)
    asc = _autoscaler(r)
    asc.source.p99 = 0.5
    asc.step(now=0.0)
    asc.step(now=1.5)                      # the scale_up
    ups = smetrics.AUTOSCALER_DECISIONS.labels(action="scale_up").value
    assert ups >= 1
    assert smetrics.AUTOSCALER_FLEET_SIZE.labels(
        kind="total").value == 3.0
    assert smetrics.AUTOSCALER_FLEET_SIZE.labels(
        kind="desired").value == 3.0
    assert smetrics.AUTOSCALER_SIGNAL.labels(
        signal="queue_wait_p99_s").value == 0.5
    trace = asc.fleet_trace
    assert trace[0]["size"] == 2 and trace[-1]["size"] == 3


# -- the windowed p99 source ----------------------------------------------

class _FakeFleet:
    """stats()-shaped fleet with one scriptable replica metricz."""

    def __init__(self):
        self.buckets = [[0.1, 0], [0.5, 0], ["inf", 0]]

    def stats(self):
        return {"supervised": True, "ready": 1, "size": 1,
                "replicas": [{"index": 0, "state": "ready",
                              "endpoint": "fake:1",
                              "queue_depth": 3}]}


def _wire_source(fleet, window_s=10.0):
    src = RouterSource(router=fleet, window_s=window_s)
    src._metricz = lambda ep: {
        "paddle_serving_queue_wait_seconds": {
            "type": "histogram", "samples": [{
                "labels": {"model": "m"}, "sum": 0.0,
                "count": fleet.buckets[-1][1],
                "buckets": [list(b) for b in fleet.buckets]}]}}
    return src


def test_source_windowed_p99_and_attainment():
    fleet = _FakeFleet()
    src = _wire_source(fleet)
    fleet.buckets = [[0.1, 10], [0.5, 10], ["inf", 10]]
    obs = src.poll(now=0.0, slo_s=0.25)
    assert obs["p99"] == 0.1 and obs["attainment"] == 1.0
    assert obs["queue_depth"] == 3 and obs["ready"] == 1
    # 100 new observations, all slower than 0.5s -> p99 blows out and
    # attainment collapses to the 10 old fast ones
    fleet.buckets = [[0.1, 10], [0.5, 10], ["inf", 110]]
    obs = src.poll(now=1.0, slo_s=0.25)
    assert obs["p99"] == float("inf")
    assert obs["attainment"] == pytest.approx(10 / 110)


def test_source_clamps_histogram_resets():
    """A replica restart RESETS its histogram; the cumulative counts
    going backwards must read as zero new observations, not negative
    ones faking a clear (or breaching) signal."""
    fleet = _FakeFleet()
    src = _wire_source(fleet)
    fleet.buckets = [[0.1, 5], [0.5, 5], ["inf", 100]]
    src.poll(now=0.0, slo_s=0.25)
    fleet.buckets = [[0.1, 0], [0.5, 0], ["inf", 2]]   # the restart
    obs = src.poll(now=1.0, slo_s=0.25)
    assert obs["p99"] == float("inf"), \
        "the pre-restart slow tail must still be in the window"
    merged = src._merged()
    assert all(v >= 0 for v in merged.values())


def test_source_window_expires_old_signal():
    fleet = _FakeFleet()
    src = _wire_source(fleet, window_s=5.0)
    fleet.buckets = [[0.1, 0], [0.5, 0], ["inf", 50]]
    assert src.poll(now=0.0, slo_s=0.25)["p99"] == float("inf")
    # no new traffic; the old breach ages out of the window
    obs = src.poll(now=60.0, slo_s=0.25)
    assert obs["p99"] == 0.0 and obs["attainment"] == 1.0


# -- HBM bin-packing (MEM_r01 compiled footprints) ------------------------

def _mem_entry(nbytes):
    """The MEM_r01.json shape tools/mem_probe.py records per model."""
    return {"compiled": {"peak_bytes": int(nbytes),
                         "argument_bytes": 0, "output_bytes": 0},
            "live_buffers": {"total_bytes": 0}}


def test_bin_pack_first_fit_decreasing():
    hosts = bin_pack({"a": _mem_entry(600), "b": _mem_entry(500),
                      "c": _mem_entry(400)}, hbm_bytes=1000)
    assert hosts == [["a", "c"], ["b"]]


def test_bin_pack_is_deterministic_on_ties():
    hosts = bin_pack({"z": 300, "a": 300, "m": 300}, hbm_bytes=1000)
    assert hosts == [["a", "m", "z"]]


def test_bin_pack_refuses_model_bigger_than_budget():
    with pytest.raises(PlacementError, match="exceeds"):
        bin_pack({"huge": _mem_entry(2048)}, hbm_bytes=1024)


def test_validate_host_refuses_summed_overcommit():
    foot = {"a": _mem_entry(700), "b": _mem_entry(400)}
    assert validate_host(["a"], foot, hbm_bytes=1000) == 700
    with pytest.raises(PlacementError, match="over HBM budget"):
        validate_host(["a", "b"], foot, hbm_bytes=1000)


def test_uncosted_model_is_refused_not_guessed():
    with pytest.raises(PlacementError, match="compiled.peak_bytes"):
        peak_bytes_of({"live_buffers": {"total_bytes": 5}})


def test_budget_falls_back_to_hbm_bytes_flag():
    old = flags.get("hbm_bytes")
    try:
        flags.set("hbm_bytes", 1000.0)
        assert bin_pack({"a": 900}) == [["a"]]
        flags.set("hbm_bytes", 0.0)
        with pytest.raises(PlacementError, match="no per-host HBM"):
            bin_pack({"a": 900})
    finally:
        flags.set("hbm_bytes", old)


def test_plan_placement_from_mem_report():
    report = {"models": {"big": _mem_entry(900),
                         "mid": _mem_entry(500),
                         "small": _mem_entry(90)}}
    plan = plan_placement(report, hbm_bytes=1000)
    assert plan["budget"] == 1000
    assert [h["models"] for h in plan["hosts"]] == \
        [["big", "small"], ["mid"]]
    assert all(h["bytes"] <= plan["budget"] for h in plan["hosts"])
    with pytest.raises(PlacementError):
        plan_placement(report, models=["big"], hbm_bytes=800)


# -- supervisor: quarantine cooldown, healthy reset, OOM classify ---------

class _FakeProc:
    def __init__(self, pid=12345, code=None):
        self.pid = pid
        self._code = code

    def poll(self):
        return self._code


def _offline_router(tmp_path, **kw):
    """A supervised router that is never start()ed: _monitor_one is
    driven by hand against fake processes — the supervisor state
    machine without fork/compile costs."""
    kw.setdefault("crash_loop_limit", 2)
    kw.setdefault("crash_loop_window_s", 60.0)
    kw.setdefault("restart_backoff_base_s", 0.01)
    router = Router(spec={"model": {"kind": "saved"}}, replicas=1,
                    workdir=str(tmp_path), **kw)
    spawns = []

    def fake_spawn(r):
        spawns.append(r.index)
        r.proc = _FakeProc(pid=1000 + len(spawns))
        r.set_state(STARTING)

    router._spawn = fake_spawn
    return router, spawns


def test_quarantine_is_a_cooldown_not_a_verdict(tmp_path):
    """crash_loop_limit deaths -> FAILED, but after the cooldown the
    slot gets another chance (counted cause=quarantine_retry) instead
    of being dead forever."""
    router, spawns = _offline_router(tmp_path,
                                     quarantine_cooldown_s=0.3,
                                     healthy_reset_s=30.0)
    r = router._replicas[0]
    q0 = smetrics.ROUTER_RESTARTS.labels(cause="quarantine_retry").value

    r.proc = _FakeProc(code=1)
    router._monitor_one(r)                 # death 1 -> DOWN + backoff
    assert r.state == DOWN and len(r.restart_times) == 1
    r.restart_at = 0.0
    router._monitor_one(r)                 # backoff elapsed -> respawn
    assert spawns == [0] and r.state == STARTING

    r.proc = _FakeProc(code=1)
    router._monitor_one(r)                 # death 2 -> crash loop
    assert r.state == FAILED and r.quarantines == 1
    router._monitor_one(r)                 # cooldown NOT elapsed
    assert r.state == FAILED and spawns == [0]

    time.sleep(0.35)
    router._monitor_one(r)                 # cooldown elapsed -> retry
    assert r.state == STARTING and spawns == [0, 0]
    assert not r.restart_times, "retry must reset the crash ledger"
    assert smetrics.ROUTER_RESTARTS.labels(
        cause="quarantine_retry").value - q0 == 1


def test_repeat_quarantines_back_off_exponentially(tmp_path):
    router, _ = _offline_router(tmp_path, quarantine_cooldown_s=10.0,
                                quarantine_backoff_max=8.0)
    r = router._replicas[0]
    now = time.monotonic()
    r.failed_at = now
    r.state = FAILED
    r.quarantines = 3                      # third offence: 10 * 2^2
    router._monitor_one(r)
    assert r.state == FAILED, "40s cooldown cannot elapse instantly"
    r.failed_at = now - 41.0
    router._monitor_one(r)
    assert r.state == STARTING
    # the multiplier is capped: quarantines=20 waits 10*8, not 10*2^19
    r.state = FAILED
    r.quarantines = 20
    r.failed_at = now - 81.0
    router._monitor_one(r)
    assert r.state == STARTING


def test_sustained_healthy_period_resets_the_ledger(tmp_path):
    router, _ = _offline_router(tmp_path, healthy_reset_s=0.5)
    r = router._replicas[0]
    r.proc = _FakeProc()
    r.restart_times.append(1.0)
    r.backoff_s = 4.0
    r.quarantines = 2
    r.set_state(READY)
    now = time.monotonic()
    router._healthy_check(r, now)          # not sustained yet
    assert r.quarantines == 2
    r.ready_since = now - 1.0              # held READY past the bar
    router._healthy_check(r, now)
    assert not r.restart_times and r.backoff_s == 0.0
    assert r.quarantines == 0


def test_oom_death_is_classified_and_replaced_once(tmp_path):
    """A memdump next to the flight recorder flips the death to
    cause="oom" and the slot respawns immediately with the fallback
    spec — and only ONCE: a second OOM (fallback still too big) rides
    the normal crash accounting instead of replace-looping."""
    router, spawns = _offline_router(tmp_path)
    small = {"model": {"kind": "saved", "buckets": [1]}}
    router.set_oom_fallback(small)
    r = router._replicas[0]
    flight = tmp_path / "flight0"
    flight.mkdir()
    r.flight_dir = str(flight)
    (flight / "replica.4242.memdump.json").write_text(
        json.dumps({"error": {"type": "MemoryError"}}))
    r.proc = _FakeProc(pid=4242, code=42)
    r.set_state(READY)
    oom0 = smetrics.ROUTER_RESTARTS.labels(cause="oom").value

    router._monitor_one(r)
    assert r.last_exit["cause"] == "oom"
    assert r.last_exit["memdump"].endswith(".4242.memdump.json")
    assert r.spec == small, "OOM must swap in the fallback spec"
    assert r.oom_replaced and spawns == [0], \
        "the replace respawns immediately, no backoff"
    assert not r.restart_times, "an OOM is not crash-loop evidence"
    assert smetrics.ROUTER_RESTARTS.labels(
        cause="oom").value - oom0 == 1

    # the fallback OOMs too: same witness file convention, new pid
    (flight / "replica.4243.memdump.json").write_text("{}")
    r.proc = _FakeProc(pid=4243, code=42)
    router._monitor_one(r)
    assert r.state == DOWN and len(r.restart_times) == 1, \
        "second OOM must fall through to crash accounting"
    assert r.last_exit["cause"] == "oom"   # still classified honestly
    assert smetrics.ROUTER_RESTARTS.labels(
        cause="oom").value - oom0 == 2
    assert spawns == [0], "no immediate respawn the second time"


def test_crash_without_memdump_stays_cause_crash(tmp_path):
    router, _ = _offline_router(tmp_path)
    router.set_oom_fallback({"model": {"kind": "tiny"}})
    r = router._replicas[0]
    r.flight_dir = str(tmp_path / "nodir")
    r.proc = _FakeProc(pid=777, code=1)
    r.set_state(READY)
    router._monitor_one(r)
    assert r.last_exit["cause"] == "crash"
    assert not r.oom_replaced and r.spec != {"model": {"kind": "tiny"}}


# -- elastic pool over attached in-process servers ------------------------

def _attached_pair(**router_kw):
    a, b = ModelServer(), ModelServer()
    ea, eb = a.serve(), b.serve()
    router = Router(endpoints=[ea, eb], **router_kw)
    router.start()
    router.wait_ready(timeout_s=10)
    return a, b, router


def test_scale_down_reroutes_sticky_entries_cleanly():
    """Draining a replica holding sticky entries: the same request_id
    keeps working afterwards, re-routed to a survivor, and the
    victim's sticky entries are gone."""
    a, b, router = _attached_pair()
    try:
        r1 = router.route({"method": "models", "req_id": "sticky-x"})
        assert r1["ok"]
        victim = r1["routed_replica"]
        out = router.scale_down(index=victim)
        assert out["ok"] and out["removed"] == victim, out
        assert out["drained"] is True and out["size"] == 1
        r2 = router.route({"method": "models", "req_id": "sticky-x"})
        assert r2["ok"] and r2["routed_replica"] != victim, r2
        st = router.stats()
        assert st["size"] == 1
        assert all(rep["index"] != victim for rep in st["replicas"])
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_scale_down_with_zero_traffic_is_immediate():
    a, b, router = _attached_pair()
    try:
        t0 = time.monotonic()
        out = router.scale_down()
        elapsed = time.monotonic() - t0
        assert out["ok"] and out["drained"] is True, out
        assert elapsed < 2.0, \
            f"an idle drain must settle immediately, took {elapsed:.1f}s"
        assert out["removed"] == 1, "LIFO: highest index drains first"
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_scale_down_refuses_the_last_ready_replica():
    a, b, router = _attached_pair()
    try:
        assert router.scale_down()["ok"]
        out = router.scale_down()
        assert not out["ok"] and out["kind"] == "unavailable", out
        assert router.stats()["size"] == 1
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_attached_scale_up_adopts_endpoints():
    a, b, router = _attached_pair()
    c = ModelServer()
    try:
        refuse = router.scale_up()
        assert not refuse["ok"], "attached scale_up needs endpoints"
        ec = c.serve()
        out = router.scale_up(endpoints=[ec])
        assert out["ok"] and out["added"] == [2] and out["size"] == 3
        _wait(lambda: router.stats()["ready"] == 3,
              msg="adopted replica to pass readyz")
    finally:
        router.stop(terminate_replicas=False)
        for s in (a, b, c):
            s.stop()


def test_replica_gauges_and_stats_surface():
    """Per-replica inflight / queue-depth / one-hot state reach the
    registry (the scrape) and stats() (the RPC) — the exact snapshot
    the autoscaler runs on."""
    a, b, router = _attached_pair(stats_poll_interval_s=0.05)
    try:
        _wait(lambda: all(r._stats_at > 0 for r in router._replicas),
              msg="monitor to poll replica stats")
        st = router.stats()
        assert st["size"] == 2
        for rep in st["replicas"]:
            assert rep["queue_depth"] == 0
            assert rep["quarantines"] == 0 and rep["last_exit"] is None
            lbl = str(rep["index"])
            assert smetrics.ROUTER_REPLICA_QUEUE_DEPTH.labels(
                replica=lbl).value == 0.0
            assert smetrics.ROUTER_REPLICA_INFLIGHT.labels(
                replica=lbl).value == 0.0
            one_hot = {s: smetrics.ROUTER_REPLICA_STATE.labels(
                replica=lbl, state=s).value for s in _STATES}
            assert one_hot["ready"] == 1.0
            assert sum(one_hot.values()) == 1.0, one_hot
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


def test_autoscaler_death_freezes_fleet_router_keeps_serving():
    """The expendability contract (docs/robustness.md): kill the
    autoscaler loop and the router serves on at the frozen size."""
    a, b, router = _attached_pair()
    try:
        asc = Autoscaler(router=router,
                         policy=AutoscalePolicy(poll_interval_s=0.02,
                                                min_replicas=1,
                                                max_replicas=4))
        asc.start()
        _wait(lambda: len(asc.fleet_trace) >= 3,
              msg="the loop to take a few observations")
        asc.stop()                         # the autoscaler "dies"
        assert asc._thread is None
        size0 = router.stats()["size"]
        for i in range(5):
            r = router.route({"method": "models",
                              "req_id": f"after-death-{i}"})
            assert r["ok"], r
        assert router.stats()["size"] == size0, \
            "a dead autoscaler must freeze, not mutate, the fleet"
    finally:
        router.stop(terminate_replicas=False)
        a.stop()
        b.stop()


# -- desired state -> kube specs ------------------------------------------

def test_desired_state_renders_to_kube_specs():
    r = _FakeRouter(size=2)
    asc = _autoscaler(r)
    asc.source.p99 = 0.5
    asc.step(now=0.0)
    asc.step(now=1.5)                      # scale to 3
    ds = asc.desired_state()
    assert ds["replicas"] == 3
    assert ds["policy"]["slo_queue_wait_p99_s"] == 0.1
    docs = render_kube(ds, jobname="fleet", port=7070)
    assert [d["kind"] for d in docs] == ["Service", "Job"]
    job = docs[1]
    assert job["spec"]["completions"] == 3
    assert job["spec"]["completionMode"] == "Indexed"
    entry = job["spec"]["template"]["spec"]["containers"][0][
        "command"][-1]
    assert "paddle_tpu_torch.serving.replica" in entry
    assert "--port 7070" in entry


def test_kube_specs_ask_for_the_card():
    """Port difference: the replica pod asks for ``nvidia.com/gpu`` where
    the reference's asks for ``google.com/tpu``; none without ``gpu``."""
    ds = {"replicas": 2, "spec": {"model": {"kind": "decoder_lm"}}}
    job = render_kube(ds, gpu=1)[1]
    res = job["spec"]["template"]["spec"]["containers"][0]["resources"]
    assert res["limits"]["nvidia.com/gpu"] == "1"
    assert res["requests"]["nvidia.com/gpu"] == "1"
    assert not any("tpu" in k for k in res["limits"])
    job = render_kube(ds)[1]
    res = job["spec"]["template"]["spec"]["containers"][0]["resources"]
    assert "nvidia.com/gpu" not in res["limits"]
