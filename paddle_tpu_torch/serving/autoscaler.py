"""Autoscaling serving fleet of the port (the port's own copy of
``paddle_tpu/serving/autoscaler.py``): close the loop from metrics to
replica count.

An :class:`Autoscaler` attaches to a supervised
:class:`~paddle_tpu_torch.serving.router.Router` and reconciles the pool
size against a declarative :class:`AutoscalePolicy`. Everything it
reads is a METRICS SNAPSHOT — ``router.stats()`` (or the
``router_stats`` RPC) for fleet shape and per-replica queue depth, and
each replica's ``metricz`` RPC for the
``paddle_serving_queue_wait_seconds`` histogram — never object
internals, so the same loop drives an in-process router or a remote
one over the wire.

The control law (one :meth:`Autoscaler.step` per poll):

* **scale up** when the fleet-wide queue-wait p99 (computed over a
  sliding window of per-replica histogram DELTAS, so replica restarts
  that reset a histogram cannot fake a clear signal) breaches the SLO
  for ``breach_window_s`` — hysteresis — and the pool is under
  ``max_replicas``;
* **scale down** by GRACEFUL DRAIN (``Router.scale_down``, the
  rolling-restart-proven path) only after the signal stays well clear
  of the SLO (``scale_down_factor``) with an empty queue for
  ``clear_window_s``;
* after any action a ``cooldown_s`` quiet period — the two windows
  plus the cooldown mean the loop can never flap;
* a replica OOM is NOT handled here: attaching the policy registers
  ``oom_fallback`` on the router, whose supervisor replaces the
  memdump-witnessed death with the smaller-footprint spec directly
  (replace, not restart-loop — serving/router.py ``_monitor_one``).

The autoscaler is deliberately EXPENDABLE: it holds no routing state,
so if its loop dies the fleet freezes at its current size and the
router keeps serving.

Placement is honest: :func:`bin_pack` packs models onto hosts by their
peak bytes from a report in the reference's MEM_r01.json format (each
model's ``compiled.peak_bytes``), capped by ``FLAGS_hbm_bytes``, and
:func:`validate_host` REFUSES any host whose summed peaks exceed the
budget. The desired state renders to ``tools/kube_gen_job.py``-style
specs (:func:`render_kube`) so the same policy can drive real pods.

Telemetry: ``paddle_autoscaler_decisions_total{action}``,
``paddle_autoscaler_fleet_size{kind}``,
``paddle_autoscaler_signal{signal}``,
``paddle_autoscaler_slo_attainment_ratio`` — serving/metrics.py.

Port differences: :func:`render_kube` asks for the card
(``nvidia.com/gpu``, its ``gpu`` argument) where the reference asks for
``google.com/tpu``, and its pods run ``python -m
paddle_tpu_torch.serving.replica``; the port writes no MEM_r01 report
of its own yet (the compiled breakdown is not ported), so a placement
report is the reference's format filled by the caller.
"""

from __future__ import annotations

import dataclasses
import json
import socket as socket_module
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from paddle_tpu_torch.serving import metrics as smetrics

_QUEUE_WAIT_FAMILY = "paddle_serving_queue_wait_seconds"


@dataclasses.dataclass
class AutoscalePolicy:
    """The declarative SLO policy the reconciler drives toward.

    ``slo_queue_wait_p99_s`` IS the SLO: the windowed fleet-wide
    queue-wait p99 a request may see before the fleet is undersized.
    The remaining knobs shape the response, not the target."""

    slo_queue_wait_p99_s: float = 0.25  # the SLO itself
    min_replicas: int = 1
    max_replicas: int = 4
    breach_window_s: float = 2.0        # sustained breach before up
    clear_window_s: float = 5.0         # sustained clear before down
    cooldown_s: float = 5.0             # quiet period after any action
    scale_down_factor: float = 0.5      # clear means p99 <= SLO * this
    scale_down_max_queue_depth: int = 0  # ... AND queues this empty
    window_s: float = 10.0              # sliding signal window
    poll_interval_s: float = 0.5
    model: Optional[str] = None         # None = all hosted models
    scale_spec: Optional[dict] = None   # spec for scale-up slots
    oom_fallback: Optional[dict] = None  # smaller-footprint replacement


def _rpc(endpoint: str, payload: dict, timeout: float = 2.0):
    """One request/response on a short-lived connection (the source
    must never hold sockets the routing path could starve behind)."""
    try:
        host, port = endpoint.rsplit(":", 1)
        with socket_module.create_connection(
                (host, int(port)), timeout=timeout) as s:
            s.sendall((json.dumps(payload) + "\n").encode())
            line = s.makefile("rb").readline()
        return json.loads(line) if line else None
    except (ConnectionError, OSError, json.JSONDecodeError, ValueError):
        return None


class RouterSource:
    """Metrics-snapshot source over a router: fleet shape from
    ``stats()`` / the ``router_stats`` RPC, queue-wait histograms from
    each replica's ``metricz`` RPC, merged into a sliding window of
    per-poll DELTAS (clamped at zero per replica, so a restart that
    resets a histogram never subtracts observations)."""

    def __init__(self, router=None, endpoint: Optional[str] = None,
                 window_s: float = 10.0, model: Optional[str] = None):
        if router is None and endpoint is None:
            raise ValueError("RouterSource needs a router or a router "
                             "endpoint")
        self._router = router
        self._endpoint = endpoint
        self.window_s = float(window_s)
        self.model = model
        self._prev: Dict[tuple, Dict[float, int]] = {}
        self._samples: "deque[tuple]" = deque()   # (t, {ub: cum_delta})

    # -- raw snapshots ---------------------------------------------------
    def fleet(self) -> dict:
        if self._router is not None:
            return self._router.stats()
        resp = _rpc(self._endpoint, {"method": "router_stats"})
        if resp and resp.get("ok"):
            return resp["stats"]
        return {"replicas": [], "ready": 0, "size": 0}

    def _metricz(self, endpoint: str) -> Optional[dict]:
        resp = _rpc(endpoint, {"method": "metricz"})
        if resp and resp.get("ok"):
            return resp.get("metrics")
        return None

    # -- the sliding signal window ---------------------------------------
    def _ingest(self, now: float, fleet: dict):
        deltas: Dict[float, int] = {}
        for rep in fleet.get("replicas", []):
            if rep.get("state") not in ("ready", "draining") \
                    or not rep.get("endpoint"):
                continue
            snap = self._metricz(rep["endpoint"])
            fam = (snap or {}).get(_QUEUE_WAIT_FAMILY)
            if not fam:
                continue
            for sample in fam.get("samples", []):
                model = (sample.get("labels") or {}).get("model", "")
                if self.model and model != self.model:
                    continue
                cur = {
                    (float("inf") if ub == "inf" else float(ub)): int(c)
                    for ub, c in sample.get("buckets", [])}
                key = (rep["endpoint"], model)
                prev = self._prev.get(key, {})
                self._prev[key] = cur
                for ub, cum in cur.items():
                    d = cum - prev.get(ub, 0)
                    if d > 0:              # clamp: restarts reset cums
                        deltas[ub] = deltas.get(ub, 0) + d
        self._samples.append((now, deltas))
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def _merged(self) -> Dict[float, int]:
        merged: Dict[float, int] = {}
        for _, deltas in self._samples:
            for ub, d in deltas.items():
                merged[ub] = merged.get(ub, 0) + d
        return merged

    def queue_wait_p99(self) -> float:
        """Windowed fleet-wide queue-wait p99 (upper bucket bound);
        0.0 with no windowed observations."""
        merged = self._merged()
        total = merged.get(float("inf"), 0)
        if total <= 0:
            return 0.0
        target = 0.99 * total
        for ub in sorted(merged):
            if merged[ub] >= target:
                return ub
        return float("inf")

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of windowed queue-wait observations at or under the
        SLO (bucketed: the smallest bound >= SLO answers). 1.0 with an
        empty window — no evidence of breach."""
        merged = self._merged()
        total = merged.get(float("inf"), 0)
        if total <= 0:
            return 1.0
        under = 0
        for ub in sorted(merged):
            if ub >= slo_s:
                under = merged[ub]
                break
        return min(1.0, under / total)

    def poll(self, now: Optional[float] = None,
             slo_s: float = 0.0) -> dict:
        """One observation: fleet shape + the windowed signals."""
        now = time.monotonic() if now is None else now
        fleet = self.fleet()
        self._ingest(now, fleet)
        reps = fleet.get("replicas", [])
        return {
            "fleet": fleet,
            "size": fleet.get("size", len(reps)),
            "ready": fleet.get("ready", 0),
            "queue_depth": sum(int(r.get("queue_depth", 0))
                               for r in reps),
            "p99": self.queue_wait_p99(),
            "attainment": self.slo_attainment(slo_s),
        }


class Autoscaler:
    """The reconciler: poll the source, decide, drive the router.

    :meth:`step` is ONE deterministic poll-decide-act cycle (pass
    ``now`` to drive it from a test without sleeping); :meth:`start`
    wraps it in a daemon thread at ``policy.poll_interval_s``. The
    loop holds no routing state — killing it freezes the fleet at its
    current size while the router keeps serving."""

    def __init__(self, router=None,
                 policy: Optional[AutoscalePolicy] = None,
                 source=None):
        self.policy = policy or AutoscalePolicy()
        self.router = router
        if source is None:
            source = RouterSource(router,
                                  window_s=self.policy.window_s,
                                  model=self.policy.model)
        self.source = source
        if router is not None and self.policy.oom_fallback is not None:
            # the replace-not-restart-loop arm lives in the router's
            # supervisor (it sees the death first); attaching the
            # policy arms it
            router.set_oom_fallback(self.policy.oom_fallback)
        self._breach_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._last_action_t = float("-inf")
        self._desired: Optional[int] = None
        self.fleet_trace: List[dict] = []
        self.decisions: List[dict] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- one control cycle -----------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        p = self.policy
        obs = self.source.poll(now=now, slo_s=p.slo_queue_wait_p99_s)
        size, ready = int(obs["size"]), int(obs["ready"])
        depth, p99 = int(obs["queue_depth"]), float(obs["p99"])
        if self._desired is None:
            self._desired = size
        smetrics.AUTOSCALER_SIGNAL.labels(
            signal="queue_wait_p99_s").set(p99)
        smetrics.AUTOSCALER_SIGNAL.labels(
            signal="queue_depth").set(float(depth))
        smetrics.AUTOSCALER_SLO_ATTAINMENT.set(float(obs["attainment"]))

        # hysteresis bookkeeping: breach and clear are SUSTAINED states
        if p99 > p.slo_queue_wait_p99_s:
            if self._breach_since is None:
                self._breach_since = now
            self._clear_since = None
        else:
            self._breach_since = None
            if p99 <= p.slo_queue_wait_p99_s * p.scale_down_factor \
                    and depth <= p.scale_down_max_queue_depth:
                if self._clear_since is None:
                    self._clear_since = now
            else:
                self._clear_since = None

        action, detail = "hold", {}
        cooled = now - self._last_action_t >= p.cooldown_s
        if cooled and self._breach_since is not None \
                and now - self._breach_since >= p.breach_window_s \
                and size < p.max_replicas:
            out = self.router.scale_up(spec=p.scale_spec) \
                if self.router is not None else {"ok": False}
            if out.get("ok"):
                action = "scale_up"
                size = int(out.get("size", size + 1))
                self._desired = min(p.max_replicas, size)
                self._last_action_t = now
                self._breach_since = None
                detail = {"added": out.get("added")}
        elif cooled and self._clear_since is not None \
                and now - self._clear_since >= p.clear_window_s \
                and size > p.min_replicas and ready > 1:
            out = self.router.scale_down() \
                if self.router is not None else {"ok": False}
            if out.get("ok"):
                action = "scale_down"
                size = int(out.get("size", size - 1))
                self._desired = max(p.min_replicas, size)
                self._last_action_t = now
                self._clear_since = None
                detail = {"removed": out.get("removed"),
                          "drained": out.get("drained")}

        smetrics.AUTOSCALER_DECISIONS.labels(action=action).inc()
        smetrics.AUTOSCALER_FLEET_SIZE.labels(
            kind="desired").set(float(self._desired))
        smetrics.AUTOSCALER_FLEET_SIZE.labels(
            kind="ready").set(float(ready))
        smetrics.AUTOSCALER_FLEET_SIZE.labels(
            kind="total").set(float(size))
        rec = {"t": now, "action": action, "p99": p99,
               "queue_depth": depth, "ready": ready, "size": size,
               "desired": self._desired,
               "attainment": float(obs["attainment"]), **detail}
        self.fleet_trace.append({"t": now, "desired": self._desired,
                                 "ready": ready, "size": size})
        if action != "hold":
            self.decisions.append(rec)
        return rec

    # -- the loop --------------------------------------------------------
    def run(self):
        while self._running:
            try:
                self.step()
            except Exception:
                pass                       # an observer, never a SPOF
            time.sleep(self.policy.poll_interval_s)

    def start(self):
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(
            target=self.run, daemon=True, name="paddle-autoscaler")
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- desired state ---------------------------------------------------
    def desired_state(self) -> dict:
        """The declarative target the loop converged to — what
        :func:`render_kube` turns into pod specs."""
        spec = self.policy.scale_spec
        if spec is None and self.router is not None:
            spec = getattr(self.router, "_spec", None)
        return {"replicas": self._desired
                if self._desired is not None
                else self.policy.min_replicas,
                "spec": spec or {},
                "policy": dataclasses.asdict(self.policy)}


# -- HBM bin-packing (compiled footprints, MEM_r01) -----------------------

class PlacementError(ValueError):
    """A placement violates the per-host HBM budget (or cannot be
    costed — no compiled footprint)."""


def peak_bytes_of(entry) -> int:
    """Peak bytes of one MEM_r01-style model entry (its
    ``compiled.peak_bytes``) — or a raw byte count."""
    if isinstance(entry, (int, float)):
        return int(entry)
    peak = (entry.get("compiled") or {}).get("peak_bytes")
    if peak is None:
        raise PlacementError(
            "model entry carries no compiled.peak_bytes — placement "
            "is by measured peak footprint only, never a guess")
    return int(peak)


def _budget(hbm_bytes) -> int:
    if hbm_bytes is None:
        from paddle_tpu_torch import flags
        hbm_bytes = flags.get("hbm_bytes") or 0
    hbm_bytes = int(hbm_bytes)
    if hbm_bytes <= 0:
        raise PlacementError(
            "no per-host HBM budget: pass hbm_bytes or set "
            "FLAGS_hbm_bytes")
    return hbm_bytes


def validate_host(names: List[str], footprints: dict,
                  hbm_bytes=None) -> int:
    """REFUSE a host whose summed compiled peaks exceed the budget;
    returns the host's total bytes when it fits."""
    budget = _budget(hbm_bytes)
    total = sum(peak_bytes_of(footprints[n]) for n in names)
    if total > budget:
        raise PlacementError(
            f"host over HBM budget: {sorted(names)} sum to {total} "
            f"bytes > {budget} (FLAGS_hbm_bytes)")
    return total


def bin_pack(footprints: dict, hbm_bytes=None) -> List[List[str]]:
    """First-fit-decreasing by compiled peak: models → hosts, each
    capped by the HBM budget. Deterministic (ties break by name).
    Raises :class:`PlacementError` when any single model exceeds the
    budget — no host can take it, and lying about it would just be a
    deferred OOM."""
    budget = _budget(hbm_bytes)
    sized = sorted(((peak_bytes_of(e), n)
                    for n, e in footprints.items()),
                   key=lambda t: (-t[0], t[1]))
    hosts: List[List[str]] = []
    free: List[int] = []
    for nbytes, name in sized:
        if nbytes > budget:
            raise PlacementError(
                f"model {name!r} compiled peak {nbytes} bytes exceeds "
                f"the per-host HBM budget {budget}")
        for i, room in enumerate(free):
            if nbytes <= room:
                hosts[i].append(name)
                free[i] -= nbytes
                break
        else:
            hosts.append([name])
            free.append(budget - nbytes)
    return hosts


def plan_placement(mem_report: dict, models: Optional[List[str]] = None,
                   hbm_bytes=None) -> dict:
    """A MEM_r01.json report → a validated per-host placement:
    ``{"budget": N, "hosts": [{"models": [...], "bytes": M}, ...]}``."""
    entries = mem_report.get("models") or {}
    if models is not None:
        entries = {n: entries[n] for n in models}
    budget = _budget(hbm_bytes)
    hosts = bin_pack(entries, budget)
    return {"budget": budget,
            "hosts": [{"models": h,
                       "bytes": validate_host(h, entries, budget)}
                      for h in hosts]}


# -- kube rendering (tools/kube_gen_job.py-style specs) -------------------

def render_kube(desired: dict, jobname: str = "paddle-serving",
                image: str = "paddle-tpu-torch:latest", port: int = 9876,
                cpu: int = 2, memory_gi: int = 4,
                gpu: int = 0) -> List[dict]:
    """Desired state → Kubernetes specs in ``tools/kube_gen_job.py``'s
    idiom: a headless Service plus an Indexed Job of N replica pods
    (completion index = pool slot) each running ``python -m
    paddle_tpu_torch.serving.replica`` on ``gpu`` cards. The same
    declarative target the in-process reconciler drives, rendered for
    real pods."""
    replicas = int(desired.get("replicas", 1))
    spec = desired.get("spec") or {}
    spec_json = json.dumps(spec).replace("'", "'\\''")
    entry = (f"python -m paddle_tpu_torch.serving.replica "
             f"--spec-json '{spec_json}' --port {port}")
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": jobname},
        "spec": {
            "clusterIP": "None",
            "publishNotReadyAddresses": True,
            "selector": {"job-name": jobname},
            "ports": [{"name": "serving", "port": port}],
        },
    }
    resources = {
        "requests": {"cpu": str(cpu), "memory": f"{memory_gi}Gi"},
        "limits": {"cpu": str(cpu), "memory": f"{memory_gi}Gi"},
    }
    if gpu:
        resources["limits"]["nvidia.com/gpu"] = str(gpu)
        resources["requests"]["nvidia.com/gpu"] = str(gpu)
    job = {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": jobname},
        "spec": {
            "completions": replicas,
            "parallelism": replicas,
            "completionMode": "Indexed",
            "backoffLimit": 0,
            "template": {
                "metadata": {"labels": {"job-name": jobname}},
                "spec": {
                    "subdomain": jobname,
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "replica",
                        "image": image,
                        "command": ["/bin/sh", "-c", entry],
                        "env": [
                            {"name": "FLAGS_trace_role",
                             "value": "replica"},
                            {"name": "PADDLE_REPLICA_ID",
                             "valueFrom": {"fieldRef": {"fieldPath":
                                 "metadata.annotations['batch."
                                 "kubernetes.io/"
                                 "job-completion-index']"}}},
                        ],
                        "ports": [{"containerPort": port}],
                        "resources": resources,
                    }],
                },
            },
        },
    }
    return [service, job]
