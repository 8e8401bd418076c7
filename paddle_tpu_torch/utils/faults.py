"""Deterministic fault injection (the port's own copy of
``paddle_tpu/utils/faults.py``): tests and operators (via flags) arm
*named sites* inside the runtime to raise or delay on an exact,
replayable schedule, so every chaos run is deterministic: same plan +
same seed -> same faults at the same hits.

Instrumented sites in the port (grep for ``faults.inject``):

    serving.rpc.send    ServingClient, before a request hits the socket
    serving.rpc.recv    ServingClient, after send / before the reply read
    serving.handle      the server's RPC handler, before dispatching
    serving.reply       the server's RPC handler, after execution /
                        before the reply write (a fault here is the
                        mid-request kill: work done, ack lost)
    serving.dispatch    the slot and wave engines, before each model
                        call (admission prefill, decode / verify step,
                        wave prefill)
    executor.dispatch   Executor.run, before the block runs
    ckpt.write_var      fluid.io, before each variable file is written
                        (raise / delay) and after its checksum (truncate,
                        by ``mutate_file``)

Plan grammar (``FLAGS_fault_plan`` env / ``flags.set("fault_plan", ...)``
or programmatic :func:`arm` / :func:`active`):

    PLAN  := SPEC { ";" SPEC }
    SPEC  := SITE ":" MODE [ "@" SCHED ] { ":" KEY "=" VAL }
    MODE  := "raise" | "delay" | "truncate"
    SCHED := N{,N}       fire on these 1-based hit indices (default: 1)
           | "every" N   fire on every Nth hit
           | "p" FLOAT   fire per hit with seeded probability (replayable:
                         per-site RNG streams keyed by (seed, site))
    KEYS  := "times" = K          stop after K total fires
           | "exc"   = NAME       raise mode: ConnectionError, OSError,
                                  TimeoutError, IOError, EOFError,
                                  RuntimeError, MemoryError
                                  (default: FaultInjected)
           | "s"     = SECONDS    delay mode sleep (default 0.001)
           | "to"    = BYTES      truncate mode target size (default 0)

    e.g.  serving.rpc.send:raise@2,4:exc=ConnectionError;serving.handle:delay@1:s=0.05

A site counts a *hit* only for specs whose mode applies to the call:
``inject()`` services raise/delay specs, ``mutate_file()`` truncate specs
(it tears a file just written, as a crash after its checksum would).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Union


class FaultInjected(Exception):
    """Default exception for raise-mode sites (subclass nothing socket-ish
    on purpose: a retry layer must *opt in* to treating an injected fault
    as retryable via ``exc=ConnectionError`` etc.)."""


_EXC_BY_NAME = {
    "FaultInjected": FaultInjected,
    "ConnectionError": ConnectionError,
    "OSError": OSError,
    "TimeoutError": TimeoutError,
    "IOError": IOError,
    "EOFError": EOFError,
    "RuntimeError": RuntimeError,
    # host-OOM analogue, so a plan can raise MemoryError at any site
    "MemoryError": MemoryError,
}

_MODES = ("raise", "delay", "truncate")


@dataclass(frozen=True)
class FaultSpec:
    """Schedule + effect for one site."""
    mode: str = "raise"
    at: FrozenSet[int] = frozenset()     # 1-based hit indices
    every: int = 0                       # fire on every Nth hit
    p: float = 0.0                       # seeded per-hit probability
    times: Optional[int] = None          # max total fires
    delay_s: float = 0.001
    truncate_to: int = 0
    exc: Optional[type] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"fault mode {self.mode!r} not in {_MODES}")
        if not self.at and not self.every and not self.p:
            object.__setattr__(self, "at", frozenset([1]))


def parse_spec(text: str) -> FaultSpec:
    """``"raise@2:exc=ConnectionError"`` → FaultSpec (site not included)."""
    parts = text.split(":")
    head, kvs = parts[0], parts[1:]
    mode, _, sched = head.partition("@")
    at: FrozenSet[int] = frozenset()
    every, p = 0, 0.0
    if sched:
        if sched.startswith("every"):
            every = int(sched[len("every"):])
        elif sched.startswith("p"):
            p = float(sched[1:])
        else:
            at = frozenset(int(x) for x in sched.split(","))
    kw: Dict[str, object] = {}
    for kv in kvs:
        k, _, v = kv.partition("=")
        if k == "times":
            kw["times"] = int(v)
        elif k == "exc":
            try:
                kw["exc"] = _EXC_BY_NAME[v]
            except KeyError:
                raise ValueError(
                    f"unknown exc {v!r}; one of {sorted(_EXC_BY_NAME)}")
        elif k == "s":
            kw["delay_s"] = float(v)
        elif k == "to":
            kw["truncate_to"] = int(v)
        else:
            raise ValueError(f"unknown fault spec key {k!r} in {text!r}")
    return FaultSpec(mode=mode, at=at, every=every, p=p, **kw)


def parse_plan(text: str) -> Dict[str, FaultSpec]:
    """``"site:spec;site2:spec2"`` → {site: FaultSpec}."""
    plan: Dict[str, FaultSpec] = {}
    for item in text.split(";"):
        item = item.strip()
        if not item:
            continue
        site, _, spec = item.partition(":")
        if not spec:
            raise ValueError(f"fault plan item {item!r} has no spec")
        plan[site] = parse_spec(spec)
    return plan


@dataclass
class _SiteState:
    spec: FaultSpec
    hits: int = 0
    fired: int = 0
    rng: Optional[random.Random] = field(default=None)


class FaultRegistry:
    """Thread-safe site registry with per-site hit counters."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._sites: Dict[str, _SiteState] = {}
        self._seed = seed
        self._loaded = False      # flags plan consulted yet?
        # observers outlive reset(): they are process infrastructure
        # (the flight recorder's black box), not part of any plan
        self._observers = []

    # -- configuration ---------------------------------------------------
    def seed(self, n: int):
        with self._lock:
            self._seed = int(n)
            for site, st in self._sites.items():
                st.rng = random.Random(f"{self._seed}:{site}")

    def arm(self, site: str, spec: Union[FaultSpec, str]):
        if isinstance(spec, str):
            spec = parse_spec(spec)
        with self._lock:
            self._sites[site] = _SiteState(
                spec, rng=random.Random(f"{self._seed}:{site}"))
            self._loaded = True   # explicit arming supersedes the env plan

    def disarm(self, site: Optional[str] = None):
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def reset(self):
        """Clear every armed site and counter. The env/flags plan is NOT
        re-read afterwards (call :func:`reload_from_flags` for that) so a
        test's reset cannot resurrect a leaked environment plan."""
        with self._lock:
            self._sites.clear()
            self._loaded = True

    def reload_from_flags(self):
        """(Re-)install the plan from FLAGS_fault_plan / FLAGS_fault_seed."""
        from paddle_tpu_torch import flags
        plan = flags.get("fault_plan")
        with self._lock:
            self._sites.clear()
            self._seed = int(flags.get("fault_seed"))
            self._loaded = True
        if plan:
            for site, spec in parse_plan(plan).items():
                self.arm(site, spec)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {s: {"hits": st.hits, "fired": st.fired,
                        "mode": st.spec.mode}
                    for s, st in self._sites.items()}

    # -- observers -------------------------------------------------------
    def add_observer(self, fn):
        """``fn(site, mode)`` is called for every fault that FIRES,
        before its effect (raise/delay/truncate) — so a crash recorder
        can name the kill point even when the effect ends the process."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn):
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify(self, site: str, mode: str):
        for fn in tuple(self._observers):
            try:
                fn(site, mode)
            except Exception:
                pass

    # -- firing ----------------------------------------------------------
    def _fire(self, site: str, modes) -> Optional[FaultSpec]:
        """Count a hit for `site` if its spec's mode is serviced by this
        call; return the spec when it should fire now."""
        if not self._loaded:
            self.reload_from_flags()
        with self._lock:
            st = self._sites.get(site)
            if st is None or st.spec.mode not in modes:
                return None
            st.hits += 1
            spec = st.spec
            fire = (st.hits in spec.at
                    or (spec.every and st.hits % spec.every == 0))
            if spec.p:
                # consume one rand per hit regardless, so replay is exact
                r = st.rng.random()
                fire = fire or r < spec.p
            if fire and spec.times is not None and st.fired >= spec.times:
                fire = False
            if fire:
                st.fired += 1
                return spec
            return None

    def inject(self, site: str):
        """Instrumentation point for raise/delay specs."""
        spec = self._fire(site, ("raise", "delay"))
        if spec is None:
            return
        self._notify(site, spec.mode)
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        exc = spec.exc or FaultInjected
        raise exc(f"injected fault at site {site!r}")

    def mutate_file(self, site: str, path: str):
        """Instrumentation point for truncate specs: tears the file that
        was just written (models a crash/partial flush *after* any
        integrity metadata was recorded)."""
        spec = self._fire(site, ("truncate",))
        if spec is None:
            return
        self._notify(site, spec.mode)
        with open(path, "r+b") as f:
            f.truncate(spec.truncate_to)


_REG = FaultRegistry()


def inject(site: str) -> None:
    if _REG._loaded and not _REG._sites:   # zero-cost when idle
        return
    _REG.inject(site)


def mutate_file(site: str, path: str) -> None:
    if _REG._loaded and not _REG._sites:
        return
    _REG.mutate_file(site, path)


def arm(site: str, spec: Union[FaultSpec, str]) -> None:
    _REG.arm(site, spec)


def disarm(site: Optional[str] = None) -> None:
    _REG.disarm(site)


def reset() -> None:
    _REG.reset()


def seed(n: int) -> None:
    _REG.seed(n)


def stats() -> Dict[str, dict]:
    return _REG.stats()


def add_observer(fn) -> None:
    _REG.add_observer(fn)


def remove_observer(fn) -> None:
    _REG.remove_observer(fn)


def reload_from_flags() -> None:
    _REG.reload_from_flags()


@contextmanager
def active(plan: Union[str, Dict[str, Union[FaultSpec, str]]],
           seed_: int = 0):
    """Arm a plan for the duration of a with-block, then clear it.

        with faults.active("serving.reply:raise@1:exc=ConnectionError"):
            client.infer("clf", feeds)
    """
    _REG.reset()
    _REG.seed(seed_)
    if isinstance(plan, str):
        plan = parse_plan(plan)
    for site, spec in plan.items():
        _REG.arm(site, spec)
    try:
        yield _REG
    finally:
        _REG.reset()
