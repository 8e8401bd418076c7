"""Runtime flag registry of the port (the port's own copy of
``paddle_tpu/flags.py``, cut to the flags its modules read).

A flag's value is the programmatic override (``flags.set``), else the
``FLAGS_<name>`` environment variable parsed to the flag's type, else
its default -- the reference's gflags-from-the-environment bootstrap.
The defaults and the parsing are the JAX registry's.

Read by ``utils/faults.py`` (``fault_plan``, ``fault_seed``),
``observability/exporters.py`` (``metrics_port``, ``metrics_host``),
``observability/spool.py`` (``trace_spool_dir``, ``trace_role``),
``observability/flight_recorder.py`` and ``observability/memory.py``
(``flight_recorder_dir``, ``flight_recorder_capacity``),
``observability/lock_witness.py`` (``lock_witness``) and
``serving/autoscaler.py`` (``hbm_bytes``, the placement budget).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class FlagDef:
    name: str
    type: type
    default: Any
    help: str


_DEFS: Dict[str, FlagDef] = {}
_OVERRIDES: Dict[str, Any] = {}


def define(name: str, type_, default, help_: str):
    if name in _DEFS:
        raise ValueError(f"flag {name!r} already defined")
    _DEFS[name] = FlagDef(name, type_, default, help_)


def _parse(d: FlagDef, raw: str):
    if d.type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return d.type(raw)


def get(name: str):
    """Current value: programmatic override > FLAGS_<name> env > default."""
    d = _DEFS.get(name)
    if d is None:
        raise KeyError(f"unknown flag {name!r}; defined: {sorted(_DEFS)}")
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get("FLAGS_" + name)
    if raw is not None:
        try:
            return _parse(d, raw)
        except ValueError:
            import warnings
            warnings.warn(f"FLAGS_{name}={raw!r} does not parse as "
                          f"{d.type.__name__}; using default {d.default!r}")
    return d.default


def set(name: str, value):   # noqa: A001 - mirrors gflags SetCommandLineOption
    d = _DEFS.get(name)
    if d is None:
        raise KeyError(f"unknown flag {name!r}")
    if value is None:
        _OVERRIDES[name] = None
    elif isinstance(value, str):
        # the env path's parsing: set('x', '0') on a bool flag disables
        _OVERRIDES[name] = _parse(d, value)
    else:
        _OVERRIDES[name] = d.type(value)


def reset(name: Optional[str] = None):
    if name is None:
        _OVERRIDES.clear()
    else:
        _OVERRIDES.pop(name, None)


def all_flags():
    return dict(_DEFS)


define("fault_plan", str, "",
       "Deterministic fault-injection plan (paddle_tpu_torch.utils."
       "faults): 'site:mode[@sched][:k=v]...' specs joined by ';', e.g. "
       "'serving.rpc.send:raise@2:exc=ConnectionError'. Loaded lazily at "
       "the first instrumented site hit.")
define("fault_seed", int, 0,
       "Seed for probabilistic fault schedules ('p0.1'): per-site RNG "
       "streams are keyed by (seed, site) so chaos runs replay exactly.")
define("metrics_port", int, -1,
       "Prometheus scrape endpoint (GET /metrics, /healthz) on "
       "this port via a stdlib http.server thread. -1 (default) "
       "disables; 0 binds an ephemeral port "
       "(observability.exporters.active_server().port).")
define("metrics_host", str, "127.0.0.1",
       "Interface the scrape endpoint binds. The loopback default is "
       "deliberate (the registry is unauthenticated).")
define("trace_spool_dir", str, "",
       "Directory the per-process span spool appends to "
       "(<role>.<pid>.jsonl, one JSON span per line, flushed per span -- "
       "crash-tolerant). Empty (default) disables. Merge every spool "
       "into one Perfetto trace with tools/trace_collect.py.")
define("trace_role", str, "",
       "Role label naming this process's spool file and Perfetto "
       "process track ('router', 'replica', 'client'...). Defaults to "
       "the process name derived from sys.argv when empty.")
define("flight_recorder_dir", str, "",
       "Directory for the crash flight recorder: a bounded in-memory "
       "ring of recent spans, metric deltas and fault-site hits, dumped "
       "atomically (<role>.<pid>.dump.json) on unhandled exception, "
       "SIGTERM, or a fault-injection fire -- plus an always-flushed "
       "blackbox JSONL that survives SIGKILL. OOM memdumps "
       "(<role>.<pid>.memdump.json) land here too. Empty (default) "
       "disables (paddle_tpu_torch.observability.flight_recorder).")
define("flight_recorder_capacity", int, 256,
       "Ring capacity (recent events kept) of the flight recorder.")
define("hbm_bytes", float, 0.0,
       "The per-host device memory budget (bytes) the serving "
       "placement (serving/autoscaler.py bin_pack / validate_host) "
       "packs models against when no budget is passed. 0 (default): "
       "none, and placement refuses to guess.")
define("lock_witness", bool, False,
       "Runtime lock-order witness (observability/lock_witness.py): "
       "ObservedLock records per-thread acquisition order and validates "
       "the global lock DAG online. A held->acquiring edge that closes "
       "a cycle is a witnessed inversion: it increments "
       "paddle_lock_witness_violations_total and dumps BOTH stacks "
       "through the flight recorder. Off by default.")
