"""Runtime flag registry of the port (the port's own copy of
``paddle_tpu/flags.py``, cut to the flags its modules read).

A flag's value is the programmatic override (``flags.set``), else the
``FLAGS_<name>`` environment variable parsed to the flag's type, else
its default -- the reference's gflags-from-the-environment bootstrap.
The defaults and the parsing are the JAX registry's.

Read by ``utils/faults.py`` (``fault_plan``, ``fault_seed``) and
``observability/exporters.py`` (``metrics_port``, ``metrics_host``).
``trace_role`` comes with the span spool, which reads it.
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
