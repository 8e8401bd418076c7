"""OOM forensics of the port (the OOM half of
``paddle_tpu/observability/memory.py``, ``:440-523``).

- :func:`is_oom_error` -- a device OOM (``torch.cuda.OutOfMemoryError``,
  or an error whose text says "out of memory" / the reference's
  ``RESOURCE_EXHAUSTED``) or the host analogue a fault plan injects
  (``MemoryError``).
- :func:`dump_on_oom` -- the except path of a dispatch (the executor's
  ``run``, the serving engines' ``_run``): an OOM error inside it calls
  :func:`oom_dump` under the dispatch's program label, then goes on.
- :func:`oom_dump` -- writes ``<role>.<pid>.memdump.json`` atomically
  (tmp + fsync + replace) into the flight recorder's directory (the
  running recorder's, else ``FLAGS_flight_recorder_dir``), counts
  ``paddle_oom_events_total{program}``, notes the event in the flight
  recorder and dumps it. It never raises: it runs on an error path whose
  original error must go on. The router classifies a replica's death
  ``cause="oom"`` by this file (``serving/router.py`` ``_find_memdump``).

The memdump keeps the reference's keys. Port differences in their
values: ``compiled`` is null (eager PyTorch has no compiled breakdown);
``total_bytes`` and ``watermark_bytes`` are the card's
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` and
``device`` holds them with ``memory_reserved`` and the allocator's
``memory_stats`` counters (:func:`device_census`) -- all empty or 0 in a
process that never touched a card; ``families``, ``top_buffers`` and
``watermark_history`` are empty (the scope census, the compiled
breakdowns, the donation audit and the ``/memory`` route are not
ported).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.spool import default_role, wall_us

OOM_EVENTS = metrics.counter(
    "paddle_oom_events_total", "Device OOMs caught on a dispatch's "
    "error path by the OOM forensics (memdump written)", ("program",))

# the allocator counters a memdump carries (torch.cuda.memory_stats keys)
_STATS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
          "reserved_bytes.all.current", "reserved_bytes.all.peak",
          "active_bytes.all.current", "num_alloc_retries", "num_ooms")


def is_oom_error(e: BaseException) -> bool:
    """A device OOM (``torch.cuda.OutOfMemoryError``, or an error whose
    text says so) or the host analogue a fault plan injects
    (``MemoryError``)."""
    if isinstance(e, MemoryError):
        return True
    import torch
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = str(e)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


def device_census() -> dict:
    """The card's allocator census of this process: {} when it never
    initialised CUDA (a CPU replica), else its device name, the bytes
    allocated, the high watermark, the bytes reserved and the
    allocator's counters."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    dev = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(dev)
    return {"device": torch.cuda.get_device_name(dev),
            "allocated_bytes": int(torch.cuda.memory_allocated(dev)),
            "max_allocated_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "reserved_bytes": int(torch.cuda.memory_reserved(dev)),
            "memory_stats": {k: stats[k] for k in _STATS if k in stats}}


def oom_dump(exc: BaseException, program: Optional[str] = None
             ) -> Optional[str]:
    """Write ``<role>.<pid>.memdump.json`` into the flight recorder's
    directory and return its path; None when no directory is set (the
    reference's gate) or on any failure -- NEVER raises."""
    try:
        from paddle_tpu_torch import flags
        from paddle_tpu_torch.observability import flight_recorder
        rec = flight_recorder.current()
        dirpath = (os.path.dirname(rec.dump_path) if rec is not None
                   else (flags.get("flight_recorder_dir") or None))
        if dirpath is None:
            return None
        program = program or "unknown"
        OOM_EVENTS.labels(program=program).inc()
        census = device_census()
        role = rec.role if rec is not None else default_role()
        doc = {"role": role, "pid": os.getpid(), "reason": "oom",
               "wall_us": wall_us(time.perf_counter()),
               "program": program, "error": str(exc)[:500],
               "exc_type": type(exc).__name__,
               "compiled": None,
               "families": {},
               "total_bytes": census.get("allocated_bytes", 0),
               "top_buffers": [],
               "watermark_bytes": census.get("max_allocated_bytes", 0),
               "watermark_history": [],
               "device": census}
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"{role}.{os.getpid()}.memdump.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        flight_recorder.note("oom", program=program,
                             total_bytes=doc["total_bytes"], memdump=path)
        if rec is not None:
            rec.dump("oom")
        return path
    except Exception:
        return None


@contextlib.contextmanager
def dump_on_oom(program: str):
    """Around a dispatch (``paddle_tpu/core/executor.py:466-471``,
    ``paddle_tpu/serving/engine.py:336-339``): an OOM error raised inside
    writes the memdump under ``program`` (:func:`oom_dump`, which never
    raises), then the error goes on."""
    try:
        yield
    except Exception as e:
        if is_oom_error(e):
            oom_dump(e, program=program)
        raise
