"""Executor of the port: ``run(program, feed, fetch_list)`` over a scope
(a subset of ``paddle_tpu/core/executor.py``; reference:
python/paddle/fluid/executor.py:260 class, :447 run).

- Places: :class:`CPUPlace` and :class:`CUDAPlace` (``:31-53``).
  ``Executor()`` with no place is ``CUDAPlace(0)`` and raises without a
  card; the CPU is used only when ``CPUPlace()`` is passed. There is no
  ``TPUPlace``.
- :meth:`Executor.run` (``:116``) takes ``program`` (None: the default main
  program, ``fluid/framework.py`` ``default_main_program``), ``feed``
  (a dict, or a list of ``iterations`` dicts), ``fetch_list`` (names or
  variables), ``scope``, ``return_numpy`` and ``iterations``. Feeds move to
  the executor's device and are cast there to their ``VarDesc`` dtype.
  ``iterations > 1`` runs a plain loop of single steps, the fetches
  stacked on a leading axis, the step seeds those of the reference
  (``:453-457``). A :class:`~paddle_tpu_torch.core.lowering.BlockRunner`
  is cached per (program version, feeds, fetches, test mode).
- The chaos site ``executor.dispatch`` fires inside the except path of the
  reference (``:445-471``): an OOM writes the memdump under the runner's
  program label and re-raises (``observability/memory.py``
  ``dump_on_oom``). ``FLAGS_check_nan_inf`` scans the fetches and the
  updated state (``:475-485``); ``FLAGS_benchmark`` prints the run's wall
  time; the ``executor.run`` span is recorded when span capture is on
  (``observability/tracing.py`` ``active``).
- Each row-sparse optimizer apply (``core/selected_rows.py``
  ``record_sparse_apply``) advances ``paddle_sparse_rows_touched_total``
  by its rows once a step (``:601-617``).

Not ported, and refused where a program asks for them: attached
``py_readers`` (ROADMAP A6.10), the build strategy's passes (A6.10),
``dist_config`` and its pad-and-slice (A6.9), ``stacked_feed`` (a feed
list does the same here), the sharded tables' ``_embed_caches`` (A6.9).
The step-telemetry and HBM recorders (``_record_telemetry``,
``_record_memory``) are left out (A6.8).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import flags
from paddle_tpu_torch.core.lowering import BlockRunner
from paddle_tpu_torch.core.registry import TORCH_DTYPES
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.observability import memory as _obs_memory
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _obs_tracing
from paddle_tpu_torch.utils import faults as _faults


class Place:
    """Device tag (reference: platform/place.h Place variant)."""

    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    pass


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class EOFException(Exception):
    """Raised by ``exe.run`` when an attached reader's epoch is exhausted
    (reference: fluid.core.EOFException). The port attaches no reader yet
    (ROADMAP A6.10); the name is kept for callers that catch it."""


def _resolve_device(place: Place) -> torch.device:
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if not isinstance(place, CUDAPlace):
        raise TypeError(f"unsupported place {place!r} (CPUPlace or "
                        f"CUDAPlace)")
    _device.resolve("cuda")                  # raises without a card
    n = torch.cuda.device_count()
    if not 0 <= place.device_id < n:
        raise ValueError(f"{place!r}: this process sees {n} CUDA "
                         f"device(s)")
    return torch.device("cuda", place.device_id)


def _to_feed(val, want: Optional[str], dev: torch.device) -> torch.Tensor:
    """A feed value as a tensor on ``dev`` in its declared dtype."""
    if isinstance(val, torch.Tensor):
        t = val.to(dev)
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(val))).to(dev)
    if want is not None and t.dtype != TORCH_DTYPES[want]:
        t = t.to(TORCH_DTYPES[want])
    return t


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        raise TypeError("a bfloat16 fetch has no numpy dtype; run with "
                        "return_numpy=False")
    return t.detach().cpu().numpy()


class Executor:
    """reference: executor.py:260. One instance per place; caches block
    runners keyed the way executor.py:222 keys its program cache."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = _resolve_device(self.place)
        self._cache: Dict[Any, BlockRunner] = {}
        self._step = 0

    def close(self):
        self._cache.clear()

    def _runner(self, program, feed_names, fetch_names,
                is_test: bool) -> BlockRunner:
        desc = program.desc if hasattr(program, "desc") else program
        key = (desc.version_token, tuple(feed_names), tuple(fetch_names),
               is_test)
        runner = self._cache.get(key)
        if runner is None:
            runner = BlockRunner(desc, 0, feed_names, fetch_names,
                                 is_test=is_test, device=self.device)
            self._cache[key] = runner
        return runner

    @staticmethod
    def _refuse_unported(program, stacked_feed):
        if getattr(program, "_py_readers", None):
            raise NotImplementedError(
                "attached py_readers are not ported (ROADMAP A6.10): "
                "pass the batches as feeds")
        if getattr(program, "_apply_build_strategy", None) is not None:
            raise NotImplementedError(
                "build-strategy passes are not ported (ROADMAP A6.10)")
        if getattr(program, "dist_config", None) is not None:
            raise NotImplementedError(
                "a program with a dist_config is not ported (ROADMAP A6.9)")
        if getattr(getattr(program, "desc", None), "_embed_caches", None):
            raise NotImplementedError(
                "sharded-table caches are not ported (ROADMAP A6.9)")
        if stacked_feed:
            raise NotImplementedError(
                "stacked_feed is not ported: pass a list of `iterations` "
                "feed dicts")

    def run(self, program=None, feed=None,
            fetch_list: Optional[List[Any]] = None,
            feed_var_name: str = "feed", fetch_var_name: str = "fetch",
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True, iterations: int = 1,
            stacked_feed=False):
        """reference: executor.py:447 — the same signature. ``feed`` is one
        batch dict (reused every step) or a list of ``iterations`` dicts;
        with ``iterations > 1`` each fetch comes back stacked on a leading
        [iterations] axis."""
        if program is None:
            from paddle_tpu_torch.fluid.framework import default_main_program
            program = default_main_program()
        self._refuse_unported(program, stacked_feed)
        scope = scope or global_scope()
        fetch_list = fetch_list or []
        if iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {iterations}")
        if isinstance(feed, (list, tuple)):
            if len(feed) != iterations:
                raise ValueError(
                    f"feed list has {len(feed)} batches but iterations="
                    f"{iterations}")
            feeds_per_step = list(feed)
        else:
            feeds_per_step = [feed or {}] * iterations
        feed_names = sorted(feeds_per_step[0])
        fetch_names = [v if isinstance(v, str) else v.name
                       for v in fetch_list]
        is_test = bool(getattr(program, "_is_test", False))
        runner = self._runner(program, feed_names, fetch_names, is_test)

        converted: Dict[int, Dict[str, torch.Tensor]] = {}
        steps = []
        for f in feeds_per_step:
            if id(f) not in converted:       # a reused dict converts once
                if sorted(f) != feed_names:
                    raise ValueError(
                        f"every feed dict of a run needs the same names: "
                        f"{sorted(f)} against {feed_names}")
                converted[id(f)] = {
                    n: _to_feed(f[n], runner.feed_dtype(n), self.device)
                    for n in feed_names}
            steps.append(converted[id(f)])

        bench = flags.get("benchmark")
        t0 = time.perf_counter()
        span = (_obs_tracing.span("executor.run", iterations=iterations)
                if _obs_tracing.active() else contextlib.nullcontext())
        seed0 = self._step + 1
        self._step += iterations
        with span, _obs_memory.dump_on_oom(runner.obs_label):
            # chaos site: the OOM-forensics test arms
            # 'executor.dispatch:raise@1:exc=MemoryError' here
            _faults.inject("executor.dispatch")
            outs = [runner(scope, f, seed0 + i) for i, f in enumerate(steps)]
        _count_sparse_rows(runner, iterations)
        fetches = outs[0] if iterations == 1 else [
            torch.stack([o[j] for o in outs]) for j in range(len(fetch_names))]
        if bench:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"[FLAGS_benchmark] run {time.perf_counter() - t0:.4f}s "
                  f"iterations={iterations} feeds={len(feed_names)} "
                  f"fetches={len(fetch_names)}")
        if flags.get("check_nan_inf"):
            # FLAGS_check_nan_inf (reference: operator.cc:978-990): the
            # fetches and every state var the run updated
            for name, o in zip(fetch_names, fetches):
                _assert_finite(name, o)
            for name in runner.sig.state_names:
                v = scope.find_var(name)
                if v is not None:
                    _assert_finite(name, v)
        if return_numpy:
            return [_to_numpy(o) for o in fetches]
        return list(fetches)


def _count_sparse_rows(runner: BlockRunner, iterations: int) -> None:
    """Advance the rows-touched counter of every sparse-apply site the
    run's optimizer ops registered, once a step."""
    sites = getattr(runner._program_desc, "_sparse_sites", None)
    if not sites:
        return
    fam = _obs_metrics.counter(
        "paddle_sparse_rows_touched_total",
        "embedding-table rows (incl. duplicates) carried by row-sparse "
        "gradients into the sparse optimizer apply, per param", ("param",))
    for pname, (k, _height) in sites.items():
        fam.labels(param=pname).inc(k * iterations)


def _assert_finite(name: str, arr):
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))
    if t.is_floating_point() and not bool(torch.isfinite(t).all()):
        n_nan = int(torch.isnan(t).sum())
        n_inf = int(torch.isinf(t).sum())
        raise FloatingPointError(
            f"check_nan_inf: variable {name!r} has {n_nan} NaN / {n_inf} "
            f"Inf values (shape {tuple(t.shape)})")
