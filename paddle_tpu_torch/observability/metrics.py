"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram
(the port's own copy of ``paddle_tpu/observability/metrics.py``).

A process-default :class:`MetricsRegistry` of named metric *families*,
each optionally fanned out by label values, rendered either as
Prometheus text exposition (scraped via ``observability.exporters``) or
as a JSON snapshot (the server's ``metricz`` wire method).

No dependency beyond the standard library, and a cheap hot path:
``Counter.inc`` is one lock and one float add; instrument sites fire
per serving EVENT (an admission, a decode step, a request), never per
tensor op.

Conventions (the reference's):
- names are ``paddle_<subsystem>_<what>[_total|_seconds|_bytes]``,
  counters end in ``_total``, durations are seconds;
- label values are enum-like (a model tag, a cause), never ids or paths;
- families are get-or-create (:func:`counter` twice returns the same
  family), so every instrumented module declares its metrics at import.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# latency-shaped default buckets (sub-ms RPCs up to multi-second
# checkpoint writes), upper bounds in seconds; +Inf is implicit
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _check_name(name: str):
    if not name or not all(c.isalnum() or c == "_" for c in name) \
            or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r} (use "
                         f"[a-zA-Z_][a-zA-Z0-9_]*)")


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic accumulator for one label combination."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value for one label combination."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def set_to_current_time(self):
        self.set(time.time())

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cumulative-bucket histogram for one label combination
    (Prometheus semantics: ``bucket[i]`` counts observations ≤
    ``upper_bounds[i]``, the implicit +Inf bucket equals ``count``)."""

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.upper_bounds = tuple(sorted(float(b) for b in buckets))
        if not self.upper_bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bucket_counts = [0] * len(self.upper_bounds)
        self._sum = 0.0
        self._count = 0
        # last exemplar per bucket index (len(upper_bounds) = +Inf):
        # bounded by construction, so an outlier in the top bucket is
        # one lookup away from its trace (docs/observability.md)
        self._exemplars: Dict[int, str] = {}

    def observe(self, value: float, exemplar: Optional[str] = None):
        v = float(value)
        # le semantics: v lands in the smallest bucket whose bound >= v
        # (bisect_left keeps an exact-bound observation in that bucket)
        i = bisect_left(self.upper_bounds, v)
        with self._lock:
            # per-bound counts here; rendered cumulatively (le semantics)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = str(exemplar)

    def time(self):
        """``with hist.time(): ...`` — observe the block's duration."""
        return _HistTimer(self)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)], +Inf last."""
        return self.snapshot()[0]

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(cumulative_buckets, sum, count) read under ONE lock hold —
        renderers must use this so a concurrent observe() can never
        produce text where bucket{le="+Inf"} != count."""
        with self._lock:
            out, acc = [], 0
            for ub, c in zip(self.upper_bounds, self._bucket_counts):
                acc += c
                out.append((ub, acc))
            out.append((float("inf"), self._count))
            return out, self._sum, self._count

    def exemplars(self) -> Dict[float, str]:
        """{bucket_upper_bound: last exemplar} for buckets that have
        one (e.g. the trace_id of the last sample to land there)."""
        with self._lock:
            bounds = self.upper_bounds + (float("inf"),)
            return {bounds[i]: ex for i, ex in self._exemplars.items()}


class _HistTimer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric fanned out by label values. A family declared
    with no ``labelnames`` proxies the metric methods directly
    (``family.inc()`` == ``family.labels().inc()``)."""

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: Sequence[str] = (), **kwargs):
        _check_name(name)
        for ln in labelnames:
            _check_name(ln)
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self.labels()          # eager zero-valued child: renders at 0

    def labels(self, *values, **kv) -> object:
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(str(kv[ln]) for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(labels: {self.labelnames})") from None
            if len(kv) != len(self.labelnames):
                extra = set(kv) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects {len(self.labelnames)} label "
                f"value(s) {self.labelnames}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = _KINDS[self.kind](threading.Lock(), **self._kwargs)
                self._children[values] = child
            return child

    # -- no-label convenience proxies -----------------------------------
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"call .labels(...) first")
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0):
        self._solo().dec(amount)

    def set(self, value: float):
        self._solo().set(value)

    def observe(self, value: float, exemplar: Optional[str] = None):
        self._solo().observe(value, exemplar)

    def time(self):
        return self._solo().time()

    @property
    def value(self):
        return self._solo().value

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Thread-safe name → :class:`Family` map with get-or-create
    declaration and two render targets (Prometheus text, JSON dict)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _declare(self, name: str, kind: str, help_: str,
                 labelnames: Sequence[str], **kwargs) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames) \
                        or fam._kwargs != kwargs:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames} "
                        f"(options {fam._kwargs}), cannot redeclare as "
                        f"{kind}{tuple(labelnames)} (options {kwargs})")
                return fam
            fam = Family(name, kind, help_, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._declare(name, "counter", help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._declare(name, "gauge", help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._declare(name, "histogram", help_, labelnames,
                             buckets=buckets)

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def unregister(self, name: str):
        with self._lock:
            self._families.pop(name, None)

    def clear(self):
        """Drop every family — test isolation only; instrumented modules
        keep references to their (now orphaned) families, so production
        code must never call this."""
        with self._lock:
            self._families.clear()

    # -- rendering -------------------------------------------------------
    @staticmethod
    def _labels_text(names: Iterable[str], values: Iterable[str],
                     extra: Tuple[str, str] = None) -> str:
        pairs = [(n, v) for n, v in zip(names, values)]
        if extra is not None:
            pairs.append(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
        return "{" + inner + "}"

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4. HELP/TYPE lines render
        for every registered family — a scrape shows the full catalog
        from process start, not metrics popping into existence."""
        lines: List[str] = []
        for fam in self.families():
            help_ = fam.help.replace("\\", r"\\").replace("\n", r"\n")
            lines.append(f"# HELP {fam.name} {help_}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in sorted(fam.children().items()):
                lt = self._labels_text(fam.labelnames, values)
                if fam.kind == "histogram":
                    buckets, hsum, hcount = child.snapshot()
                    for ub, cum in buckets:
                        blt = self._labels_text(
                            fam.labelnames, values, ("le", _fmt_value(ub)))
                        lines.append(f"{fam.name}_bucket{blt} {cum}")
                    lines.append(f"{fam.name}_sum{lt} "
                                 f"{_fmt_value(hsum)}")
                    lines.append(f"{fam.name}_count{lt} {hcount}")
                else:
                    lines.append(f"{fam.name}{lt} "
                                 f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: {type, help, samples: [...]}} — the format
        the exporters dump and bench.py writes next to its results."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            samples = []
            for values, child in sorted(fam.children().items()):
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    buckets, hsum, hcount = child.snapshot()
                    sample = {
                        "labels": labels, "sum": hsum, "count": hcount,
                        "buckets": [[("inf" if ub == float("inf") else ub),
                                     c] for ub, c in buckets]}
                    ex = child.exemplars()
                    if ex:
                        sample["exemplars"] = {
                            ("inf" if ub == float("inf") else str(ub)): e
                            for ub, e in ex.items()}
                    samples.append(sample)
                else:
                    samples.append({"labels": labels,
                                    "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out

    def snapshot_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-default registry every instrumented module declares
    into (the analogue of prometheus_client's REGISTRY)."""
    return _DEFAULT


def counter(name: str, help_: str = "",
            labelnames: Sequence[str] = ()) -> Family:
    return _DEFAULT.counter(name, help_, labelnames)


def gauge(name: str, help_: str = "",
          labelnames: Sequence[str] = ()) -> Family:
    return _DEFAULT.gauge(name, help_, labelnames)


def histogram(name: str, help_: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
    return _DEFAULT.histogram(name, help_, labelnames, buckets=buckets)
