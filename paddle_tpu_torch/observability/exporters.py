"""The scrape endpoint of the port (the port's own copy of the
endpoint half of ``paddle_tpu/observability/exporters.py``).

:class:`MetricsServer` is a stdlib ``http.server`` thread serving
``GET /metrics`` (the registry in Prometheus text), ``/healthz``
(liveness: "this process serves HTTP") and ``/readyz`` (readiness: "send
me traffic", from the probe :func:`set_ready_probe` registers -- the
replica process and the router register theirs). Its socket binds at
construction (port 0 = ephemeral; read ``.port`` back), so there is no
pick-a-port-then-rebind window.

:func:`ensure_started` starts one from ``FLAGS_metrics_port`` (and
``FLAGS_metrics_host``), idempotently, after importing the modules
whose families the catalog holds, so a scrape shows them at zero from
the start: the serving, router and autoscaler families
(``serving/metrics.py``), the retry / breaker families
(``distributed/resilience.py``), the tracer's dropped-span counter
(``observability/tracing.py``), the OOM counter
(``observability/memory.py``) and the lock witness's violation counter
(``observability/lock_witness.py``).

Port differences: no ``MetricsDumper`` and no ``FLAGS_metrics_dump_path``
(the step-record dump serves the reference's executor, which the port
does not have yet); no ``/memory`` route (its HBM census is not ported);
and the analysis, program-contract and pass-pipeline catalogs of the
reference have no counterpart in the port.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddle_tpu_torch.observability import metrics

_lock = threading.Lock()
_server: Optional["MetricsServer"] = None
_started_from_flags = False
_ready_probe = None


def set_ready_probe(fn) -> None:
    """Register the process's readiness callable for ``GET /readyz``
    (``None`` clears it). Distinct from ``/healthz`` the same way the
    replica wire protocol splits them: healthz says "this process serves
    HTTP", readyz says "send me traffic" -- false during warmup and
    while draining. With no probe registered /readyz answers 200 like
    /healthz (a process with no warmup phase is ready the moment it
    serves). A probe that returns falsy OR raises answers 503 -- a
    broken probe must read as not-ready, never as ready."""
    global _ready_probe
    _ready_probe = fn


class _ScrapeHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        route = self.path.split("?")[0]
        if route == "/healthz":
            # liveness probe for process-launch tests / orchestrators:
            # no registry render, just "this process serves HTTP"
            body = b"ok\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if route == "/readyz":
            probe = _ready_probe
            try:
                ready = True if probe is None else bool(probe())
            except Exception:
                ready = False
            body = b"ready\n" if ready else b"not ready\n"
            self.send_response(200 if ready else 503)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if route not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = self.server.registry.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet: no per-scrape stderr spam
        pass


class MetricsServer:
    """Prometheus scrape endpoint on a socket bound AT CONSTRUCTION
    (port 0 picks an ephemeral port; read ``.port`` back) — no TOCTOU
    window between choosing the port and serving on it."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[metrics.MetricsRegistry] = None):
        self._httpd = ThreadingHTTPServer((host, port), _ScrapeHandler)
        self._httpd.daemon_threads = True
        self._httpd.registry = (registry  # type: ignore[attr-defined]
                                or metrics.default_registry())
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True,
            name="paddle-metrics-http")
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def _preregister_catalog():
    """Import every instrumented module of the port so its families
    exist in the registry before the first scrape."""
    import importlib
    for mod in ("paddle_tpu_torch.observability.tracing",
                "paddle_tpu_torch.observability.memory",
                "paddle_tpu_torch.observability.lock_witness",
                "paddle_tpu_torch.distributed.resilience",
                "paddle_tpu_torch.serving.metrics"):
        importlib.import_module(mod)


def ensure_started() -> bool:
    """Idempotently start the scrape endpoint FLAGS_metrics_port asks
    for. Never raises -- a port in use warns once and latches off
    instead of failing the caller. With the flag unset nothing latches,
    so a flag set later is still honored. Returns True once the
    endpoint runs."""
    global _server, _started_from_flags
    if _server is not None:
        return True
    if _started_from_flags:       # a prior attempt failed: stay off
        return False              # (shutdown() un-latches)
    from paddle_tpu_torch import flags
    port = flags.get("metrics_port")
    if port < 0:
        return False
    with _lock:
        if _server is not None:
            return True
        if _started_from_flags:
            return False
        _preregister_catalog()
        try:
            _server = MetricsServer(port=port,
                                    host=flags.get("metrics_host"))
        except Exception as e:
            import warnings
            warnings.warn(f"metrics scrape endpoint disabled: cannot "
                          f"bind port {port}: {e!r}")
        _started_from_flags = True
        return _server is not None


def active_server() -> Optional[MetricsServer]:
    return _server


def shutdown():
    """Stop the flag-started endpoint and allow a later
    :func:`ensure_started` to re-read the flags."""
    global _server, _started_from_flags
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None
        _started_from_flags = False
