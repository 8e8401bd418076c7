"""The PyTorch port's fleet observability against the JAX package's:
the span spool (``observability/spool.py``), the flight recorder
(``observability/flight_recorder.py``), the tracer's flag-driven
autostart, the lock witness (``observability/lock_witness.py``), the OOM
forensics (``observability/memory.py`` ``is_oom_error`` / ``oom_dump``),
the scrape endpoint's ``/readyz`` with ``set_ready_probe``, and the
breaker's flight-recorder note.

The scenarios are the reference's (tests/test_trace_context.py ``:414``,
``:482``; tests/test_concurrency_lint.py ``:230-300``;
tests/test_observability.py ``:256``; tests/test_memory_observability.py
``:211``). Where a file is written, the same scenario runs through the
JAX package's module and the port's, and the files must have the same
layout: the same names, the same keys on every line and in every
document (the port's memdump adds ``device``). ``tools/trace_collect.py``
(a stdlib tool) merges spools of both packages into one trace.

Each side has its own registries, flags and fault sites: a JAX flag or
fault plan never reaches the port's modules, nor the reverse.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import memory as jmem
from paddle_tpu.observability import spool as jspool
from paddle_tpu.observability import trace_context as jtctx
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch import flags
from paddle_tpu_torch.distributed.resilience import CircuitBreaker
from paddle_tpu_torch.observability import exporters
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability import memory
from paddle_tpu_torch.observability import spool
from paddle_tpu_torch.observability import trace_context as tctx
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": dict(spool=jspool, fr=jfr, tctx=jtctx, tracing=jtracing,
                     faults=jfaults),
         "port": dict(spool=spool, fr=flight_recorder, tctx=tctx,
                      tracing=tracing, faults=faults)}


def _trace_collect():
    path = os.path.join(REPO, "tools", "trace_collect.py")
    spec = importlib.util.spec_from_file_location("trace_collect", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# -- the span spool -----------------------------------------------------------

def _spool_pair(side, d):
    """tests/test_trace_context.py:414 on one side: a client span whose
    traceparent a 'server' spool's two spans continue."""
    m = SIDES[side]
    client = m["spool"].SpanSpool(d, role=f"client_{side}")
    m["tracing"].add_sink(client)
    with m["tctx"].client_span("rpc.call"):
        header = m["tctx"].current().to_traceparent()
    m["tracing"].remove_sink(client)
    client.close()
    server = m["spool"].SpanSpool(d, role=f"server_{side}")
    m["tracing"].add_sink(server)
    with m["tctx"].activate(m["tctx"].from_traceparent(header)):
        with m["tctx"].span("server.handle"):
            with m["tctx"].span("server.work", rows=2):
                time.sleep(0.001)
    m["tracing"].remove_sink(server)
    server.close()
    return client.path, server.path


def test_spool_format_matches_the_reference_and_merges(tmp_path):
    """The port's spool files carry the reference's lines key for key;
    trace_collect's gate passes over the port's pair, and a JAX client's
    spool chains into the port's server spans (and the reverse)."""
    tc = _trace_collect()
    d = str(tmp_path / "spools")
    files = {side: _spool_pair(side, d) for side in SIDES}
    for jpath, ppath in zip(files["jax"], files["port"]):
        assert os.path.basename(ppath) == \
            os.path.basename(jpath).replace("_jax.", "_port.")
        jl, pl = _lines(jpath), _lines(ppath)
        assert [sorted(r) for r in pl] == [sorted(r) for r in jl]
        assert [r.get("name") for r in pl] == [r.get("name") for r in jl]
    meta, spans, torn = tc.load_spool(files["port"][0])
    assert meta["role"] == "client_port" and torn == 0
    assert spans[0]["name"] == "rpc.call"
    assert len(spans[0]["trace_id"]) == 32
    assert tc.check(list(files["port"])) == []
    # across the packages: the wire's traceparent is the same
    cross = str(tmp_path / "cross")
    client = jspool.SpanSpool(cross, role="client")
    jtracing.add_sink(client)
    with jtctx.client_span("rpc.call"):
        header = jtctx.current().to_traceparent()
    jtracing.remove_sink(client)
    client.close()
    server = spool.SpanSpool(cross, role="replica")
    tracing.add_sink(server)
    with tctx.activate(tctx.from_traceparent(header)):
        with tctx.span("server.handle"):
            pass
    tracing.remove_sink(server)
    server.close()
    paths = tc.find_spools(cross)
    assert tc.check(paths, chain=["client", "replica"]) == []
    flows = [e for e in tc.merge(paths)["traceEvents"]
             if e.get("ph") in ("s", "f")]
    assert sorted(e["ph"] for e in flows) == ["f", "s"]


def test_spool_autostart_from_flags(tmp_path):
    """:482 -- tracing.active() consults the spool flags once: the path
    a spawned replica takes (env only, no API calls)."""
    d = str(tmp_path / "auto")
    flags.set("trace_spool_dir", d)
    flags.set("trace_role", "autorole")
    prev = tracing._autostart_done
    tracing._autostart_done = False
    try:
        assert tctx.active()             # autostarts the spool sink
        with tctx.span("auto.span"):
            pass
        sp = spool.current()
        assert sp is not None and sp.role == "autorole"
    finally:
        spool.shutdown()
        tracing._autostart_done = prev
        flags.reset("trace_spool_dir")
        flags.reset("trace_role")
    files = os.listdir(d)
    assert files == [f"autorole.{os.getpid()}.jsonl"]
    recs = _lines(os.path.join(d, files[0]))
    assert recs[0]["k"] == "meta"
    assert any(r.get("name") == "auto.span" for r in recs[1:])


# -- the flight recorder ------------------------------------------------------

def _record(side, d):
    """One recorder on one side: a span, a note, a fault fire, an
    explicit dump, the excepthook's dump; returns (dump doc, black box
    lines, paths)."""
    m = SIDES[side]
    rec = m["fr"].ensure_started(directory=d, role=f"rec_{side}",
                                 capacity=8)
    try:
        assert m["fr"].current() is rec
        with m["tctx"].span("fr.span"):
            pass
        m["fr"].note("breadcrumb", replica=3)
        with m["faults"].active("serving.handle:delay@1:s=0"):
            m["faults"].inject("serving.handle")
        fault_doc = json.loads(open(rec.dump_path).read())
        path = m["fr"].dump("explicit")
        doc = json.loads(open(path).read())
        m["fr"]._excepthook(RuntimeError, RuntimeError("boom"), None)
        exc_doc = json.loads(open(rec.dump_path).read())
    finally:
        m["fr"].shutdown()
    assert m["fr"].current() is None
    return (fault_doc, doc, exc_doc, _lines(rec.blackbox_path),
            rec.dump_path, rec.blackbox_path)


def test_flight_recorder_matches_the_reference(tmp_path, capsys):
    """The ring, the black box and the atomic dump: the same files, the
    same document keys and event kinds as the reference's recorder; the
    fault observer dumps before the effect; the excepthook dumps."""
    got = {side: _record(side, str(tmp_path / side)) for side in SIDES}
    for side, (fault_doc, doc, exc_doc, bb, dump_path, bb_path) in \
            got.items():
        assert os.path.basename(dump_path) == \
            f"rec_{side}.{os.getpid()}.dump.json"
        assert bb_path == dump_path.replace(".dump.json",
                                            ".blackbox.jsonl")
        assert fault_doc["reason"] == "fault"
        assert doc["reason"] == "explicit" and exc_doc["reason"] == \
            "exception"
        assert [e["kind"] for e in bb] == \
            ["start", "span", "note", "fault", "exception"]
        assert fault_doc["faults"]["serving.handle"]["hits"] == 1
        assert len(doc["events"]) == 4           # capacity 8, 4 so far
    (jf, jd, je, jbb, *_), (pf, pd, pe, pbb, *_) = got["jax"], got["port"]
    assert sorted(pd) == sorted(jd) and sorted(pf) == sorted(jf)
    assert [sorted(e) for e in pbb] == [sorted(e) for e in jbb]
    assert pd["memory"] == memory.device_census()
    assert "RuntimeError" in capsys.readouterr().err   # the chained hook


def test_flight_recorder_sigterm_dumps_and_dies_of_sigterm(tmp_path):
    """The SIGTERM dumper (main thread): dump, restore the disposition,
    re-kill -- the process still dies OF SIGTERM."""
    code = ("import os, signal, sys, time\n"
            "from paddle_tpu_torch.observability import flight_recorder\n"
            "flight_recorder.ensure_started(directory=sys.argv[1], "
            "role='victim')\n"
            "flight_recorder.note('about_to_die')\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "time.sleep(30)\n")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == -signal.SIGTERM, res.stderr
    (dump,) = [n for n in os.listdir(tmp_path) if n.endswith(".dump.json")]
    doc = json.loads(open(tmp_path / dump).read())
    assert doc["reason"] == "sigterm" and doc["role"] == "victim"
    assert [e["kind"] for e in doc["events"]] == ["start", "note",
                                                  "sigterm"]


def test_breaker_trip_is_noted_in_the_flight_recorder(tmp_path):
    rec = flight_recorder.ensure_started(directory=str(tmp_path),
                                         role="breaker")
    try:
        br = CircuitBreaker(failure_threshold=2, reset_timeout_s=60.0,
                            name="fleet-obs-test")
        br.record_failure()
        br.record_failure()
        br.record_failure()               # already open: one note only
    finally:
        flight_recorder.shutdown()
    notes = [e for e in _lines(rec.blackbox_path)
             if e.get("what") == "breaker_open"]
    assert notes == [dict(notes[0], breaker="fleet-obs-test", failures=2)]
    assert len(notes) == 1


# -- the lock witness ---------------------------------------------------------

@pytest.fixture
def witness():
    lock_witness.reset()
    flags.set("lock_witness", True)
    try:
        yield lock_witness
    finally:
        flags.reset("lock_witness")
        lock_witness.reset()


def test_witness_fires_on_inversion_with_both_stacks(witness):
    a = lock_witness.make_lock("W.a")
    b = lock_witness.make_lock("W.b")
    with a:
        with b:
            pass
    assert lock_witness.violations() == []
    before = lock_witness.declare_metrics().value
    with b:
        with a:              # W.b -> W.a closes the cycle
            pass
    bad = lock_witness.violations()
    assert len(bad) == 1, bad
    v = bad[0]
    assert v["held"] == "W.b" and v["acquiring"] == "W.a"
    assert "test_witness_fires_on_inversion" in v["stack_now"]
    assert "test_witness_fires_on_inversion" in v["prior_stack"]
    assert v["thread"] and v["prior_thread"]
    assert lock_witness.declare_metrics().value == before + 1
    assert set(lock_witness.edges()) == {("W.a", "W.b"), ("W.b", "W.a")}


def test_witness_off_records_nothing_and_ignores_the_jax_flag():
    """Off by default; the JAX package's flag does not arm the port's
    witness (each side reads its own registry)."""
    lock_witness.reset()
    assert not flags.get("lock_witness")
    jflags.set("lock_witness", True)
    try:
        a = lock_witness.make_lock("Off.a")
        b = lock_witness.make_lock("Off.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    finally:
        jflags.reset("lock_witness")
    assert lock_witness.edges() == {}
    assert lock_witness.violations() == []


def test_witness_same_name_is_reentrant_not_inversion(witness):
    l1 = lock_witness.make_lock("_Replica.lock")
    l2 = lock_witness.make_lock("_Replica.lock")
    with l1:
        with l2:
            pass
    with l2:
        with l1:
            pass
    assert lock_witness.violations() == []


def test_witness_dumps_flight_recorder(witness, tmp_path):
    rec = flight_recorder.ensure_started(directory=str(tmp_path),
                                         role="witness_test")
    try:
        a = lock_witness.make_lock("FR.a")
        b = lock_witness.make_lock("FR.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert len(lock_witness.violations()) == 1
        doc = json.loads(open(rec.dump_path).read())
        assert doc["reason"] == "lock_witness"
        notes = [e for e in doc["events"]
                 if e.get("kind") == "note"
                 and e.get("what") == "lock_witness_violation"]
        assert len(notes) == 1
        assert notes[0]["held"] == "FR.b" and notes[0]["stack_now"]
    finally:
        flight_recorder.shutdown()


# -- OOM forensics ------------------------------------------------------------

@pytest.mark.parametrize("exc,oom", [
    (MemoryError("host"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: while allocating"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("shape mismatch"), False),
    (ConnectionError("peer gone"), False),
])
def test_is_oom_error_as_the_reference(exc, oom):
    assert memory.is_oom_error(exc) is oom
    assert jmem.is_oom_error(exc) is oom


def test_is_oom_error_knows_the_cuda_allocator_error():
    err = torch.cuda.OutOfMemoryError("Tried to allocate")
    assert memory.is_oom_error(err)


def test_oom_dump_writes_the_reference_memdump(tmp_path):
    """tests/test_memory_observability.py:211 without the executor: the
    memdump lands as ``<role>.<pid>.memdump.json`` beside the recorder's
    dump, atomically (no .tmp left), with the reference's keys (the
    port's adds ``device``), counted in paddle_oom_events_total; the
    recorder notes it and dumps with reason oom. A CPU process's census
    is empty."""
    docs = {}
    for side, mod, fr in (("jax", jmem, jfr), ("port", memory,
                                               flight_recorder)):
        d = tmp_path / side
        fr.ensure_started(directory=str(d), role=f"mem_{side}")
        try:
            if side == "port":
                c0 = memory.OOM_EVENTS.labels(program="lm").value
                path = memory.oom_dump(MemoryError("injected"),
                                       program="lm")
                assert memory.OOM_EVENTS.labels(
                    program="lm").value == c0 + 1
            else:
                path = jmem.oom_dump(None, None, MemoryError("injected"))
        finally:
            fr.shutdown()
        assert path == str(d / f"mem_{side}.{os.getpid()}.memdump.json")
        assert sorted(os.listdir(d)) == sorted(
            [os.path.basename(path), f"mem_{side}.{os.getpid()}.dump.json",
             f"mem_{side}.{os.getpid()}.blackbox.jsonl"])
        docs[side] = json.loads(open(path).read())
        rec = json.loads(open(d / f"mem_{side}.{os.getpid()}.dump.json")
                         .read())
        assert rec["reason"] == "oom"
        assert any(e.get("what") == "oom" for e in rec["events"])
    assert sorted(docs["port"]) == sorted(list(docs["jax"]) + ["device"])
    doc = docs["port"]
    assert doc["reason"] == "oom" and doc["exc_type"] == "MemoryError"
    assert doc["error"] == "injected" and doc["program"] == "lm"
    assert doc["compiled"] is None and doc["role"] == "mem_port"
    if not torch.cuda.is_initialized():
        assert doc["device"] == {} and doc["total_bytes"] == 0


def test_oom_dump_gated_on_a_directory_and_never_raises(tmp_path):
    assert flight_recorder.current() is None
    assert memory.oom_dump(MemoryError("no dir")) is None
    flags.set("flight_recorder_dir", str(tmp_path))
    try:
        path = memory.oom_dump(MemoryError("flag dir"))
        assert path is not None and os.path.exists(path)
        blocked = tmp_path / "file"
        blocked.write_text("")
        flags.set("flight_recorder_dir", str(blocked / "under_a_file"))
        assert memory.oom_dump(MemoryError("unwritable")) is None
    finally:
        flags.reset("flight_recorder_dir")


# -- /readyz and set_ready_probe ---------------------------------------------

def test_scrape_endpoint_readyz_probe():
    """tests/test_observability.py:256: GET /readyz reflects the
    registered probe (200 / 503), defaults to ready with no probe, and a
    RAISING probe reads as not-ready; /healthz stays liveness only."""
    srv = exporters.MetricsServer(port=0)
    url = f"http://127.0.0.1:{srv.port}/readyz"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200
        ready = [False]
        exporters.set_ready_probe(lambda: ready[0])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 503
        ready[0] = True
        with urllib.request.urlopen(url, timeout=5) as r:
            assert r.status == 200 and r.read() == b"ready\n"

        def boom():
            raise RuntimeError("probe crashed")
        exporters.set_ready_probe(boom)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=5)
        assert ei.value.code == 503, "a broken probe must read not-ready"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            assert r.status == 200
    finally:
        exporters.set_ready_probe(None)
        srv.stop()


def test_scrape_shows_the_fleet_catalog_at_zero():
    """The exporter's catalog: the router, autoscaler, OOM and witness
    families render before their first event."""
    flags.set("metrics_port", 0)
    try:
        assert exporters.ensure_started()
        port = exporters.active_server().port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
    finally:
        exporters.shutdown()
        flags.reset("metrics_port")
    for fam in ("paddle_router_requests_total",
                "paddle_router_replica_restarts_total",
                "paddle_autoscaler_decisions_total",
                "paddle_oom_events_total",
                "paddle_lock_witness_violations_total"):
        assert f"# TYPE {fam} " in body, fam


# -- imports ------------------------------------------------------------------

def test_fleet_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import paddle_tpu_torch.flags\n"
            "import paddle_tpu_torch.observability.spool\n"
            "import paddle_tpu_torch.observability.flight_recorder\n"
            "import paddle_tpu_torch.observability.lock_witness\n"
            "import paddle_tpu_torch.observability.memory\n"
            "import paddle_tpu_torch.observability.tracing\n"
            "import paddle_tpu_torch.observability.exporters\n"
            "import paddle_tpu_torch.distributed.resilience\n"
            "import paddle_tpu_torch.serving.metrics\n"
            "import paddle_tpu_torch.serving.server\n"
            "import paddle_tpu_torch.serving.replica\n"
            "import paddle_tpu_torch.serving.router\n"
            "import paddle_tpu_torch.serving.autoscaler\n"
            "import paddle_tpu_torch.ops.embed_cache\n"
            "from paddle_tpu_torch import serving\n"
            "serving.Router, serving.Autoscaler, serving.bin_pack\n"
            "serving.replica.build_engine\n"
            "paddle_tpu_torch.observability.tracing.active()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
