"""The PyTorch port's serving wire: ``ServingClient`` against
``ModelServer`` over JSON/TCP, the fault plans of the reference's chaos
suite, and the one wire between the JAX package's client and server and
the port's.

The scenarios are tests/test_serving.py's ``:463`` (the round trip) and
tests/test_chaos_serving.py's (``:68-183`` and ``:328`` on a stub
engine: dropped connections ridden out, a lost reply applied at most
once, delays, a shed not retried, the breaker opening against a dead
server, the whole plan's counters; ``:229-320`` on a slot engine: a
cancel frees its slot within one step, a killed client frees its slot,
a retry joins the in-flight stream). Widths are tests/test_serving.py's
``_LM_CFG`` (vocab 32, d_model 16, 2 heads, 2 layers); the slot engine
of the cancel cases has a budget of 512 so that a cancel always races a
generation in flight. The JAX wave engine's weights (seed 7) are carried
into the port's models with ``params_from_jax``.

The fault plans arm the port's registry (``paddle_tpu_torch.utils.
faults``): the client and the server here are both the port's, except in
the cross-wire cases.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import bucketing as jbk
from paddle_tpu.serving import client as jcli
from paddle_tpu.serving import server as jsrv

from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import client as tcli
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import server as tsrv
from paddle_tpu_torch.utils import faults

LM_CFG = dict(prompt_len=8, max_new=8, vocab=32, d_model=16, d_inner=32,
              n_head=2, n_layer=2)
LM = {k: LM_CFG[k] for k in ("vocab", "d_model", "d_inner", "n_head",
                             "n_layer")}
CACHE_LEN = LM_CFG["prompt_len"] + LM_CFG["max_new"]
LONG = 512                       # the cancel cases' budget


@pytest.fixture(autouse=True)
def fp32_and_no_leaked_faults():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old
    faults.reset()


@pytest.fixture(scope="module")
def jwave():
    """The JAX wave engine (warmed) and the weights of its scope."""
    progs = jT.build_decoder_lm_programs(**LM_CFG)
    gm = jserving.GenerativeModel("lm_rpc_jwave", progs,
                                  jserving.BucketPolicy((2, 4)))
    gm.warmup()
    names = [p.name for p in progs["decode"][0].global_block()
             .all_parameters()]
    gm.params = {n: np.asarray(gm.scope.find_var(n)) for n in names}
    return gm


def _lm(params, cache_len=CACHE_LEN):
    lm = tT.DecoderLM(**LM, cache_len=cache_len, device="cpu")
    lm.load_state_dict(convert.params_from_jax(params))
    return lm


@pytest.fixture(scope="module")
def long_slot(jwave):
    """A 2-slot contiguous engine with a budget of 512 (the reference's
    chaos ``_slot_model``), shared by the cancel cases."""
    e = teng.make_slot_model("lm_rpc_long", _lm(jwave.params, 8 + LONG),
                             n_slots=2, prompt_buckets=(8,), device="cpu")
    e.warmup()
    return e


class StubEngine:
    """A numpy engine both servers host: rows in, x * 2 + 1 and the row
    sums out."""

    def __init__(self, name, policy):
        self.name = name
        self.policy = policy

    def warmup(self):
        return {"dispatched": 0}

    def infer(self, feeds):
        x = np.asarray(feeds["x"], np.float32)
        return [x * 2.0 + 1.0, x.sum(axis=1)]


@pytest.fixture
def served():
    """The port's server hosting the stub (``clf_chaos`` of the
    reference's suite), on an ephemeral port."""
    server = tsrv.ModelServer()
    server.add_model(StubEngine("stub_chaos", tbk.BucketPolicy((1, 2))))
    endpoint = server.serve()
    yield server, endpoint
    faults.reset()
    server.stop()


def _applied(name="stub_chaos"):
    return tsm.REQUESTS_APPLIED.labels(model=name).value


def _retries(what):
    return resilience.RETRY_ATTEMPTS.labels(what=what).value


def _wait(cond, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while not cond() and time.perf_counter() < deadline:
        time.sleep(0.002)
    return cond()


# -- the round trip (tests/test_serving.py:463) -------------------------------

def test_rpc_roundtrip(jwave):
    """:463, with the port's engines: ping, models, the stub's infer, a
    wave generate and a seeded slot generate over the wire equal the
    engines' in-process streams (the wave's the JAX engine's); a typed
    rejection crosses the wire; stats report the buckets."""
    wave = teng.GenerativeModel("lm_rpc_wave", _lm(jwave.params), (8,),
                                tbk.BucketPolicy((2, 4)))
    slots = teng.make_slot_model("lm_rpc_slots", _lm(jwave.params),
                                 n_slots=4, prompt_buckets=(4, 8),
                                 layout="paged", device="cpu")
    server = tsrv.ModelServer()
    for e in (StubEngine("stub_rpc", tbk.BucketPolicy((2,))), wave, slots):
        server.add_model(e)
    client = tcli.ServingClient(server.serve())
    try:
        assert client.ping()
        assert client.models() == ["lm_rpc_slots", "lm_rpc_wave",
                                   "stub_rpc"]
        x = np.random.RandomState(7).rand(2, 8).astype(np.float32)
        y, s = client.infer("stub_rpc", {"x": x})
        np.testing.assert_array_equal(y, x * 2.0 + 1.0)
        np.testing.assert_array_equal(s, x.sum(axis=1))
        prompt = list(range(1, 7))
        (toks,) = client.generate("lm_rpc_wave", [prompt], max_new=4)
        np.testing.assert_array_equal(
            toks, jwave.generate([prompt], max_new=4)[0])
        got = client.generate("lm_rpc_slots", [prompt, [3, 9]], max_new=6,
                              temperature=0.8, top_k=4, seed=21)
        server.model("lm_rpc_slots").stop()      # the engine to ourselves
        want = slots.generate([prompt, [3, 9]], max_new=6, temperature=0.8,
                              top_k=4, seeds=[21, 22])
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        with pytest.raises(tsrv.ModelNotFoundError):
            client.infer("missing", {"x": x})
        stats = client.stats()
        assert stats["stub_rpc"]["buckets"] == [2]
        assert stats["lm_rpc_slots"]["buckets"] == [4]
        assert stats["lm_rpc_slots"]["kind"] == "PagedSlotGenerativeModel"
    finally:
        client.close()
        server.stop()


def test_rpc_reply_carries_the_trace_id(long_slot):
    """With the tracer on, the reply carries the request's trace_id and
    every server span of the request -- handle, admission, queue wait,
    the prefill at its bucket, the decode steps, settle -- lies in the
    client's trace."""
    server = tsrv.ModelServer()
    server.add_model(long_slot, warmup=False)
    client = tcli.ServingClient(server.serve())
    tracer = tracing.default_tracer()
    tracer.reset()
    tracer.start()
    try:
        (toks,) = client.generate(long_slot.name, [[1, 2, 3]], max_new=3)
        assert len(toks) == 3
        tid = client.last_trace_id
        assert tid and len(tid) == 32
        names = {s.name for s in tracer.spans() if s.trace_id == tid}
    finally:
        tracer.stop()
        tracer.reset()
        client.close()
        server.stop()
    assert {"serving.generate", "serving.handle", "serving.admission",
            "serving.queue_wait", "serving.prefill@8",
            "serving.decode_step", "serving.settle"} <= names, names


def test_rpc_readyz_and_drain():
    """``readyz`` answers ready; ``drain`` answers drained and asks the
    host to exit after the reply; then ``readyz`` answers not ready and
    new work is refused as a typed shed."""
    server = tsrv.ModelServer()
    server.add_model(StubEngine("stub_drain_rpc", tbk.BucketPolicy((1,))))
    client = tcli.ServingClient(server.serve())
    try:
        rz = client._call({"method": "readyz"})
        assert rz["ready"] is True and rz["draining"] is False
        assert rz["models"] == ["stub_drain_rpc"]
        dr = client._call({"method": "drain", "timeout_s": 5.0})
        assert dr["drained"] is True and "_exit" not in dr
        assert server.wait_exit(5.0)
        rz = client._call({"method": "readyz"})
        assert rz["ready"] is False and rz["draining"] is True
        with pytest.raises(tsrv.RequestShedError):
            client.infer("stub_drain_rpc",
                         {"x": np.ones((1, 8), np.float32)})
        snap = client._call({"method": "metricz"})["metrics"]
        fam = snap["paddle_serving_requests_total"]["samples"]
        assert any(s["labels"] == {"model": "stub_drain_rpc",
                                   "outcome": "drained"} and s["value"] >= 1
                   for s in fam)
    finally:
        client.close()
        server.stop()


# -- the slot lifecycle under failure (tests/test_chaos_serving.py:229-320) ----

def test_cancel_over_the_wire_frees_the_slot_within_one_step(long_slot):
    """:229 over the wire: a cancel from a second client ends a
    generation in flight; its caller gets RequestCancelledError (kind
    ``cancelled``), the slot is free within one scheduler step and admits
    the next request."""
    server = tsrv.ModelServer()
    hosted = server.add_model(long_slot, warmup=False)
    endpoint = server.serve()
    name = long_slot.name
    c0 = tsm.SLOT_EVICTIONS.labels(model=name, cause="cancelled").value
    a, b = tcli.ServingClient(endpoint), tcli.ServingClient(endpoint)
    caught = []

    def run():
        try:
            a.generate(name, [np.arange(1, 6)], max_new=LONG - 12,
                       request_id="cancel-1")
        except BaseException as e:         # noqa: BLE001 - the witness
            caught.append(e)
    t = threading.Thread(target=run)
    try:
        t.start()
        assert _wait(lambda: long_slot.active_count() == 1)
        assert b.cancel(name, "cancel-1")
        steps0 = hosted.sched_steps          # the request is flagged now
        t.join(30)
        assert not t.is_alive()
        assert len(caught) == 1
        assert isinstance(caught[0], tsrv.RequestCancelledError)
        assert long_slot.active_count() == 0
        assert hosted.sched_steps - steps0 <= 1
        assert tsm.SLOT_EVICTIONS.labels(
            model=name, cause="cancelled").value - c0 == 1
        (toks,) = b.generate(name, [np.arange(1, 6)], max_new=4)
        assert len(toks) == 4
    finally:
        a.close()
        b.close()
        server.stop()


def test_killed_client_frees_its_slot_mid_generation(long_slot):
    """:260: a raw socket starts a long generation and dies; the handler
    sees the hang-up, cancels, and the slot frees."""
    server = tsrv.ModelServer()
    server.add_model(long_slot, warmup=False)
    host, port = server.serve().rsplit(":", 1)
    name = long_slot.name
    c0 = tsm.SLOT_EVICTIONS.labels(model=name, cause="cancelled").value
    try:
        s = socket.create_connection((host, int(port)), timeout=10)
        s.sendall((json.dumps(
            {"method": "generate", "model": name, "req_id": "kill-1",
             "prompts": [[1, 2, 3]], "max_new": LONG - 12}) + "\n")
            .encode())
        assert _wait(lambda: long_slot.active_count() == 1)
        time.sleep(0.05)
        s.close()
        assert _wait(lambda: long_slot.active_count() == 0)
        assert tsm.SLOT_EVICTIONS.labels(
            model=name, cause="cancelled").value - c0 == 1
    finally:
        server.stop()


def test_generate_retry_joins_the_inflight_stream(long_slot):
    """:293: a retried request_id joins the in-flight stream (one
    admission, one application) and is answered from the cache after it
    settles; over the wire a lost reply is applied once."""
    server = tsrv.ModelServer()
    server.add_model(long_slot, warmup=False)
    client = tcli.ServingClient(server.serve())
    name = long_slot.name
    adm0 = tsm.SLOT_ADMISSIONS.labels(model=name).value
    app0 = tsm.REQUESTS_APPLIED.labels(model=name).value
    try:
        f1 = server.submit_generate(name, [np.arange(1, 7)], max_new=40,
                                    request_id="retry-1")
        assert _wait(lambda: long_slot.active_count() > 0)
        f2 = server.submit_generate(name, [np.arange(1, 7)], max_new=40,
                                    request_id="retry-1")
        assert f1 is f2
        (t1,) = f1.result(60)
        assert len(t1) == 40
        (t2,) = server.generate(name, [np.arange(1, 7)], max_new=40,
                                request_id="retry-1")
        np.testing.assert_array_equal(t1, t2)
        assert tsm.SLOT_ADMISSIONS.labels(model=name).value - adm0 == 1
        assert tsm.REQUESTS_APPLIED.labels(model=name).value - app0 == 1
        with faults.active("serving.reply:raise@1:exc=ConnectionError"):
            (t3,) = client.generate(name, [np.arange(1, 7)], max_new=40,
                                    request_id="lost-1")
            assert faults.stats()["serving.reply"]["fired"] == 1
        np.testing.assert_array_equal(t3, t1)
        assert tsm.SLOT_ADMISSIONS.labels(model=name).value - adm0 == 2
        assert tsm.REQUESTS_APPLIED.labels(model=name).value - app0 == 2
    finally:
        client.close()
        server.stop()


# -- fault plans on the stub (tests/test_chaos_serving.py:68-183, :328) -------

def test_client_rides_dropped_connections(served):
    """:68: send faults on an exact schedule are retried with backoff;
    every request succeeds, the retry counter moves by the faults fired,
    and each request executed exactly once."""
    _, endpoint = served
    client = tcli.ServingClient(endpoint)
    x = np.random.RandomState(0).rand(1, 8).astype(np.float32)
    applied0, retries0 = _applied(), _retries("serving.infer")
    with faults.active("serving.rpc.send:raise@2,4:exc=ConnectionError"):
        for _ in range(3):
            (out, _) = client.infer("stub_chaos", {"x": x})
            np.testing.assert_array_equal(out, x * 2.0 + 1.0)
        assert faults.stats()["serving.rpc.send"]["fired"] == 2
    assert _retries("serving.infer") - retries0 == 2
    assert _applied() - applied0 == 3
    client.close()


def test_lost_reply_is_applied_at_most_once(served):
    """:94: the server executes, the reply is lost; the retry carries the
    same request_id and is answered from the idempotency cache."""
    _, endpoint = served
    client = tcli.ServingClient(endpoint)
    x = np.ones((1, 8), np.float32)
    applied0 = _applied()
    with faults.active("serving.reply:raise@1:exc=ConnectionError"):
        (out, _) = client.infer("stub_chaos", {"x": x})
        np.testing.assert_array_equal(out, x * 2.0 + 1.0)
        assert faults.stats()["serving.reply"]["fired"] == 1
    assert _applied() - applied0 == 1
    client.close()


def test_delayed_responses_ride_through(served):
    """:114: delays at the handle site slow requests down, break
    nothing, and retry nothing."""
    _, endpoint = served
    client = tcli.ServingClient(endpoint)
    x = np.ones((1, 8), np.float32)
    retries0 = _retries("serving.infer")
    with faults.active("serving.handle:delay@1,2:s=0.05"):
        t0 = time.perf_counter()
        client.infer("stub_chaos", {"x": x})
        client.infer("stub_chaos", {"x": x})
        elapsed = time.perf_counter() - t0
        assert faults.stats()["serving.handle"]["fired"] == 2
    assert elapsed >= 0.1
    assert _retries("serving.infer") == retries0
    client.close()


def test_shed_is_not_retried(served):
    """:131: a typed shed crosses the wire and surfaces at once; the
    retry counter does not move."""
    server, endpoint = served
    hosted = server.model("stub_chaos")
    hosted.max_queue_depth = 0
    client = tcli.ServingClient(endpoint)
    retries0 = _retries("serving.infer")
    with pytest.raises(tsrv.RequestShedError):
        client.infer("stub_chaos", {"x": np.ones((1, 8), np.float32)})
    assert _retries("serving.infer") == retries0
    hosted.max_queue_depth = 64
    client.close()


def test_breaker_opens_against_dead_server():
    """:148: a stopped server exhausts the retry budget once, trips the
    breaker, and later calls fast-fail while it cools down."""
    server = tsrv.ModelServer()
    server.add_model(StubEngine("stub_dead", tbk.BucketPolicy((1,))))
    endpoint = server.serve()
    server.stop()
    breaker = resilience.CircuitBreaker(
        failure_threshold=3, reset_timeout_s=30.0, name="serving_chaos_port")
    opens0 = resilience.BREAKER_OPENS.labels(name="serving_chaos_port").value
    client = tcli.ServingClient(
        endpoint,
        retry_policy=resilience.RetryPolicy(
            max_attempts=4, base_delay_s=0.005, max_delay_s=0.01,
            deadline_s=5.0, retryable=(ConnectionError, OSError)),
        breaker=breaker)
    with pytest.raises(tcli.ServingUnavailableError) as ei:
        client.infer("stub_dead", {"x": np.ones((1, 8), np.float32)})
    assert ei.value.attempts == 4
    assert breaker.state == resilience.CircuitBreaker.OPEN
    assert resilience.BREAKER_OPENS.labels(
        name="serving_chaos_port").value - opens0 == 1
    t0 = time.perf_counter()
    with pytest.raises(tcli.ServingUnavailableError):
        client.infer("stub_dead", {"x": np.ones((1, 8), np.float32)})
    assert time.perf_counter() - t0 < 2.0
    client.close()


def test_recv_fault_after_execution_dedups(served):
    """:183: a drop after the send is a lost reply: the retry dedups."""
    _, endpoint = served
    client = tcli.ServingClient(endpoint)
    applied0 = _applied()
    with faults.active("serving.rpc.recv:raise@1:exc=ConnectionError"):
        (out, _) = client.infer("stub_chaos",
                                {"x": np.full((1, 8), 0.5, np.float32)})
    assert out.shape == (1, 8)
    assert _applied() - applied0 == 1
    client.close()


def test_counters_match_the_full_fault_plan(served):
    """:328: client and server sites in one plan; faults fired, retries
    and applications match the schedule."""
    _, endpoint = served
    client = tcli.ServingClient(endpoint)
    rng = np.random.RandomState(1)
    n = 6
    applied0, retries0 = _applied(), _retries("serving.infer")
    plan = ("serving.rpc.send:raise@3:exc=ConnectionError;"
            "serving.reply:raise@2:exc=ConnectionError;"
            "serving.handle:delay@5:s=0.02")
    with faults.active(plan, seed_=7):
        for _ in range(n):
            (out, _) = client.infer(
                "stub_chaos", {"x": rng.rand(1, 8).astype(np.float32)})
            assert out.shape == (1, 8)
        st = faults.stats()
        assert [st[k]["fired"] for k in ("serving.rpc.send",
                                         "serving.reply",
                                         "serving.handle")] == [1, 1, 1]
    assert _retries("serving.infer") - retries0 == 2
    assert _applied() - applied0 == n
    client.close()


# -- one wire: the JAX package's client and server with the port's ----------

@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_one_wire_both_ways(jwave, direction):
    """The reference's ServingClient drives the port's ModelServer and the
    port's client drives the reference's: infer on the stub, a greedy
    generate (both servers' wave engines carry the same weights: the JAX
    engine's stream), ``readyz``, and a typed rejection surfacing as the
    client's own ModelNotFoundError."""
    if direction == "jax_client_port_server":
        srv_mod, bk, cli = tsrv, tbk, jcli
        wave = teng.GenerativeModel("lm_wire", _lm(jwave.params), (8,),
                                    tbk.BucketPolicy((2, 4)))
        not_found = jsrv.ModelNotFoundError
    else:
        srv_mod, bk, cli = jsrv, jbk, tcli
        wave = jwave
        not_found = tsrv.ModelNotFoundError
    server = srv_mod.ModelServer()
    server.add_model(StubEngine("stub_wire", bk.BucketPolicy((1, 2))))
    server.add_model(wave, warmup=wave is not jwave)
    client = cli.ServingClient(server.serve())
    try:
        assert client.ping()
        assert client._call({"method": "readyz"})["ready"] is True
        x = np.random.RandomState(3).rand(2, 8).astype(np.float32)
        y, s = client.infer("stub_wire", {"x": x})
        np.testing.assert_array_equal(y, x * 2.0 + 1.0)
        np.testing.assert_array_equal(s, x.sum(axis=1))
        prompts = [[5, 1, 19, 3], [7, 2]]
        got = client.generate(wave.name, prompts, max_new=6)
        want = jwave.generate(prompts, max_new=6)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        with pytest.raises(not_found):
            client.generate("missing", prompts, max_new=2)
    finally:
        client.close()
        server.stop()


def test_flags_start_the_endpoint_and_arm_a_fault_plan():
    """``FLAGS_metrics_port`` starts the scrape endpoint through
    ``ensure_started`` (idempotent; nothing without the flag), and
    ``FLAGS_fault_plan`` / ``FLAGS_fault_seed`` arm the registry through
    ``reload_from_flags``, parsed as the JAX flags parse them."""
    import urllib.request
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import exporters
    for name, value in (("metrics_port", "0"), ("fault_seed", "5"),
                        ("metrics_host", "127.0.0.1")):
        flags.set(name, value)
        jflags.set(name, value)
        assert flags.get(name) == jflags.get(name)
    flags.reset()
    jflags.reset()
    assert flags.get("metrics_port") == -1 and not exporters.ensure_started()
    flags.set("metrics_port", "0")
    flags.set("fault_plan", "serving.handle:delay@2:s=0.001")
    try:
        assert exporters.ensure_started() and exporters.ensure_started()
        srv = exporters.active_server()
        body = urllib.request.urlopen(f"http://{srv.endpoint}/metrics",
                                      timeout=10).read().decode()
        assert "# TYPE paddle_serving_requests_total counter" in body
        assert "# TYPE paddle_retry_attempts_total counter" in body
        faults.reload_from_flags()
        faults.inject("serving.handle")
        faults.inject("serving.handle")
        assert faults.stats()["serving.handle"] == {
            "hits": 2, "fired": 1, "mode": "delay"}
    finally:
        exporters.shutdown()
        flags.reset()
        faults.reset()
    assert exporters.active_server() is None
