"""The PyTorch port's model server, in process, against the JAX package's
(paddle_tpu/serving/server.py) and its engines.

The scenarios are tests/test_serving.py's (``:374-437`` on a stub
engine, ``:543`` the join / leave parity, ``:581`` the seeded streams,
``:641`` the slot metrics) and tests/test_kv_pool.py's (``:210`` the
page-pool gauges, ``:490-520`` the page-exhaustion put-back), at their
``_LM_CFG``: vocab 32, d_model 16, 2 heads, 2 layers, prompt_len 8,
max_new 8, slot prompt buckets 4/8, 4 slots. The JAX engines are built
once per module; their weights (``build_decoder_lm_programs``, seed 7)
are read from the wave engine's scope and carried across with
``params_from_jax``. Token streams must be EQUAL: at these widths no two
logits lie near a tie (tests/test_torch_wave_engine.py).

The coalesce, shed, dedup, drain and error-kind cases host a numpy stub
engine (``name``, ``policy``, ``warmup``, ``infer``) on the JAX server
and on the port's, and must give the same outcomes on both
(``ServedModel``, the saved-model engine of this wave, has its own tests
in ``tests/test_torch_served_model.py``).
"""

import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import bucketing as jbk
from paddle_tpu.serving import engine as jeng
from paddle_tpu.serving import metrics as jsm
from paddle_tpu.serving import server as jsrv

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import server as tsrv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CFG = dict(prompt_len=8, max_new=8, vocab=32, d_model=16, d_inner=32,
              n_head=2, n_layer=2)
LM = {k: LM_CFG[k] for k in ("vocab", "d_model", "d_inner", "n_head",
                             "n_layer")}
CACHE_LEN = LM_CFG["prompt_len"] + LM_CFG["max_new"]
SLOT_BUCKETS = (4, 8)
SPEC_K = 3
SIDES = {"jax": (jsrv, jsm, jbk), "port": (tsrv, tsm, tbk)}


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def jx():
    """The JAX engines, each built on first use and kept for the module,
    and the weights of their shared scope."""
    built = {}

    def get(key):
        if key not in built:
            if key == "wave":
                progs = jT.build_decoder_lm_programs(**LM_CFG)
                built[key] = jserving.GenerativeModel(
                    "lm_srv_wave", progs, jserving.BucketPolicy((2, 4)))
                built[key].warmup()
                names = [p.name for p in progs["decode"][0].global_block()
                         .all_parameters()]
                built["params"] = {n: np.asarray(
                    built[key].scope.find_var(n)) for n in names}
            else:
                spec = key == "spec"
                layout = "paged" if spec else "contiguous"
                built[key] = jeng.make_slot_model(
                    f"lm_srv_{key}", jT.build_decoder_lm_programs(
                        **LM_CFG, prompt_buckets=SLOT_BUCKETS,
                        modes=jT.slot_modes(layout, spec=spec), n_slots=4,
                        page_size=4 if spec else None,
                        spec_k=SPEC_K if spec else None))
                built[key].warmup()
        e = built[key]
        if key != "wave":
            e.reset()
            e.drafter = jeng.NgramDrafter()
        return e

    def params():
        get("wave")
        return built["params"]
    get.params = params
    return get


def _lm(params, cache_len=CACHE_LEN):
    lm = tT.DecoderLM(**LM, cache_len=cache_len, device="cpu")
    lm.load_state_dict(convert.params_from_jax(params))
    return lm


def _slots(params, layout="contiguous", name=None, **kw):
    e = teng.make_slot_model(name or f"lm_port_{layout}", _lm(params),
                             n_slots=kw.pop("n_slots", 4),
                             prompt_buckets=SLOT_BUCKETS, layout=layout,
                             device="cpu", **kw)
    e.warmup()
    return e


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 32, (int(n),)) for n in lengths]


def _assert_streams_equal(want, got, label=""):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{label} {i}")


# -- the slot scheduler (tests/test_serving.py:543, :581) ---------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_slot_server_concurrent_join_leave_parity(jx, layout):
    """:543: staggered concurrent submits with mixed budgets (and one EOS
    early leave) through the port's server over the port's slot engine
    each equal the JAX wave engine's sequential stream."""
    gm = jx("wave")
    engine = _slots(jx.params(), layout)
    server = tsrv.ModelServer()
    server.add_model(engine, warmup=False)
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 32, (int(rng.randint(3, 9)),))
               for _ in range(8)]
    budgets = [int(rng.randint(2, 9)) for _ in range(8)]
    oracle = [gm.generate([p], max_new=m)[0]
              for p, m in zip(prompts, budgets)]
    try:
        futs = []
        for i, p in enumerate(prompts):
            futs.append(server.submit_generate(engine.name, [p],
                                               max_new=budgets[i]))
            if i % 3 == 0:
                time.sleep(0.003)
        outs = [f.result(60)[0] for f in futs]
        eos = int(oracle[0][1])
        (cut,) = server.generate(engine.name, [prompts[0]],
                                 max_new=budgets[0], eos_id=eos)
        for o, ref, m in zip(outs, oracle, budgets):
            np.testing.assert_array_equal(o, ref[:m])
        assert len(cut) <= 2 and int(cut[-1]) == eos
        np.testing.assert_array_equal(cut, oracle[0][:len(cut)])
        assert engine.active_count() == 0
        if layout == "paged":
            assert engine.pool.free_count() + engine.pool.cached_count() \
                == engine.n_pages
    finally:
        server.stop()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_server_seeded_streams_match_the_jax_slot_engine(jx, layout):
    """:581: sampled requests with explicit seeds, one prompt a request
    and three prompts in one request (prompt i samples with seed + i),
    equal the JAX slot engine's seeded streams."""
    prompts = _prompts(13, (6, 6, 6))
    seeds = [101, 102, 103]
    kw = dict(max_new=8, temperature=0.8, top_k=5)
    want = jx("slot").generate(prompts, seeds=seeds, **kw)
    engine = _slots(jx.params(), layout)
    server = tsrv.ModelServer()
    server.add_model(engine, warmup=False)
    try:
        futs = [server.submit_generate(engine.name, [p], seed=s, **kw)
                for p, s in zip(prompts, seeds)]
        _assert_streams_equal(want, [f.result(60)[0] for f in futs],
                              "one a request")
        _assert_streams_equal(want, server.generate(
            engine.name, prompts, seed=seeds[0], **kw), "one request")
    finally:
        server.stop()


# -- pages before slots (tests/test_kv_pool.py:490-520) -----------------------

def test_server_queues_when_pages_exhausted(jx):
    """:500: a pool of 4 pages holds one bucket-8 admission (span 3) at a
    time while 4 slots stay free: the overflow queues (the prompt goes
    back to the head) and every request completes, each with the
    oracle's stream, every page back at the end."""
    engine = _slots(jx.params(), "paged", name="lm_port_paged_tiny",
                    page_size=4, n_pages=4)
    server = tsrv.ModelServer(linger_s=0.001, max_queue_depth=64)
    server.add_model(engine, warmup=False)
    prompts = [[i + 1, 2, 3] for i in range(5)]
    try:
        futs = [server.submit_generate(engine.name, [p], max_new=8)
                for p in prompts]
        outs = [f.result(120)[0] for f in futs]
    finally:
        server.stop()
    want = [jx("wave").generate([p], max_new=8)[0] for p in prompts]
    _assert_streams_equal(want, outs, "queued")
    assert engine.pool.free_count() == 4


def test_server_maps_exhaustion_to_typed_wire_kind():
    """:490: a page-exhaustion shed maps to the wire kind "exhausted" (the
    isinstance scan must not stop at RuntimeError), and the port's map
    of error kinds is the JAX server's, class name by class name."""
    assert tsrv._ERROR_KINDS[teng.SlotExhaustedError] == "exhausted"
    err = teng.SlotExhaustedError("x")
    kind = next(k for klass, k in tsrv._ERROR_KINDS.items()
                if isinstance(err, klass))
    assert kind == "exhausted"
    assert [(c.__name__, k) for c, k in tsrv._ERROR_KINDS.items()] == \
        [(c.__name__, k) for c, k in jsrv._ERROR_KINDS.items()]


def test_dispatch_fault_fails_the_request_and_frees_its_pages(jx):
    """The fault site ``serving.dispatch`` (before every model call, as
    the JAX engine's ``_run``): a raise at an admission's prefill fails
    that request with the injected error, counted as outcome "error";
    the page lease is aborted, and the same request then gets the
    oracle's stream."""
    from paddle_tpu_torch.utils import faults
    engine = _slots(jx.params(), "paged", name="lm_port_fault",
                    page_size=4)
    server = tsrv.ModelServer()
    server.add_model(engine, warmup=False)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    e0 = tsm.REQUESTS.labels(model=engine.name, outcome="error").value
    try:
        with faults.active("serving.dispatch:raise@1:exc=RuntimeError"):
            with pytest.raises(RuntimeError, match="serving.dispatch"):
                server.generate(engine.name, [prompt], max_new=6)
            assert faults.stats()["serving.dispatch"]["fired"] == 1
        assert engine.active_count() == 0
        assert engine.pool.free_count() == engine.n_pages
        (toks,) = server.generate(engine.name, [prompt], max_new=6)
    finally:
        faults.reset()
        server.stop()
    np.testing.assert_array_equal(toks,
                                  jx("wave").generate([prompt], max_new=6)[0])
    assert tsm.REQUESTS.labels(model=engine.name,
                               outcome="error").value == e0 + 1


# -- the wave batcher ------------------------------------------------------------

def test_wave_engine_on_the_batcher_matches_the_jax_server(jx):
    """The port's wave engine hosted on the port's wave batcher and the
    JAX wave engine on the JAX server: the same concurrent greedy
    requests give the same streams, each the JAX engine's own, and both
    servers coalesced them into fewer batches than requests."""
    prompts = _prompts(21, (3, 8, 5, 6, 2, 7))
    budgets = [5, 8, 3, 8, 6, 4]
    jgm = jx("wave")
    want = [jgm.generate([p], max_new=m)[0] for p, m in zip(prompts,
                                                            budgets)]
    port = teng.GenerativeModel("lm_port_wave", _lm(jx.params()), (8,),
                                tbk.BucketPolicy((2, 4)))
    got = {}
    for side, engine in (("jax", jgm), ("port", port)):
        srv_mod, sm, _ = SIDES[side]
        server = srv_mod.ModelServer(linger_s=0.2)
        server.add_model(engine, warmup=side == "port")
        b0 = sm.BATCHES.labels(model=engine.name).value
        try:
            futs = [server.submit_generate(engine.name, [p], max_new=m)
                    for p, m in zip(prompts, budgets)]
            got[side] = [f.result(60)[0] for f in futs]
        finally:
            server.stop()
        assert sm.BATCHES.labels(model=engine.name).value - b0 < 6, side
        assert sm.BATCH_OCCUPANCY.labels(model=engine.name).value > 0
    _assert_streams_equal(want, got["jax"], "jax server")
    _assert_streams_equal(want, got["port"], "port server")


# -- the stub engine on both servers (tests/test_serving.py:374-437) ----------

class StubEngine:
    """A numpy engine both servers can host: rows in, two outputs per
    row out; a negative input raises ValueError."""

    def __init__(self, name, policy):
        self.name = name
        self.policy = policy
        self.calls = []

    def warmup(self):
        return {"dispatched": 0}

    def infer(self, feeds):
        x = np.asarray(feeds["x"], np.float32)
        self.calls.append(len(x))
        if (x < 0).any():
            raise ValueError("negative input")
        return [x * 2.0 + 1.0, x.sum(axis=1)]


def _stub_server(side, name, buckets=(1, 4), **kw):
    srv_mod, sm, bk = SIDES[side]
    engine = StubEngine(f"{name}_{side}", bk.BucketPolicy(buckets))
    server = srv_mod.ModelServer(**kw)
    hosted = server.add_model(engine)
    return server, hosted, engine, srv_mod, sm


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stub_coalesces_requests(side):
    """:374: concurrent single-row submits coalesce into fewer batches
    than requests, and every caller gets exactly its own rows."""
    server, _, engine, _, sm = _stub_server(side, "stub_batch",
                                            linger_s=0.2)
    b0 = sm.BATCHES.labels(model=engine.name).value
    a0 = sm.REQUESTS_APPLIED.labels(model=engine.name).value
    rng = np.random.RandomState(6)
    xs = [rng.rand(1, 8).astype(np.float32) for _ in range(4)]
    try:
        futs = [server.submit_infer(engine.name, {"x": x}) for x in xs]
        outs = [f.result(30) for f in futs]
    finally:
        server.stop()
    for x, (y, s) in zip(xs, outs):
        np.testing.assert_array_equal(y, x * 2.0 + 1.0)
        np.testing.assert_array_equal(s, x.sum(axis=1))
    assert sm.BATCHES.labels(model=engine.name).value - b0 < 4
    assert sum(engine.calls) == 4 and len(engine.calls) < 4
    assert sm.REQUESTS_APPLIED.labels(model=engine.name).value - a0 == 4
    assert sm.BATCH_OCCUPANCY.labels(model=engine.name).value > 0


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stub_sheds_at_queue_depth_bound(side):
    """:397: a full queue sheds (typed, counted), an oversized request is
    shed, an unknown model is ModelNotFoundError."""
    server, hosted, engine, srv_mod, sm = _stub_server(side, "stub_shed",
                                                       buckets=(1,))
    hosted.max_queue_depth = 0
    shed0 = sm.REQUESTS.labels(model=engine.name, outcome="shed").value
    try:
        with pytest.raises(srv_mod.RequestShedError):
            server.submit_infer(engine.name,
                                {"x": np.zeros((1, 8), np.float32)})
        assert sm.REQUESTS.labels(model=engine.name,
                                  outcome="shed").value == shed0 + 1
        hosted.max_queue_depth = 8
        with pytest.raises(srv_mod.RequestShedError):
            server.submit_infer(engine.name,
                                {"x": np.zeros((5, 8), np.float32)})
        with pytest.raises(srv_mod.ModelNotFoundError):
            server.submit_infer("nope", {"x": np.zeros((1, 8), np.float32)})
    finally:
        server.stop()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stub_request_id_dedup(side):
    """:419: a resubmit with the same request_id is answered from the
    idempotency cache: the applied counter moves once."""
    server, _, engine, _, sm = _stub_server(side, "stub_dedup")
    x = {"x": np.ones((1, 8), np.float32)}
    a0 = sm.REQUESTS_APPLIED.labels(model=engine.name).value
    try:
        out1 = server.infer(engine.name, x, request_id="req-1")
        out2 = server.infer(engine.name, x, request_id="req-1")
    finally:
        server.stop()
    np.testing.assert_array_equal(out1[0], out2[0])
    assert sm.REQUESTS_APPLIED.labels(model=engine.name).value == a0 + 1
    assert len(engine.calls) == 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stub_drain_gate(side):
    """The drain gate: after ``drain`` new work is refused with
    ReplicaDrainingError (counted as outcome "drained"), readiness drops,
    and a retry of a settled request is still answered (the dedup checks
    come before the gate)."""
    server, _, engine, srv_mod, sm = _stub_server(side, "stub_drain")
    server.mark_ready()
    x = {"x": np.ones((1, 8), np.float32)}
    d0 = sm.REQUESTS.labels(model=engine.name, outcome="drained").value
    try:
        done = server.infer(engine.name, x, request_id="before")
        assert server.ready
        drained, duration = server.drain(timeout_s=5.0)
        assert drained and duration >= 0 and not server.ready
        with pytest.raises(srv_mod.ReplicaDrainingError):
            server.submit_infer(engine.name, x)
        assert sm.REQUESTS.labels(model=engine.name,
                                  outcome="drained").value == d0 + 1
        again = server.infer(engine.name, x, request_id="before")
        np.testing.assert_array_equal(done[0], again[0])
    finally:
        server.stop()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_stub_engine_error_settles_the_wave(side):
    """An engine error fails every request of its wave with that error
    (counted as outcome "error"); the batcher lives on and serves the
    next request."""
    server, _, engine, _, sm = _stub_server(side, "stub_err")
    e0 = sm.REQUESTS.labels(model=engine.name, outcome="error").value
    try:
        with pytest.raises(ValueError, match="negative"):
            server.infer(engine.name, {"x": -np.ones((1, 8), np.float32)})
        y, _ = server.infer(engine.name, {"x": np.ones((1, 8), np.float32)})
    finally:
        server.stop()
    np.testing.assert_array_equal(y, np.full((1, 8), 3.0, np.float32))
    assert sm.REQUESTS.labels(model=engine.name,
                              outcome="error").value == e0 + 1


# -- telemetry (tests/test_serving.py:641, tests/test_kv_pool.py:210) ---------

FAMILIES = ("PREFILLS", "DECODE_STEPS", "TOKENS_GENERATED",
            "SLOT_ADMISSIONS", "SPEC_PROPOSED", "SPEC_ACCEPTED")


def _family_reading(sm, name):
    out = {f: getattr(sm, f).labels(model=name).value for f in FAMILIES}
    for cause in ("eos", "max_new", "cancelled"):
        out[f"evict_{cause}"] = sm.SLOT_EVICTIONS.labels(
            model=name, cause=cause).value
    for cause in ("capacity", "reset"):
        out[f"kv_evict_{cause}"] = sm.KV_PAGE_EVICTIONS.labels(
            model=name, cause=cause).value
    tps = sm.TOKENS_PER_STEP.labels(model=name)
    out["tokens_per_step"] = (tps.count, tps.sum)
    return out


def _gauges(sm, name):
    return {"occupancy": sm.SLOT_OCCUPANCY.labels(model=name).value,
            "pages_total": sm.KV_PAGES_TOTAL.labels(model=name).value,
            "pages_free": sm.KV_PAGES_FREE.labels(model=name).value,
            "shared": sm.KV_PREFIX_SHARED_PAGES.labels(model=name).value}


def _schedule(engine, sm):
    """A known admission schedule on a paged spec engine: three joins
    (two share a full prompt page; one carries an EOS), a step, a
    cancel, two more joins, steps to the end. Returns the family deltas
    and the gauges at two points, and the streams."""
    engine.reset()
    before = _family_reading(sm, engine.name)
    prompts = [[3, 1, 4, 1, 5, 9], [3, 1, 4, 1, 2, 6, 5], [7, 7, 2],
               [3, 1, 4, 1, 8], [9, 2, 6, 5, 3, 5, 8, 9]]
    budgets = [8, 6, 5, 7, 8]
    streams = {i: [] for i in range(len(prompts))}
    owner = {}

    def join(i, eos_id=None):
        slot, first, done = engine.admit(prompts[i], seed=10 + i,
                                         temperature=0.7 if i == 2 else 0.0,
                                         top_k=4, max_new=budgets[i],
                                         eos_id=eos_id)
        streams[i].append(first)
        if not done:
            owner[slot] = i

    def step():
        for slot, tok, done in engine.step():
            streams[owner[slot]].append(tok)
            if done:
                del owner[slot]
    join(0)
    join(1)
    join(2, eos_id=9)
    mid = _gauges(sm, engine.name)
    step()
    cancel = next(s for s, i in owner.items() if i == 0)
    engine.release(cancel, cause="cancelled")
    del owner[cancel]
    join(3)
    join(4)
    while owner:
        step()
    after = _family_reading(sm, engine.name)
    delta = {k: (tuple(a - b for a, b in zip(after[k], before[k]))
                 if isinstance(after[k], tuple) else after[k] - before[k])
             for k in after}
    return delta, mid, _gauges(sm, engine.name), streams


def test_metric_families_match_jax_on_a_known_schedule(jx):
    """The families the engines and the page pool update (prefills,
    decode / verify dispatches, tokens, admissions, evictions by cause,
    spec proposed / accepted, tokens per step, occupancy, the KV page
    gauges and evictions) move on a known admission schedule exactly as
    the JAX paged spec engine's, with the same streams; a scrape of the
    port's MetricsServer shows them and /healthz answers."""
    jdelta, jmid, jend, jstreams = _schedule(jx("spec"), jsm)
    port = _slots(jx.params(), "paged", name="lm_port_sched", page_size=4,
                  spec_k=SPEC_K)
    tdelta, tmid, tend, tstreams = _schedule(port, tsm)
    assert {i: [int(t) for t in s] for i, s in tstreams.items()} == \
        {i: [int(t) for t in s] for i, s in jstreams.items()}
    assert tdelta == jdelta
    assert (tmid, tend) == (jmid, jend)
    assert tdelta["SLOT_ADMISSIONS"] == 5 and tdelta["evict_cancelled"] == 1
    assert tdelta["SPEC_PROPOSED"] >= tdelta["SPEC_ACCEPTED"]
    assert tmid["shared"] == 1 and tend["pages_free"] < tend["pages_total"]

    msrv = texp.MetricsServer(port=0)
    try:
        base = f"http://{msrv.endpoint}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert urllib.request.urlopen(base + "/healthz",
                                      timeout=10).status == 200
    finally:
        msrv.stop()
    m = 'model="lm_port_sched"'
    for line in (
            f'paddle_serving_prefills_total{{{m}}} '
            f'{int(tsm.PREFILLS.labels(model="lm_port_sched").value)}',
            f'paddle_serving_slot_admissions_total{{{m}}}',
            f'paddle_serving_decode_steps_total{{{m}}}',
            f'paddle_serving_tokens_generated_total{{{m}}}',
            f'paddle_serving_spec_proposed_tokens_total{{{m}}}',
            f'paddle_serving_spec_accepted_tokens_total{{{m}}}',
            f'paddle_serving_tokens_per_step_bucket{{{m},le="1"}}',
            f'paddle_serving_slot_evictions_total{{{m},cause="cancelled"}} 1',
            f'paddle_serving_decode_slot_occupancy_ratio{{{m}}} 0',
            f'paddle_kv_pages_total{{{m}}} {int(tend["pages_total"])}',
            f'paddle_kv_pages_free{{{m}}} {int(tend["pages_free"])}',
            f'paddle_kv_prefix_shared_pages{{{m}}}'):
        assert line in body, line


def test_server_slot_latency_families_count_the_schedule(jx):
    """:641: through the port's server, one TTFT observation a request,
    an inter-token one for every later token, one latency and one
    applied request each; the percentile helpers read them."""
    engine = _slots(jx.params(), "contiguous", name="lm_port_latency")
    name = engine.name
    server = tsrv.ModelServer()
    server.add_model(engine, warmup=False)
    c0 = {f: getattr(tsm, f).labels(model=name).count
          for f in ("TTFT", "INTER_TOKEN", "REQUEST_LATENCY", "QUEUE_WAIT")}
    a0 = tsm.REQUESTS_APPLIED.labels(model=name).value
    n_req, budget = 3, 5
    try:
        futs = [server.submit_generate(name, [p], max_new=budget)
                for p in _prompts(15, (5, 5, 5))]
        assert all(len(f.result(60)[0]) == budget for f in futs)
    finally:
        server.stop()
    got = {f: getattr(tsm, f).labels(model=name).count - c0[f] for f in c0}
    assert got == {"TTFT": n_req, "INTER_TOKEN": n_req * (budget - 1),
                   "REQUEST_LATENCY": n_req, "QUEUE_WAIT": n_req}
    assert tsm.REQUESTS_APPLIED.labels(model=name).value - a0 == n_req
    assert tsm.histogram_percentile(tsm.TTFT, 0.99, model=name) > 0
    assert tsm.latency_percentile(name, 0.5) > 0
    assert tsm.queue_wait_percentile(name, 0.5) > 0


# -- C8: the slot engine's policy -------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_slot_engine_policy_is_the_jax_engines(layout):
    """C8: a slot engine carries ``policy = BucketPolicy((n_slots,))`` as
    the JAX engine does (``paddle_tpu/serving/engine.py:740``); the
    server reads it for the most prompts a request may carry and reports
    it as ``buckets``."""
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")
    e = teng.make_slot_model("m", lm, n_slots=2, prompt_buckets=SLOT_BUCKETS,
                             layout=layout, device="cpu")
    assert isinstance(e.policy, tbk.BucketPolicy)
    assert e.policy.batch_buckets == jbk.BucketPolicy((2,)).batch_buckets
    server = tsrv.ModelServer()
    hosted = server.add_model(e)
    try:
        assert hosted.max_rows == 2
        assert server.stats()["m"]["buckets"] == [2]
        with pytest.raises(tsrv.RequestShedError):
            server.submit_generate("m", [[1], [2], [3]], max_new=2)
    finally:
        server.stop()


def test_server_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import paddle_tpu_torch.flags\n"
            "import paddle_tpu_torch.observability.metrics\n"
            "import paddle_tpu_torch.observability.tracing\n"
            "import paddle_tpu_torch.observability.trace_context\n"
            "import paddle_tpu_torch.observability.exporters\n"
            "import paddle_tpu_torch.utils.faults\n"
            "import paddle_tpu_torch.distributed.resilience\n"
            "import paddle_tpu_torch.serving.metrics\n"
            "import paddle_tpu_torch.serving.server\n"
            "import paddle_tpu_torch.serving.client\n"
            "from paddle_tpu_torch import serving\n"
            "serving.ModelServer, serving.ServingClient\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
