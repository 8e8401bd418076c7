"""The PyTorch port's replica process (``paddle_tpu_torch/serving/replica.py``)
spawned by the port's router, against the JAX package's slot engine.

One spec drives both packages: the reference's replica spec (its
``decoder_lm`` ``params``, tests/test_chaos_router.py's tiny widths:
vocab 32, d_model 16, 2 heads, 2 layers, prompt_len 8, max_new 8) plus
the port's ``weights`` -- an ``.npz`` saved from the JAX startup scope of
the same seed (7) -- and ``device: "cpu"``. The JAX engine the reference's
``build_engine`` builds from those params is built here in process, once
per module; the port's replica, spawned by the port's ``Router``, must
give its streams (greedy and seeded) token for token (at these widths no
two logits lie near a tie: tests/test_torch_serving_server.py).

Two cases spawn replica subprocesses, three processes in all (each
imports torch): the streams case, and the OOM case -- a replica whose
spec sets ``oom_exit`` and a fault plan raising ``MemoryError`` at its
first post-warmup ``serving.dispatch`` exits 42 without a reply, leaves
``replica.<pid>.memdump.json`` in its flight-recorder directory, and is
classified ``cause="oom"`` and replaced ONCE with the fallback spec,
which then answers the request the dead replica dropped. Every wait has
a deadline; the router families are read as deltas.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import engine as jeng

from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as smetrics
from paddle_tpu_torch.serving.client import ServingClient
from paddle_tpu_torch.serving.replica import build_engine
from paddle_tpu_torch.serving.router import Router

PARAMS = dict(prompt_len=8, max_new=8, vocab=32, d_model=16, d_inner=32,
              n_head=2, n_layer=2, n_slots=2)
# the contiguous slot engine's warmup dispatches its one prompt bucket
# and the decode step: hit 3 of serving.dispatch is the first admission
FIRST_ADMISSION_HIT = 3


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The JAX slot engine exactly as the reference's replica builds it
    from ``PARAMS`` (``replica.py:54-78``), warmed, and its weights
    saved as the port spec's ``.npz``."""
    progs = jT.build_decoder_lm_programs(
        name="lm", modes=("prefill_slot", "decode_slot"), **PARAMS)
    m = jeng.SlotGenerativeModel("lm", progs)
    m.warmup()
    names = [p.name for p in progs["decode_slot"][0].global_block()
             .all_parameters()]
    path = str(tmp_path_factory.mktemp("weights") / "lm.npz")
    np.savez(path, **{n: np.asarray(m.scope.find_var(n)) for n in names})
    return m, path


def _spec(weights, **top):
    return {"model": {"kind": "decoder_lm", "name": "lm",
                      "weights": weights, "device": "cpu",
                      "params": dict(PARAMS)}, **top}


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 32, (int(n),)) for n in lengths]


def _assert_streams_equal(want, got, label=""):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{label} {i}")


@pytest.fixture
def clean_env(monkeypatch):
    """The router gives each slot its own flight-recorder dir only when
    the environment names none."""
    for k in ("FLAGS_flight_recorder_dir", "FLAGS_trace_spool_dir",
              "FLAGS_fault_plan", "FLAGS_trace_role"):
        monkeypatch.delenv(k, raising=False)


# -- build_engine -------------------------------------------------------------

def test_build_engine_refuses_a_spec_without_weights():
    """A replica never serves the zeros a DecoderLM starts from."""
    spec = {"kind": "decoder_lm", "name": "lm", "device": "cpu",
            "params": dict(PARAMS)}
    with pytest.raises(ValueError, match="weights"):
        build_engine(spec)


@pytest.mark.parametrize("kind,match", [("saved", "A6"),
                                        ("mystery", "unknown model kind")])
def test_build_engine_refuses_saved_and_unknown_kinds(kind, match):
    """An unknown kind raises ValueError; a saved spec with an
    ``aot_dir`` raises NotImplementedError naming A6.8 (the saved kind
    itself is served since A6.2: tests/test_torch_served_model.py)."""
    with pytest.raises((ValueError, NotImplementedError), match=match):
        build_engine({"kind": kind, "name": "m", "model_dir": "/nowhere",
                      "aot_dir": "/nowhere/aot"})


def test_build_engine_maps_the_reference_params(jx):
    """The keys that pick the JAX views pick the port's layout: slot
    modes -> contiguous, paged modes -> paged with page_size / n_pages /
    kv_codec, spec_k -> the verify window, ``slots: false`` -> the wave
    engine over ``buckets``; the weights are the .npz's."""
    _, weights = jx
    spec = _spec(weights)["model"]
    e = build_engine(spec)
    assert isinstance(e, teng.ContiguousSlotGenerativeModel)
    assert (e.n_slots, e.prompt_buckets, e.cache_len) == (2, (8,), 16)
    with np.load(weights) as w:
        np.testing.assert_array_equal(e.model.emb.detach().numpy(),
                                      w["lm_emb"])
    paged = dict(spec, params=dict(
        PARAMS, modes=["prefill_paged", "decode_paged"], page_size=4,
        kv_codec="int8", spec_k=2, prompt_buckets=[4, 8]))
    e = build_engine(paged)
    assert isinstance(e, teng.PagedSlotGenerativeModel)
    assert (e.spec_k, e.prompt_buckets) == (2, (4, 8))
    assert e.geometry.page_size == 4 and e.geometry.kv_codec == "int8"
    wave = build_engine(dict(spec, slots=False, buckets=[1, 2, 4]))
    assert isinstance(wave, teng.GenerativeModel)
    assert wave.policy.batch_buckets == (1, 2, 4)
    cuda = dict(spec, device="cuda")
    if torch.cuda.is_available():
        assert build_engine(cuda).model.device.type == "cuda"
    else:                      # never a silent CPU replica
        with pytest.raises(RuntimeError, match="CUDA"):
            build_engine(cuda)


# -- spawned replicas ---------------------------------------------------------

def test_spawned_cpu_replica_gives_the_jax_engine_streams(jx, tmp_path,
                                                          clean_env):
    """The port's router spawns ``python -m paddle_tpu_torch.serving.
    replica`` from the spec; through the router's wire its greedy and
    seeded streams equal the JAX slot engine's; router.stop() SIGTERMs
    it, and it drains and exits 0."""
    m, weights = jx
    router = Router(spec=_spec(weights), replicas=1,
                    workdir=str(tmp_path / "fleet"))
    router.start()
    try:
        assert router.wait_ready(timeout_s=120), router.stats()
        rep = router.stats()["replicas"][0]
        assert rep["state"] == "ready" and rep["pid"] is not None
        assert router._replicas[0].proc.args[1:3] == [
            "-m", "paddle_tpu_torch.serving.replica"]
        client = ServingClient(router.serve())
        try:
            prompts = _prompts(3, (3, 4, 7, 8))
            got = [t for i in (0, 2)      # n_slots prompts a request
                   for t in client.generate("lm", prompts[i:i + 2],
                                            max_new=6)]
            _assert_streams_equal(m.generate(prompts, max_new=6), got,
                                  "greedy")
            kw = dict(max_new=8, temperature=0.8, top_k=5)
            sampled = _prompts(13, (6, 5))
            _assert_streams_equal(
                m.generate(sampled, seeds=[101, 102], **kw),
                client.generate("lm", sampled, seed=101, **kw), "seeded")
        finally:
            client.close()
    finally:
        router.stop()
    proc = router._replicas[0].proc
    assert proc.returncode == 0, "a SIGTERM'd replica drains and exits 0"


def test_oom_exit_replica_exits_42_and_is_replaced_once(jx, tmp_path,
                                                        clean_env):
    m, weights = jx
    plan = f"serving.dispatch:raise@{FIRST_ADMISSION_HIT}:exc=MemoryError"
    doomed = _spec(weights, oom_exit=True, env={"FLAGS_fault_plan": plan})
    fallback = _spec(weights, oom_exit=True)
    router = Router(specs=[doomed], workdir=str(tmp_path / "fleet"),
                    oom_fallback=fallback, route_deadline_s=120.0)
    oom0 = smetrics.ROUTER_RESTARTS.labels(cause="oom").value
    conn0 = smetrics.ROUTER_FAILOVERS.labels(cause="conn_error").value
    router.start()
    try:
        assert router.wait_ready(timeout_s=120), router.stats()
        r = router._replicas[0]
        dead_pid = r.proc.pid
        prompts = _prompts(3, (3, 4))
        resp = router.route({"method": "generate", "model": "lm",
                             "req_id": "oom-1",
                             "prompts": [p.tolist() for p in prompts],
                             "max_new": 6, "temperature": 0.0, "top_k": 0})
        assert resp.get("ok"), resp
        want = m.generate(prompts, max_new=6)
        assert [list(t) for t in resp["tokens"]] == \
            [list(map(int, w)) for w in want]
        assert smetrics.ROUTER_FAILOVERS.labels(
            cause="conn_error").value - conn0 >= 1, \
            "the dying replica dropped the request without a reply"
        assert r.proc.pid != dead_pid
        memdump = os.path.join(r.flight_dir,
                               f"replica.{dead_pid}.memdump.json")
        assert r.last_exit == {"code": 42, "cause": "oom",
                               "memdump": memdump}
        assert r.oom_replaced and r.spec == fallback
        assert smetrics.ROUTER_RESTARTS.labels(
            cause="oom").value - oom0 == 1, "replaced exactly once"
        doc = json.loads(open(memdump).read())    # complete on disk
        assert doc["reason"] == "oom" and doc["exc_type"] == "MemoryError"
        assert doc["pid"] == dead_pid and doc["role"] == "replica"
        assert doc["device"] == {} and doc["compiled"] is None
        assert not os.path.exists(memdump + ".tmp")
        st = router.stats()
        assert st["ready"] == 1 and st["replicas"][0]["restarts"] == 0
    finally:
        router.stop()
