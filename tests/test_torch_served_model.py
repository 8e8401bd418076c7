"""The port's ``ServedModel`` (``paddle_tpu_torch/serving/engine.py``), in
process, behind the port's ``ModelServer`` and its wire, and as a
``kind: "saved"`` replica spawned by the port's ``Router``, against the
JAX ``ServedModel`` and predictor on the same saved directory, on the
CPU.

The model is a small classifier with two batch feeds, the LSTM's shape
of feed (``a`` [B, 5, 3] floats and ``seq_lens`` [B] int32, both padded
to the bucket): an AVERAGE sequence pool, an fc + relu and an fc +
softmax (the passes fuse both fc), saved by the JAX
``save_inference_model`` from its startup scope. Policy ``(1, 2, 4)``.
Fetches agree within ``TOL`` (rtol 1e-5 / atol 1e-6: one fp32 forward
whose sums run in another order on each side); a JAX result through
either side's wire equals the JAX engine's exactly.

One replica process is spawned in all (it imports torch, ~4 s). The
serving families are process-wide: counts are read as deltas.
"""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinf
from paddle_tpu.fluid import layers, unique_name
from paddle_tpu.serving import bucketing as jbk
from paddle_tpu.serving import client as jcli
from paddle_tpu.serving import engine as jeng
from paddle_tpu.serving import server as jsrv

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.inference import AnalysisConfig
from paddle_tpu_torch.observability import flight_recorder as trec
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import client as tcli
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import server as tsrv
from paddle_tpu_torch.serving.replica import build_engine
from paddle_tpu_torch.serving.router import Router
from paddle_tpu_torch.utils import faults as tfaults

TOL = dict(rtol=1e-5, atol=1e-6)
BUCKETS = (1, 2, 4)
T, D = 5, 3


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(directory, the JAX predictor) of the classifier."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = 5
    with jfluid.program_guard(main, startup), unique_name.guard():
        a = layers.data(name="a", shape=[T, D], dtype="float32")
        sl = layers.data(name="seq_lens", shape=[], dtype="int32")
        pooled = layers.sequence_pool(a, "average", seq_lens=sl)
        h = layers.fc(pooled, size=8, act="relu")
        prob = layers.fc(h, size=4, act="softmax")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path_factory.mktemp("clf"))
    jfluid.io.save_inference_model(d, ["a", "seq_lens"], [prob], exe,
                                   main_program=main, scope=scope)
    return d, jinf.PaddlePredictor(jinf.AnalysisConfig(model_dir=d))


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.standard_normal((n, T, D)).astype(np.float32),
            "seq_lens": rng.randint(1, T + 1, n).astype(np.int32)}


def _rows(feeds, i, j):
    return {k: v[i:j] for k, v in feeds.items()}


def _port(d, name="clf", buckets=BUCKETS):
    cfg = AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    return teng.ServedModel(name, d, tbk.BucketPolicy(buckets), cfg)


def test_pad_to_bucket_and_slice_outputs_match_jax():
    """The vote picks the batch feeds (the lengths pad too; a feed of
    another leading dim and a scalar stay), ``batch_names`` overrides it,
    and a scalar fetch passes the slice."""
    feeds = {"a": np.arange(12.0).reshape(3, 4), "seq_lens": np.arange(3),
             "table": np.ones((7, 2)), "step": np.array(5)}
    for names in (None, ["a"]):
        got, n = tbk.pad_to_bucket(feeds, 4, batch_names=names)
        want, m = jbk.pad_to_bucket(feeds, 4, batch_names=names)
        assert n == m == 3 and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    outs = [np.arange(8.0).reshape(4, 2), np.array(1.5), np.ones(2)]
    for g, w in zip(tbk.slice_outputs(outs, 3), jbk.slice_outputs(outs, 3)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 4, 10])
def test_infer_pads_slices_and_chunks_as_jax(saved, n):
    """n rows in, n rows out: 3 pads to 4, 10 chunks 4 + 4 + 2 (one
    predictor run a chunk, each at its bucket); every run's feeds at a
    signature warmup dispatched."""
    d, _ = saved
    port = _port(d)
    assert port.warmup() == {"dispatched": len(BUCKETS)}
    runs = []
    real_run = port.predictor.run

    def counted(feeds):
        runs.append(port._shape_sig(feeds))
        return real_run(feeds)
    port.predictor.run = counted
    jax = jeng.ServedModel("clf", d, jbk.BucketPolicy(BUCKETS))
    feeds = _feeds(n, seed=n)
    (got,), (want,) = port.infer(feeds), jax.infer(feeds)
    assert got.shape == want.shape == (n, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert len(runs) == -(-n // BUCKETS[-1])
    assert set(runs) <= port.warmed


def test_warmup_dispatches_every_bucket_as_jax(saved, tmp_path):
    """The port dispatches each bucket once; the JAX engine (no AOT
    persisted) compiles each once."""
    d, _ = saved
    jax = jeng.ServedModel("clf", d, jbk.BucketPolicy(BUCKETS))
    counts = jax.warmup(aot_dir=str(tmp_path), persist=False)
    port = _port(d)
    assert port.warmup()["dispatched"] == \
        counts["loaded"] + counts["compiled"] == len(BUCKETS)
    assert port.row_specs == jax.row_specs == {
        "a": ((T, D), "float32"), "seq_lens": ((), "int32")}


def test_server_coalesces_dedups_and_sheds(saved):
    """A port ModelServer hosting the port's ServedModel: four single-row
    submits coalesce into fewer batches and each caller gets its row of
    the predictor's result; a resubmitted request id is applied once; a
    batch above the largest bucket is shed."""
    d, jp = saved
    served = _port(d, "clf_srv")
    server = tsrv.ModelServer(linger_s=0.2)
    server.add_model(served)
    name = served.name
    feeds = _feeds(4, seed=11)
    want = jp.run(feeds)[0]
    b0 = tsm.BATCHES.labels(model=name).value
    a0 = tsm.REQUESTS_APPLIED.labels(model=name).value
    try:
        futs = [server.submit_infer(name, _rows(feeds, i, i + 1))
                for i in range(4)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(30)[0], want[i:i + 1],
                                       **TOL)
        assert tsm.BATCHES.labels(model=name).value - b0 < 4
        first = server.infer(name, _rows(feeds, 0, 2), request_id="r-1")
        again = server.infer(name, _rows(feeds, 0, 2), request_id="r-1")
        np.testing.assert_array_equal(first[0], again[0])
        assert tsm.REQUESTS_APPLIED.labels(model=name).value - a0 == 5
        with pytest.raises(tsrv.RequestShedError):
            server.submit_infer(name, _feeds(5))
    finally:
        server.stop()


def test_the_wire_both_ways(saved):
    """The JAX client against the port's server hosting the port's
    ServedModel, and the port's client against the JAX server hosting the
    JAX ServedModel: both give the JAX engine's rows."""
    d, _ = saved
    jax = jeng.ServedModel("clf_wire", d, jbk.BucketPolicy(BUCKETS))
    feeds = _feeds(3, seed=12)
    want = jax.infer(feeds)[0]
    port_server = tsrv.ModelServer()
    port_server.add_model(_port(d, "clf_wire"))
    jax_server = jsrv.ModelServer()
    jax_server.add_model(jax, warmup=False)
    try:
        got = jcli.ServingClient(port_server.serve()).infer("clf_wire",
                                                            feeds)
        np.testing.assert_allclose(got[0], want, **TOL)
        got = tcli.ServingClient(jax_server.serve()).infer("clf_wire", feeds)
        np.testing.assert_array_equal(got[0], want)
    finally:
        port_server.stop()
        jax_server.stop()


def test_oom_in_infer_leaves_the_memdump_under_the_models_name(saved,
                                                                tmp_path):
    """An OOM inside a run goes through the executor's except path: the
    memdump and ``paddle_oom_events_total`` under the ServedModel's name,
    then the error goes on."""
    d, _ = saved
    port = _port(d, "clf_oom")
    before = tmem.OOM_EVENTS.labels(program="clf_oom").value
    tflags.set("flight_recorder_dir", str(tmp_path))
    try:
        with tfaults.active("executor.dispatch:raise@1:exc=MemoryError"):
            with pytest.raises(MemoryError):
                port.infer(_feeds(2))
    finally:
        tflags.reset("flight_recorder_dir")
        trec.shutdown()
    dumps = [f for f in os.listdir(tmp_path) if f.endswith(".memdump.json")]
    assert len(dumps) == 1, dumps
    assert tmem.OOM_EVENTS.labels(program="clf_oom").value == before + 1


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("FLAGS_flight_recorder_dir", "FLAGS_trace_spool_dir",
              "FLAGS_fault_plan", "FLAGS_trace_role"):
        monkeypatch.delenv(k, raising=False)


def test_saved_replica_behind_the_router(saved, tmp_path, clean_env):
    """The port's router spawns one ``kind: "saved"`` replica over the
    JAX-saved directory (``device: "cpu"``); through the router's wire
    it gives the JAX predictor's rows, and it drains and exits 0. A spec
    with an ``aot_dir`` raises."""
    d, jp = saved
    spec = {"model": {"kind": "saved", "name": "clf_fleet",
                      "model_dir": d, "buckets": list(BUCKETS),
                      "device": "cpu"}}
    with pytest.raises(NotImplementedError, match="A6.8"):
        build_engine(dict(spec["model"], aot_dir=str(tmp_path)))
    router = Router(spec=spec, replicas=1, workdir=str(tmp_path / "fleet"))
    router.start()
    try:
        assert router.wait_ready(timeout_s=120), router.stats()
        client = tcli.ServingClient(router.serve())
        for n, seed in ((1, 13), (3, 14)):
            feeds = _feeds(n, seed)
            got = client.infer("clf_fleet", feeds)
            np.testing.assert_allclose(got[0], jp.run(feeds)[0], **TOL)
        proc = router._replicas[0].proc
    finally:
        router.stop()
    assert proc.wait(timeout=30) == 0
