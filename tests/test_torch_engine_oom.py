"""OOM forensics at the serving engines' dispatch site, on both sides
(ROADMAP C9): an OOM error at ``serving.dispatch`` leaves
``<role>.<pid>.memdump.json`` in the flight recorder's directory and one
``paddle_oom_events_total{program}`` count under the program label of the
reference (``paddle_tpu/serving/engine.py:269-270``, ``:750-751``), then
re-raises.

The smallest input of the roadmap: engines named ``oom_j`` (the contiguous
slot engine, ``make_slot_model``) and ``oom_w`` (the wave engine), vocab
32, d_model 16, d_inner 32, 2 heads, 2 layers, prompt_len 8 + max_new 8,
2 slots, slot prompt buckets 4 / 8; the fault plan
``serving.dispatch:raise@N:exc=MemoryError``; then
``generate([np.array([1, 2, 3])], max_new=2)``. Hit 1 is the prefill
(program ``oom_j.prefill_slot@4``, ``oom_w.prefill@8``), hit 2 the first
decode step (``oom_j.decode_slot``, ``oom_w.decode``). The weights do not
matter. Each side writes into a directory of its own (both name the file
by this process's pid).
"""

import builtins
import json
import os

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jT
from paddle_tpu.observability import flight_recorder as jrec
from paddle_tpu.observability import memory as jmem
from paddle_tpu.serving import engine as jeng
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.observability import flight_recorder as trec
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.utils import faults as tfaults

LM_CFG = dict(prompt_len=8, max_new=8, vocab=32, d_model=16, d_inner=32,
              n_head=2, n_layer=2)
SLOT_BUCKETS = (4, 8)
N_SLOTS = 2
# (engine, fault hit) -> the program label of the reference
CASES = {("slot", 1): "oom_j.prefill_slot@4",
         ("slot", 2): "oom_j.decode_slot",
         ("wave", 1): "oom_w.prefill@8", ("wave", 2): "oom_w.decode"}


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX engines, built once for the module."""
    slot = jeng.make_slot_model("oom_j", jT.build_decoder_lm_programs(
        **LM_CFG, prompt_buckets=SLOT_BUCKETS,
        modes=jT.slot_modes("contiguous"), n_slots=N_SLOTS))
    wave = jserving.GenerativeModel(
        "oom_w", jT.build_decoder_lm_programs(**LM_CFG),
        jserving.BucketPolicy((1, 2)))
    return {"slot": slot, "wave": wave}


def _port_engine(kind):
    lm = tT.DecoderLM(**{k: LM_CFG[k] for k in ("vocab", "d_model",
                                                "d_inner", "n_head",
                                                "n_layer")},
                      cache_len=LM_CFG["prompt_len"] + LM_CFG["max_new"],
                      device="cpu")
    if kind == "slot":
        return teng.make_slot_model("oom_j", lm, n_slots=N_SLOTS,
                                    prompt_buckets=SLOT_BUCKETS,
                                    device="cpu")
    return teng.GenerativeModel("oom_w", lm.to("cpu"),
                                prompt_buckets=(LM_CFG["prompt_len"],))


def _memdump(d):
    dumps = [f for f in os.listdir(d) if f.endswith(".memdump.json")]
    assert len(dumps) == 1, dumps
    with open(os.path.join(d, dumps[0])) as f:
        return json.load(f)


def _raise_at(engine, hit, faults, flags, recorder, d,
              exc="MemoryError"):
    """The plan armed at hit ``hit``, ``FLAGS_flight_recorder_dir`` at
    ``d``; a flight recorder that the flag started (span capture starts
    one the first time it is asked, ``tracing.active``) is shut down
    after, so the next test's directory is its own."""
    plan = f"serving.dispatch:raise@{hit}:exc={exc}"
    flags.set("flight_recorder_dir", d)
    try:
        with faults.active(plan):
            with pytest.raises(getattr(builtins, exc)):
                engine.generate([np.array([1, 2, 3])], max_new=2)
    finally:
        flags.reset("flight_recorder_dir")
        recorder.shutdown()


@pytest.mark.parametrize("kind,hit", sorted(CASES))
def test_dispatch_oom_leaves_the_references_memdump(kind, hit, tmp_path,
                                                    jax_engines):
    program = CASES[(kind, hit)]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jbefore = jmem.OOM_EVENTS.labels(program=program).value
    tbefore = tmem.OOM_EVENTS.labels(program=program).value

    jengine = jax_engines[kind]
    if kind == "slot":
        jengine.reset()
    _raise_at(jengine, hit, jfaults, jflags, jrec, jdir)
    _raise_at(_port_engine(kind), hit, tfaults, tflags, trec, tdir)

    for d, side in ((jdir, "jax"), (tdir, "port")):
        doc = _memdump(d)
        assert (doc["program"], doc["reason"], doc["exc_type"]) == (
            program, "oom", "MemoryError"), side
    assert jmem.OOM_EVENTS.labels(program=program).value == jbefore + 1
    assert tmem.OOM_EVENTS.labels(program=program).value == tbefore + 1


def test_no_memdump_without_an_oom(tmp_path):
    """Another error at the site goes on untouched: no memdump, no
    count."""
    d = str(tmp_path)
    before = tmem.OOM_EVENTS.labels(program="oom_j.prefill_slot@4").value
    _raise_at(_port_engine("slot"), 1, tfaults, tflags, trec, d,
              exc="RuntimeError")
    assert not [f for f in os.listdir(d) if f.endswith(".memdump.json")]
    assert tmem.OOM_EVENTS.labels(
        program="oom_j.prefill_slot@4").value == before
