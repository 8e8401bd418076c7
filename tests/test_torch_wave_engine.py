"""The PyTorch port's contiguous KV layout and wave engine, as a whole,
against the JAX package's engines (paddle_tpu/serving/engine.py
``GenerativeModel``, and ``SlotGenerativeModel`` over the contiguous
slot views, with and without the ``decode_verify`` view).

The scenarios are those of tests/test_serving.py (``:274-324``,
``:497-641``) and the contiguous half of tests/test_spec_decode.py
(``:108-204``), at their ``_LM_CFG``: vocab 32, d_model 16, 2 heads,
2 layers, prompt_len 8, max_new 8 (cache_len 16), slot prompt buckets
4/8, 4 slots, ``spec_k`` 3. The JAX engines are built once per module;
they share one scope's weights by name (``build_decoder_lm_programs``,
seed 7), which are read from the wave engine's scope and carried across
with ``params_from_jax``: one port ``DecoderLM`` serves every engine.

Token streams must be EQUAL: the samples are a function of the logits
and the counter-hash noise, which the port reproduces bit for bit, and
at these widths no two logits lie near a tie. ``decode_flops`` and
``full_forward_flops`` count products with ``FlopCounterMode`` and are
held to the reference's properties (flat in position, the full forward
at least 5x a decode step), not to XLA's counts.
"""

import itertools
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from paddle_tpu import serving
from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import engine as jeng

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CFG = dict(prompt_len=8, max_new=8, vocab=32, d_model=16, d_inner=32,
              n_head=2, n_layer=2)
LM = {k: LM_CFG[k] for k in ("vocab", "d_model", "d_inner", "n_head",
                             "n_layer")}
CACHE_LEN = LM_CFG["prompt_len"] + LM_CFG["max_new"]
SLOT_BUCKETS = (4, 8)
SPEC_K = 3


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

    def slot_progs(spec):
        return jT.build_decoder_lm_programs(
            **LM_CFG, prompt_buckets=SLOT_BUCKETS,
            modes=jT.slot_modes("contiguous", spec=spec), n_slots=4,
            spec_k=SPEC_K if spec else None)

    def get(key):
        if key not in built:
            if key == "wave":
                progs = jT.build_decoder_lm_programs(**LM_CFG)
                built[key] = serving.GenerativeModel(
                    "lm_port_wave", progs, serving.BucketPolicy((2, 4)))
                names = [p.name for p in progs["decode"][0].global_block()
                         .all_parameters()]
                built["params"] = {n: np.asarray(
                    built[key].scope.find_var(n)) for n in names}
            else:
                built[key] = jeng.make_slot_model(
                    f"lm_port_{key}", slot_progs(key == "spec"))
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


def _lm(params, cache_len=CACHE_LEN, device="cpu"):
    lm = tT.DecoderLM(**LM, cache_len=cache_len, device=device)
    lm.load_state_dict(convert.params_from_jax(params))
    return lm


_NAMES = itertools.count()


def _wave(params, prompt_buckets=(8,), policy=(2, 4), cache_len=CACHE_LEN):
    return teng.GenerativeModel(f"lm_wave{next(_NAMES)}",
                                _lm(params, cache_len),
                                prompt_buckets, tbk.BucketPolicy(policy))


def _slots(params, layout="contiguous", n_slots=4, spec_k=None,
           drafter=None, **kw):
    e = teng.make_slot_model(f"lm_slots{next(_NAMES)}", _lm(params),
                             n_slots=n_slots,
                             prompt_buckets=SLOT_BUCKETS, layout=layout,
                             spec_k=spec_k, drafter=drafter, device="cpu",
                             **kw)
    e.warmup()
    return e


def _counts(engine):
    """The engine's serving counters, read from the process-wide
    ``paddle_serving_*`` families under its name (the helpers name every
    engine afresh): prefills, decode steps, tokens, drafts proposed and
    accepted, and the tokens committed a slot a dispatch by count (the
    ``tokens_per_step`` buckets are one token wide up to 6)."""
    out = {k: int(f.labels(model=engine.name).value) for k, f in (
        ("prefills", tsm.PREFILLS), ("decode_steps", tsm.DECODE_STEPS),
        ("tokens_generated", tsm.TOKENS_GENERATED),
        ("spec_proposed", tsm.SPEC_PROPOSED),
        ("spec_accepted", tsm.SPEC_ACCEPTED))}
    per, prev = Counter(), 0
    for ub, cum in tsm.TOKENS_PER_STEP.labels(
            model=engine.name).snapshot()[0]:
        if cum > prev:
            per[ub] = cum - prev
        prev = cum
    out["tokens_per_step"] = per
    return out


def _assert_streams_equal(want, got, label=""):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{label} {i}")


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 32, (int(n),)) for n in lengths]


class _CannedDrafter:
    """tests/test_spec_decode.py's scripted proposer: the next k tokens
    of the true stream (prompt + the reference continuation)."""

    def __init__(self, target):
        self.target = [int(t) for t in target]

    def propose(self, tokens, k):
        n = len(tokens)
        assert self.target[:n] == [int(t) for t in tokens]
        return self.target[n:n + k]


# -- the wave engine (tests/test_serving.py:274-324, :614) -------------------

def test_wave_transcript_equals_full_forward_and_jax(jx):
    """:274: the greedy prefill + decode transcript equals the
    full-forward-per-token transcript, and the JAX wave engine's."""
    prompts = _prompts(3, (8, 8, 8, 8))
    want = jx("wave").generate(prompts, max_new=8)
    gm = _wave(jx.params())
    _assert_streams_equal(want, gm.generate(prompts, max_new=8), "wave")
    _assert_streams_equal(want, gm.full_forward_generate(prompts,
                                                         max_new=8), "full")
    c = _counts(gm)
    assert (c["prefills"], c["decode_steps"], c["tokens_generated"]) == \
        (1, 7, 32)


def test_wave_bucket_invariance(jx):
    """:287: short prompts in a larger prompt bucket generate the same
    tokens (cache_len 13 at bucket 5, 16 at bucket 8), the JAX engine's."""
    raw = _prompts(4, (3, 5, 4))
    want = jx("wave").generate(raw, max_new=6)
    at5 = _wave(jx.params(), (5,), (4,), cache_len=5 + LM_CFG["max_new"])
    at8 = _wave(jx.params(), (8,), (4,))
    _assert_streams_equal(want, at5.generate(raw, max_new=6), "bucket 5")
    _assert_streams_equal(want, at8.generate(raw, max_new=6), "bucket 8")


def test_decode_cost_flat_and_below_the_full_forward(jx):
    """:309: the decode step's FLOPs do not depend on the position, and a
    full forward at the serving length costs at least 5x one step."""
    gm = _wave(jx.params())
    f0 = gm.decode_flops(bucket=2, step=0)
    assert f0 > 0 and f0 == gm.decode_flops(bucket=2, step=7)
    full = gm.full_forward_flops(2)
    assert full / f0 >= 5.0, (full, f0)


def test_generate_rejects_overlong_prompt_and_budget(jx):
    """:324, on both engines."""
    for gm, too_long in ((jx("wave"), jeng.PromptTooLongError),
                         (_wave(jx.params()), teng.PromptTooLongError)):
        with pytest.raises(too_long):
            gm.generate([np.arange(1, 12)], max_new=2)   # 11 > bucket 8
        with pytest.raises(ValueError):
            gm.generate([np.arange(1, 5)], max_new=99)   # > cache budget


def test_prompt_ladder_parity_and_cost(jx):
    """:614: a wave engine over the ladder 4/8 warms three dispatches
    (prefill@4, prefill@8, decode), generates what the single-bucket JAX
    engine does, and prefills short prompts at bucket 4 for fewer FLOPs
    than at 8."""
    gml = _wave(jx.params(), (4, 8), (2,))
    assert gml.warmup() == {"dispatched": 3}
    short = _prompts(14, (3, 4))
    _assert_streams_equal(jx("wave").generate(short, max_new=6),
                          gml.generate(short, max_new=6), "ladder")

    def prefill_flops(p):
        with FlopCounterMode(display=False) as fc:
            gml.model.prefill(torch.zeros((2, p), dtype=torch.int64))
        return fc.get_total_flops()
    assert prefill_flops(4) < prefill_flops(8)


def test_bucket_policy_follows_the_jax_policy():
    from paddle_tpu.utils import padding as jpad
    for n in (1, 3, 7, 16, 40):
        assert tbk.BucketPolicy.pow2(16).batch_buckets == \
            serving.BucketPolicy.pow2(16).batch_buckets
        assert tbk.BucketPolicy((8, 2, 2)).chunks(n) == \
            serving.BucketPolicy((8, 2, 2)).chunks(n)
        rows = np.arange(n * 2).reshape(n, 2)
        np.testing.assert_array_equal(tbk.pad_rows(rows, 16),
                                      jpad.pad_rows(rows, 16))
    assert tbk.BucketPolicy().bucket_for(3) == 4
    with pytest.raises(ValueError, match="chunk"):
        tbk.BucketPolicy((2, 4)).bucket_for(5)


# -- the contiguous slot engine (tests/test_serving.py:497-611) --------------

def test_slot_random_arrivals_match_the_wave_oracle(jx):
    """:497: a randomized join/leave interleaving (random arrival order
    and admission counts, mixed budgets and prompt lengths across the
    ladder) gives each request the JAX wave engine's stream."""
    sgm = _slots(jx.params())
    rng = np.random.RandomState(11)
    n_req = 10
    prompts = [rng.randint(1, 32, (int(rng.randint(3, 9)),))
               for _ in range(n_req)]
    budgets = [int(rng.randint(2, 9)) for _ in range(n_req)]
    oracle = [jx("wave").generate([p], max_new=m)[0]
              for p, m in zip(prompts, budgets)]
    order = list(rng.permutation(n_req))
    collected, results, slot2idx = {}, {}, {}
    while order or slot2idx:
        k = int(rng.randint(0, sgm.free_count() + 1))
        if not slot2idx and order:
            k = max(k, 1)
        for _ in range(k):
            if not order:
                break
            i = order.pop(0)
            slot, first, done = sgm.admit(prompts[i], max_new=budgets[i])
            collected[i] = [first]
            if done:
                results[i] = collected[i]
            else:
                slot2idx[slot] = i
        for slot, tok, done in sgm.step():
            i = slot2idx[slot]
            collected[i].append(tok)
            if done:
                results[i] = collected[i]
                del slot2idx[slot]
    assert len(results) == n_req
    for i in range(n_req):
        np.testing.assert_array_equal(np.asarray(results[i], np.int64),
                                      oracle[i][:budgets[i]])
    assert sgm.active_count() == 0


def test_sampling_parity_and_fresh_engine_replay(jx):
    """:581: temperature 0 and top_k 1 equal the greedy wave oracle; a
    seeded sampled stream equals the JAX slot engine's and replays on a
    fresh port engine of 2 slots; other seeds give other streams."""
    prompts = _prompts(13, (6, 6, 6))
    greedy = [jx("wave").generate([p], max_new=8)[0] for p in prompts]
    sgm = _slots(jx.params())
    for kwargs in (dict(temperature=0.0), dict(temperature=0.9, top_k=1)):
        _assert_streams_equal(greedy, sgm.generate(prompts, max_new=8,
                                                   **kwargs), str(kwargs))
    kw = dict(max_new=8, temperature=0.8, top_k=5, seeds=[101, 102, 103])
    s1 = sgm.generate(prompts, **kw)
    _assert_streams_equal(jx("slot").generate(prompts, **kw), s1, "jax")
    _assert_streams_equal(s1, _slots(jx.params(), n_slots=2)
                          .generate(prompts, **kw), "replay")
    s3 = sgm.generate(prompts, **dict(kw, seeds=[7, 8, 9]))
    assert any((a != b).any() for a, b in zip(s1, s3))


def test_contiguous_and_paged_engines_give_the_same_streams(jx):
    """The fp32 contiguous and paged engines over one model: the same
    greedy and seeded streams (the paged decode is the contiguous one
    through the page gathers, bit for bit)."""
    prompts = _prompts(3, (3, 4, 7, 8, 5, 2))
    contiguous = _slots(jx.params())
    paged = _slots(jx.params(), "paged", page_size=4)
    for kw in (dict(max_new=8),
               dict(max_new=7, temperature=0.8, top_k=4,
                    seeds=[5, 2 ** 31 + 9, -3, 2 ** 40, 123456789, 0])):
        _assert_streams_equal(paged.generate(prompts, **kw),
                              contiguous.generate(prompts, **kw), str(kw))


# -- contiguous speculative decoding (tests/test_spec_decode.py:108-204) ----

def test_spec_greedy_streams_match_jax_and_the_plain_engine(jx):
    """:108: the contiguous spec engine == the JAX contiguous spec engine
    == the plain contiguous engine, token for token; the counters add
    up."""
    prompts = _prompts(3, (3, 4, 7, 8, 5, 2))
    want = jx("spec").generate(prompts, max_new=6)
    port = _slots(jx.params(), spec_k=SPEC_K)
    got = port.generate(prompts, max_new=6)
    _assert_streams_equal(want, got, "jax/port")
    _assert_streams_equal(_slots(jx.params()).generate(prompts, max_new=6),
                          got, "plain/spec")
    c = _counts(port)
    assert c["tokens_generated"] == 36 and c["prefills"] == 6
    assert sum(n * k for n, k in c["tokens_per_step"].items()) == 30
    assert c["spec_accepted"] <= c["spec_proposed"]


def test_spec_seeded_sampled_streams_match_and_replay(jx):
    """:150-187: the seeded contiguous spec stream equals the JAX spec
    engine's and the plain engine's, and replays."""
    prompts = _prompts(11, (3, 6, 8))
    kw = dict(max_new=7, temperature=0.8, top_k=0, seeds=[101, 202, 303])
    port = _slots(jx.params(), spec_k=SPEC_K)
    got = port.generate(prompts, **kw)
    _assert_streams_equal(jx("spec").generate(prompts, **kw), got, "jax")
    _assert_streams_equal(_slots(jx.params()).generate(prompts, **kw), got,
                          "plain/spec")
    _assert_streams_equal(got, port.generate(prompts, **kw), "replay")


def test_spec_eos_inside_a_window_ends_the_request(jx):
    """:190-204: an EOS inside an accepted window ends the request there,
    on both contiguous spec engines under the same scripted drafter."""
    base = _slots(jx.params())
    prompt = [5, 1, 19]
    ref = base.generate([prompt], max_new=8)[0]
    eos = int(ref[2])
    want = base.generate([prompt], max_new=8, eos_id=eos)[0]
    assert len(want) <= 3 and int(want[-1]) == eos
    target = list(prompt) + list(ref)
    port = _slots(jx.params(), spec_k=SPEC_K,
                  drafter=_CannedDrafter(target))
    np.testing.assert_array_equal(port.generate([prompt], max_new=8,
                                                eos_id=eos)[0], want)
    assert _counts(port)["spec_accepted"] > 0
    m = jx("spec")
    m.drafter = _CannedDrafter(target)
    np.testing.assert_array_equal(m.generate([prompt], max_new=8,
                                             eos_id=eos)[0], want)


# -- make_slot_model and imports ---------------------------------------------

def test_make_slot_model_layout_choice():
    """The default layout is the reference flag's, contiguous; a
    paged-only argument under it raises ValueError; the slot pool and the
    verify window are validated as for the paged layout."""
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")

    def make(**kw):
        return teng.make_slot_model("lm", lm, n_slots=kw.pop("n_slots", 4),
                                    prompt_buckets=SLOT_BUCKETS,
                                    device="cpu", **kw)
    e = make()
    assert isinstance(e, teng.ContiguousSlotGenerativeModel)
    assert (e.PREFILL, e.DECODE, e.VERIFY) == ("prefill_slot",
                                               "decode_slot",
                                               "decode_verify")
    assert e.cache.k[0].shape == (4, CACHE_LEN, 2, 8)
    assert e.cache.k[0].dtype == torch.float32
    assert isinstance(make(layout="paged"), teng.PagedSlotGenerativeModel)
    assert make(spec_k=SPEC_K).spec_k == SPEC_K
    for bad in (dict(page_size=4), dict(n_pages=16), dict(kv_codec="int8"),
                dict(kv_codec="bf16")):
        with pytest.raises(ValueError, match="paged"):
            make(**bad)
    for bad, match in ((dict(layout="ring"), "layout"),
                       (dict(n_slots=0), "n_slots"),
                       (dict(spec_k=0), "spec_k"),
                       (dict(spec_k=9), "window")):
        with pytest.raises(ValueError, match=match):
            make(**bad)


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import paddle_tpu_torch.serving.engine\n"
            "import paddle_tpu_torch.serving.bucketing\n"
            "import paddle_tpu_torch.ops.kv_attention\n"
            "import paddle_tpu_torch.models.transformer\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
