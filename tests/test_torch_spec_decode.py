"""The PyTorch port's speculative decoding on the paged layout
(paddle_tpu_torch: ``kv_attention_verify_paged``, the
``decode_verify_paged`` view, the slot engine's draft -> verify -> commit
step, ``NgramDrafter`` and ``ModelDrafter``) against the JAX package's
(paddle_tpu/serving/engine.py ``PagedSlotGenerativeModel`` with the
``decode_verify_paged`` view), on the CPU at tests/test_spec_decode.py's
geometry: vocab 32, d_model 16, 2 heads, 2 layers, prompt buckets 4/8,
cache_len 16, 4 slots, pages of 4 rows, ``spec_k`` 3. The weights are
read from the JAX engine's scope (built once per module) and carried
across with ``params_from_jax``.

Also the fp32 result of a bf16 product (``nn_ops.amp_product``) and its
hand-written backward against ``jax.vjp`` of the JAX ``mul`` under AMP.

Tolerances, with their reasons:
- token streams, drafts and the engine's counters: equal (the accept
  rule compares tokens; the samples are a function of the logits and the
  counter-hash noise, which the port reproduces bit for bit);
- the verify op's fp32 ``Out`` and written pool rows: rtol=atol=1e-5 (the
  two frameworks sum the dots in different orders); bf16 rows rtol 2e-2
  (one bf16 rounding of values an fp32 ulp apart); int8 rows within one
  quantization step; rows no write reaches: bit-identical;
- ``amp_product``: rtol 1e-5 / atol 1e-6 for the fp32 result and the
  gradients (fp32 sums of exact products in another order; each gradient
  is rounded to bf16 on both sides, and the same fp32 value rounds to the
  same bf16 value), and the smallest input exactly.

The tests marked ``gpu`` (``python3 -m pytest --noconftest -m gpu
tests/test_torch_spec_decode.py`` on the card; JAX is imported inside
fixtures, so they need none) hold the AMP product on the card: the
smallest input, the backward against the CPU formula and its fp32 sums
against fp64 beside a one-rounding control, the same bits
under either setting of ``allow_bf16_reduced_precision_reduction``, and
an fp32 result for every bf16 product of the AMP trainers' steps; and
the spec engine's streams on the card against the plain engine's.
"""

import importlib
import itertools
import os
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.ops import kv_attention as tkv
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab=32, d_model=16, d_inner=32, n_head=2, n_layer=2)
PROMPT_LEN, MAX_NEW, BUCKETS = 8, 8, (4, 8)
CACHE_LEN = PROMPT_LEN + MAX_NEW
GEOM = dict(n_slots=4, page_size=4)
SPEC_K = 3
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def jx():
    """The JAX side: the engines (built on first use, kept for the
    module), the verify op and the drafters."""
    jax = pytest.importorskip("jax")
    jT = importlib.import_module("paddle_tpu.models.transformer")
    jeng = importlib.import_module("paddle_tpu.serving.engine")
    serving = importlib.import_module("paddle_tpu.serving")
    jkv = importlib.import_module("paddle_tpu.ops.kv_attention")
    importlib.import_module("paddle_tpu.ops")         # the emitters
    cfg = dict(prompt_len=PROMPT_LEN, max_new=MAX_NEW, **LM)
    built = {}

    def spec_engine():
        if "spec" not in built:
            progs = jT.build_decoder_lm_programs(
                **cfg, prompt_buckets=BUCKETS,
                modes=jT.slot_modes("paged", spec=True), spec_k=SPEC_K,
                **GEOM)
            m = jeng.make_slot_model("lm_port_spec", progs)
            m.warmup()
            names = [p.name for p in progs["decode_verify_paged"][0]
                     .global_block().all_parameters()]
            built["spec"] = (m, {n: np.asarray(m.scope.find_var(n))
                                 for n in names})
        m, params = built["spec"]
        m.reset()
        m.drafter = jeng.NgramDrafter()
        return m, params

    def oracle():
        """The wave engine over the same weights: the JAX ModelDrafter
        needs its ``full`` view."""
        if "oracle" not in built:
            built["oracle"] = serving.GenerativeModel(
                "lm_port_spec_oracle", jT.build_decoder_lm_programs(**cfg),
                serving.BucketPolicy((2, 4)))
        return built["oracle"]
    return SimpleNamespace(jax=jax, jnp=jax.numpy, jeng=jeng, jkv=jkv,
                           spec_engine=spec_engine, oracle=oracle)


def _lm(params, device="cpu"):
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device=device)
    lm.load_state_dict(convert.params_from_jax(params))
    return lm


_NAMES = itertools.count()


def _port(params, spec_k=SPEC_K, drafter=None, device="cpu"):
    e = teng.make_slot_model(f"lm_spec_port{next(_NAMES)}",
                             _lm(params, device),
                             prompt_buckets=BUCKETS, layout="paged",
                             spec_k=spec_k, drafter=drafter, device=device,
                             **GEOM)
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


class _CannedDrafter:
    """tests/test_spec_decode.py's scripted proposer: it knows the true
    stream (prompt + the reference continuation), proposes its next k
    tokens and corrupts every position >= ``sched[call]``, so the
    accept / reject counts of each dispatch are known in advance."""

    def __init__(self, target, vocab, sched=None):
        self.target = [int(t) for t in target]
        self.vocab = int(vocab)
        self.sched = sched
        self.calls = 0

    def propose(self, tokens, k):
        n = len(tokens)
        assert self.target[:n] == [int(t) for t in tokens], \
            "engine committed a token off the reference stream"
        d = self.target[n:n + k]
        keep = len(d) if self.sched is None else self.sched[self.calls]
        self.calls += 1
        return [t if i < keep else (t + 1) % self.vocab
                for i, t in enumerate(d)]


def _assert_streams_equal(want, got, label=""):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"{label} {i}")


# -- the op ------------------------------------------------------------------

H, D = 2, 8
M = H * D
N_PAGES, PS, MP = 16, 4, 4          # flat pool of 64 rows; 16 cache rows
R = N_PAGES * PS
K1 = SPEC_K + 1


def _verify_feeds(rng):
    """Five slots. 0: a full window crossing from page 2 into page 3;
    1: a one-token window (plain decode), reading a prefix page it shares
    with slot 0; 2: a window running past the table's 16 rows (the last
    two positions drop); 3: inactive; 4: a window running past its
    3-page lease into the sentinel page (the last two positions drop)."""
    pages = rng.permutation(N_PAGES)
    table = np.full((5, MP), N_PAGES, np.int64)
    table[0] = pages[0:4]
    table[1, :2] = [pages[0], pages[4]]
    table[2] = pages[5:9]
    table[4, :3] = pages[9:12]
    return {"PageTable": table,
            "Pos": np.array([[9], [6], [14], [-1], [10]], np.int64),
            "SeqLen": np.array([[3], [4], [5], [0], [2]], np.int64),
            "GenStart": np.array([[4], [4], [8], [0], [4]], np.int64),
            "Active": np.array([[1], [1], [1], [0], [1]], np.int64),
            "WinLen": np.array([[4], [1], [4], [1], [4]], np.int64)}


def _pools(rng, codec):
    if codec == "int8":
        k = rng.randint(-127, 128, (N_PAGES, PS, H, D)).astype(np.int8)
        v = rng.randint(-127, 128, (N_PAGES, PS, H, D)).astype(np.int8)
        ks = np.abs(rng.randn(N_PAGES, PS, H)).astype(np.float32) * 0.01
        vs = np.abs(rng.randn(N_PAGES, PS, H)).astype(np.float32) * 0.01
        return [k, v, ks, vs]
    k = rng.randn(N_PAGES, PS, H, D).astype(np.float32)
    v = rng.randn(N_PAGES, PS, H, D).astype(np.float32)
    return [k, v, None, None]


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_verify_paged_op_matches_jax(jx, codec):
    jnp = jx.jnp
    rng = np.random.RandomState(21)
    x = rng.randn(5, K1, M).astype(np.float32)
    ws = [(rng.randn(M, M) * M ** -0.5).astype(np.float32)
          for _ in range(4)]
    pools = _pools(rng, codec)
    feeds = _verify_feeds(rng)

    def jax_plane(a, plane):
        if a is None:
            return None
        return jnp.asarray(a, jnp.bfloat16) if codec == "bf16" \
            and plane < 2 else jnp.asarray(a)

    def torch_plane(a, plane):
        if a is None:
            return None
        t = torch.from_numpy(a.copy())
        return t.to(torch.bfloat16) if codec == "bf16" and plane < 2 else t
    ins = {"X": [jnp.asarray(x)],
           **{n: [jnp.asarray(w)] for n, w in zip(("Wq", "Wk", "Wv", "Wo"),
                                                   ws)},
           "PageK": [jax_plane(pools[0], 0)],
           "PageV": [jax_plane(pools[1], 1)],
           **{k: [jnp.asarray(v)] for k, v in feeds.items()}}
    if codec == "int8":
        ins["PageKS"] = [jax_plane(pools[2], 2)]
        ins["PageVS"] = [jax_plane(pools[3], 3)]
    jres = jx.jkv._kv_attention_verify_paged(None, ins, {"n_head": H,
                                                         "codec": codec})
    tp = [torch_plane(p, i) for i, p in enumerate(pools)]
    f = {k: torch.from_numpy(v) for k, v in feeds.items()}
    out = tkv.kv_attention_verify_paged(
        torch.from_numpy(x), *(torch.from_numpy(w) for w in ws), tp[0],
        tp[1], f["PageTable"], f["Pos"], f["SeqLen"], f["GenStart"],
        f["Active"], f["WinLen"], H, codec, tp[2], tp[3])

    # Out where it is defined: active slots, window positions < win_len
    i = np.arange(K1)
    live = (feeds["Active"] > 0) & (i[None, :] < feeds["WinLen"])
    np.testing.assert_allclose(out.numpy()[live],
                               _as_np(jres["Out"][0])[live],
                               rtol=1e-5, atol=1e-5)
    # the rows written: inside the table's span and the lease
    wp = feeds["Pos"] + i[None, :]
    page = np.take_along_axis(feeds["PageTable"],
                              np.clip(wp // PS, 0, MP - 1), axis=1)
    rows = page * PS + wp % PS
    ok = live & (wp < MP * PS) & (page < N_PAGES)
    written = rows[ok]
    assert len(written) == 4 + 1 + 2 + 2
    other = np.setdiff1d(np.arange(R), written)
    names = ["PageKOut", "PageVOut", "PageKSOut", "PageVSOut"]
    for plane in range(4 if codec == "int8" else 2):
        want = _as_np(jres[names[plane]][0]).reshape(R, -1)
        got = _as_np(tp[plane]).reshape(R, -1)
        np.testing.assert_array_equal(got[other], want[other])
        if codec == "none":
            np.testing.assert_allclose(got[written], want[written],
                                       rtol=1e-5, atol=1e-5)
        elif codec == "bf16":
            np.testing.assert_allclose(got[written], want[written],
                                       rtol=2e-2, atol=1e-6)
        elif plane >= 2:
            np.testing.assert_allclose(got[written], want[written],
                                       rtol=1e-6, atol=0)
    if codec == "int8":
        for c, s in ((0, 2), (1, 3)):
            step = _as_np(jres[names[s]][0]).reshape(R, H, 1)[written]
            deq_w = (_as_np(jres[names[c]][0]).reshape(R, H, D)[written]
                     .astype(np.float32) * step)
            deq_t = (_as_np(tp[c]).reshape(R, H, D)[written]
                     .astype(np.float32)
                     * _as_np(tp[s]).reshape(R, H, 1)[written])
            assert np.all(np.abs(deq_t - deq_w) <= step * (1 + 1e-5))


# -- the engine --------------------------------------------------------------

def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 32, (int(n),)) for n in lengths]


def test_greedy_streams_match_jax_and_the_plain_engine(jx):
    """tests/test_spec_decode.py:108-127 on the paged layout: the port's
    spec engine == the JAX spec engine == the port's engine without
    speculation, token for token; the counters add up."""
    m, params = jx.spec_engine()
    prompts = _prompts(3, (3, 4, 7, 8, 5, 2))
    want = m.generate(prompts, max_new=6)
    port = _port(params)
    got = port.generate(prompts, max_new=6)
    base = _port(params, spec_k=None).generate(prompts, max_new=6)
    _assert_streams_equal(want, got, "jax/port")
    _assert_streams_equal(base, got, "plain/spec")
    c = _counts(port)
    assert c["tokens_generated"] == 36 and c["prefills"] == 6
    assert sum(n * k for n, k in c["tokens_per_step"].items()) == 30
    assert sum(c["tokens_per_step"].values()) >= c["decode_steps"]
    assert c["spec_accepted"] <= c["spec_proposed"]


def test_seeded_sampled_streams_match_and_replay(jx):
    """:150-187: temperature 0.8, per-request seeds: the port's spec
    stream equals the JAX spec engine's and the plain engine's, and a
    second, fresh port engine replays it."""
    m, params = jx.spec_engine()
    prompts = _prompts(11, (3, 6, 8))
    kw = dict(max_new=7, temperature=0.8, top_k=0, seeds=[101, 202, 303])
    want = m.generate(prompts, **kw)
    got = _port(params).generate(prompts, **kw)
    base = _port(params, spec_k=None).generate(prompts, **kw)
    again = _port(params).generate(prompts, **kw)
    _assert_streams_equal(want, got, "jax/port")
    _assert_streams_equal(base, got, "plain/spec")
    _assert_streams_equal(got, again, "replay")
    top = dict(max_new=6, temperature=1.1, top_k=4, seeds=[7, 8])
    short = [[9, 4, 2, 17], [21, 5]]
    m.reset()
    _assert_streams_equal(m.generate(short, **top),
                          _port(params).generate(short, **top), "top_k")


def test_eos_inside_a_window_ends_the_request(jx):
    """:190-204: an EOS inside an accepted window ends the request there,
    on both engines under the same scripted drafter."""
    m, params = jx.spec_engine()
    base = _port(params, spec_k=None)
    prompt = [5, 1, 19]
    ref = base.generate([prompt], max_new=8)[0]
    eos = int(ref[2])
    want = base.generate([prompt], max_new=8, eos_id=eos)[0]
    assert len(want) <= 3 and int(want[-1]) == eos
    target = list(prompt) + list(ref)
    port = _port(params, drafter=_CannedDrafter(target, LM["vocab"]))
    got = port.generate([prompt], max_new=8, eos_id=eos)[0]
    m.drafter = _CannedDrafter(target, LM["vocab"])
    jgot = m.generate([prompt], max_new=8, eos_id=eos)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)


def test_perfect_drafter_commits_a_budget_of_8_in_two_dispatches(jx):
    """:130-147: with a perfect proposer a budget-8 request takes
    ceil((8 - 1) / (K + 1)) = 2 verify dispatches (4 + 3 tokens after
    the admission's first)."""
    _, params = jx.spec_engine()
    prompt = [7, 3, 11]
    ref = _port(params, spec_k=None).generate([prompt], max_new=8)[0]
    port = _port(params, drafter=_CannedDrafter(list(prompt) + list(ref),
                                                LM["vocab"]))
    np.testing.assert_array_equal(port.generate([prompt], max_new=8)[0],
                                  ref)
    c = _counts(port)
    assert c["decode_steps"] == 2
    assert c["tokens_per_step"] == {4: 1, 3: 1}


def test_scripted_schedule_counts_as_the_reference(jx):
    """:235-289 without the scrape endpoint: budget 8 leaves 7 tokens
    after the admission. Dispatch 1 drafts min(K, remaining - 1) = 3,
    all accepted, and commits 4; dispatch 2 drafts 2, the schedule
    accepts 1, and commits 2; dispatch 3 has 1 left, drafts nothing and
    commits 1. Proposed 5, accepted 4, commits {4, 2, 1}; the drafter is
    called twice. The JAX engine emits the same stream under the same
    schedule."""
    m, params = jx.spec_engine()
    prompt = [2, 29, 13]
    ref = _port(params, spec_k=None).generate([prompt], max_new=8)[0]
    target = list(prompt) + list(ref)
    drafter = _CannedDrafter(target, LM["vocab"], sched=[3, 1])
    port = _port(params, drafter=drafter)
    np.testing.assert_array_equal(port.generate([prompt], max_new=8)[0],
                                  ref)
    assert drafter.calls == 2
    c = _counts(port)
    assert (c["spec_proposed"], c["spec_accepted"]) == (5, 4)
    assert c["tokens_per_step"] == {4: 1, 2: 1, 1: 1}
    assert c["decode_steps"] == 3 and c["tokens_generated"] == 8
    m.drafter = _CannedDrafter(target, LM["vocab"], sched=[3, 1])
    np.testing.assert_array_equal(m.generate([prompt], max_new=8)[0], ref)


# -- the drafters ------------------------------------------------------------

def test_ngram_drafter_prompt_lookup():
    """:206-214's cases."""
    d = teng.NgramDrafter(max_ngram=3)
    assert d.propose([1, 4, 5, 6, 7, 2, 4, 5], 2) == [6, 7]
    assert d.propose([1, 2, 3], 0) == []
    assert d.propose([1], 4) == []
    assert d.propose([1, 2, 3, 4], 3) == []


@pytest.mark.parametrize("vocab", [256, 65536, 1 << 20],
                         ids=["bytes", "uint16", "uint32"])
def test_ngram_drafter_proposes_as_the_jax_drafter(jx, vocab):
    """Seeded random histories, short alphabets so that n-grams recur,
    over each of the byte encodings (ids under 256, under 65536, above)."""
    rng = np.random.RandomState(vocab % 1000)
    want_d, got_d = jx.jeng.NgramDrafter(), teng.NgramDrafter()
    wide_d = (jx.jeng.NgramDrafter(max_ngram=5, min_ngram=2),
              teng.NgramDrafter(max_ngram=5, min_ngram=2))
    hits = 0
    for case in range(60):
        alphabet = rng.choice(vocab, int(rng.randint(2, 9)), replace=False)
        hist = [int(t) for t in rng.choice(alphabet,
                                           int(rng.randint(1, 40)))]
        k = int(rng.randint(0, 6))
        want = want_d.propose(hist, k)
        assert got_d.propose(hist, k) == want, (case, hist, k)
        assert wide_d[1].propose(hist, k) == wide_d[0].propose(hist, k)
        hits += bool(want)
    assert hits > 20


def test_model_drafter_drafts_as_the_jax_drafter(jx):
    """The port's ModelDrafter over a DecoderLM proposes what the JAX
    ModelDrafter over the wave engine's ``full`` view proposes, on the
    same weights, for histories short and longer than cache_len - k."""
    _, params = jx.spec_engine()
    jd = jx.jeng.ModelDrafter(jx.oracle())
    td = teng.ModelDrafter(_lm(params))
    rng = np.random.RandomState(5)
    for n, k in ((1, 3), (3, 3), (9, 2), (15, 1), (20, 3), (12, 0)):
        hist = [int(t) for t in rng.randint(1, 32, n)]
        assert td.propose(hist, k) == jd.propose(hist, k), (n, k)


def test_model_drafter_streams_stay_lossless(jx):
    """:217-232: the draft model is the target's own ``full`` view, so
    acceptance is near-perfect and the stream still equals the plain
    engine's."""
    _, params = jx.spec_engine()
    ref = _port(params, spec_k=None).generate([[3, 14, 15]], max_new=6)[0]
    port = _port(params, drafter=teng.ModelDrafter(_lm(params)))
    np.testing.assert_array_equal(
        port.generate([[3, 14, 15]], max_new=6)[0], ref)
    assert _counts(port)["spec_accepted"] > 0


# -- geometry and imports ----------------------------------------------------

def test_paged_geometry_validates_spec_k():
    """analysis/contracts.py:154-162: K >= 1, and the K+1 window fits the
    generated region plus the last committed token's row."""
    for bad in (0, -1):
        with pytest.raises(ValueError, match="spec_k"):
            tT.paged_geometry(PROMPT_LEN, CACHE_LEN, 2, spec_k=bad)
    with pytest.raises(ValueError, match="window"):
        tT.paged_geometry(PROMPT_LEN, CACHE_LEN, 2, spec_k=9)
    assert tT.paged_geometry(PROMPT_LEN, CACHE_LEN, 2,
                             spec_k=8).spec_k == 8
    assert tT.paged_geometry(PROMPT_LEN, CACHE_LEN, 2).spec_k is None
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        teng.make_slot_model("lm", lm, prompt_buckets=BUCKETS,
                             layout="paged", spec_k=-2, device="cpu", **GEOM)


def test_span_for_matches_the_jax_pool_without_draft_headroom(jx):
    """The spec engine reserves no draft headroom (its windows stop at
    ``remaining - 1`` drafts), as the JAX engine's ``draft_window=0``."""
    jpool = importlib.import_module("paddle_tpu.serving.kv_pool")
    from paddle_tpu_torch.serving import kv_pool as tpool
    for total in (1, 4, 5, 13, 16):
        assert tpool.PagePool(8, 4).span_for(total) == \
            jpool.PagePool(8, 4).span_for(total, draft_window=0)


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import paddle_tpu_torch.serving.engine\n"
            "import paddle_tpu_torch.ops.nn_ops\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# -- C6 on the CPU: an fp32 result of bf16 operands --------------------------

def test_amp_product_smallest_input_keeps_the_fp32_sum():
    """x [[1, 1]] and y [[1], [2**-8]] are exact in bf16; their fp32 sum
    is 1.00390625, which bf16 would round to 1.0."""
    x = torch.tensor([[1.0, 1.0]])
    y = torch.tensor([[1.0], [2.0 ** -8]])
    out = tnn.amp_product(x, y, keep=False)
    assert out.dtype == torch.float32 and out.item() == 1.00390625
    assert tnn.amp_product(x, y, keep=True).item() == 1.0


@pytest.mark.parametrize("shape", [((3, 5, 24), (24, 12)),
                                   ((2, 3, 5, 8), (2, 3, 8, 7))],
                         ids=["mul", "matmul"])
@pytest.mark.parametrize("keep", [False, True], ids=["fp32", "bf16"])
def test_amp_product_and_its_backward_match_jax(jx, shape, keep):
    """``amp_product`` and its hand-written backward against ``jax.vjp``
    of ``jnp.matmul(bf16, bf16, preferred_element_type=float32)`` (the
    product of the JAX ``mul`` / ``matmul`` under ``__amp_bf16__``), the
    result rounded to bf16 under ``keep``. fp32 operands, as the AMP
    trainers' weights."""
    jax, jnp = jx.jax, jx.jnp
    rng = np.random.RandomState(7)
    xs, ys = shape
    x = rng.randn(*xs).astype(np.float32)
    y = (rng.randn(*ys) * 0.3).astype(np.float32)

    def ref(a, b):
        out = jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        return out.astype(jnp.bfloat16) if keep else out
    want, pull = jax.vjp(ref, jnp.asarray(x), jnp.asarray(y))
    cot = rng.randn(*want.shape).astype(np.float32)
    if keep:
        cot = torch.from_numpy(cot).bfloat16().float().numpy()
    wx, wy = pull(jnp.asarray(cot).astype(want.dtype))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    got = tnn.amp_product(xt, yt, keep)
    assert got.dtype == (torch.bfloat16 if keep else torch.float32)
    got.backward(torch.from_numpy(cot).to(got.dtype))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               _as_np(want), **F32_TOL)
    assert xt.grad.dtype == yt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), _as_np(wx), **F32_TOL)
    np.testing.assert_allclose(yt.grad.numpy(), _as_np(wy), **F32_TOL)


def test_amp_product_rejects_broadcast_batches():
    with pytest.raises(ValueError, match="batch"):
        tnn.amp_product(torch.ones(2, 3, 4), torch.ones(1, 4, 5), False)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "`pytest --noconftest -m gpu`)")
    return torch.device("cuda")


@pytest.fixture
def reduced_flag():
    """Restores ``allow_bf16_reduced_precision_reduction`` (True on the
    card by default) after a test that sets it."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_bf16_reduced_precision_reduction
    yield flags
    flags.allow_bf16_reduced_precision_reduction = old


@pytest.mark.gpu
def test_cuda_amp_product_keeps_the_fp32_sum(cuda_device):
    """C6 on the card: 1.00390625 for the smallest input (a bf16 cuBLAS
    product gives 1.0); the forward and the hand-written backward equal
    to the CPU formula's at the shapes of ``fc`` and ``matmul``, on the
    same seeded cotangent: both sum exact products in fp32, in other
    orders (the tensor cores' sums lost up to 5e-7 of the sum of the
    terms' magnitudes on an H100, CUDA-core fp32 4e-8), and round the
    gradients to bf16."""
    x = torch.tensor([[1.0, 1.0]], device=cuda_device)
    y = torch.tensor([[1.0], [2.0 ** -8]], device=cuda_device)
    assert tnn.amp_product(x, y, keep=False).item() == 1.00390625
    rng = np.random.RandomState(3)
    for xs, ys, os in (((64, 50, 512), (512, 2048), (64, 50, 2048)),
                       ((4, 8, 128, 64), (4, 8, 64, 128), (4, 8, 128, 128))):
        for keep in (False, True):
            host = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                    for s in (xs, ys)]
            cot = torch.from_numpy(rng.randn(*os).astype(np.float32) * 0.01)
            res = []
            for dev in ("cpu", cuda_device):
                a, b = (t.clone().to(dev).requires_grad_() for t in host)
                out = tnn.amp_product(a, b, keep)
                out.backward(cot.to(dev, out.dtype))
                res.append([t.detach().float().cpu()
                            for t in (out, a.grad, b.grad)])
            # a bf16 value (the result under keep, every gradient) within
            # one bf16 step, where the two sums straddle a rounding
            # boundary; atol 5e-7 of the terms' magnitudes (the result's:
            # ~330, the gradients' < 25) with margin
            for i, (want, got) in enumerate(zip(*res)):
                rtol = 1e-4 if i == 0 and not keep else 2 ** -7
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=rtol,
                                           atol=1e-3 if i == 0 else 1e-4)


#: C6's backward sums against fp64, as a share of the sum of the terms'
#: magnitudes: between the tensor cores' error and one bf16 rounding of
#: the cotangent (the readings are in the test's docstring)
COTANGENT_SHARE_LIMIT = 1e-5


@pytest.mark.gpu
def test_cuda_amp_backward_takes_the_whole_fp32_cotangent(cuda_device):
    """C6's backward on the card before its bf16 rounding: the fp32 sums
    of the fp32 cotangent and the bf16 operand (``dx`` and ``dy`` at the
    shapes of ``fc`` and ``matmul``) against their fp64 product, as the
    largest share of the sum of the terms' magnitudes. JAX's transpose
    multiplies the whole fp32 cotangent; the port's three-term split
    read 1.5e-7 to 5.9e-7 on an H100 80GB HBM3 at 700 W (tensor-core
    sums). A planted control that rounds the cotangent to bf16 once, one
    rounding more than JAX, read 2.4e-4 to 1.06e-3 there; the limit lies
    between, 17x above the one and 24x below the other. A copy of the
    port whose backward took that one term failed this test."""
    rng = np.random.RandomState(5)
    readings = {"split": [], "control": []}
    for xs, ys, os in (((64, 50, 512), (512, 2048), (64, 50, 2048)),
                       ((4, 8, 128, 64), (4, 8, 64, 128), (4, 8, 128, 128))):
        xb, yb = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  .to(cuda_device, torch.bfloat16) for s in (xs, ys))
        g = torch.from_numpy(rng.randn(*os).astype(np.float32) * 0.01
                             ).to(cuda_device)
        if yb.dim() == 2:                    # as the backward folds x
            xt, g2 = xb.reshape(-1, xs[-1]).t(), g.reshape(-1, os[-1])
        else:
            xt, g2 = xb.transpose(-1, -2), g
        yt = yb.transpose(-1, -2)
        for name, split in (("split", tnn._cotangent_terms),
                            ("control", lambda t: (t.bfloat16(),))):
            for got, exact, mag in (
                    (tnn._sum_products(split(g), yt, True),
                     torch.matmul(g.double(), yt.double()),
                     torch.matmul(g.double().abs(), yt.double().abs())),
                    (tnn._sum_products(split(g2), xt, False),
                     torch.matmul(xt.double(), g2.double()),
                     torch.matmul(xt.double().abs(), g2.double().abs()))):
                assert got.dtype == torch.float32
                readings[name].append(
                    ((got.double() - exact).abs() / mag).max().item())
    print(f"cotangent sum error shares: {readings}")
    assert max(readings["split"]) < COTANGENT_SHARE_LIMIT
    assert min(readings["control"]) > COTANGENT_SHARE_LIMIT


@pytest.mark.gpu
def test_cuda_amp_product_sums_in_fp32_whatever_the_flag(cuda_device,
                                                         reduced_flag):
    """C7 on the card: [4, 8192] x [8192, 4] products of seeded normal
    values, the smallest shape whose bf16 cuBLAS result moved with
    ``allow_bf16_reduced_precision_reduction`` on an H100 (by one bf16
    step, 0.21-1.0, for each of 8 seeds), give the same bits either way
    through ``amp_product`` (pure and conservative)."""
    moved = 0
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        a = torch.randn(4, 8192, generator=gen).to(cuda_device)
        b = torch.randn(8192, 4, generator=gen).to(cuda_device)
        runs = {}
        for flag in (True, False):
            reduced_flag.allow_bf16_reduced_precision_reduction = flag
            runs[flag] = (a.bfloat16() @ b.bfloat16(),
                          tnn.amp_product(a, b, False),
                          tnn.amp_product(a, b, True))
        moved += not torch.equal(runs[True][0], runs[False][0])
        for i in (1, 2):
            assert torch.equal(runs[True][i], runs[False][i])
    assert moved, "no bf16 product moved with the flag on this card"


@pytest.mark.gpu
def test_cuda_spec_engine_streams_equal_the_plain_engine(cuda_device):
    """The spec engine on the card at this file's width gives the plain
    engine's greedy and seeded streams (the same seeded weights on both),
    under the n-gram drafter and a perfect one."""
    rng = np.random.RandomState(0)
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device=cuda_device)
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32) * 0.5))

    def engine(spec_k, drafter=None):
        e = teng.make_slot_model(f"lm_spec_gpu{next(_NAMES)}", lm,
                                 prompt_buckets=BUCKETS,
                                 layout="paged", spec_k=spec_k,
                                 drafter=drafter, device=cuda_device, **GEOM)
        e.warmup()
        return e
    prompts = _prompts(3, (3, 4, 7, 8, 5, 2))
    for kw in (dict(max_new=8), dict(max_new=7, temperature=0.8,
                                     seeds=[1, 2, 3, 4, 5, 6])):
        want = engine(None).generate(prompts, **kw)
        spec = engine(SPEC_K)
        _assert_streams_equal(want, spec.generate(prompts, **kw), "ngram")
        assert _counts(spec)["decode_steps"] > 0
    one = [int(t) for t in prompts[0]]
    ref = engine(None).generate([one], max_new=8)[0]
    perfect = engine(SPEC_K, _CannedDrafter(one + list(ref), LM["vocab"]))
    np.testing.assert_array_equal(perfect.generate([one], max_new=8)[0],
                                  ref)
    assert _counts(perfect)["decode_steps"] == 2


class _Products(TorchDispatchMode):
    """Counts every dense product (op, input dtypes, result dtype) run
    under it, the backward's too."""

    NAMES = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv",
             "dot", "matmul", "linear", "convolution", "_scaled_mm"}

    def __init__(self):
        super().__init__()
        self.seen = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.NAMES:
            dts = sorted({str(a.dtype).split(".")[-1] for a in args
                          if isinstance(a, torch.Tensor)})
            self.seen[(str(func), tuple(dts),
                       str(out.dtype).split(".")[-1])] += 1
        return out


@pytest.mark.gpu
def test_cuda_amp_trainers_bf16_products_have_fp32_results(cuda_device):
    """C7 over the AMP trainers: one step (forward and backward) of the
    pure-AMP Transformer (fused attention and head; composed attention and
    head) and of the conservative stacked LSTM and translator at small
    widths; every dense product the step runs on bf16 operands has an
    fp32 result, whose sums the reduced-precision flag does not govern
    (the flash and fused-CE kernels are this port's own, not cuBLAS)."""
    from paddle_tpu_torch.contrib import mixed_precision as tmp
    from paddle_tpu_torch.models import machine_translation as tM
    from paddle_tpu_torch.models import stacked_dynamic_lstm as tL
    rng = np.random.RandomState(0)
    dev = cuda_device

    def ids(high, *shape):
        return torch.from_numpy(rng.randint(0, high, shape)).to(dev)
    cfg = dict(src_vocab=64, tgt_vocab=64, max_len=16, d_model=32,
               d_inner=64, n_head=2, n_layer=1, dropout=0.0)
    steps = []
    for fused in (True, False):
        model, _ = tT.build(**cfg, fused_attention=fused, fused_head=fused,
                            device=dev)
        feed = [ids(64, 4, 16, 1) for _ in range(3)]
        steps.append((model, lambda m=model, f=feed: m(*f)))
    lstm, _, _ = tL.build(dict_dim=50, emb_dim=16, hid_dim=16,
                          stacked_num=2, device=dev)
    lens = torch.tensor([8, 5, 3, 8], dtype=torch.int32, device=dev)
    steps.append((lstm, lambda: lstm(ids(50, 4, 8), lens, ids(2, 4, 1))[0]))
    mt, _, _ = tM.build(device=dev)
    steps.append((mt, lambda: mt(ids(30, 4, 8), ids(30, 4, 8),
                                 ids(30, 4, 8))))
    seen = Counter()
    for model, step in steps:
        tmp.rewrite_program_amp(model)
        with _Products() as mode:
            step().backward()
            torch.cuda.synchronize()
        seen += mode.seen
    print(sorted(seen.items()))
    low = [p for p in seen if "bfloat16" in p[1] or "float16" in p[1]]
    assert low, seen
    assert all(res == "float32" for _, _, res in low), low
