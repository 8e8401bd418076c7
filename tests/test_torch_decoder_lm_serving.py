"""The PyTorch port's paged decoder-LM serving slice, as a whole, against
the JAX package's PagedSlotGenerativeModel.

JAX side: ``build_decoder_lm_programs`` at the tests/test_kv_pool.py
geometry (vocab 32, d_model 16, 2 heads, 2 layers, prompt buckets 4/8,
cache_len 16, 4 slots, pages of 4 rows) under ``make_slot_model``. Port
side: the weights are read from that engine's scope and carried across
with ``params_from_jax``; the port's engine runs the same geometry on
``device="cpu"``, where the page gathers take their plain versions.
Token streams must be IDENTICAL; the ``full`` view's logits agree at
rtol=atol=1e-5 (fp32 sums in another order)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import engine as jeng
from paddle_tpu.serving import kv_pool as jpool

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import kv_pool as tpool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab=32, d_model=16, d_inner=32, n_head=2, n_layer=2)
PROMPT_LEN, MAX_NEW, BUCKETS = 8, 8, (4, 8)
CACHE_LEN = PROMPT_LEN + MAX_NEW
GEOM = dict(n_slots=4, page_size=4)


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX engine per (codec, n_pages), built on first use and kept
    for the module (each costs a few jit compiles)."""
    built = {}

    def get(codec="none", n_pages=None):
        key = (codec, n_pages)
        if key not in built:
            progs = jT.build_decoder_lm_programs(
                prompt_len=PROMPT_LEN, max_new=MAX_NEW, **LM,
                prompt_buckets=BUCKETS,
                modes=("prefill_paged", "decode_paged", "full"),
                kv_codec=codec, n_pages=n_pages, **GEOM)
            m = jeng.make_slot_model(f"lm_port_{codec}_{n_pages}", progs)
            built[key] = (progs, m)
        progs, m = built[key]
        m.reset()
        return progs, m
    return get


def _params(progs, m):
    names = [p.name for p in
             progs["decode_paged"][0].global_block().all_parameters()]
    return {n: np.asarray(m.scope.find_var(n)) for n in names}


def _port(progs, m, codec="none", n_pages=None, device="cpu"):
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device=device)
    lm.load_state_dict(convert.params_from_jax(_params(progs, m)))
    e = teng.make_slot_model("lm_port", lm, prompt_buckets=BUCKETS,
                             layout="paged", kv_codec=codec, n_pages=n_pages,
                             device=device, **GEOM)
    e.warmup()
    return e


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, 32, (int(n),)) for n in (3, 4, 7, 8, 5, 2)]


def _assert_streams_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_greedy_streams_match_jax(jax_engines, codec):
    progs, m = jax_engines(codec)
    port = _port(progs, m, codec)
    want = m.generate(_prompts(), max_new=6)
    _assert_streams_equal(want, port.generate(_prompts(), max_new=6))
    assert port.prefills == 6 and port.tokens_generated == 36


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_seeded_sampled_streams_match_jax(jax_engines, codec):
    progs, m = jax_engines(codec)
    port = _port(progs, m, codec)
    seeds = [5, 2 ** 31 + 9, -3, 2 ** 40, 123456789, 0]
    kw = dict(max_new=6, temperature=0.8, top_k=5, seeds=seeds)
    want = m.generate(_prompts(), **kw)
    _assert_streams_equal(want, port.generate(_prompts(), **kw))


def test_mixed_per_request_settings_match_one_request_at_a_time(
        jax_engines):
    """Per-request budgets and sampling in one ``generate`` give what
    each request gets served alone by the JAX engine."""
    progs, m = jax_engines()
    port = _port(progs, m)
    prompts = _prompts()
    budgets, temps, topks = [6, 2, 8, 5, 3, 7], [0, .8, 0, .8, 0, 0], \
        [0, 5, 0, 3, 0, 0]
    got = port.generate(prompts, max_new=budgets, temperature=temps,
                        top_k=topks, seeds=list(range(6)))
    for i, p in enumerate(prompts):
        m.reset()
        want = m.generate([p], max_new=budgets[i], temperature=temps[i],
                          top_k=topks[i], seeds=[i])[0]
        np.testing.assert_array_equal(got[i], want)


def test_prefix_sharing_matches_jax(jax_engines):
    """tests/test_kv_pool.py::test_engine_prefix_sharing_cow_bit_
    identical on both engines: same tokens, same shared pages."""
    progs, m = jax_engines()
    port = _port(progs, m)
    pa, pb = [5, 6, 7, 8, 1, 2], [5, 6, 7, 8, 3]
    seen = {}
    for key, e in (("jax", m), ("port", port)):
        e.reset()
        sa, fa, _ = e.admit(pa, max_new=5)
        sb, fb, _ = e.admit(pb, max_new=5)
        shared_page = e.pool.lease(sa).pages[0]
        assert e.pool.lease(sb).pages[0] == shared_page
        toks = {sa: [fa], sb: [fb]}
        counts = [(e.pool.shared_count(), e.pool.page_refs(shared_page),
                   e.pool.free_count())]
        done = set()
        while len(done) < 2:
            for slot, tok, d in e.step():
                toks[slot].append(tok)
                if d:
                    done.add(slot)
        counts.append((e.pool.shared_count(), e.pool.page_refs(shared_page),
                       e.pool.free_count(), e.pool.cached_count()))
        seen[key] = (toks[sa], toks[sb], counts)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2][0][:2] == (1, 2)      # one page, two sharers


def test_page_starved_pool_raises_where_jax_does(jax_engines):
    progs, m = jax_engines("none", 4)
    port = _port(progs, m, n_pages=4)
    for e, exc in ((m, jeng.SlotExhaustedError),
                   (port, teng.SlotExhaustedError)):
        e.reset()
        e.admit([9, 9, 9, 9, 9], max_new=8)      # span 4 = the whole pool
        assert e.free_pages() == 0 and e.free_count() == 3
        with pytest.raises(exc) as ei:
            e.admit([4, 4, 4], max_new=8)
        msg = str(ei.value)
        assert "free_pages=0" in msg and "pages_total=4" in msg
        assert "free_slots=3" in msg
        # a short request fits once the first leaves
        e.release(0)
        e.admit([4, 4, 4], max_new=1)
    assert port.pool.stats() == m.pool.stats()


def test_admit_failure_releases_the_lease(jax_engines):
    """A prefill that raises after the pages were leased must return
    them, scrub the slot's table row and drop the pending write rows;
    the same slot then serves the request bit-identically."""
    progs, m = jax_engines()
    port = _port(progs, m)
    ref = port.generate([[1, 2, 3]], max_new=4)[0]
    port.reset()
    orig = port._dispatch

    def boom(view, feeds):
        raise RuntimeError("injected prefill failure")
    port._dispatch = boom
    with pytest.raises(RuntimeError, match="injected"):
        port.admit([1, 2, 3], max_new=4)
    port._dispatch = orig
    assert port.pool.lease(0) is None
    assert port.free_pages() == port.n_pages
    assert port._pending_rows is None
    assert (port._table[0] == port.n_pages).all()
    np.testing.assert_array_equal(port.generate([[1, 2, 3]], max_new=4)[0],
                                  ref)


def test_full_view_logits_match_jax(jax_engines):
    progs, m = jax_engines()
    main, _, _, fetch = progs["full"]
    ids = np.random.RandomState(4).randint(0, 32, (2, CACHE_LEN))
    want, = fluid.Executor(fluid.TPUPlace()).run(
        main, feed={"ids": ids[:, :, None].astype(np.int64)},
        fetch_list=[fetch], scope=m.scope)
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")
    lm.load_state_dict(convert.params_from_jax(_params(progs, m)))
    got = lm.full(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _pool_schedule(pool):
    """The admission schedule of tests/test_kv_pool.py's pool tests."""
    out = []
    for slot, toks, span in ((0, [1, 2, 3, 4, 5], 2),
                             (1, [1, 2, 3, 4, 9], 2),
                             (2, [7, 7, 7, 7, 7, 7, 7, 7], 3)):
        out.append(pool.acquire(slot, toks, span))
    pool.release(0)
    pool.abort(2)
    out.append(pool.stats())
    pool.release(1)
    out.append(pool.acquire(3, [9, 9, 9, 9, 9, 9, 9, 9, 1], 7))
    out.append(pool.stats())
    with pytest.raises(Exception) as ei:
        pool.acquire(4, [1], 99)
    out.append(type(ei.value).__name__)
    pool.reset()
    out.append(pool.stats())
    return out


def test_page_pool_follows_the_jax_pool():
    assert _pool_schedule(tpool.PagePool(8, 4)) == \
        _pool_schedule(jpool.PagePool(8, 4))
    p = tpool.PagePool(4, 4)
    p.acquire(0, [1, 2, 3, 4], 1)
    p.release(0)
    p.acquire(1, [5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5], 4)
    assert p.evictions["capacity"] == 1


def test_geometry_validation():
    with pytest.raises(ValueError, match="divide"):
        tT.paged_geometry(8, 16, 2, page_size=3)
    with pytest.raises(ValueError, match="span"):
        tT.paged_geometry(8, 16, 2, page_size=4, n_pages=2)
    with pytest.raises(ValueError, match="kv_codec"):
        tT.paged_geometry(8, 16, 2, kv_codec="fp8")
    g = tT.paged_geometry(8, 16, 4, page_size=4, kv_codec="int8")
    assert (g.max_pages, g.n_pages, g.store_dtype) == (4, 16, torch.int8)
    with pytest.raises(KeyError):
        convert.params_from_jax({"lm_page_k_0": np.zeros(2)})


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tT.DecoderLM(**LM, cache_len=CACHE_LEN)
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.make_slot_model("lm", lm, prompt_buckets=BUCKETS,
                             layout="paged", **GEOM)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.make_slot_model("lm", lm, prompt_buckets=BUCKETS,
                             n_slots=GEOM["n_slots"])


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for mod in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                                 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
