"""The PyTorch port's paged KV-cache attention and token sampling
(paddle_tpu_torch/ops/kv_attention.py) against the JAX emitters of
paddle_tpu/ops/kv_attention.py (called directly: they do not read
``ctx``). Inputs are made from seeds with numpy and handed to both.

Tolerances, with their reasons:
- fp32 ``Out`` and written pool rows: rtol=atol=1e-5 (the two
  frameworks sum the dots in different orders);
- bf16 pool rows: rtol=2e-2 (one bf16 rounding of values an fp32 ulp
  apart can land on neighbouring bf16 values);
- int8 pools: dequantized values within one quantization step (an input
  an ulp apart can round to the neighbouring code), scales at 1e-6;
- rows no write reaches: bit-identical, so a sentinel row never lands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import kv_attention as jkv
from paddle_tpu_torch.ops import kv_attention as tkv

H, D = 2, 8
M = H * D
N_PAGES, PS, MP = 8, 4, 4          # flat pool of 32 rows; 16 cache rows
R = N_PAGES * PS


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _weights(rng):
    return [(rng.randn(M, M) * M ** -0.5).astype(np.float32)
            for _ in range(4)]


def _pools(rng, codec):
    """Random resident pool content in the codec's storage."""
    if codec == "int8":
        k = rng.randint(-127, 128, (N_PAGES, PS, H, D)).astype(np.int8)
        v = rng.randint(-127, 128, (N_PAGES, PS, H, D)).astype(np.int8)
        ks = np.abs(rng.randn(N_PAGES, PS, H)).astype(np.float32) * 0.01
        vs = np.abs(rng.randn(N_PAGES, PS, H)).astype(np.float32) * 0.01
        return [k, v, ks, vs]
    k = rng.randn(N_PAGES, PS, H, D).astype(np.float32)
    v = rng.randn(N_PAGES, PS, H, D).astype(np.float32)
    return [k, v, None, None]


def _jax(a, codec, plane):
    if a is None:
        return None
    if codec == "bf16" and plane < 2:
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a)


def _torch(a, codec, plane):
    if a is None:
        return None
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if codec == "bf16" and plane < 2 else t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _compare_pools(jres, tpools, codec, written):
    """Pool planes after the op: written rows at the codec's tolerance,
    every other row bit-identical."""
    names = ["PageKOut", "PageVOut", "PageKSOut", "PageVSOut"]
    other = np.setdiff1d(np.arange(R), written)
    for plane in range(4 if codec == "int8" else 2):
        want = _np(jres[names[plane]][0]).reshape(R, -1)
        got = _np(tpools[plane]).reshape(R, -1)
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
            step = _np(jres[names[s]][0]).reshape(R, H, 1)[written]
            deq_w = (_np(jres[names[c]][0]).reshape(R, H, D)[written]
                     .astype(np.float32) * step)
            deq_t = (_np(tpools[c]).reshape(R, H, D)[written]
                     .astype(np.float32)
                     * _np(tpools[s]).reshape(R, H, 1)[written])
            assert np.all(np.abs(deq_t - deq_w) <= step * (1 + 1e-5))


def _ins(x, ws, pools, codec, extra):
    ins = {"X": [jnp.asarray(x)],
           **{n: [jnp.asarray(w)] for n, w in zip(("Wq", "Wk", "Wv", "Wo"),
                                                   ws)},
           "PageK": [_jax(pools[0], codec, 0)],
           "PageV": [_jax(pools[1], codec, 1)]}
    if codec == "int8":
        ins["PageKS"] = [_jax(pools[2], codec, 2)]
        ins["PageVS"] = [_jax(pools[3], codec, 3)]
    ins.update({k: [jnp.asarray(v)] for k, v in extra.items()})
    return ins


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_prefill_paged_matches_jax(codec):
    rng = np.random.RandomState(11)
    t = 8
    x = rng.randn(1, t, M).astype(np.float32)
    ws = _weights(rng)
    pools = _pools(rng, codec)
    # positions 0-3 ride a shared prefix page (sentinel: never written);
    # 4-7 land in pages 5 and 2, half each
    rows = np.array([R, R + 3, R, R, 5 * PS, 5 * PS + 1, 2 * PS + 2,
                     2 * PS + 3], np.int64)
    jres = jkv._kv_attention_prefill_paged(
        None, _ins(x, ws, pools, codec, {"Rows": rows[:, None]}),
        {"n_head": H, "codec": codec})
    tp = [_torch(p, codec, i) for i, p in enumerate(pools)]
    out = tkv.kv_attention_prefill_paged(
        torch.from_numpy(x), *(torch.from_numpy(w) for w in ws), tp[0],
        tp[1], torch.from_numpy(rows[:, None]), H, codec, tp[2], tp[3])
    np.testing.assert_allclose(out.numpy(), _np(jres["Out"][0]),
                               rtol=1e-5, atol=1e-5)
    _compare_pools(jres, tp, codec, rows[rows < R])


def _decode_feeds(rng):
    """Four slots: three live with spans of 4, 2 and 3 pages (the rest of
    each table row is the sentinel N_PAGES), one free slot."""
    table = np.full((4, MP), N_PAGES, np.int64)
    pages = rng.permutation(N_PAGES)
    table[0, :4] = pages[:4]
    table[1, :2] = pages[4:6]
    table[2, :3] = pages[5:8]       # shares page pages[5] with slot 1
    seq_len = np.array([[3], [4], [2], [0]], np.int64)
    gen_start = np.array([[4], [4], [8], [0]], np.int64)
    pos = np.array([[9], [6], [10], [-1]], np.int64)
    active = np.array([[1], [1], [1], [0]], np.int64)
    return {"PageTable": table, "Pos": pos, "SeqLen": seq_len,
            "GenStart": gen_start, "Active": active}


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_decode_paged_matches_jax(codec):
    rng = np.random.RandomState(12)
    x = rng.randn(4, 1, M).astype(np.float32)
    ws = _weights(rng)
    pools = _pools(rng, codec)
    feeds = _decode_feeds(rng)
    jres = jkv._kv_attention_decode_paged(
        None, _ins(x, ws, pools, codec, feeds),
        {"n_head": H, "codec": codec})
    tp = [_torch(p, codec, i) for i, p in enumerate(pools)]
    f = {k: torch.from_numpy(v) for k, v in feeds.items()}
    out = tkv.kv_attention_decode_paged(
        torch.from_numpy(x), *(torch.from_numpy(w) for w in ws), tp[0],
        tp[1], f["PageTable"], f["Pos"], f["SeqLen"], f["GenStart"],
        f["Active"], H, codec, tp[2], tp[3])
    np.testing.assert_allclose(out.numpy(), _np(jres["Out"][0]),
                               rtol=1e-5, atol=1e-5)
    table, pos = feeds["PageTable"], feeds["Pos"][:, 0]
    live = feeds["Active"][:, 0] > 0
    written = (table[np.arange(4), np.maximum(pos, 0) // PS] * PS
               + pos % PS)[live]
    _compare_pools(jres, tp, codec, written)


def test_kv_quant_matches_jax():
    rng = np.random.RandomState(13)
    rows = rng.randn(6, H, D).astype(np.float32) * 3
    rows[2, 1] = 0.0                 # an all-zero head: scale floor
    jq, js = jkv._kv_quant(jnp.asarray(rows))
    tq, ts = tkv.kv_quant(torch.from_numpy(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def _jax_sample(logits, temp, topk, seed, step):
    res = jkv._token_sample(None, {
        "Logits": [jnp.asarray(logits)],
        "Temperature": [jnp.asarray(temp[:, None])],
        "TopK": [jnp.asarray(topk[:, None])],
        "Seed": [jnp.asarray(seed[:, None])],
        "StepIdx": [jnp.asarray(step[:, None])]}, {})
    return np.asarray(res["Out"][0]).reshape(-1)


def _port_sample(logits, temp, topk, seed, step):
    return tkv.token_sample(
        torch.from_numpy(logits), torch.from_numpy(temp[:, None]),
        torch.from_numpy(topk[:, None]), torch.from_numpy(seed[:, None]),
        torch.from_numpy(step[:, None])).numpy().reshape(-1)


# seeds past int32 (the JAX op reads int64 feeds as int32, so they wrap)
# and negative ones; token indices up to 10**6
_SEEDS = np.array([0, 1, 2 ** 31 + 3, -5, 2 ** 40 + 11, -(2 ** 33) - 1,
                   2 ** 62 + 12345, 77], np.int64)
_STEPS = np.array([0, 1, 999_999, 10 ** 6, 12345, 7, 2 ** 31 + 1, 3],
                  np.int64)


def test_token_sample_greedy_rows_match_jax():
    rng = np.random.RandomState(14)
    b, v = 8, 50
    logits = rng.randn(b, v).astype(np.float32)
    temp = np.array([0, 0, 0.8, 0.5, -1, 0, 1.0, 0], np.float32)
    topk = np.array([0, 3, 1, 1, 5, 1, 1, 40], np.int64)
    got = _port_sample(logits, temp, topk, _SEEDS, _STEPS)
    np.testing.assert_array_equal(got, _jax_sample(logits, temp, topk,
                                                   _SEEDS, _STEPS))
    np.testing.assert_array_equal(got, logits.argmax(-1))


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_token_sample_seeded_matches_jax(top_k):
    rng = np.random.RandomState(15 + top_k)
    b, v = 8, 64
    for trial in range(4):
        logits = rng.randn(b, v).astype(np.float32) * 2
        temp = np.full(b, 0.8, np.float32)
        topk = np.full(b, top_k, np.int64)
        seed = _SEEDS + trial
        step = _STEPS + 3 * trial
        np.testing.assert_array_equal(
            _port_sample(logits, temp, topk, seed, step),
            _jax_sample(logits, temp, topk, seed, step))


def _jax_gumbel(seed, step, v):
    """The noise of kv_attention.py:584-595, spelled with jnp uint32
    exactly as the JAX op spells it (after its int32 feed cast)."""
    seed = jnp.asarray(seed).astype(jnp.int32)
    step = jnp.asarray(step).astype(jnp.int32)
    j = jnp.arange(v, dtype=jnp.uint32)[None, :]
    x = (j * jnp.uint32(0x9E3779B9)
         ^ seed.astype(jnp.uint32)[:, None] * jnp.uint32(0x85EBCA6B))
    x = x ^ (step.astype(jnp.uint32)[:, None] * jnp.uint32(0x27D4EB2F))
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    u = ((x >> jnp.uint32(8)).astype(jnp.float32) + 0.5) * (1.0 / (1 << 24))
    return np.asarray(-jnp.log(-jnp.log(u)))


def test_gumbel_noise_matches_jax():
    v = 300
    got = tkv.gumbel_noise(torch.from_numpy(_SEEDS),
                           torch.from_numpy(_STEPS), v).numpy()
    np.testing.assert_allclose(got, _jax_gumbel(_SEEDS, _STEPS, v),
                               rtol=0, atol=1e-6)
