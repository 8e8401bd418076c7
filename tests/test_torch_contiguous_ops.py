"""The PyTorch port's contiguous KV-cache ops (paddle_tpu_torch/ops/
kv_attention.py: ``kv_attention_prefill``, ``kv_attention_prefill_slot``,
``kv_attention_decode``, ``kv_attention_verify``) against the JAX
emitters of paddle_tpu/ops/kv_attention.py, called directly (they do not
read ``ctx``). Inputs are made from seeds with numpy and handed to both.

The feeds hold the layout's trouble spots: a free slot whose ``pos`` is
-1, an active slot whose ``pos`` lies past the cache, and a verify window
running past its last row. Each must write nothing, where a plain
advanced-index write (``cache[arange(B), pos] = k_t``) wraps -1 onto the
slot's last row and a clamped one lands the overflow on it; the controls
show that the checks below catch both.

Tolerances, with their reasons:
- ``Out`` and the written cache rows: rtol=atol=1e-5 (the two frameworks
  sum the fp32 dots in different orders);
- rows no write reaches, and the zeros beyond a prefilled prompt:
  bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import kv_attention as jkv
from paddle_tpu_torch.ops import kv_attention as tkv

H, D = 2, 8
M = H * D
N, S = 5, 16                 # five slots of 16 cache rows
K1 = 4                       # a verify window: the last token + 3 drafts
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _weights(rng):
    return [(rng.randn(M, M) * M ** -0.5).astype(np.float32)
            for _ in range(4)]


def _caches(rng):
    return [rng.randn(N, S, H, D).astype(np.float32) for _ in range(2)]


def _ins(x, ws, caches, names, feeds):
    ins = {"X": [jnp.asarray(x)],
           **{n: [jnp.asarray(w)] for n, w in zip(("Wq", "Wk", "Wv", "Wo"),
                                                   ws)},
           names[0]: [jnp.asarray(caches[0])],
           names[1]: [jnp.asarray(caches[1])]}
    ins.update({k: [jnp.asarray(v)] for k, v in feeds.items()})
    return ins


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def check_cache(got, want, written):
    """A cache after the op: the rows in ``written`` ([k, 2] (slot, row)
    pairs) at 1e-5, every other row bit-identical."""
    got = np.asarray(got).reshape(N * S, -1)
    want = np.asarray(want).reshape(N * S, -1)
    flat = np.asarray(written, np.int64).reshape(-1, 2)
    flat = flat[:, 0] * S + flat[:, 1]
    other = np.setdiff1d(np.arange(N * S), flat)
    np.testing.assert_array_equal(got[other], want[other])
    np.testing.assert_allclose(got[flat], want[flat], **TOL)


def _decode_feeds():
    """0, 1: mid-stream; 2: active, but its pos lies past the cache (the
    write drops); 3: a free slot, pos -1; 4: a short prompt in a larger
    bucket."""
    return {"Pos": np.array([[9], [6], [S], [-1], [5]], np.int64),
            "SeqLen": np.array([[3], [4], [5], [0], [2]], np.int64),
            "GenStart": np.array([[4], [4], [8], [0], [4]], np.int64),
            "Active": np.array([[1], [1], [1], [0], [1]], np.int64)}


def _verify_feeds():
    """0: a full window; 1: a window of one (plain decode); 2: a window
    running past the cache's 16 rows (positions 16 and 17 drop); 3: a
    free slot, pos -1; 4: a window of three."""
    return {"Pos": np.array([[9], [6], [14], [-1], [5]], np.int64),
            "SeqLen": np.array([[3], [4], [5], [0], [2]], np.int64),
            "GenStart": np.array([[4], [4], [8], [0], [4]], np.int64),
            "Active": np.array([[1], [1], [1], [0], [1]], np.int64),
            "WinLen": np.array([[4], [1], [4], [1], [3]], np.int64)}


def _window_rows(feeds, k1):
    """(slot, row) pairs a window writes, from the feeds alone: active,
    window position < WinLen, 0 <= pos + i < S."""
    pos = feeds["Pos"][:, 0]
    wlen = feeds["WinLen"][:, 0] if "WinLen" in feeds else np.ones(N, int)
    out = []
    for b in range(N):
        for i in range(k1):
            r = pos[b] + i
            if feeds["Active"][b, 0] and i < wlen[b] and 0 <= r < S:
                out.append((b, r))
    return out


def _run_window(op, feeds, k1, seed):
    """The JAX emitter and the port's op on the same window; returns
    (jres, port Out, port caches)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, k1, M).astype(np.float32)
    ws = _weights(rng)
    caches = _caches(rng)
    emit = {"decode": jkv._kv_attention_decode,
            "verify": jkv._kv_attention_verify}[op]
    jres = emit(None, _ins(x, ws, caches, ("CacheK", "CacheV"), feeds),
                {"n_head": H})
    tc = [_t(c.copy()) for c in caches]
    f = {k: _t(v) for k, v in feeds.items()}
    if op == "decode":
        out = tkv.kv_attention_decode(_t(x), *map(_t, ws), tc[0], tc[1],
                                      f["Pos"], f["SeqLen"], f["GenStart"],
                                      f["Active"], H)
    else:
        out = tkv.kv_attention_verify(_t(x), *map(_t, ws), tc[0], tc[1],
                                      f["Pos"], f["SeqLen"], f["GenStart"],
                                      f["Active"], f["WinLen"], H)
    return jres, out, tc, (x, ws, caches)


@pytest.mark.parametrize("op,k1", [("decode", 1), ("verify", K1)])
def test_window_ops_match_jax(op, k1):
    feeds = _decode_feeds() if op == "decode" else _verify_feeds()
    jres, out, tc, _ = _run_window(op, feeds, k1, seed=7 + k1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jres["Out"][0]),
                               **TOL)
    written = _window_rows(feeds, k1)
    assert len(written) == (3 if op == "decode" else 4 + 1 + 2 + 3)
    check_cache(tc[0].numpy(), jres["CacheKOut"][0], written)
    check_cache(tc[1].numpy(), jres["CacheVOut"][0], written)


def _project(x, w):
    b, t, _ = x.shape
    return (x.reshape(-1, M) @ w).reshape(b, t, H, D)


def _control(kind, x, ws, caches, feeds):
    """What a plain PyTorch write would leave in the K cache:
    ``"wrap"`` writes at pos by advanced indexing every row whose pos
    indexes the cache, active or not (a -1 lands on the slot's last
    row); ``"clamp"`` writes each live window position
    at min(pos + i, S - 1) (the overflow lands on the last row)."""
    k = torch.from_numpy(_project(x, ws[1]))
    cache = torch.from_numpy(caches[0].copy())
    pos = torch.from_numpy(feeds["Pos"][:, 0])
    if kind == "wrap":
        live = torch.from_numpy(feeds["Active"][:, 0] > 0) & (pos < S)
        rows = torch.arange(N)
        cache[rows[live | (pos < 0)], pos[live | (pos < 0)]] = \
            k[live | (pos < 0), 0]
        return cache.numpy()
    for b in range(N):
        for i in range(int(feeds["WinLen"][b, 0])):
            if feeds["Active"][b, 0]:
                cache[b, min(int(pos[b]) + i, S - 1)] = k[b, i]
    return cache.numpy()


@pytest.mark.parametrize("kind,op,k1", [("wrap", "decode", 1),
                                        ("clamp", "verify", K1)])
def test_plain_index_writes_fail_the_cache_check(kind, op, k1):
    """The controls: the JAX op's caches against a plain PyTorch write
    fail :func:`check_cache`, so the port's pass means its drop rule.
    With the trouble slot's row taken from the JAX op (the free slot for
    the wrap, the overflowing window for the clamp) the control passes:
    the failure is that slot's, and the rest of the control is right."""
    feeds = _decode_feeds() if op == "decode" else _verify_feeds()
    jres, _, _, (x, ws, caches) = _run_window(op, feeds, k1, seed=7 + k1)
    want = np.asarray(jres["CacheKOut"][0])
    written = _window_rows(feeds, k1)
    got = _control(kind, x, ws, caches, feeds)
    with pytest.raises(AssertionError):
        check_cache(got, want, written)
    trouble = 3 if kind == "wrap" else 2
    got[trouble] = want[trouble]
    check_cache(got, want, written)


def test_prefill_slot_matches_jax():
    """Two prompts of 6 positions into slots 3 and 1 of the pool: each
    slot's whole row is the prompt's K/V and zeros beyond, the other
    slots bit-identical."""
    rng = np.random.RandomState(11)
    t = 6
    x = rng.randn(2, t, M).astype(np.float32)
    ws = _weights(rng)
    pools = _caches(rng)
    slot = np.array([[3], [1]], np.int64)
    jres = jkv._kv_attention_prefill_slot(
        None, _ins(x, ws, pools, ("PoolK", "PoolV"), {"Slot": slot}),
        {"n_head": H})
    tp = [_t(p.copy()) for p in pools]
    out = tkv.kv_attention_prefill_slot(_t(x), *map(_t, ws), tp[0], tp[1],
                                        _t(slot), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(jres["Out"][0]),
                               **TOL)
    written = [(int(s), r) for s in slot[:, 0] for r in range(S)]
    for plane, name in ((0, "PoolKOut"), (1, "PoolVOut")):
        check_cache(tp[plane].numpy(), jres[name][0], written)
        assert not tp[plane][slot[:, 0], t:].any()


def test_prefill_matches_jax():
    """The wave prefill: Out and fresh caches of cache_len S, the
    prompt's K/V in [:, :T] and zeros beyond."""
    rng = np.random.RandomState(12)
    t = 6
    x = rng.randn(3, t, M).astype(np.float32)
    ws = _weights(rng)
    ins = {"X": [jnp.asarray(x)],
           **{n: [jnp.asarray(w)] for n, w in zip(("Wq", "Wk", "Wv", "Wo"),
                                                   ws)}}
    jres = jkv._kv_attention_prefill(None, ins, {"n_head": H,
                                                 "cache_len": S})
    out, ck, cv = tkv.kv_attention_prefill(_t(x), *map(_t, ws), H, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(jres["Out"][0]),
                               **TOL)
    for got, name in ((ck, "CacheK"), (cv, "CacheV")):
        assert got.shape == (3, S, H, D)
        np.testing.assert_allclose(got[:, :t].numpy(),
                                   np.asarray(jres[name][0])[:, :t], **TOL)
        assert not got[:, t:].any()


def test_contiguous_and_paged_decode_are_the_same_bits():
    """One page of S rows a slot: the paged op over that pool and the
    contiguous op over the same rows give the same bits, Out and
    caches."""
    rng = np.random.RandomState(13)
    x = rng.randn(N, K1, M).astype(np.float32)
    ws = [_t(w) for w in _weights(rng)]
    caches = _caches(rng)
    f = {k: _t(v) for k, v in _verify_feeds().items()}
    tc = [_t(c.copy()) for c in caches]
    tp = [_t(c.copy()) for c in caches]
    out_c = tkv.kv_attention_verify(_t(x), *ws, tc[0], tc[1], f["Pos"],
                                    f["SeqLen"], f["GenStart"], f["Active"],
                                    f["WinLen"], H)
    table = torch.arange(N)[:, None]
    out_p = tkv.kv_attention_verify_paged(_t(x), *ws, tp[0], tp[1], table,
                                          f["Pos"], f["SeqLen"],
                                          f["GenStart"], f["Active"],
                                          f["WinLen"], H)
    assert torch.equal(out_c, out_p)
    assert torch.equal(tc[0], tp[0]) and torch.equal(tc[1], tp[1])
