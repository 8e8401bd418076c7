"""The decoder LM's serving programs in the port (``paddle_tpu_torch``:
``fluid/models/transformer.py`` ``decoder_lm`` / ``build_decoder_lm_programs``
/ ``slot_modes``, the ``kv_attention_*`` and ``token_sample`` layers,
``gather`` / ``expand``, ``analysis/contracts.py`` and the engines over a
program family) against the JAX package, on the CPU.

At ``tests/test_torch_decoder_lm_serving.py``'s widths (vocab 32, d_model
16, 2 heads, 2 layers, prompt buckets 4/8, cache_len 16, 4 slots, pages
of 4 rows):

- every mode of ``DECODER_LM_MODES`` builds equal to the JAX build as JSON
  values, main and startup (bucketed prefills; paged under codecs none,
  bf16 and int8; with ``spec_k``), with the same feed specs, fetch names
  and geometry record;
- each of the ten new emitters equals the JAX emitter on the same seeded
  inputs (outputs rtol / atol 1e-5: fp32 sums in another order), covering
  sentinel rows, inactive slots, prefix-shared rows, ``win_len`` < K + 1
  and int8; after each op, every pool row the op must not write is
  bit-unchanged and the written rows agree (fp32 / bf16 rtol 1e-5, int8
  codes within one step, scales rtol 1e-5);
- every op of every view infers its shapes on meta tensors;
- the program engines (``make_slot_model(name, programs)`` paged none and
  int8, paged with the verify view, contiguous with the verify view;
  ``GenerativeModel(name, programs)``) give the JAX program engines'
  streams token for token, greedy and seeded sampled, on the JAX
  startup's weights carried across (the paged ones also sharing a
  prefix page), and the ``full`` view's logits within rtol / atol 1e-5;
- the program engines equal the port's nn.Module engines on the same
  weights;
- the geometry errors are the JAX record's;
- the new modules import with neither ``jax`` nor ``paddle_tpu`` loaded.

The JAX engines are built once per module (each costs a few jit
compiles), under a ``unique_name`` guard; every engine here has a name of
its own (``sprog_*``): the serving families are process-wide.
"""

import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import contracts as jcontracts
from paddle_tpu.core import registry as jreg
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import transformer as jT
from paddle_tpu.serving import bucketing as jbucketing
from paddle_tpu.serving import engine as jeng

import paddle_tpu.ops  # noqa: F401  (registers the JAX emitters)

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.analysis import contracts as tcontracts
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import shape_inference as tsi
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.models import transformer as tT
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import transformer as tmodels
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.serving import bucketing as tbucketing
from paddle_tpu_torch.serving import engine as teng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab=32, d_model=16, d_inner=32, n_head=2, n_layer=2)
PROMPT_LEN, MAX_NEW, BUCKETS = 8, 8, (4, 8)
CACHE_LEN = PROMPT_LEN + MAX_NEW
SLOTS = dict(n_slots=4)
PAGED = dict(n_slots=4, page_size=4)
SPEC_K = 3
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=1e-5, atol=1e-6)
_NAMES = itertools.count()


def _name(kind):
    return f"sprog_{kind}{next(_NAMES)}"


@pytest.fixture(autouse=True)
def fp32_matmuls():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _build(side, **kw):
    """One package's family under a fresh name guard."""
    kw = dict(prompt_len=PROMPT_LEN, max_new=MAX_NEW, **LM, **kw)
    if side == "jax":
        with junique.guard():
            return jT.build_decoder_lm_programs(**kw)
    with tunique.guard():
        return tT.build_decoder_lm_programs(**kw)


def _json(program):
    return json.loads(program.desc.serialize_to_string())


def _diffs(a, b, path=""):
    """The first paths where two JSON values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(f"{path}/{k}: only in one")
            else:
                out += _diffs(a[k], b[k], f"{path}/{k}")
        return out[:8]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diffs(x, y, f"{path}[{i}]")][:8]
    return [] if a == b else [f"{path}: port {a!r:.80} jax {b!r:.80}"]


# -- the builds -----------------------------------------------------------------

ALL_MODES = jcontracts.DECODER_LM_MODES
BUILDS = {
    "every_mode_bucketed": dict(modes=ALL_MODES, prompt_buckets=BUCKETS,
                                spec_k=SPEC_K, **PAGED),
    "paged_bf16_spec": dict(modes=jT.slot_modes("paged", spec=True),
                            prompt_buckets=BUCKETS, kv_codec="bf16",
                            spec_k=SPEC_K, **PAGED),
    "paged_int8_spec": dict(modes=jT.slot_modes("paged", spec=True),
                            prompt_buckets=BUCKETS, kv_codec="int8",
                            spec_k=SPEC_K, n_pages=9, **PAGED),
    "contiguous_spec_default_k": dict(
        modes=jT.slot_modes("contiguous", spec=True), **SLOTS),
    "wave_defaults": dict(),
    "paged_one_bucket_wide_pages": dict(modes=("prefill_paged",
                                               "decode_paged"),
                                        n_slots=2, page_size=8),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_build_matches_jax(case):
    jp, tp = _build("jax", **BUILDS[case]), _build("port", **BUILDS[case])
    assert sorted(tp) == sorted(jp)
    for key in jp:
        for i, what in ((0, "main"), (1, "startup")):
            a, b = _json(tp[key][i]), _json(jp[key][i])
            assert a == b, (key, what, _diffs(a, b))
        assert tp[key][2:] == jp[key][2:], key         # feeds, fetch
        assert tp[key][0]._is_test and jp[key][0]._is_test
        assert (tp[key][0]._geometry.as_dict()
                == jp[key][0]._geometry.as_dict()), key


def test_slot_modes_and_flags_match_jax():
    for layout in ("contiguous", "paged"):
        for spec in (False, True):
            assert tT.slot_modes(layout, spec) == jT.slot_modes(layout, spec)
    assert tT.slot_modes() == ("prefill_slot", "decode_slot")
    tflags.set("kv_cache_layout", "paged")
    try:
        assert tT.slot_modes() == ("prefill_paged", "decode_paged")
    finally:
        tflags.reset("kv_cache_layout")
    tflags.set("kv_cache_codec", "int8")
    try:
        g = tcontracts.validate_geometry("decode_paged", 8, 8, n_slots=2)
        assert (g.kv_codec, g.store_dtype) == ("int8", "int8")
    finally:
        tflags.reset("kv_cache_codec")
    assert tmodels.build_decoder_lm_programs is tT.build_decoder_lm_programs
    assert tmodels.decoder_lm is tT.decoder_lm
    assert tmodels.slot_modes is tT.slot_modes


BAD_GEOMETRY = [
    ("decode_paged", 8, 8, dict()),                         # no n_slots
    ("nope", 8, 8, dict()),
    ("decode", 20, 8, dict(cache_len=16)),
    ("decode_verify", 8, 8, dict(n_slots=2, spec_k=-1)),
    ("decode_verify_paged", 8, 8, dict(n_slots=2, spec_k=9)),
    ("prefill_paged", 8, 8, dict(n_slots=2, page_size=3)),
    ("decode_paged", 8, 8, dict(n_slots=2, page_size=4, n_pages=3)),
    ("decode_paged", 8, 8, dict(n_slots=2, kv_codec="fp8")),
]


@pytest.mark.parametrize("mode,p,n,kw", BAD_GEOMETRY)
def test_geometry_errors_match_jax(mode, p, n, kw):
    with pytest.raises(ValueError) as want:
        jcontracts.validate_geometry(mode, p, n, **kw)
    with pytest.raises(ValueError) as got:
        tcontracts.validate_geometry(mode, p, n, **kw)
    assert str(got.value) == str(want.value)


def test_geometry_records_match_jax_and_count():
    fam = tmetrics.counter("paddle_analysis_contract_checks_total", "",
                           ("check",)).labels(check="geometry")
    before = fam.value
    for mode in ALL_MODES:
        kw = dict(n_slots=3, page_size=4, kv_codec="int8", spec_k=2)
        assert (tcontracts.validate_geometry(mode, 8, 8, **kw).as_dict()
                == jcontracts.validate_geometry(mode, 8, 8, **kw).as_dict())
    assert fam.value - before == len(ALL_MODES)
    with pytest.raises(ValueError) as want:
        jT.build_decoder_lm_programs(prompt_len=8, prompt_buckets=(4, 6))
    with pytest.raises(ValueError) as got:
        tT.build_decoder_lm_programs(prompt_len=8, prompt_buckets=(4, 6))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="kv_cache_layout"):
        tT.slot_modes("ring")


# -- the emitters ------------------------------------------------------------------

H, D = 2, 8
M = H * D


def _jax_emit(op_type, ins, attrs):
    ctx = jreg.EmitContext(base_key=jax.random.PRNGKey(0), is_test=True)
    j_ins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    out = jreg.get_op(op_type).emit(ctx, j_ins, attrs)
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _port_emit(op_type, ins, attrs):
    t_ins = {k: [torch.from_numpy(np.array(a)) for a in v]
             for k, v in ins.items()}
    out = treg.get_op(op_type).emit(None, t_ins, attrs)
    res = {}
    for k, v in out.items():
        res[k] = [a.float().numpy() if a.dtype == torch.bfloat16
                  else a.numpy() for a in v]
    return res, t_ins


def _weights(rng):
    return {n: [rng.normal(0, M ** -0.5, (M, M)).astype(np.float32)]
            for n in ("Wq", "Wk", "Wv", "Wo")}


def _canonical(a):
    """int64 as the JAX package's int32 (64-bit types off)."""
    a = np.asarray(a)
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _pool(rng, shape, codec):
    if codec == "int8":
        return rng.randint(-127, 128, shape).astype(np.int8)
    x = rng.normal(0, 1, shape).astype(np.float32)
    if codec == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16)
    return x


def _as_np(p):
    return p.float().numpy() if isinstance(p, torch.Tensor) else p


def _as_jax(p):
    """A test input for the JAX emitter: a bf16 pool stays bf16."""
    if isinstance(p, torch.Tensor):
        return jnp.asarray(p.float().numpy(), dtype=jnp.bfloat16)
    return p


def _check_pool(name, before, got, want, written, codec):
    """Rows (first axis of the flat [R, ...] view) not in ``written``
    are bit-unchanged in the port's pool; the written rows agree with the
    JAX op's."""
    before, got, want = (np.asarray(_as_np(a)) for a in (before, got, want))
    if before.dtype != np.int8:
        before, got, want = (a.astype(np.float32)
                             for a in (before, got, want))
    r = before.shape[0] * before.shape[1] if before.ndim == 4 else \
        before.shape[0] * before.shape[1]
    b, g, w = (a.reshape(r, -1) for a in (before, got, want))
    keep = np.setdiff1d(np.arange(r), written)
    np.testing.assert_array_equal(g[keep], b[keep], err_msg=name)
    if codec == "int8" and g.dtype == np.int8:
        assert np.abs(g[written].astype(np.int32)
                      - w[written].astype(np.int32)).max() <= 1, name
    else:
        np.testing.assert_allclose(g[written], w[written], err_msg=name,
                                   **POOL_TOL)


def test_gather_and_expand_match_jax():
    rng = np.random.RandomState(0)
    table = rng.normal(size=(6, 3)).astype(np.float32)
    for idx in (np.array([[2], [0], [5]]), np.array([[-1], [9], [3]]),
                np.array([[1, 4], [-7, 2]])):
        ins = {"X": [table], "Index": [idx.astype(np.int64)]}
        np.testing.assert_array_equal(_port_emit("gather", ins, {})[0]["Out"][0],
                                      _jax_emit("gather", ins, {})["Out"][0])
    ints = {"X": [np.arange(10, dtype=np.int64).reshape(5, 2)],
            "Index": [np.array([4, 7, -2])]}
    np.testing.assert_array_equal(
        _canonical(_port_emit("gather", ints, {})[0]["Out"][0]),
        _jax_emit("gather", ints, {})["Out"][0])
    x = rng.randint(0, 9, (3, 1)).astype(np.int64)
    for times in ([1, 4], [2, 1], [3], [2, 1, 2]):
        ins, attrs = {"X": [x]}, {"expand_times": times}
        np.testing.assert_array_equal(
            _canonical(_port_emit("expand", ins, attrs)[0]["Out"][0]),
            _jax_emit("expand", ins, attrs)["Out"][0])


def test_token_sample_matches_jax():
    rng = np.random.RandomState(1)
    b, v = 8, 40
    ins = {"Logits": [rng.normal(0, 2, (b, v)).astype(np.float32)],
           "Temperature": [np.array([[0], [.8], [1.3], [.5], [0], [.9],
                                     [2.], [.7]], np.float32)],
           "TopK": [np.array([[0], [5], [0], [1], [3], [40], [2], [-1]],
                             np.int64)],
           "Seed": [np.array([[5], [2 ** 31 + 9], [-3], [7], [0], [11],
                              [123456789], [2 ** 40]], np.int64)],
           "StepIdx": [rng.randint(0, 200, (b, 1)).astype(np.int64)]}
    got = _port_emit("token_sample", ins, {})[0]["Out"][0]
    assert got.shape == (b, 1)
    np.testing.assert_array_equal(_canonical(got),
                                  _jax_emit("token_sample", ins, {})["Out"][0])


def test_prefill_matches_jax():
    rng = np.random.RandomState(2)
    ins = {"X": [rng.normal(size=(2, 5, M)).astype(np.float32)],
           **_weights(rng)}
    attrs = {"n_head": H, "cache_len": 7}
    got, _ = _port_emit("kv_attention_prefill", ins, attrs)
    want = _jax_emit("kv_attention_prefill", ins, attrs)
    for slot in ("Out", "CacheK", "CacheV"):
        np.testing.assert_allclose(got[slot][0], want[slot][0],
                                   err_msg=slot, **OUT_TOL)
    assert not got["CacheK"][0][:, 5:].any()


def test_prefill_slot_matches_jax():
    rng = np.random.RandomState(3)
    n, s = 4, 7
    pools = [rng.normal(size=(n, s, H, D)).astype(np.float32)
             for _ in range(2)]
    ins = {"X": [rng.normal(size=(2, 5, M)).astype(np.float32)],
           **_weights(rng), "PoolK": [pools[0].copy()],
           "PoolV": [pools[1].copy()],
           "Slot": [np.array([[3], [1]], np.int64)]}
    got, t_ins = _port_emit("kv_attention_prefill_slot", ins, {"n_head": H})
    want = _jax_emit("kv_attention_prefill_slot", ins, {"n_head": H})
    np.testing.assert_allclose(got["Out"][0], want["Out"][0], **OUT_TOL)
    rows = np.concatenate([np.arange(3 * s, 4 * s), np.arange(s, 2 * s)])
    for i, (slot, out) in enumerate((("PoolK", "PoolKOut"),
                                     ("PoolV", "PoolVOut"))):
        # the op writes the scope's pool in place and returns it
        assert got[out][0] is not None
        np.testing.assert_array_equal(t_ins[slot][0].numpy(), got[out][0])
        _check_pool(out, pools[i], got[out][0], want[out][0], rows, "none")


def _window_feeds(rng, b, k1, s_len, inactive=(), win=None):
    pos = rng.randint(4, s_len - k1, (b, 1)).astype(np.int64)
    lens = rng.randint(1, 4, (b, 1)).astype(np.int64)
    gen0 = np.full((b, 1), 4, np.int64)
    active = np.ones((b, 1), np.int64)
    for r in inactive:
        active[r] = 0
        pos[r] = -1
    feeds = {"Pos": [pos], "SeqLen": [lens], "GenStart": [gen0],
             "Active": [active]}
    if win is not None:
        feeds["WinLen"] = [np.asarray(win, np.int64).reshape(b, 1)]
    return feeds


@pytest.mark.parametrize("k1", [1, 4])
def test_contiguous_decode_and_verify_match_jax(k1):
    rng = np.random.RandomState(4 + k1)
    b, s_len = 4, 12
    op = "kv_attention_decode" if k1 == 1 else "kv_attention_verify"
    win = None if k1 == 1 else [4, 2, 1, 3]
    feeds = _window_feeds(rng, b, k1, s_len, inactive=(2,), win=win)
    if k1 > 1:
        feeds["Pos"][0][3] = s_len - 2      # a window running past S
    pools = [rng.normal(size=(b, s_len, H, D)).astype(np.float32)
             for _ in range(2)]
    ins = {"X": [rng.normal(size=(b, k1, M)).astype(np.float32)],
           **_weights(rng), "CacheK": [pools[0].copy()],
           "CacheV": [pools[1].copy()], **feeds}
    got, _ = _port_emit(op, ins, {"n_head": H})
    want = _jax_emit(op, ins, {"n_head": H})
    act = feeds["Active"][0][:, 0] > 0
    np.testing.assert_allclose(got["Out"][0][act], want["Out"][0][act],
                               **OUT_TOL)
    pos = feeds["Pos"][0][:, 0]
    wl = np.asarray(win if win is not None else [1] * b)
    written = [r * s_len + pos[r] + i for r in range(b) if act[r]
               for i in range(min(wl[r], k1)) if pos[r] + i < s_len]
    for i, out in enumerate(("CacheKOut", "CacheVOut")):
        _check_pool(out, pools[i], got[out][0], want[out][0],
                    np.asarray(written), "none")


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_prefill_paged_matches_jax(codec):
    rng = np.random.RandomState(7)
    n_pages, ps, t = 6, 4, 8
    pools = [_pool(rng, (n_pages, ps, H, D), codec) for _ in range(2)]
    rows = np.arange(t) + 8
    rows[:4] = n_pages * ps                 # a prefix-shared page
    rows[6] = n_pages * ps + 5              # a sentinel past the pool
    ins = {"X": [rng.normal(size=(1, t, M)).astype(np.float32)],
           **_weights(rng), "Rows": [rows[:, None].astype(np.int64)],
           "PageK": [pools[0]], "PageV": [pools[1]]}
    outs = ["PageKOut", "PageVOut"]
    before = [pools[0], pools[1]]
    if codec == "int8":
        scales = [rng.uniform(.01, .1, (n_pages, ps, H)).astype(np.float32)
                  for _ in range(2)]
        ins.update(PageKS=[scales[0]], PageVS=[scales[1]])
        outs += ["PageKSOut", "PageVSOut"]
        before += scales
    jins = {k: [_as_jax(a) for a in v] for k, v in ins.items()}
    pins = {k: [(a.clone() if isinstance(a, torch.Tensor) else a.copy())
                for a in v] for k, v in ins.items()}
    attrs = {"n_head": H, "codec": codec}
    got = _port_emit_any("kv_attention_prefill_paged", pins, attrs)
    want = _jax_emit("kv_attention_prefill_paged", jins, attrs)
    np.testing.assert_allclose(got["Out"][0], want["Out"][0], **OUT_TOL)
    written = rows[rows < n_pages * ps]
    for out, b in zip(outs, before):
        _check_pool(out, b, got[out][0], want[out][0], written, codec)


def _port_emit_any(op_type, ins, attrs):
    """As :func:`_port_emit` for inputs that may be bf16 tensors."""
    t_ins = {k: [a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.array(a)) for a in v]
             for k, v in ins.items()}
    out = treg.get_op(op_type).emit(None, t_ins, attrs)
    return {k: [_as_np(a) if a.dtype == torch.bfloat16 else a.numpy()
                for a in v] for k, v in out.items()}


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("k1", [1, 3])
def test_paged_decode_and_verify_match_jax(codec, k1):
    rng = np.random.RandomState(9 + k1)
    b, n_pages, ps, mp = 4, 10, 4, 3
    s_len = mp * ps
    op = "kv_attention_decode_paged" if k1 == 1 else \
        "kv_attention_verify_paged"
    win = None if k1 == 1 else [3, 2, 1, 3]
    feeds = _window_feeds(rng, b, k1, s_len, inactive=(1,), win=win)
    table = np.array([[0, 1, 2], [3, n_pages, n_pages], [4, 5, n_pages],
                      [6, 7, 8]], np.int64)
    if k1 > 1:
        feeds["Pos"][0][2] = 6               # its window runs past the lease
        feeds["Pos"][0][0] = 9               # and past the table's span
    pools = [_pool(rng, (n_pages, ps, H, D), codec) for _ in range(2)]
    ins = {"X": [rng.normal(size=(b, k1, M)).astype(np.float32)],
           **_weights(rng), "PageK": [pools[0]], "PageV": [pools[1]],
           "PageTable": [table], **feeds}
    outs = ["PageKOut", "PageVOut"]
    before = [pools[0], pools[1]]
    if codec == "int8":
        scales = [rng.uniform(.01, .1, (n_pages, ps, H)).astype(np.float32)
                  for _ in range(2)]
        ins.update(PageKS=[scales[0]], PageVS=[scales[1]])
        outs += ["PageKSOut", "PageVSOut"]
        before += scales
    jins = {k: [_as_jax(a) for a in v] for k, v in ins.items()}
    pins = {k: [(a.clone() if isinstance(a, torch.Tensor) else a.copy())
                for a in v] for k, v in ins.items()}
    attrs = {"n_head": H, "codec": codec}
    got = _port_emit_any(op, pins, attrs)
    want = _jax_emit(op, jins, attrs)
    act = feeds["Active"][0][:, 0] > 0
    np.testing.assert_allclose(got["Out"][0][act], want["Out"][0][act],
                               **OUT_TOL)
    pos = feeds["Pos"][0][:, 0]
    wl = np.asarray(win if win is not None else [1] * b)
    written = []
    for r in range(b):
        for i in range(min(wl[r], k1)):
            p = pos[r] + i
            if act[r] and p < s_len and table[r, p // ps] < n_pages:
                written.append(table[r, p // ps] * ps + p % ps)
    for out, bf in zip(outs, before):
        _check_pool(out, bf, got[out][0], want[out][0],
                    np.asarray(written, np.int64), codec)


def test_dropped_writes_leave_the_pool_bit_unchanged():
    """All rows of a write sentinels: the pool keeps every bit (the
    on-device drop writes the rows' own bits back)."""
    rng = np.random.RandomState(12)
    n_pages, ps = 3, 4
    pools = [rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
             for _ in range(2)]
    ins = {"X": [rng.normal(size=(1, 4, M)).astype(np.float32)],
           **_weights(rng), "Rows": [np.full((4, 1), n_pages * ps,
                                             np.int64)],
           "PageK": [pools[0].copy()], "PageV": [pools[1].copy()]}
    got, _ = _port_emit("kv_attention_prefill_paged", ins,
                        {"n_head": H, "codec": "none"})
    np.testing.assert_array_equal(got["PageKOut"][0], pools[0])
    np.testing.assert_array_equal(got["PageVOut"][0], pools[1])


# -- every view infers its shapes on meta tensors ----------------------------------

def test_every_view_infers_shapes_on_meta_tensors():
    progs = _build("port", **BUILDS["every_mode_bucketed"])
    progs.update(_build("port", **BUILDS["paged_int8_spec"]))
    checked = 0
    for key, (main, _, _, _) in progs.items():
        block = main.desc.global_block
        for op in block.ops:
            res = tsi.abstract_eval_op(block, op)
            assert res.ok, (key, op.type, res.skipped, res.error)
            for n, (shape, dtype) in res.outputs.items():
                v = block.var(n)
                assert (list(shape), dtype) == (list(v.shape), v.dtype), \
                    (key, op.type, n)
            checked += 1
    assert checked > 200


# -- the engines -------------------------------------------------------------------

def _carry(jscope, tscope, progs):
    """The JAX startup's parameters into a port scope."""
    for key in progs:
        for p in progs[key][0].global_block().all_parameters():
            tscope.set_var(p.name, torch.from_numpy(
                np.array(jscope.find_var(p.name))))


@pytest.fixture(scope="module")
def jax_families():
    """One JAX engine per family, built on first use and kept for the
    module."""
    built = {}

    def get(kind):
        if kind not in built:
            if kind == "wave":
                progs = _build("jax", prompt_buckets=BUCKETS,
                               modes=("prefill", "decode", "full"))
                eng = jeng.GenerativeModel(
                    _name("jwave"), progs, jbucketing.BucketPolicy((8,)))
            else:
                layout, spec, codec = kind
                kw = dict(PAGED if layout == "paged" else SLOTS)
                if layout == "paged":
                    kw["kv_codec"] = codec
                progs = _build("jax", prompt_buckets=BUCKETS,
                               modes=jT.slot_modes(layout, spec),
                               spec_k=SPEC_K if spec else None, **kw)
                eng = jeng.make_slot_model(_name("jslot"), progs)
            built[kind] = (progs, eng)
        progs, eng = built[kind]
        if kind != "wave":
            eng.reset()
        return progs, eng
    return get


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, 32, (int(n),)) for n in (3, 4, 7, 8, 5, 2)]


SAMPLED = dict(max_new=6, temperature=0.8, top_k=5,
               seeds=[5, 2 ** 31 + 9, -3, 2 ** 40, 123456789, 0])


def _port_slot(kind, jprogs, jeng_):
    layout, spec, codec = kind
    kw = dict(PAGED if layout == "paged" else SLOTS)
    if layout == "paged":
        kw["kv_codec"] = codec
    progs = _build("port", prompt_buckets=BUCKETS,
                   modes=tT.slot_modes(layout, spec),
                   spec_k=SPEC_K if spec else None, **kw)
    e = teng.make_slot_model(_name("tslot"), progs, device="cpu")
    _carry(jeng_.scope, e.scope, progs)
    e.warmup()
    return e


def _equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


SLOT_KINDS = [("paged", False, "none"), ("paged", False, "int8"),
              ("paged", True, "none"), ("contiguous", True, "none")]


@pytest.mark.parametrize("kind", SLOT_KINDS,
                         ids=["-".join(map(str, k)) for k in SLOT_KINDS])
def test_slot_program_engine_streams_match_jax(jax_families, kind):
    """Greedy and seeded sampled streams; on the paged pool a request
    that shares a full prompt page with a live one skips that page's
    writes (sentinel rows, dropped on the device), as the JAX engine."""
    jprogs, jm = jax_families(kind)
    e = _port_slot(kind, jprogs, jm)
    layout, spec, _ = kind
    assert isinstance(e, teng.PagedSlotGenerativeModel
                      if layout == "paged" else
                      teng.ContiguousSlotGenerativeModel)
    assert (e.n_slots, e.prompt_buckets, e.cache_len, e.spec_k) == \
        (4, BUCKETS, CACHE_LEN, SPEC_K if spec else 0)
    _equal(jm.generate(_prompts(), max_new=6),
           e.generate(_prompts(), max_new=6))
    jm.reset()
    e.reset()
    _equal(jm.generate(_prompts(), **SAMPLED),
           e.generate(_prompts(), **SAMPLED))
    if layout != "paged":
        return
    jm.reset()
    e.reset()
    base = np.arange(1, 9)
    for prompt in (base, np.concatenate([base[:4], [20, 21, 22]])):
        got, want = e.admit(prompt, max_new=5), jm.admit(prompt, max_new=5)
        assert got == want
        assert e.pool.lease(got[0]).n_shared == \
            jm.pool.lease(want[0]).n_shared
    assert e.pool.lease(1).n_shared == 1
    while e.active_count():
        assert e.step() == jm.step()


def test_wave_program_engine_matches_jax(jax_families):
    jprogs, jm = jax_families("wave")
    progs = _build("port", prompt_buckets=BUCKETS,
                   modes=("prefill", "decode", "full"))
    e = teng.GenerativeModel(_name("twave"), progs,
                             policy=tbucketing.BucketPolicy((8,)),
                             device="cpu")
    assert e.prompt_buckets == BUCKETS and e.max_new == MAX_NEW
    _carry(jm.scope, e.scope, progs)
    _equal(jm.generate(_prompts(), max_new=6),
           e.generate(_prompts(), max_new=6))
    _equal(jm.full_forward_generate(_prompts()[:4], max_new=5),
           e.full_forward_generate(_prompts()[:4], max_new=5))
    ids = np.random.RandomState(4).randint(0, 32, (3, CACHE_LEN))
    jfull = jprogs["full"]
    got = e.model.run("full", ids=torch.from_numpy(ids)).numpy()
    from paddle_tpu.core.lowering import CompiledBlock
    cb = CompiledBlock(jfull[0].desc, 0, ["ids"], [jfull[3]], is_test=True)
    consts = {n: jm.scope.find_var(n) for n in cb.sig.const_names}
    want = np.asarray(cb.fn({}, consts, {"ids": ids[..., None]},
                            np.uint32(0))[0][0])
    np.testing.assert_allclose(got, want, **OUT_TOL)


@pytest.fixture(scope="module")
def module_weights():
    """Seeded weights under the JAX names, a DecoderLM on them and the
    arrays."""
    rng = np.random.RandomState(21)
    progs = _build("port", modes=("decode_paged",), n_slots=4, page_size=4)
    arrays = {p.name: rng.normal(0, 0.3, p.shape).astype(np.float32)
              for p in progs["decode_paged"][0].global_block()
              .all_parameters()}
    lm = tmodels.DecoderLM(**LM, cache_len=CACHE_LEN, device="cpu")
    lm.load_state_dict(convert.params_from_jax(arrays))
    return arrays, lm


@pytest.mark.parametrize("layout,codec,spec", [
    ("paged", "none", False), ("paged", "int8", False),
    ("contiguous", "none", False)])
def test_program_engine_matches_the_module_engine(module_weights, layout,
                                                  codec, spec):
    arrays, lm = module_weights
    kw = dict(PAGED if layout == "paged" else SLOTS)
    extra = dict(kv_codec=codec) if layout == "paged" else {}
    progs = _build("port", prompt_buckets=BUCKETS,
                   modes=tT.slot_modes(layout, spec),
                   spec_k=SPEC_K if spec else None, **kw, **extra)
    prog_e = teng.make_slot_model(_name("tprog"), progs, device="cpu")
    for n, a in arrays.items():
        prog_e.scope.set_var(n, torch.from_numpy(a))
    mod_e = teng.make_slot_model(_name("tmod"), lm, prompt_buckets=BUCKETS,
                                 layout=layout, device="cpu",
                                 spec_k=SPEC_K if spec else None, **kw,
                                 **extra)
    _equal(mod_e.generate(_prompts(), max_new=7),
           prog_e.generate(_prompts(), max_new=7))
    mod_e.reset()
    prog_e.reset()
    _equal(mod_e.generate(_prompts(), **SAMPLED),
           prog_e.generate(_prompts(), **SAMPLED))


def test_wave_program_engine_matches_the_module_engine(module_weights):
    arrays, lm = module_weights
    progs = _build("port", prompt_buckets=BUCKETS,
                   modes=("prefill", "decode", "full"))
    policy = tbucketing.BucketPolicy((1, 2, 4, 8))
    prog_e = teng.GenerativeModel(_name("tpw"), progs, policy=policy,
                                  device="cpu")
    for n, a in arrays.items():
        prog_e.scope.set_var(n, torch.from_numpy(a))
    mod_e = teng.GenerativeModel(_name("tmw"), lm, BUCKETS, policy)
    _equal(mod_e.generate(_prompts(), max_new=8),
           prog_e.generate(_prompts(), max_new=8))
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 32, (2, 11)))
    np.testing.assert_allclose(prog_e.model.full(ids).numpy(),
                               lm.full(ids).numpy(), **OUT_TOL)


def test_engines_refuse_what_the_port_lacks():
    progs = _build("port", modes=tT.slot_modes("paged"), **PAGED)
    with pytest.raises(NotImplementedError, match="A6.9"):
        teng.make_slot_model(_name("x"), progs, dist=object(),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="A6.9"):
        teng.GenerativeModel(_name("x"), _build("port"), dist=object(),
                             device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        teng.make_slot_model(_name("x"), progs, n_slots=4, device="cpu")
    with pytest.raises(ValueError, match="prompt buckets"):
        teng.GenerativeModel(_name("x"), _build("port"), (4, 8),
                             device="cpu")
    with pytest.raises(ValueError, match="decode_slot"):
        teng.make_slot_model(_name("x"), _build("port"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teng.make_slot_model(_name("x"), progs)


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import numpy as np\n"
            "import torch\n"
            "import paddle_tpu_torch.analysis.contracts\n"
            "from paddle_tpu_torch.fluid.models import transformer as T\n"
            "from paddle_tpu_torch.serving import engine\n"
            "from paddle_tpu_torch.core.registry import OPS\n"
            "import paddle_tpu_torch.ops.kv_attention\n"
            "assert len(OPS) == 124, sorted(OPS)\n"
            "p = T.build_decoder_lm_programs(prompt_len=4, max_new=4,\n"
            "    vocab=16, d_model=8, d_inner=8, n_head=2, n_layer=1,\n"
            "    modes=T.slot_modes('paged'), n_slots=2, page_size=2)\n"
            "e = engine.make_slot_model('lm_imp', p, device='cpu')\n"
            "out = e.generate([np.array([1, 2, 3])], max_new=3)\n"
            "assert out[0].shape == (3,)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'paddle_tpu'\n"
            "             or m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
