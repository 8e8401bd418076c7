"""The PyTorch port's masked sequence pool (paddle_tpu_torch/ops/kernels/
seqpool.py) and its callers ``sequence_pool`` and ``sequence_conv``
(paddle_tpu_torch/ops/sequence_ops.py) against the JAX package: the Pallas
kernel ``masked_seqpool`` in interpret mode (paddle_tpu/ops/pallas/
seqpool.py), its custom VJP, and the ``sequence_pool`` and
``sequence_conv`` ops through the executor (tests/op_test.py
``run_single_op``; on the CPU the ops take their composed branches).

Tolerances: rtol 1e-5 / atol 1e-6 for the pools and their gradients (one
fp32 sum over T in another order; on the card, at T 100, the rtol is
taken of the pool of |x|, since the error of a sum grows with its terms'
magnitudes, not with the sum); rtol 1e-5 / atol 1e-5 for
``sequence_conv`` (a product of depth 4 * 16 in another order).

The CUDA kernel runs only on the card: the ``gpu`` test holds it against
its plain version there and skips elsewhere
(``pytest --noconftest -m gpu tests/test_torch_seqpool.py``)."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import sequence_ops as tseq
from paddle_tpu_torch.ops.kernels import seqpool as tsp

POOL_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("SUM", "AVERAGE", "SQRT")


@pytest.fixture(scope="module")
def jx():
    """(jax, the JAX package's Pallas seqpool module)."""
    import importlib
    jax = pytest.importorskip("jax")
    return jax, importlib.import_module("paddle_tpu.ops.pallas.seqpool")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _data(b=5, t=7, d=128, seed=0):
    """B not a multiple of 8 (the TPU kernel pads it), one empty row, one
    full row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lens[0], lens[1] = t, 0
    return x, lens


@pytest.mark.parametrize("pooltype", MODES)
def test_plain_version_matches_the_pallas_kernel(jx, pooltype):
    jax, psp = jx
    x, lens = _data()
    want = psp.masked_seqpool(jax.numpy.asarray(x), jax.numpy.asarray(lens),
                              pooltype, True)
    got = tsp.masked_seqpool(torch.from_numpy(x), torch.from_numpy(lens),
                             pooltype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("pooltype", MODES)
def test_gradient_matches_the_pallas_vjp(jx, pooltype):
    jax, psp = jx
    x, lens = _data(seed=1)
    g = np.random.RandomState(2).randn(x.shape[0], x.shape[2]).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a: psp.masked_seqpool(
        a, jax.numpy.asarray(lens), pooltype, True), jax.numpy.asarray(x))
    (want,) = vjp(jax.numpy.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    tsp.masked_seqpool(xt, torch.from_numpy(lens), pooltype).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **POOL_TOL)


def _chunked_pool(x, lens, pooltype, warps, chunk):
    """The CUDA kernel's fp32 arithmetic in numpy: warp k sums rows
    [k chunk, (k + 1) chunk) of t below min(lens[b], T) in increasing t,
    the warps' sums are added in warp order, then divided by max(n, 1)
    (AVERAGE) or its square root (SQRT)."""
    b, t, d = x.shape
    out = np.zeros((b, d), np.float32)
    for row in range(b):
        end = min(max(int(lens[row]), 0), t)
        parts = []
        for k in range(warps):
            acc = np.zeros(d, np.float32)
            for tt in range(k * chunk, min(end, (k + 1) * chunk)):
                acc = acc + x[row, tt]
            parts.append(acc)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        denom = np.float32(max(int(lens[row]), 1))
        if pooltype == "SQRT":
            denom = np.sqrt(denom)
        out[row] = total if pooltype == "SUM" else total / denom
    return out


@pytest.mark.parametrize("pooltype", MODES)
def test_the_kernels_chunk_order_matches_the_pallas_kernel(jx, pooltype):
    """The redesigned kernel's order of the fp32 sum (T split into 8 chunks
    of 13 steps at T 100, the plan the wrapper passes: ``pool_warps`` and
    ``pool_chunk``), ragged lengths with 0, 1, T and one above T among
    them, against the JAX package's Pallas kernel in interpret mode: within
    rtol 1e-5 of the pool of |x|, atol 1e-6 (POOL_TOL, as the card's
    checks hold the kernel)."""
    jax, psp = jx
    rng = np.random.RandomState(9)
    b, t, d = 7, 100, 24
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.array([100, 0, 37, 1, 99, 13, 250], np.int32)
    warps = tsp.pool_warps(t, tsp.DTYPES[torch.float32])
    chunk = tsp.pool_chunk(t, warps)
    assert (warps, chunk) == (8, 13)
    got = _chunked_pool(x, lens, pooltype, warps, chunk)
    jnp = jax.numpy
    want = np.asarray(psp.masked_seqpool(jnp.asarray(x), jnp.asarray(lens),
                                         pooltype, True))
    scale = np.asarray(psp.masked_seqpool(jnp.asarray(np.abs(x)),
                                          jnp.asarray(lens), pooltype, True))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= POOL_TOL["atol"] + POOL_TOL["rtol"] * scale).all(), \
        float(err.max())
    assert (got[1] == 0).all()


@pytest.mark.parametrize("t", [0, 1, 7, 12, 13, 30, 96, 100, 1000])
def test_pool_chunks_cover_t(t):
    """The kernel's chunks of t: the ``pool_warps`` warps of a row (the
    plan the embedding gather + pool shares, held by its own test) take
    ``pool_chunk`` steps each; the chunks cover T, every warp's starts
    inside it, and none is longer than ~12 steps below 8 warps."""
    warps = tsp.pool_warps(t, tsp.DTYPES[torch.float32])
    chunk = tsp.pool_chunk(t, warps)
    assert warps * chunk >= t and (warps - 1) * chunk < max(t, 1)
    assert chunk <= tsp.STEPS_PER_WARP or warps == tsp.MAX_WARPS


@pytest.mark.parametrize("shape", [(5, 7, 6), (5, 7, 3, 4), (5, 7)],
                         ids=["rank3", "rank4", "rank2"])
@pytest.mark.parametrize("pooltype", MODES)
def test_sequence_pool_matches_the_jax_op_at_any_rank(pooltype, shape):
    from op_test import run_single_op
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    lens = np.array([7, 0, 3, 1, 5], np.int32)
    want = run_single_op("sequence_pool",
                         {"X": {"x": x}, "SeqLens": {"sl": lens}},
                         {"pooltype": pooltype})["__out_Out_0"]
    got = tseq.sequence_pool(torch.from_numpy(x), torch.from_numpy(lens),
                             pooltype)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), want, **POOL_TOL)


@pytest.mark.parametrize("dtype", ["float16", "int32"])
@pytest.mark.parametrize("pooltype", MODES)
def test_sequence_pool_matches_the_jax_op_at_other_dtypes(pooltype, dtype):
    """The refer branch pools every dtype, and so does the port: fp16 in
    fp16 (rtol 2e-3: two fp16 roundings), int32 summed exactly (int64 in
    the port, as torch.sum widens it), its AVERAGE and SQRT in fp32."""
    from op_test import run_single_op
    rng = np.random.RandomState(8)
    x = (rng.randn(5, 7, 6) * 4).astype(dtype)
    lens = np.array([7, 0, 3, 1, 5], np.int32)
    want = run_single_op("sequence_pool",
                         {"X": {"x": x}, "SeqLens": {"sl": lens}},
                         {"pooltype": pooltype})["__out_Out_0"]
    got = tseq.sequence_pool(torch.from_numpy(x), torch.from_numpy(lens),
                             pooltype)
    assert got.shape == tuple(want.shape)
    assert got.is_floating_point() == np.issubdtype(want.dtype, np.floating)
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=2e-3 if dtype == "float16" else 1e-6,
                               atol=1e-3 if dtype == "float16" else 0)


# float8 and unsigned arrays between numpy (ml_dtypes, as JAX takes them)
# and torch, by their bits
NARROW = {"float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2,
          "float8_e4m3fnuz": torch.float8_e4m3fnuz,
          "float8_e5m2fnuz": torch.float8_e5m2fnuz, "uint16": torch.uint16,
          "uint32": torch.uint32, "uint64": torch.uint64}


def _np_narrow(a: np.ndarray, dtype: str) -> np.ndarray:
    import ml_dtypes
    return a.astype(getattr(ml_dtypes, dtype) if dtype.startswith("float8")
                    else np.dtype(dtype))


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name.startswith("float8"):
        return torch.from_numpy(a.view(np.uint8)).view(NARROW[a.dtype.name])
    return torch.from_numpy(a.astype(np.int64)).to(NARROW[a.dtype.name])


def _values(t: torch.Tensor) -> np.ndarray:
    """float64 values of a float8, unsigned or float tensor."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64).numpy().astype(np.float64)
    return t.to(torch.float64 if t.is_floating_point() else torch.int64) \
        .numpy().astype(np.float64)


# what the reference's sequence_pool returns for these inputs on the CPU
# (x64 off: an unsigned sum is uint32)
JAX_DTYPE = {("float8_e4m3fn", "SUM"): "float8_e4m3fn",
             ("float8_e4m3fn", "AVERAGE"): "float8_e4m3fn",
             ("float8_e4m3fn", "SQRT"): "float8_e4m3fn",
             ("float8_e5m2", "SUM"): "float8_e5m2",
             ("float8_e4m3fnuz", "SUM"): "float8_e4m3fnuz",
             ("float8_e4m3fnuz", "AVERAGE"): "float8_e4m3fnuz",
             ("float8_e4m3fnuz", "SQRT"): "float8_e4m3fnuz",
             ("float8_e5m2fnuz", "SUM"): "float8_e5m2fnuz",
             ("float8_e5m2fnuz", "SQRT"): "float8_e5m2fnuz",
             ("uint32", "SUM"): "uint32", ("uint32", "AVERAGE"): "float32",
             ("uint32", "SQRT"): "float32", ("uint16", "SUM"): "uint32",
             ("uint64", "SQRT"): "float32"}
PORT_DTYPE = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2,
              "float8_e4m3fnuz": torch.float8_e4m3fnuz,
              "float8_e5m2fnuz": torch.float8_e5m2fnuz, "uint32": torch.uint64,
              "float32": torch.float32}


@pytest.mark.parametrize("dtype,pooltype", sorted(JAX_DTYPE))
def test_sequence_pool_matches_the_jax_op_at_float8_and_unsigned(dtype,
                                                                  pooltype):
    """The refer branch of the JAX op (``_sequence_pool``, called as the
    executor calls it: its program layer refuses these dtypes) pools
    float8 in float8, every partial sum rounded, and unsigned integers to
    an unsigned sum (uint32 without x64; the port's uint64) and an fp32
    AVERAGE / SQRT. The port's plain version gives the same values bit for
    bit, and the dtypes written in JAX_DTYPE / PORT_DTYPE."""
    import jax.numpy as jnp
    from paddle_tpu.ops import sequence_ops as jseq
    rng = np.random.RandomState(11)
    x = (rng.randn(6, 11, 5) * 4).astype(np.float32)
    x = _np_narrow(np.abs(x) if dtype.startswith("u") else x, dtype)
    lens = np.array([11, 0, 3, 1, 7, 9], np.int32)
    want = jseq._sequence_pool(None, {"X": [jnp.asarray(x)],
                                      "SeqLens": [jnp.asarray(lens)]},
                               {"pooltype": pooltype})["Out"][0]
    assert str(want.dtype) == JAX_DTYPE[(dtype, pooltype)]
    got = tseq.sequence_pool(_to_torch(x), torch.from_numpy(lens), pooltype)
    assert got.dtype == PORT_DTYPE[JAX_DTYPE[(dtype, pooltype)]]
    np.testing.assert_array_equal(_values(got),
                                  np.asarray(want).astype(np.float64))


# float8 without infinities or negative zero: (exponent bits, mantissa bits)
FNUZ = {"float8_e4m3fnuz": (4, 3), "float8_e5m2fnuz": (5, 2)}


@pytest.mark.parametrize("dtype", sorted(FNUZ))
def test_fnuz_codes_round_trip(dtype):
    """All 256 codes of a fnuz type: torch's value of each is the
    reference's (ml_dtypes, as JAX holds it), and the plain conversion
    back gives the same code (0x80, the one NaN, included)."""
    import ml_dtypes
    codes = np.arange(256, dtype=np.uint8)
    values = torch.from_numpy(codes).view(NARROW[dtype]).to(torch.float32)
    want = codes.view(getattr(ml_dtypes, dtype)).astype(np.float32)
    np.testing.assert_array_equal(values.numpy(), want)   # NaN == NaN here
    assert int(torch.isnan(values).sum()) == 1 and bool(values[128].isnan())
    back = values.to(NARROW[dtype]).view(torch.uint8).numpy()
    np.testing.assert_array_equal(back, codes)


def _fnuz_rule(values: np.ndarray, e_bits: int, m_bits: int) -> np.ndarray:
    """The codes ``Elem<Fnuz<E, M>>::bits`` (csrc/pool_elem.cuh) gives, in
    numpy: round to nearest on the type's grid, ties to even; past the
    largest finite value, infinities and NaN -> 0x80; zero -> +0."""
    bias, top = 1 << (e_bits - 1), (1 << e_bits) - 1
    out = []
    for v in values.astype(np.float32):
        if not np.isfinite(v):
            out.append(0x80)
            continue
        a = abs(float(v))
        if a == 0.0:
            out.append(0)
            continue
        e = math.frexp(a)[1] - 1
        sub = e < 1 - bias
        step = (1 - bias if sub else e) - m_bits
        q = int(np.rint(np.float32(math.ldexp(a, -step))))
        if q == 0:
            out.append(0)
            continue
        if sub:
            be, bm = q >> m_bits, q & ((1 << m_bits) - 1)
        elif q == 2 << m_bits:
            be, bm = e + 1 + bias, 0
        else:
            be, bm = e + bias, q - (1 << m_bits)
        out.append(0x80 if be > top else
                   (0x80 if v < 0 else 0) | (be << m_bits) | bm)
    return np.array(out, np.uint8)


@pytest.mark.parametrize("dtype", sorted(FNUZ))
def test_fnuz_rounding_rule_is_the_references(dtype):
    """The pooling kernels' hand-written fnuz conversion rule (mirrored in
    :func:`_fnuz_rule`) against torch's conversion (the plain versions')
    and ml_dtypes' (the reference's) on every code's value, every midpoint
    between neighbours, the floats just either side of each midpoint, the
    overflow edge, float32 subnormals, zeros, infinities and NaN."""
    import ml_dtypes
    codes = np.arange(256, dtype=np.uint8)
    grid = np.unique(np.abs(codes.view(getattr(ml_dtypes, dtype))
                            .astype(np.float64)))
    grid = grid[np.isfinite(grid)]
    mids = (grid[:-1] + grid[1:]) / 2
    top = grid[-1] + (grid[-1] - grid[-2]) / 2     # the overflow edge
    pts = np.concatenate([grid, mids, [top, top * 1.5, 1e30, 1e-40, 1e-45]])
    pts = pts.astype(np.float32)
    pts = np.concatenate([pts, np.nextafter(pts, np.float32(np.inf)),
                          np.nextafter(pts, np.float32(0))])
    pts = np.concatenate([pts, -pts, np.float32([0.0, -0.0, np.inf,
                                                 -np.inf, np.nan])])
    got = _fnuz_rule(pts, *FNUZ[dtype])
    by_torch = torch.from_numpy(pts).to(NARROW[dtype]).view(
        torch.uint8).numpy()
    by_reference = pts.astype(getattr(ml_dtypes, dtype)).view(np.uint8)
    np.testing.assert_array_equal(by_torch, by_reference)
    np.testing.assert_array_equal(got, by_torch)


@pytest.mark.parametrize("dtype", sorted(FNUZ) + ["float8_e4m3fn",
                                                 "float8_e5m2"])
def test_float8_pool_of_no_steps_is_zero(dtype):
    """T 0: every pool type of a float8 x [B, 0, D] is zeros of x's type
    (the plain version's t-order loop has no step to start from)."""
    x = torch.zeros(3, 0, 5).to(NARROW[dtype])
    lens = torch.tensor([0, 2, 1])
    for mode in MODES:
        got = tsp.masked_seqpool_fwd(x, lens, mode)
        assert got.dtype == x.dtype and got.shape == (3, 5)
        assert bool((got.to(torch.float32) == 0).all())


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, lens = _data(d=12)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    before = dict(tsp.LAUNCHES)
    for mode in MODES:
        assert torch.equal(tsp.masked_seqpool_fwd(xt, lt, mode),
                           tsp.masked_seqpool_ref(xt, lt, mode))
    assert tsp.LAUNCHES == before


def test_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="pools"):
        tsp.masked_seqpool(x, torch.tensor([1, 2]), "MAX")
    with pytest.raises(ValueError, match="want lens"):
        tsp.masked_seqpool(x, torch.tensor([1, 2, 3]), "SUM")
    with pytest.raises(ValueError, match="integers"):
        tsp.masked_seqpool(x, torch.tensor([1.0, 2.0]), "SUM")
    with pytest.raises(ValueError, match="want x"):
        tsp.masked_seqpool(x[0], torch.tensor([1, 2]), "SUM")
    meta = torch.zeros(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="devices|unsupported device"):
        tsp.masked_seqpool_fwd(meta, torch.tensor([1, 2]), "SUM")


def test_default_context_start_floors_a_negative_half():
    assert [tseq.default_context_start(n) for n in (1, 2, 3, 4, 5)] == \
        [0, -1, -1, -2, -2]


@pytest.mark.parametrize("with_lens", [True, False], ids=["seq-lens",
                                                           "full"])
@pytest.mark.parametrize("filter_size", [3, 4])
def test_sequence_conv_matches_the_jax_op(filter_size, with_lens):
    from op_test import run_single_op
    rng = np.random.RandomState(4)
    b, t, d, m = 5, 9, 16, 8
    x = rng.randn(b, t, d).astype(np.float32)
    w = rng.randn(filter_size * d, m).astype(np.float32)
    lens = np.array([9, 0, 4, 1, 7], np.int32)
    inputs = {"X": {"x": x}, "Filter": {"f": w}}
    if with_lens:
        inputs["SeqLens"] = {"sl": lens}
    # the op's own default contextStart, as the layer passes it
    want = run_single_op("sequence_conv", inputs,
                         {"contextLength": filter_size})["__out_Out_0"]
    got = tseq.sequence_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(lens) if with_lens else None,
                             filter_size)
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    if with_lens:
        assert torch.all(got[1] == 0)
    with pytest.raises(ValueError, match="want filter"):
        tseq.sequence_conv(torch.from_numpy(x), torch.from_numpy(w[1:]),
                           None, filter_size)


@pytest.mark.gpu
def test_cuda_kernel_matches_the_plain_version(cuda_device):
    """At the classifier's pools (B 128, T 100, D 512, ragged, one full
    row), at an edge shape (B 5, T 7, D 100, one zero length) and at a
    width of no whole float4s (the scalar path), each pool type, one
    launch a call; the Function's backward runs in torch."""
    rng = np.random.RandomState(5)
    for b, t, d in ((128, 100, 512), (5, 7, 100), (3, 4, 6)):
        x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32)).to(
            cuda_device)
        lens = rng.randint(1, t + 1, b).astype(np.int32)
        lens[0] = t
        lens[-1] = 0
        lt = torch.from_numpy(lens).to(cuda_device)
        for mode in MODES:
            n0 = tsp.LAUNCHES["seqpool"]
            got = tsp.masked_seqpool_fwd(x, lt, mode)
            torch.cuda.synchronize()
            assert tsp.LAUNCHES["seqpool"] == n0 + 1
            # fp32 sums in another order: the error grows with the terms'
            # magnitudes, so the tolerance is relative to the pool of |x|
            scale = tsp.masked_seqpool_ref(x.abs(), lt, mode)
            err = (got - tsp.masked_seqpool_ref(x, lt, mode)).abs()
            assert bool((err <= POOL_TOL["atol"]
                         + POOL_TOL["rtol"] * scale).all()), \
                f"{mode} {b}x{t}x{d}: max abs err {float(err.max())}"
    xg = torch.randn(4, 6, 8, device=cuda_device, requires_grad=True)
    tseq.sequence_pool(xg, torch.tensor([6, 2, 0, 1], device=cuda_device),
                       "sqrt").sum().backward()
    assert torch.isfinite(xg.grad).all() and bool((xg.grad[2] == 0).all())


# rtol of the pool of |x| for each dtype the kernel takes besides fp32: fp16
# and bf16 round the sum once where the plain version rounds it twice;
# the fnuz float8 types convert by hand-written rules that round as torch
# does, so they are held bit for bit (their steps are all above the 1e-6
# atol)
# float8 rounds every partial sum at the same points in both (one float8
# step of the pool of |x| covers a conversion that rounds a tie the other
# way); unsigned sums are exact
DTYPE_RTOL = {torch.float64: 1e-12, torch.float16: 2e-3,
              torch.bfloat16: 1.6e-2, torch.int32: 0.0, torch.bool: 0.0,
              torch.complex64: 1e-5, torch.float8_e4m3fn: 2.0 ** -3,
              torch.float8_e5m2: 2.0 ** -2, torch.float8_e4m3fnuz: 0.0,
              torch.float8_e5m2fnuz: 0.0, torch.uint16: 0.0,
              torch.uint32: 0.0, torch.uint64: 0.0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPE_RTOL), ids=str)
def test_cuda_kernel_takes_every_dtype(cuda_device, dtype):
    """Every dtype the JAX op's refer branch pools (float8 and unsigned
    too): each pool type one launch, the plain version's dtype and
    values."""
    rng = np.random.RandomState(7)
    b, t, d = 6, 9, 12
    x = torch.from_numpy(rng.randn(b, t, d) * 4)
    if dtype in tsp.UNSIGNED:
        x = x.abs()
    if dtype.is_complex:
        x = torch.complex(x, torch.from_numpy(rng.randn(b, t, d)))
    x = x.to(dtype).to(cuda_device)
    lens = torch.tensor([9, 0, 4, 1, 7, 3], device=cuda_device)
    wide = torch.complex128 if dtype.is_complex else torch.float64
    for mode in MODES:
        n0 = tsp.LAUNCHES["seqpool"]
        got = tsp.masked_seqpool_fwd(x, lens, mode)
        torch.cuda.synchronize()
        assert tsp.LAUNCHES["seqpool"] == n0 + 1
        want = tsp.masked_seqpool_ref(x, lens, mode)
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = tsp.masked_seqpool_ref(x.to(wide).abs(), lens, mode)
        err = (got.to(wide) - want.to(wide)).abs()
        assert bool((err <= 1e-6 + DTYPE_RTOL[dtype] * scale).all()), \
            f"{dtype} {mode}: max abs err {float(err.max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn, torch.int64],
                         ids=str)
def test_cuda_kernel_splits_rows_across_warps(cuda_device, dtype):
    """The kernel's plan at its edges: T 100 (8 warps a row; float8 one,
    in t order) with lengths 0, 1, T and above T, at D 512 (whole float4s
    for fp32) and D 6 (no whole float4s); T 1 and T 0. Each pool type
    (SUM only for int64) against the plain version within the dtype's
    rtol of the pool of |x| (fp32: POOL_TOL), one launch a call, the same
    bits on a second call (the warps' sums are added in warp order)."""
    rng = np.random.RandomState(13)
    lens_of = {100: [100, 0, 37, 1, 99, 250], 1: [1, 0, 1, 5, 1, 0],
               0: [0, 0, 3, 0, 1, 0]}
    rtol = {torch.float32: POOL_TOL["rtol"], torch.int64: 0.0}.get(
        dtype, DTYPE_RTOL.get(dtype))
    modes = ("SUM",) if dtype == torch.int64 else MODES
    for t, d in ((100, 512), (100, 6), (1, 8), (0, 4)):
        x = torch.from_numpy(rng.randn(6, t, d) * 4).to(dtype).to(
            cuda_device)
        lens = torch.tensor(lens_of[t], device=cuda_device)
        for mode in modes:
            n0 = tsp.LAUNCHES["seqpool"]
            got = tsp.masked_seqpool_fwd(x, lens, mode)
            again = tsp.masked_seqpool_fwd(x, lens, mode)
            want = tsp.masked_seqpool_ref(x, lens, mode)
            torch.cuda.synchronize()
            assert tsp.LAUNCHES["seqpool"] == n0 + 2
            assert torch.equal(got, again), f"{dtype} {mode} T {t} D {d}"
            assert got.dtype == want.dtype and got.shape == want.shape
            scale = tsp.masked_seqpool_ref(x.double().abs(), lens, mode)
            err = (got.double() - want.double()).abs()
            assert bool((err <= POOL_TOL["atol"] + rtol * scale).all()), \
                f"{dtype} {mode} T {t} D {d}: max abs err {float(err.max())}"
