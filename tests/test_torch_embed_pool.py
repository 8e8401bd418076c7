"""The PyTorch port's embedding gather + sum pool (paddle_tpu_torch/ops/
kernels/embed_pool.py) and the op around it, ``fused_embedding_seq_pool``
(paddle_tpu_torch/ops/lod_ops.py), against the JAX package: the Pallas
kernel ``fused_embed_seq_pool`` in interpret mode and its densified VJP
(paddle_tpu/ops/pallas/embed_pool.py), and the op through the executor
(tests/op_test.py ``run_single_op``; on the CPU it takes its composed
branch).

Tolerances: rtol 1e-5 / atol 1e-6 (one fp32 sum over T in another order;
on the card, at T 100, the rtol is taken of the pool of |w|, since the
error of a sum grows with its terms' magnitudes, not with the sum).
Ids stay in [0, V): the kernel clips an id outside, the JAX op's composed
branch (``w[ids]``) would wrap a negative one.

The CUDA kernel runs only on the card: the ``gpu`` test holds it against
its plain version there and skips elsewhere
(``pytest --noconftest -m gpu tests/test_torch_embed_pool.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import lod_ops as tlod
from paddle_tpu_torch.ops.kernels import embed_pool as tep

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jx():
    """(jax, the JAX package's Pallas embed_pool module)."""
    import importlib
    jax = pytest.importorskip("jax")
    return jax, importlib.import_module("paddle_tpu.ops.pallas.embed_pool")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _data(v=40, d=128, b=5, t=6, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, t)).astype(np.int64)
    ids[0, :3] = 3                          # duplicates within a row
    lens = np.array([6, 3, 1, 6, 2], np.int32)[:b]
    return w, ids, lens


@pytest.mark.parametrize("with_lens", [True, False], ids=["seq-lens",
                                                           "all"])
def test_plain_version_matches_the_pallas_kernel(jx, with_lens):
    jax, pep = jx
    jnp = jax.numpy
    w, ids, lens = _data()
    want = pep.fused_embed_seq_pool(
        jnp.asarray(w), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(lens) if with_lens else None, True)
    got = tep.fused_embed_seq_pool(
        torch.from_numpy(w), torch.from_numpy(ids),
        torch.from_numpy(lens) if with_lens else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_gradient_matches_the_pallas_vjp(jx):
    jax, pep = jx
    jnp = jax.numpy
    w, ids, lens = _data(seed=1)
    g = np.random.RandomState(2).randn(5, 128).astype(np.float32)
    _, vjp = jax.vjp(lambda a: pep.fused_embed_seq_pool(
        a, jnp.asarray(ids.astype(np.int32)), jnp.asarray(lens), True),
        jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    tlod.fused_embedding_seq_pool(wt, torch.from_numpy(ids),
                                  torch.from_numpy(lens),
                                  sparse=False).backward(torch.from_numpy(g))
    assert not wt.grad.is_sparse
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), **TOL)


def test_sparse_gradient_keeps_every_position_as_jax_does():
    """The row-sparse gradient of grad_ops.py:72-85: one row per (b, t),
    the masked positions with zero values; coalesced, every id of the
    batch is a row, and the values equal the dense gradient's rows."""
    w, ids, lens = _data(seed=2)
    g = torch.from_numpy(np.random.RandomState(3).randn(5, 128).astype(
        np.float32))
    wt = torch.from_numpy(w).requires_grad_()
    tlod.fused_embedding_seq_pool(wt, torch.from_numpy(ids)[..., None],
                                  torch.from_numpy(lens)).backward(g)
    grad = wt.grad
    assert grad.is_sparse and grad._nnz() == ids.size
    co = grad.coalesce()
    assert sorted(co.indices()[0].tolist()) == sorted(set(ids.ravel()))
    dense = torch.zeros_like(wt).index_add_(
        0, torch.from_numpy(ids.ravel()),
        (g[:, None, :] * (torch.arange(6)[None, :] < torch.from_numpy(
            lens)[:, None])[:, :, None]).reshape(-1, 128))
    np.testing.assert_allclose(co.to_dense().numpy(), dense.numpy(), **TOL)
    masked_only = set(ids[1, 3:]) - set(ids[1, :3]) - set(
        ids[[0, 2, 3, 4]].ravel())
    for r in masked_only:
        assert r in co.indices()[0].tolist()
        assert bool((co.to_dense()[r] == 0).all())


@pytest.mark.parametrize("with_lens", [True, False], ids=["seq-lens",
                                                           "all"])
def test_op_matches_the_jax_op(with_lens):
    from op_test import run_single_op
    w, ids, lens = _data(d=8, seed=4)
    inputs = {"W": {"w": w}, "Ids": {"ids": ids[..., None]}}
    if with_lens:
        inputs["SeqLens"] = {"sl": lens}
    want = run_single_op("fused_embedding_seq_pool", inputs)["__out_Out_0"]
    got = tlod.fused_embedding_seq_pool(
        torch.from_numpy(w), torch.from_numpy(ids)[..., None],
        torch.from_numpy(lens) if with_lens else None)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float16", "int32"])
def test_op_matches_the_jax_op_at_other_dtypes(dtype):
    """The composed branch gathers a table of any dtype, and so does the
    port: fp16 summed into fp16 (rtol 2e-3), int32 exactly (int64 in the
    port, as torch.sum widens it)."""
    from op_test import run_single_op
    rng = np.random.RandomState(9)
    w = (rng.randn(13, 8) * 4).astype(dtype)
    ids = rng.randint(0, 13, (5, 6)).astype(np.int64)
    lens = np.array([6, 0, 3, 1, 5], np.int32)
    want = run_single_op("fused_embedding_seq_pool",
                         {"W": {"w": w}, "Ids": {"ids": ids},
                          "SeqLens": {"sl": lens}}, {})["__out_Out_0"]
    got = tlod.fused_embedding_seq_pool(torch.from_numpy(w),
                                        torch.from_numpy(ids),
                                        torch.from_numpy(lens))
    assert got.is_floating_point() == np.issubdtype(want.dtype, np.floating)
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=2e-3 if dtype == "float16" else 0,
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


# what the reference's fused_embedding_seq_pool returns on the CPU (x64
# off: an unsigned sum is uint32), and the port's dtype for it
JAX_DTYPE = {"float8_e4m3fn": "float8_e4m3fn", "float8_e5m2": "float8_e5m2",
             "float8_e4m3fnuz": "float8_e4m3fnuz",
             "float8_e5m2fnuz": "float8_e5m2fnuz", "uint32": "uint32",
             "uint64": "uint32"}
PORT_DTYPE = {"float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2,
              "float8_e4m3fnuz": torch.float8_e4m3fnuz,
              "float8_e5m2fnuz": torch.float8_e5m2fnuz, "uint32": torch.uint64,
              "uint64": torch.uint64}


@pytest.mark.parametrize("dtype", sorted(JAX_DTYPE))
def test_op_matches_the_jax_op_at_float8_and_unsigned(dtype):
    """The composed branch of the JAX op (``_fused_embedding_seq_pool``,
    called as the executor calls it: its program layer refuses these
    dtypes) sums float8 rows in float8, every partial sum rounded, and
    unsigned rows to an unsigned sum; the port's plain version gives the
    same values bit for bit."""
    import jax.numpy as jnp
    from paddle_tpu.ops import lod_ops as jlod
    rng = np.random.RandomState(12)
    w = (rng.randn(9, 5) * 3).astype(np.float32)
    w = _np_narrow(np.abs(w) if dtype.startswith("u") else w, dtype)
    ids = rng.randint(0, 9, (6, 11)).astype(np.int32)
    lens = np.array([11, 0, 3, 1, 7, 9], np.int32)
    want = jlod._fused_embedding_seq_pool(
        None, {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
               "SeqLens": [jnp.asarray(lens)]}, {})["Out"][0]
    assert str(want.dtype) == JAX_DTYPE[dtype]
    got = tlod.fused_embedding_seq_pool(_to_torch(w), torch.from_numpy(ids),
                                        torch.from_numpy(lens))
    assert got.dtype == PORT_DTYPE[dtype]
    np.testing.assert_array_equal(_values(got),
                                  np.asarray(want).astype(np.float64))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    w, ids, lens = _data(d=12)
    args = (torch.from_numpy(w), torch.from_numpy(ids),
            torch.from_numpy(lens))
    before = dict(tep.LAUNCHES)
    assert torch.equal(tep.fused_embed_seq_pool(*args),
                       tep.fused_embed_seq_pool_ref(*args))
    assert tep.LAUNCHES == before


def test_out_of_range_ids_read_the_clipped_row():
    w = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([[-5, 9, 2]])
    got = tep.fused_embed_seq_pool(w, ids, None)
    torch.testing.assert_close(got, (w[0] + w[3] + w[2])[None])


@pytest.mark.parametrize("t, code, warps", [
    (100, 0, 8), (7, 0, 1), (12, 2, 1), (13, 3, 2), (30, 4, 3), (96, 1, 8),
    (1000, 0, 8), (0, 0, 1), (100, 5, 1), (100, 6, 1), (100, 7, 1),
    (100, 8, 1)])
def test_pool_warps_plan(t, code, warps):
    """The kernel's chunk plan: enough warps a row that none walks more
    than about 12 ids (13 at the op program's T 100, 8 warps), at most
    8; one warp for the float8 codes 5-8, which sum in t order."""
    assert tep.pool_warps(t, code) == warps
    if warps > 1:
        assert -(-t // warps) <= tep.IDS_PER_WARP or \
            warps == tep.MAX_WARPS


def test_wrapper_rejects_what_it_does_not_take():
    w = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="want w"):
        tep.fused_embed_seq_pool(w, torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="integers"):
        tep.fused_embed_seq_pool(w, torch.zeros(2, 2))
    with pytest.raises(ValueError, match="want lens"):
        tep.fused_embed_seq_pool(w, torch.zeros(2, 2, dtype=torch.long),
                                 torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="empty"):
        tep.fused_embed_seq_pool(torch.zeros(0, 3),
                                 torch.zeros(2, 2, dtype=torch.long))


@pytest.mark.gpu
def test_cuda_kernel_matches_the_plain_version(cuda_device):
    """At the op program's shape (V 5000, D 128, B 128, T 100, ragged),
    at an edge shape (V 37, D 100, B 5, T 7, no lengths) and at a width
    of no whole float4s (the scalar path): one launch a call; the op's
    sparse gradient on the card."""
    rng = np.random.RandomState(6)
    for v, d, b, t, ragged in ((5000, 128, 128, 100, True),
                               (37, 100, 5, 7, False), (11, 6, 3, 5, True)):
        w = torch.from_numpy(rng.randn(v, d).astype(np.float32)).to(
            cuda_device)
        ids = torch.from_numpy(rng.randint(0, v, (b, t))).to(cuda_device)
        lens = torch.from_numpy(rng.randint(0, t + 1, b).astype(
            np.int32)).to(cuda_device) if ragged else None
        n0 = tep.LAUNCHES["embed_pool"]
        got = tep.fused_embed_seq_pool(w, ids, lens)
        torch.cuda.synchronize()
        assert tep.LAUNCHES["embed_pool"] == n0 + 1
        # fp32 sums in another order: the error grows with the terms'
        # magnitudes, so the tolerance is relative to the pool of |w|
        scale = tep.fused_embed_seq_pool_ref(w.abs(), ids, lens)
        err = (got - tep.fused_embed_seq_pool_ref(w, ids, lens)).abs()
        assert bool((err <= TOL["atol"] + TOL["rtol"] * scale).all()), \
            f"{v}x{d} {b}x{t}: max abs err {float(err.max())}"
    wt = w.clone().requires_grad_()
    tlod.fused_embedding_seq_pool(wt, ids, lens).sum().backward()
    assert wt.grad.is_sparse and wt.grad._nnz() == ids.numel()


# rtol of the pool of |w| for each table dtype the kernel takes besides
# fp32: fp16 and bf16 round the sum once where the plain version rounds it
# after its own fp32 accumulation too; float8 rounds every partial sum
# at the same points in both (one float8 step of the pool of |w| covers a
# conversion that rounds a tie the other way); the fnuz float8 types are
# held bit for bit (hand-written conversions that round as torch does; their
# steps are all above the 1e-6 atol); unsigned sums are exact
DTYPE_RTOL = {torch.float64: 1e-12, torch.float16: 2e-3,
              torch.bfloat16: 1.6e-2, torch.int32: 0.0, torch.int64: 0.0,
              torch.complex64: 1e-5, torch.float8_e4m3fn: 2.0 ** -3,
              torch.float8_e5m2: 2.0 ** -2, torch.float8_e4m3fnuz: 0.0,
              torch.float8_e5m2fnuz: 0.0, torch.uint16: 0.0,
              torch.uint32: 0.0, torch.uint64: 0.0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPE_RTOL), ids=str)
def test_cuda_kernel_takes_every_dtype(cuda_device, dtype):
    """Every table dtype the JAX op's composed branch gathers: one
    launch, the plain version's dtype and values."""
    rng = np.random.RandomState(8)
    v, d, b, t = 23, 12, 5, 9
    w = torch.from_numpy(rng.randn(v, d) * 4)
    if dtype in (torch.uint16, torch.uint32, torch.uint64):
        w = w.abs()
    if dtype.is_complex:
        w = torch.complex(w, torch.from_numpy(rng.randn(v, d)))
    w = w.to(dtype).to(cuda_device)
    ids = torch.from_numpy(rng.randint(0, v, (b, t))).to(cuda_device)
    lens = torch.tensor([9, 0, 4, 1, 7], device=cuda_device)
    n0 = tep.LAUNCHES["embed_pool"]
    got = tep.fused_embed_seq_pool(w, ids, lens)
    torch.cuda.synchronize()
    assert tep.LAUNCHES["embed_pool"] == n0 + 1
    want = tep.fused_embed_seq_pool_ref(w, ids, lens)
    assert got.dtype == want.dtype and got.shape == want.shape
    wide = torch.complex128 if dtype.is_complex else torch.float64
    scale = tep.fused_embed_seq_pool_ref(w.to(wide).abs(), ids, lens)
    err = (got.to(wide) - want.to(wide)).abs()
    assert bool((err <= 1e-6 + DTYPE_RTOL[dtype] * scale).all()), \
        f"{dtype}: max abs err {float(err.max())}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16, torch.bfloat16,
                                   torch.int64, torch.float8_e4m3fnuz],
                         ids=str)
def test_cuda_kernel_splits_rows_across_warps(cuda_device, dtype):
    """At T 100 (8 warps a row; float8 one) with ragged lengths, lengths
    0 and T among them: the plain version's values within the dtype's
    rtol of the pool of |w|, and the same bits on a second call (the
    warps' sums are added in warp order)."""
    rng = np.random.RandomState(9)
    v, d, b, t = 300, 40, 7, 100
    w = torch.from_numpy(rng.randn(v, d) * 4).to(dtype).to(cuda_device)
    ids = torch.from_numpy(rng.randint(0, v, (b, t))).to(cuda_device)
    lens = torch.tensor([100, 0, 37, 1, 99, 13, 64], device=cuda_device)
    got = tep.fused_embed_seq_pool(w, ids, lens)
    again = tep.fused_embed_seq_pool(w, ids, lens)
    want = tep.fused_embed_seq_pool_ref(w, ids, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = tep.fused_embed_seq_pool_ref(w.double().abs(), ids, lens)
    err = (got.double() - want.double()).abs()
    rtol = TOL["rtol"] if dtype == torch.float32 else DTYPE_RTOL[dtype]
    assert bool((err <= 1e-6 + rtol * scale).all()), \
        f"{dtype}: max abs err {float(err.max())}"
