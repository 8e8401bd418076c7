"""The PyTorch port's fused linear + cross entropy (paddle_tpu_torch/ops/
kernels/fused_ce.py and ``nn_ops.fused_linear_ce``) against the JAX
package's Pallas kernels (paddle_tpu/ops/pallas/fused_ce.py, in interpret
mode, as tests/test_fused_ce.py runs them).

On the CPU the port's wrappers take the plain PyTorch versions and the
backward runs ``FusedLinearCE.backward`` over them. Tolerances are the JAX
package's own for this kernel (tests/test_fused_ce.py): loss and lse
rtol 1e-5 / atol 1e-5; dx and dW rtol 1e-4 / atol 1e-5 -- fp32 sums over
vocab chunks on one side and over whole rows on the other.

bf16 and fp16 operands (the JAX function's production precision) are held
to the JAX function too, their gradients in their own dtype within the
tolerance :func:`_low_precision_tol` derives.

The CUDA kernels run only on the card: the ``gpu`` test holds each against
its plain version there and skips elsewhere. JAX is imported inside a
fixture, so that the card's machine, which has no JAX, collects this file
and runs its ``gpu`` test
(``pytest --noconftest -m gpu tests/test_torch_fused_ce.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import fused_ce as tfc

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the card's tolerances for the fp32 kernels (chip_smoke.py FCE_FWD_TOL,
# FCE_GRAD_TOL): fp32 sums in another order
KERNEL_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
KERNEL_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
SHAPES = [(16, 8, 24), (64, 32, 48)]      # (N, D, V)
LOW_SHAPES = [(8, 128, 128)] + SHAPES
IGNORE = -100
MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
# x / w dtype pairs that the JAX function takes mixed
MIXED = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float16, torch.float32), (torch.bfloat16, torch.float16)]


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's Pallas fused-CE module)."""
    import importlib
    jax = pytest.importorskip("jax")
    return jax, jax.numpy, importlib.import_module(
        "paddle_tpu.ops.pallas.fused_ce")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _data(n, d, v, seed=0):
    """x, w, labels (rows 3 and n - 1 at ignore_index) and a non-uniform
    per-row cotangent, from numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[[3, n - 1]] = IGNORE
    g = np.linspace(0.1, 2.0, n, dtype=np.float32)
    return x, w, labels, g


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas(jx, shape, eps):
    _, jnp, pfc = jx
    x, w, labels, _ = _data(*shape)
    want_loss, want_lse = pfc._fwd(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), eps, IGNORE, True)
    t = [torch.from_numpy(a) for a in (x, w, labels)]
    got = tnn.fused_linear_ce(t[0], t[1], t[2][:, None], eps, IGNORE)
    assert got.shape == (shape[0], 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_loss), **FWD_TOL)
    loss, lse = tfc.fused_ce_fwd_ref(*t, eps, IGNORE)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss)[:, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               **FWD_TOL)
    assert np.all(got.numpy()[[3, -1]] == 0.0)


def _ulp(t, dtype):
    """One step of ``dtype`` at |t| (its subnormal step at 0)."""
    fi = torch.finfo(dtype)
    e = torch.floor(torch.log2(t.double().abs().clamp_min(fi.tiny)))
    return torch.exp2(e - MANTISSA[dtype])


def _low_precision_tol(x, w, labels, lse, g, eps, dtype):
    """Per-element tolerances of dx and dW for 16-bit operands. Both sides
    round dz to ``dtype`` (not at all for fp32: a mixed pair's fp32 x),
    sum its products in fp32 and round the sum to the result's dtype
    once. Their fp32 z differ in the last bits (another order),
    so a dz near a rounding tie may round to the other neighbour: one step
    of it, at most 2**-m |dz| (m mantissa bits), moves a sum by that times
    its partner. So |got - want| <= one step of the result + (2**-m + K *
    2**-24) * sum |dz| |partner| (K the summed length: the fp32 order
    term), with that sum |dz| @ |w|^T for dx and |x|^T @ |dz| for dW."""
    xf, wf = x.double(), w.double()
    on, _, off, _ = tfc._consts(eps, w.shape[1])
    z = xf @ wf
    cols = torch.arange(w.shape[1])
    t = torch.where(cols[None] == labels.long()[:, None], on, 0.0) + off
    dz = ((torch.exp(z - lse.double()[:, None]) - t) * g.double()[:, None])
    dz = torch.where((labels == IGNORE)[:, None], 0.0, dz).abs()
    step = 0.0 if dtype == torch.float32 else 2.0 ** -MANTISSA[dtype]
    n, v = dz.shape
    return ((step + v * 2.0 ** -24) * (dz @ wf.abs().t()),
            (step + n * 2.0 ** -24) * (xf.abs().t() @ dz))


def _within(got, want, slack, dtype):
    want = torch.as_tensor(want).double()
    return bool(((got.double() - want).abs()
                 <= _ulp(want, dtype) + slack).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shape", LOW_SHAPES)
def test_low_precision_matches_pallas(jx, shape, eps, dtype):
    """bf16 and fp16 x and w, as the JAX function takes them: loss and lse
    fp32 (z summed in fp32, not rounded to the operands' type), dx and dW
    in the operands' dtype through dz rounded to it. N 8 / D 128 / V 128
    at eps 0.1 is the smallest program on which a port that rounded z to
    bf16 differed (by 3.4e-3) and whose backward raised."""
    jax, jnp, pfc = jx
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    x, w, labels, g = _data(*shape)
    jx_, jw_ = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want_loss, want_lse = pfc._fwd(jx_, jw_, jnp.asarray(labels), eps,
                                   IGNORE, True)

    def f(a, b):
        loss = pfc.fused_linear_ce(a, b, jnp.asarray(labels), eps, IGNORE,
                                   True)
        return jnp.sum(loss[:, 0] * jnp.asarray(g))
    want_dx, want_dw = jax.grad(f, argnums=(0, 1))(jx_, jw_)
    assert want_dx.dtype == jdt and want_dw.dtype == jdt
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)
              .requires_grad_() for a in (jx_, jw_))
    lab = torch.from_numpy(labels)
    loss, lse = tfc.fused_ce_fwd_ref(tx.detach(), tw.detach(), lab, eps,
                                     IGNORE)
    assert loss.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss)[:, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               **FWD_TOL)
    got = tfc.fused_linear_ce(tx, tw, lab, eps, IGNORE)
    np.testing.assert_allclose(got.detach().numpy()[:, 0],
                               np.asarray(want_loss)[:, 0], **FWD_TOL)
    (got[:, 0] * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == dtype and tw.grad.dtype == dtype
    sx, sw = _low_precision_tol(tx.detach(), tw.detach(), lab, lse,
                                torch.from_numpy(g), eps, dtype)
    assert _within(tx.grad, np.array(want_dx.astype(jnp.float32)), sx,
                   dtype)
    assert _within(tw.grad, np.array(want_dw.astype(jnp.float32)), sw,
                   dtype)


def _jnp_dtype(jnp, dtype):
    return {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
            torch.float32: jnp.float32}[dtype]


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("dtypes", MIXED, ids=lambda d: f"{d[0]}-{d[1]}")
def test_mixed_dtypes_match_pallas(jx, dtypes, eps):
    """x and w of two dtypes, as the JAX function takes them: z summed in
    fp32 from the promoted operands, loss and lse fp32, dz rounded to x's
    dtype where that is narrower than fp32, dx in x's dtype and dW in w's.
    Loss and lse within the fp32 tolerances (both sides sum the same
    exact fp32 products in another order); dx and dW within
    :func:`_low_precision_tol` at x's dtype (a dz near a rounding tie of
    x's dtype, the fp32 order, one step of the result's dtype)."""
    jax, jnp, pfc = jx
    xdt, wdt = dtypes
    x, w, labels, g = _data(8, 128, 128)
    jx_ = jnp.asarray(x).astype(_jnp_dtype(jnp, xdt))
    jw_ = jnp.asarray(w).astype(_jnp_dtype(jnp, wdt))
    want_loss, want_lse = pfc._fwd(jx_, jw_, jnp.asarray(labels), eps,
                                   IGNORE, True)

    def f(a, b):
        loss = pfc.fused_linear_ce(a, b, jnp.asarray(labels), eps, IGNORE,
                                   True)
        return jnp.sum(loss[:, 0] * jnp.asarray(g))
    want_dx, want_dw = jax.grad(f, argnums=(0, 1))(jx_, jw_)
    assert want_dx.dtype == jx_.dtype and want_dw.dtype == jw_.dtype
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)
              .requires_grad_() for a, dt in ((jx_, xdt), (jw_, wdt)))
    lab = torch.from_numpy(labels)
    loss, lse = tfc.fused_ce_fwd_ref(tx.detach(), tw.detach(), lab, eps,
                                     IGNORE)
    assert loss.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss)[:, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               **FWD_TOL)
    got = tfc.fused_linear_ce(tx, tw, lab, eps, IGNORE)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy()[:, 0],
                               np.asarray(want_loss)[:, 0], **FWD_TOL)
    (got[:, 0] * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == xdt and tw.grad.dtype == wdt
    sx, sw = _low_precision_tol(tx.detach(), tw.detach(), lab, lse,
                                torch.from_numpy(g), eps, xdt)
    assert _within(tx.grad, np.array(want_dx.astype(jnp.float32)), sx, xdt)
    assert _within(tw.grad, np.array(want_dw.astype(jnp.float32)), sw, wdt)


def test_split_tf32_halves():
    """hi is a TF32 value (its 13 low mantissa bits clear) nearest a, ties
    away from zero; lo is a - hi rounded the same way, also TF32; and
    |a - hi - lo| <= 2**-22 |a| where the halves stay normal (|a| >=
    2**-100), over values of every binade of fp32, subnormals, ties and
    non-finite values included."""
    rng = np.random.RandomState(3)
    a = (rng.randn(20000) * np.exp2(rng.randint(-140, 120, 20000))).astype(
        np.float32)
    ties = np.float32([1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -11),
                       1 + 2.0 ** -11 + 2.0 ** -23])
    a = torch.from_numpy(np.concatenate([a, ties, np.float32(
        [0.0, -0.0, np.inf, -np.inf, 3.4e38])]))
    hi, lo = tfc.split_tf32(a)
    for t in (hi, lo):
        bits = t.view(torch.int32)
        assert bool(((bits & 0x1FFF) == 0).all())
    fin = torch.isfinite(a) & torch.isfinite(hi)
    ad, hd = a.double(), hi.double()
    big = fin & (a.abs() >= 2.0 ** -100)
    assert bool(((ad - hd - lo.double()).abs()[big]
                 <= 2.0 ** -22 * ad.abs()[big]).all())
    # nearest, ties away: no other TF32 value is closer
    step = torch.exp2(torch.floor(torch.log2(ad.abs().clamp_min(2.0 ** -126)))
                      - 10)
    assert bool(((ad - hd).abs()[fin] <= step[fin] / 2).all())
    assert hi[-8].item() == 1 + 2.0 ** -10 and hi[-7].item() == -(1 + 2.0 ** -9)
    assert hi[-6].item() == 1 + 2.0 ** -10
    assert torch.equal(hi[-5:-1], a[-5:-1]) and bool((lo[-4:-2] == 0).all())


def test_three_tf32_terms_hold_the_fp32_tolerance():
    """Why the fp32 kernels take three TF32 products. At D 512 with
    x ~ N(0, 1) and w ~ N(0, 1/D) (the main path's head, cut to N 1024,
    V 2048), z = hi_x hi_w + (hi_x lo_w + lo_x hi_w), each product exact
    and summed in float64 as the tensor cores' fp32 sums nearly are, keeps
    the loss and both gradient products inside the card's fp32
    tolerances against float64; the one-term TF32 product does not
    (its loss error exceeds the allowance at this seed, and its dW by
    more than ten times)."""
    rng = np.random.RandomState(0)
    n, d, v, eps = 1024, 512, 2048, 0.1
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, v) * d ** -0.5).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, v, n))
    labels[::50] = IGNORE
    g = torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5)
    (xh, xl), (wh, wl) = tfc.split_tf32(x), tfc.split_tf32(w)
    f64 = torch.float64

    def one(a, b):
        return a[0].to(f64) @ b[0].to(f64)

    def three(a, b):
        return one(a, b) + (a[0].to(f64) @ b[1].to(f64)
                            + a[1].to(f64) @ b[0].to(f64))

    def loss_of(z):
        on, eps_f, _, vocab = tfc._consts(eps, v)
        lse = torch.logsumexp(z, 1)
        zl = z.gather(1, labels.clamp_min(0)[:, None])[:, 0]
        loss = lse - on * zl - eps_f * z.sum(1) / vocab
        return torch.where(labels == IGNORE, 0.0, loss), lse

    want, lse = loss_of(x.to(f64) @ w.to(f64))
    on, _, off, _ = tfc._consts(eps, v)
    t = torch.where(torch.arange(v)[None] == labels[:, None], on, 0.0) + off
    dz = (torch.exp(x.to(f64) @ w.to(f64) - lse[:, None]) - t) * g[:, None]
    dz = torch.where((labels == IGNORE)[:, None], 0.0, dz).float()
    dzs = tfc.split_tf32(dz)
    want_dx, want_dw = dz.to(f64) @ w.to(f64).t(), x.to(f64).t() @ dz.to(f64)

    def ok(got, ref, tol):
        return bool(((got - ref).abs()
                     <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    for terms, expect in ((three, True), (one, False)):
        loss = loss_of(terms((xh, xl), (wh, wl)))[0]
        dx = terms(dzs, (wh.t(), wl.t()))
        dw = terms((xh.t(), xl.t()), dzs)
        assert ok(loss, want, KERNEL_FWD_TOL) is expect
        assert ok(dw, want_dw, KERNEL_GRAD_TOL) is expect
        if expect:
            assert ok(dx, want_dx, KERNEL_GRAD_TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_pallas_vjp(jx, shape, eps):
    """dx and dW of sum(g * loss) under a non-uniform per-row cotangent
    against ``jax.grad`` through the kernel's ``_vjp_bwd``."""
    jax, jnp, pfc = jx
    x, w, labels, g = _data(*shape, seed=1)

    def f(a, b):
        loss = pfc.fused_linear_ce(a, b, jnp.asarray(labels), eps, IGNORE,
                                   True)
        return jnp.sum(loss[:, 0] * jnp.asarray(g))
    want_dx, want_dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = tfc.fused_linear_ce(tx, tw, torch.from_numpy(labels), eps,
                               IGNORE)
    (loss[:, 0] * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw),
                               **GRAD_TOL)


def test_labels_get_no_gradient():
    x, w, labels, g = _data(*SHAPES[0])
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = tfc.fused_linear_ce(tx, tw, torch.from_numpy(labels), 0.1)
    grads = loss.grad_fn.apply(torch.from_numpy(g)[:, None])
    assert len(grads) == 5 and grads[2] is None
    assert grads[0].shape == tx.shape and grads[1].shape == tw.shape


def test_plain_versions_are_the_composed_ce():
    """The closed form against the port's composed head (matmul, then
    softmax_with_cross_entropy) and autograd through it, in float64."""
    x, w, labels, g = _data(*SHAPES[1], seed=2)
    tx, tw = (torch.from_numpy(a).double().requires_grad_() for a in (x, w))
    lab = torch.from_numpy(labels)
    want = tnn.softmax_with_cross_entropy(tx @ tw, lab[:, None], 0.1,
                                          IGNORE).double()
    (want[:, 0] * torch.from_numpy(g).double()).sum().backward()
    loss, lse = tfc.fused_ce_fwd_ref(tx.detach(), tw.detach(), lab, 0.1,
                                     IGNORE)
    np.testing.assert_allclose(loss.numpy(), want[:, 0].detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    dx, dw = tfc.fused_ce_bwd_ref(tx.detach(), tw.detach(), lab, lse,
                                  torch.from_numpy(g).double(), 0.1, IGNORE)
    np.testing.assert_allclose(dx.numpy(), tx.grad.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), tw.grad.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    x, w, labels, g = (torch.from_numpy(a) for a in _data(*SHAPES[0]))
    before = dict(tfc.LAUNCHES)
    loss, lse = tfc.fused_ce_fwd(x, w, labels, 0.1)
    want_loss, want_lse = tfc.fused_ce_fwd_ref(x, w, labels, 0.1)
    assert torch.equal(loss, want_loss) and torch.equal(lse, want_lse)
    dx_ref, dw_ref = tfc.fused_ce_bwd_ref(x, w, labels, lse, g, 0.1)
    assert torch.equal(tfc.fused_ce_dx(x, w, labels, lse, g, 0.1), dx_ref)
    assert torch.equal(tfc.fused_ce_dw(x, w, labels, lse, g, 0.1), dw_ref)
    dx, dw = tfc.fused_ce_bwd(x, w, labels, lse, g, 0.1)
    assert torch.equal(dx, dx_ref) and torch.equal(dw, dw_ref)
    assert tfc.fused_ce_bwd(x, w, labels, lse, g, 0.1, dw=False)[1] is None
    assert tfc.LAUNCHES == before


def test_vocab_splits_fill_the_card():
    # Transformer-base's head: 32 row tiles of 128, each vocabulary split
    # in 4, fill 128 of 132 SMs
    assert tfc.vocab_splits(4096, 32000, 132) == 4
    assert tfc.vocab_splits(1000, 1003, 132) == 8  # never past the tiles
    assert tfc.vocab_splits(16, 100, 132) == 1
    assert tfc.vocab_splits(20000, 32000, 132) == 1


def test_operand_layouts():
    """Rows of the operand copies padded to 16 bytes (TMA's stride), and
    the backward's dW partial planes, one per slab-deep chunk of N."""
    assert tfc.padded_ld(513, torch.float32) == 516
    assert tfc.padded_ld(512, torch.float32) == 512
    assert tfc.padded_ld(1, torch.bfloat16) == 8
    assert tfc.padded_ld(100, torch.float16) == 104
    assert tfc.dw_chunks(4096, tfc.SLAB_COLS) == -(-4096 // tfc.SLAB_COLS)
    assert tfc.dw_chunks(1, 2048) == 1 and tfc.dw_chunks(2049, 2048) == 2
    assert tfc.SLAB_COLS % tfc.TILE == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, w, labels, g = (torch.from_numpy(a) for a in _data(*SHAPES[0]))
    with pytest.raises(ValueError, match="want x"):
        tfc.fused_ce_fwd(x, w[:5], labels)
    with pytest.raises(ValueError, match="labels"):
        tfc.fused_ce_fwd(x, w, labels[:5])
    with pytest.raises(ValueError, match="integers"):
        tfc.fused_ce_fwd(x, w, labels.float())
    with pytest.raises(ValueError, match="empty"):
        tfc.fused_ce_fwd(x[:0], w, labels[:0])
    with pytest.raises(ValueError, match="lse and g"):
        tfc.fused_ce_dx(x, w, labels, g[:3], g)
    meta = torch.zeros(16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.fused_ce_fwd(meta, torch.zeros(8, 24, device="meta"),
                         torch.zeros(16, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tfc.fused_ce_fwd(meta, w, labels)


def test_chunked_depth_is_exact_against_the_plain_versions():
    """The kernels' decomposition of the work: z summed over 32-deep
    stages of D in order (one 128-byte row of fp32 a stage); the backward
    over vocab slabs in order, dx accumulated slab by slab, each slab's dW
    columns from chunks of N as deep as the slab is wide, summed in
    order. In float64 at D 700, V 90 over slabs of 32 (and N 40 in chunks
    of 32) it equals the whole products to the last bits of float64, and
    the plain versions (which compute in float32) within float32's
    rounding."""
    rng = np.random.RandomState(11)
    n, d, v, eps, stage, slab = 40, 700, 90, 0.1, 32, 32
    x = torch.from_numpy(rng.randn(n, d)).double()
    w = torch.from_numpy(rng.randn(d, v) * d ** -0.5).double()
    labels = torch.from_numpy(rng.randint(0, v, n))
    labels[::7] = IGNORE
    g = torch.from_numpy(rng.rand(n) + 0.5).double()
    z = sum(x[:, c:c + stage] @ w[c:c + stage] for c in range(0, d, stage))
    np.testing.assert_allclose(z.numpy(), (x @ w).numpy(), rtol=1e-12,
                               atol=1e-12)
    loss, lse = tfc.fused_ce_fwd_ref(x, w, labels, eps)
    on, _, off, _ = tfc._consts(eps, v)
    t = torch.where(torch.arange(v)[None] == labels[:, None], on, 0.0) + off
    dz = (torch.exp(z - lse[:, None]) - t) * g[:, None]
    dz[labels == IGNORE] = 0
    dx = torch.zeros(n, d, dtype=torch.float64)
    dw = torch.zeros(d, v, dtype=torch.float64)
    for v0 in range(0, v, slab):
        s = slice(v0, v0 + slab)
        dx = dx + dz[:, s] @ w[:, s].t()
        parts = [x[r:r + slab].t() @ dz[r:r + slab, s]
                 for r in range(0, n, slab)]
        assert len(parts) == tfc.dw_chunks(n, slab)
        dw[:, s] = sum(parts)
    np.testing.assert_allclose(dx.numpy(), (dz @ w.t()).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dw.numpy(), (x.t() @ dz).numpy(),
                               rtol=1e-12, atol=1e-12)
    want_dx, want_dw = tfc.fused_ce_bwd_ref(x, w, labels, lse, g, eps)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device, monkeypatch):
    """Each kernel against its plain version on the card at edge shapes
    (N, D and V not multiples of the tiles, vocab splits, D from 3 to
    1100, several vocab slabs), eps 0 and 0.1, ignored rows, fp32 within
    the fp32 tolerances and bf16 / fp16 within :func:`_low_precision_tol`;
    one launch of fused_ce_bwd gives both gradients, each bit-equal to
    the dx-only and dW-only passes and to a second call; the autograd
    Function launches the forward and the backward once per call, also at
    the smallest input that raised before (x [1, 513]); float64
    raises."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(n, d, v, eps, torch.float32) for n, d, v, eps in (
        (1000, 100, 1003, 0.1), (37, 512, 640, 0.0), (300, 257, 129, 0.1),
        (4096, 512, 4000, 0.1), (5, 3, 7, 0.0), (300, 700, 1003, 0.1),
        (64, 513, 200, 0.0), (512, 1024, 3000, 0.1), (33, 1100, 70, 0.1),
        (600, 64, 2 * tfc.SLAB_COLS + 5, 0.1))]
    cases += [(n, d, v, eps, dt) for dt in (torch.bfloat16, torch.float16)
              for n, d, v, eps in ((1000, 100, 1003, 0.1), (5, 3, 7, 0.0),
                                   (300, 700, 1003, 0.1),
                                   (4096, 512, 4000, 0.1))]
    for n, d, v, eps, dt in cases:
        x = torch.randn(n, d, generator=gen, device=cuda_device).to(dt)
        w = (torch.randn(d, v, generator=gen, device=cuda_device)
             * d ** -0.5).to(dt)
        labels = torch.randint(0, v, (n,), generator=gen, device=cuda_device)
        labels[::7] = IGNORE
        g = torch.rand(n, generator=gen, device=cuda_device) + 0.5
        n0 = dict(tfc.LAUNCHES)
        loss, lse = tfc.fused_ce_fwd(x, w, labels, eps)
        want_loss, want_lse = tfc.fused_ce_fwd_ref(x, w, labels, eps)
        dx, dw = tfc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
        want_dx, want_dw = tfc.fused_ce_bwd_ref(x, w, labels, want_lse, g,
                                                eps)
        torch.cuda.synchronize()
        assert {k: tfc.LAUNCHES[k] - n0[k] for k in n0} == \
            {"fused_ce_fwd": 1, "fused_ce_bwd": 1}
        label = f"n={n} d={d} v={v} eps={eps} {dt}"
        assert dx.dtype == dt and dw.dtype == dt, label
        for name, got, want in (("loss", loss, want_loss),
                                ("lse", lse, want_lse)):
            torch.testing.assert_close(got, want, msg=f"{name} {label}",
                                       **KERNEL_FWD_TOL)
        if dt == torch.float32:
            for name, got, want in (("dx", dx, want_dx), ("dw", dw, want_dw)):
                torch.testing.assert_close(got, want, msg=f"{name} {label}",
                                           **KERNEL_GRAD_TOL)
        else:
            sx, sw = _low_precision_tol(x.cpu(), w.cpu(), labels.cpu(),
                                        want_lse.cpu(), g.cpu(), eps, dt)
            assert _within(dx.cpu(), want_dx.cpu(), sx, dt), f"dx {label}"
            assert _within(dw.cpu(), want_dw.cpu(), sw, dt), f"dw {label}"
        again = tfc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dw), label
        assert torch.equal(tfc.fused_ce_dx(x, w, labels, want_lse, g, eps),
                           dx), label
        assert torch.equal(tfc.fused_ce_dw(x, w, labels, want_lse, g, eps),
                           dw), label
        assert torch.equal(tfc.fused_ce_fwd(x, w, labels, eps)[0], loss)
    x = torch.randn(64, 32, device=cuda_device, requires_grad=True)
    w = torch.randn(32, 80, device=cuda_device, requires_grad=True)
    labels = torch.randint(0, 80, (64,), device=cuda_device)
    n0 = dict(tfc.LAUNCHES)
    tnn.mean(tnn.fused_linear_ce(x, w, labels[:, None], 0.1)).backward()
    torch.cuda.synchronize()
    assert {k: tfc.LAUNCHES[k] - n0[k] for k in n0} == \
        {"fused_ce_fwd": 1, "fused_ce_bwd": 1}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
    x1 = torch.randn(1, 513, device=cuda_device, requires_grad=True)
    w1 = torch.randn(513, 2, device=cuda_device)
    lab1 = torch.tensor([[0]], device=cuda_device)
    got = tnn.fused_linear_ce(x1, w1, lab1)
    torch.testing.assert_close(got[:, 0], tfc.fused_ce_fwd_ref(
        x1.detach(), w1, lab1[:, 0])[0], **KERNEL_FWD_TOL)
    got.sum().backward()
    assert torch.isfinite(x1.grad).all()
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tfc.fused_ce_fwd(x.detach().double(), w.detach().double(), labels)


@pytest.mark.gpu
def test_cuda_mixed_dtypes_match_plain_versions(cuda_device):
    """A mixed x / w pair on the card (the fp32 path over the widened
    operands, dz rounded to x's dtype where x is the narrower) against
    the plain versions: loss and lse within the fp32 kernel tolerances,
    dx in x's dtype and dW in w's within :func:`_low_precision_tol` at
    x's dtype; one launch each way; a second backward bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for xdt, wdt in MIXED:
        for n, d, v, eps in ((1000, 100, 1003, 0.1), (300, 700, 1003, 0.0),
                             (8, 128, 128, 0.1)):
            x = torch.randn(n, d, generator=gen, device=cuda_device).to(xdt)
            w = (torch.randn(d, v, generator=gen, device=cuda_device)
                 * d ** -0.5).to(wdt)
            labels = torch.randint(0, v, (n,), generator=gen,
                                   device=cuda_device)
            labels[::7] = IGNORE
            g = torch.rand(n, generator=gen, device=cuda_device) + 0.5
            n0 = dict(tfc.LAUNCHES)
            loss, lse = tfc.fused_ce_fwd(x, w, labels, eps)
            want_loss, want_lse = tfc.fused_ce_fwd_ref(x, w, labels, eps)
            dx, dw = tfc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
            want_dx, want_dw = tfc.fused_ce_bwd_ref(x, w, labels, want_lse,
                                                    g, eps)
            torch.cuda.synchronize()
            assert {k: tfc.LAUNCHES[k] - n0[k] for k in n0} == \
                {"fused_ce_fwd": 1, "fused_ce_bwd": 1}
            label = f"n={n} d={d} v={v} eps={eps} {xdt}/{wdt}"
            assert dx.dtype == xdt and dw.dtype == wdt, label
            for name, got, want in (("loss", loss, want_loss),
                                    ("lse", lse, want_lse)):
                torch.testing.assert_close(got, want, msg=f"{name} {label}",
                                           **KERNEL_FWD_TOL)
            sx, sw = _low_precision_tol(x.cpu(), w.cpu(), labels.cpu(),
                                        want_lse.cpu(), g.cpu(), eps, xdt)
            assert _within(dx.cpu(), want_dx.cpu(), sx, xdt), f"dx {label}"
            assert _within(dw.cpu(), want_dw.cpu(), sw, wdt), f"dw {label}"
            again = tfc.fused_ce_bwd(x, w, labels, want_lse, g, eps)
            assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
