"""The PyTorch port's fused linear + cross entropy (paddle_tpu_torch/ops/
kernels/fused_ce.py and ``nn_ops.fused_linear_ce``) against the JAX
package's Pallas kernels (paddle_tpu/ops/pallas/fused_ce.py, in interpret
mode, as tests/test_fused_ce.py runs them).

On the CPU the port's wrappers take the plain PyTorch versions and the
backward runs ``FusedLinearCE.backward`` over them. Tolerances are the JAX
package's own for this kernel (tests/test_fused_ce.py): loss and lse
rtol 1e-5 / atol 1e-5; dx and dW rtol 1e-4 / atol 1e-5 -- fp32 sums over
vocab chunks on one side and over whole rows on the other.

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
SHAPES = [(16, 8, 24), (64, 32, 48)]      # (N, D, V)
IGNORE = -100


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
    assert tfc.LAUNCHES == before


def test_vocab_splits_fill_the_card():
    # Transformer-base's head: 128 row tiles already fill 132 SMs
    assert tfc.vocab_splits(4096, 32000, 132) == 1
    assert tfc.vocab_splits(1000, 1003, 132) == 4
    assert tfc.vocab_splits(16, 100, 132) == 2     # never past the chunks


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
    """D > 512 on the card: z is summed over 512-wide depth chunks in
    order, and dx / dW are made one 512-wide output chunk at a time from
    that z. The same decomposition in float64 at D 700 equals the whole
    products to the last bits of float64, and the plain versions (which
    compute in float32) within float32's rounding."""
    rng = np.random.RandomState(11)
    n, d, v, eps, chunk = 40, 700, 90, 0.1, 512
    x = torch.from_numpy(rng.randn(n, d)).double()
    w = torch.from_numpy(rng.randn(d, v) * d ** -0.5).double()
    labels = torch.from_numpy(rng.randint(0, v, n))
    labels[::7] = IGNORE
    g = torch.from_numpy(rng.rand(n) + 0.5).double()
    starts = range(0, d, chunk)
    z = sum(x[:, c:c + chunk] @ w[c:c + chunk] for c in starts)
    np.testing.assert_allclose(z.numpy(), (x @ w).numpy(), rtol=1e-12,
                               atol=1e-12)
    loss, lse = tfc.fused_ce_fwd_ref(x, w, labels, eps)
    on, _, off, _ = tfc._consts(eps, v)
    t = torch.where(torch.arange(v)[None] == labels[:, None], on, 0.0) + off
    dz = (torch.exp(z - lse[:, None]) - t) * g[:, None]
    dz[labels == IGNORE] = 0
    dx = torch.cat([dz @ w[c:c + chunk].t() for c in starts], dim=1)
    dw = torch.cat([x[:, c:c + chunk].t() @ dz for c in starts], dim=0)
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
    (N, D and V not multiples of the tiles, D up to 512, vocab splits, and
    D above 512 in chunks: 513, 700, 1024 and 1100), eps 0 and 0.1,
    ignored rows; the autograd Function launches each kernel once per
    call, also at the smallest input that raised before (x [1, 513]);
    float64 raises."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for n, d, v, eps in [(1000, 100, 1003, 0.1), (37, 512, 640, 0.0),
                         (300, 257, 129, 0.1), (4096, 512, 4000, 0.1),
                         (5, 3, 7, 0.0), (300, 700, 1003, 0.1),
                         (64, 513, 200, 0.0), (512, 1024, 3000, 0.1),
                         (33, 1100, 70, 0.1)]:
        x = torch.randn(n, d, generator=gen, device=cuda_device)
        w = torch.randn(d, v, generator=gen, device=cuda_device) * d ** -0.5
        labels = torch.randint(0, v, (n,), generator=gen, device=cuda_device)
        labels[::7] = IGNORE
        g = torch.rand(n, generator=gen, device=cuda_device) + 0.5
        n0 = dict(tfc.LAUNCHES)
        loss, lse = tfc.fused_ce_fwd(x, w, labels, eps)
        want_loss, want_lse = tfc.fused_ce_fwd_ref(x, w, labels, eps)
        dx = tfc.fused_ce_dx(x, w, labels, want_lse, g, eps)
        dw = tfc.fused_ce_dw(x, w, labels, want_lse, g, eps)
        want_dx, want_dw = tfc.fused_ce_bwd_ref(x, w, labels, want_lse, g,
                                                eps)
        torch.cuda.synchronize()
        assert {k: tfc.LAUNCHES[k] - n0[k] for k in n0} == \
            {"fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
        label = f"n={n} d={d} v={v} eps={eps}"
        for name, got, want, tol in (
                ("loss", loss, want_loss, dict(rtol=1e-4, atol=1e-5)),
                ("lse", lse, want_lse, dict(rtol=1e-4, atol=1e-5)),
                ("dx", dx, want_dx, dict(rtol=1e-3, atol=1e-4)),
                ("dw", dw, want_dw, dict(rtol=1e-3, atol=1e-4))):
            torch.testing.assert_close(got, want, msg=f"{name} {label}",
                                       **tol)
    x = torch.randn(64, 32, device=cuda_device, requires_grad=True)
    w = torch.randn(32, 80, device=cuda_device, requires_grad=True)
    labels = torch.randint(0, 80, (64,), device=cuda_device)
    n0 = dict(tfc.LAUNCHES)
    tnn.mean(tnn.fused_linear_ce(x, w, labels[:, None], 0.1)).backward()
    torch.cuda.synchronize()
    assert {k: tfc.LAUNCHES[k] - n0[k] for k in n0} == \
        {"fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
    x1 = torch.randn(1, 513, device=cuda_device, requires_grad=True)
    w1 = torch.randn(513, 2, device=cuda_device)
    lab1 = torch.tensor([[0]], device=cuda_device)
    got = tnn.fused_linear_ce(x1, w1, lab1)
    torch.testing.assert_close(got[:, 0], tfc.fused_ce_fwd_ref(
        x1.detach(), w1, lab1[:, 0])[0], rtol=1e-4, atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(x1.grad).all()
    with pytest.raises(ValueError, match="float32"):
        tfc.fused_ce_fwd(x.detach().double(), w.detach().double(), labels)
