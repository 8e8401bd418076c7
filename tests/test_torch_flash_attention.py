"""The PyTorch port's flash attention (paddle_tpu_torch/ops/kernels/
flash_attention.py) and fused attention block (paddle_tpu_torch/ops/
attention_block.py) against the JAX package's Pallas flash kernels
(paddle_tpu/ops/pallas/flash_attention.py, in interpret mode with 8 x 8
blocks, as tests/test_pallas_kernels.py runs them) and its fused block
(paddle_tpu/ops/attention_block.py).

On the CPU the port's wrappers take the plain PyTorch versions and the
backward runs ``FlashAttention.backward`` over them. Tolerances are the
JAX package's own for its flash kernels (tests/test_pallas_kernels.py:35,
69): forward rtol 2e-4 / atol 2e-5, gradients rtol 1e-3 / atol 1e-4 --
fp32 sums taken blockwise on one side and over whole rows on the other.
The keep masks are integer hashes and must agree bit for bit.

The CUDA kernels run only on the card: the ``gpu`` test holds each
against its plain version there and skips elsewhere. JAX is imported
inside a fixture, so that the card's machine, which has no JAX, collects
this file and runs its ``gpu`` test
(``pytest --noconftest -m gpu tests/test_torch_flash_attention.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention_block as tab
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's Pallas flash module)."""
    import importlib
    jax = pytest.importorskip("jax")
    # the package re-exports the function under the module's name
    pfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    return jax, jax.numpy, pfa


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name: (causal, tq, tk, dropout_p)
CASES = {
    "full": (False, 16, 16, 0.0),
    "causal": (True, 16, 16, 0.0),
    "cross_causal": (True, 8, 24, 0.0),
    "dropout": (False, 16, 16, 0.3),
    "causal_dropout": (True, 16, 16, 0.3),
}
SEED = 1234567


def _inputs(case, b=2, h=3, d=8):
    causal, tq, tk, p = CASES[case]
    q, k, v = (_r(b, h, t, d, seed=s) for s, t in ((0, tq), (1, tk),
                                                    (2, tk)))
    return causal, p, q, k, v, _r(b, h, tq, d, seed=3)


def _jax_flash(jx, case, q, k, v, lse=False):
    jax, jnp, pfa = jx
    causal, p = CASES[case][0], CASES[case][3]
    seed = jnp.array([SEED], jnp.int32) if p else None
    fn = pfa.flash_attention_lse if lse else pfa.flash_attention
    return fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None,
              8, 8, True, p, seed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_pallas(jx, case):
    causal, p, q, k, v, _ = _inputs(case)
    want_o, want_lse = _jax_flash(jx, case, q, k, v, lse=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, None, p, SEED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_o), **FWD_TOL)
    b, h, tq, d = q.shape
    _, lse = tfa.flash_fwd(*(torch.from_numpy(x).reshape(b * h, -1, d)
                             for x in (q, k, v)), causal, d ** -0.5, p, SEED)
    np.testing.assert_allclose(lse.reshape(b, h, tq).numpy(),
                               np.asarray(want_lse), **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_pallas_vjp(jx, case):
    jax, jnp, _ = jx
    causal, p, q, k, v, g = _inputs(case)
    _, vjp = jax.vjp(lambda a, b_, c: _jax_flash(jx, case, a, b_, c),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_, causal, None, p, SEED)
    out.backward(torch.from_numpy(g))
    for name, got, w in zip("qkv", (tq_.grad, tk_.grad, tv_.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_hash_keep_mask_is_bit_equal(jx):
    _, jnp, pfa = jx
    rng = np.random.RandomState(0)
    bh = rng.randint(0, 512, (6, 1, 1)).astype(np.int32)
    qpos = rng.randint(-40, 4096, (1, 9, 1)).astype(np.int32)
    kpos = rng.randint(0, 4096, (1, 1, 11)).astype(np.int32)
    for seed in (0, 7, 2 ** 31 - 1, -5, -2 ** 31):
        for p in (0.1, 0.3, 0.5, 0.9):
            want = np.asarray(pfa.hash_keep_mask(
                jnp.int32(seed), jnp.asarray(bh), jnp.asarray(qpos),
                jnp.asarray(kpos), p))
            got = tfa.hash_keep_mask(seed, torch.from_numpy(bh),
                                     torch.from_numpy(qpos),
                                     torch.from_numpy(kpos), p)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_is_bit_equal_to_the_jax_op(jx):
    """The JAX dropout op's training output (nn_ops.py:487-492,
    upscale_in_train) with the seed given directly: the op draws it from
    ctx.step_key()."""
    _, jnp, pfa = jx
    x = _r(3, 5, 7, seed=4)
    for seed, p in ((11, 0.1), (-3, 0.5), (2 ** 30, 0.25)):
        idx = jnp.arange(x.size, dtype=jnp.int32).reshape(x.shape)
        keep = pfa.hash_keep_mask(jnp.int32(seed), jnp.int32(0), idx,
                                  jnp.int32(0), p)
        want = jnp.asarray(x) * keep
        got = tnn.dropout(torch.from_numpy(x), p, seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tnn.dropout(torch.ones(4), 1.0, 3), torch.zeros(4))


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.0),
                                      (True, 0.2)])
def test_fused_attention_block_matches_jax(jx, causal, p):
    """The whole block (projections, attention, Wo) and its gradients in
    every input against the JAX package's fused block, whose attention
    dropout uses the same hash and coordinates as the flash kernels."""
    jax, jnp, _ = jx
    from paddle_tpu.ops import attention_block as jab
    b, tq, tk, m, h = 2, 12, 12, 16, 4
    xq, xkv = _r(b, tq, m, seed=5), _r(b, tk, m, seed=6)
    ws = [_r(m, m, seed=7 + i) * 0.3 for i in range(4)]
    g = _r(b, tq, m, seed=11)
    seed = 77
    args = [jnp.asarray(a) for a in (xq, xkv, *ws)]
    want, vjp = jax.vjp(lambda *a: jab.attention_block(
        *a, jnp.array([seed], jnp.int32), h, causal, p), *args)
    want_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_() for a in (xq, xkv, *ws)]
    got = tab.fused_attention_block(*targs, h, causal, p, seed)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    got.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"input {i}", **GRAD_TOL)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    causal, p, q, k, v, g = _inputs("causal_dropout")
    t = [torch.from_numpy(x).reshape(6, -1, 8) for x in (q, k, v, g)]
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_fwd(*t[:3], causal, 0.5, p, SEED)
    want_o, want_lse = tfa.flash_fwd_ref(*t[:3], causal, 0.5, p, SEED)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    delta = (o * t[3]).sum(-1)
    args = (*t[:3], t[3], lse, delta, causal, 0.5, p, SEED)
    assert torch.equal(tfa.flash_dq(*args), tfa.flash_dq_ref(*args))
    for a, b_ in zip(tfa.flash_dkv(*args), tfa.flash_dkv_ref(*args)):
        assert torch.equal(a, b_)
    assert tfa.LAUNCHES == before


def test_lse_cotangent_enters_ds():
    """The dLSE input of the backward (flash_attention_lse's): with dO = 0
    the gradients are those of sum(dlse * lse)."""
    causal, _, q, k, v, _ = _inputs("full")
    t = [torch.from_numpy(x).reshape(6, -1, 8).double().requires_grad_()
         for x in (q, k, v)]
    dlse = torch.from_numpy(_r(6, 16, seed=9)).double()
    o, lse = tfa.flash_fwd_ref(*t, causal, 0.3)
    (lse * dlse).sum().backward()
    zeros = torch.zeros_like(o)
    args = (*(x.detach() for x in t), zeros, lse.detach(),
            torch.zeros_like(lse), causal, 0.3)
    dq = tfa.flash_dq(*args, dlse=dlse)
    dk, dv = tfa.flash_dkv(*args, dlse=dlse)
    for got, x in zip((dq, dk), t[:2]):
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-10,
                                   atol=1e-12)
    assert torch.count_nonzero(dv) == 0


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_head_width_padding_is_exact(causal):
    """The wrappers run a head width of 48 at 64 on the card: q, k, v and
    dO zero-padded along the head width, the scale passed in, the padding
    sliced off o, dq, dk and dv. Run on the plain versions in float64,
    that transform equals unpadded attention (lse too) to float64's last
    bits."""
    rng = np.random.RandomState(12)
    bh, t, d = 3, 20, 48
    width = tfa.kernel_width("flash", d)
    assert width == 64
    q, k, v, g = (torch.from_numpy(rng.randn(bh, t, d)) for _ in range(4))
    args = (causal, d ** -0.5, 0.2, SEED)
    o, lse = tfa.flash_fwd_ref(q, k, v, *args)
    delta = (o * g).sum(-1)
    qp, kp, vp, gp = tfa.padded(width, q, k, v, g)
    assert qp.shape == (bh, t, width) and bool((qp[..., d:] == 0).all())
    op, lsep = tfa.flash_fwd_ref(qp, kp, vp, *args)
    wide = (qp, kp, vp, gp, lsep, delta) + args
    exact = dict(rtol=1e-12, atol=1e-13)
    for got, want in (
            (tfa.unpadded(d, op), o), (lsep, lse),
            (tfa.unpadded(d, tfa.flash_dq_ref(*wide)),
             tfa.flash_dq_ref(q, k, v, g, lse, delta, *args)),
            *zip((tfa.unpadded(d, x) for x in tfa.flash_dkv_ref(*wide)),
                 tfa.flash_dkv_ref(q, k, v, g, lse, delta, *args))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **exact)
    assert [tfa.kernel_width("f", n)
            for n in (1, 32, 33, 100, 129, 256, 257, 320, 512, 513)] \
        == [32, 32, 64, 128, 256, 256, 512, 512, 512, 768]
    with pytest.raises(ValueError, match="head width 0"):
        tfa.kernel_width("flash_fwd", 0)



@pytest.mark.parametrize("d", [257, 320])
def test_wide_head_width_padding_is_exact(d):
    """Above 256 the kernels take the head width in 256-wide chunks: the
    wrappers pad 257 and 320 to 512. Run on the plain versions in
    float64, that padding equals unpadded attention (lse too) to float64's
    last bits, causal, with dropout."""
    rng = np.random.RandomState(13)
    bh, t = 2, 9
    width = tfa.kernel_width("flash", d)
    assert width == 512
    q, k, v, g = (torch.from_numpy(rng.randn(bh, t, d) * 0.1)
                  for _ in range(4))
    args = (True, d ** -0.5, 0.2, SEED)
    o, lse = tfa.flash_fwd_ref(q, k, v, *args)
    delta = (o * g).sum(-1)
    qp, kp, vp, gp = tfa.padded(width, q, k, v, g)
    op, lsep = tfa.flash_fwd_ref(qp, kp, vp, *args)
    wide = (qp, kp, vp, gp, lsep, delta) + args
    exact = dict(rtol=1e-12, atol=1e-13)
    for got, want in (
            (tfa.unpadded(d, op), o), (lsep, lse),
            (tfa.unpadded(d, tfa.flash_dq_ref(*wide)),
             tfa.flash_dq_ref(q, k, v, g, lse, delta, *args)),
            *zip((tfa.unpadded(d, x) for x in tfa.flash_dkv_ref(*wide)),
                 tfa.flash_dkv_ref(q, k, v, g, lse, delta, *args))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **exact)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="tq <= tk"):
        tfa.flash_fwd(q, torch.zeros(2, 3, 8), torch.zeros(2, 3, 8), True,
                      1.0)
    with pytest.raises(ValueError, match="want q"):
        tfa.flash_fwd(q, torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), False,
                      1.0)
    with pytest.raises(ValueError, match="dropout_p"):
        tfa.flash_fwd(q, q, q, False, 1.0, 1.0, 0)
    with pytest.raises(ValueError, match="empty"):
        tfa.flash_fwd(torch.zeros(2, 0, 8), q, q, False, 1.0)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_dq(q, q, q, q, torch.zeros(2, 3), torch.zeros(2, 4),
                     False, 1.0)
    meta = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(meta, meta, meta, False, 1.0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device, monkeypatch):
    """Each kernel against its plain version on the card at the training
    shapes (B 2, H 8, T 128, D 64), a ragged T = 100, dropout 0.1, a
    causal cross length, D = 128 and D = 256, head widths the
    wrappers pad (48: d_model 96 over 2 heads; 8, 200), and above 256 in
    256-wide chunks (257, 320: d_model 640 over 2 heads, 512); the autograd
    Function launches each kernel once per call."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(16, 128, 128, 64, False, 0.0), (16, 128, 128, 64, True, 0.0),
             (16, 100, 100, 64, True, 0.0), (16, 128, 128, 64, False, 0.1),
             (16, 100, 100, 64, True, 0.1), (8, 70, 130, 64, True, 0.1),
             (4, 128, 128, 128, True, 0.1), (4, 96, 80, 32, False, 0.2),
             (4, 128, 128, 48, True, 0.1), (4, 100, 100, 256, True, 0.0),
             (8, 70, 130, 256, True, 0.1), (4, 40, 40, 200, False, 0.2),
             (2, 33, 33, 8, True, 0.0), (2, 64, 64, 320, True, 0.1),
             (2, 40, 40, 257, False, 0.0), (2, 33, 47, 512, True, 0.0)]
    for bh, tq, tk, d, causal, p in cases:
        q, g = (torch.randn(bh, tq, d, generator=gen, device=cuda_device)
                for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=cuda_device)
                for _ in range(2))
        scale, seed = d ** -0.5, 4242
        n0 = dict(tfa.LAUNCHES)
        o, lse = tfa.flash_fwd(q, k, v, causal, scale, p, seed)
        want_o, want_lse = tfa.flash_fwd_ref(q, k, v, causal, scale, p, seed)
        delta = (want_o * g).sum(-1)
        args = (q, k, v, g, want_lse, delta, causal, scale, p, seed)
        dq = tfa.flash_dq(*args)
        dk, dv = tfa.flash_dkv(*args)
        torch.cuda.synchronize()
        assert {n: tfa.LAUNCHES[n] - n0[n] for n in n0} == \
            {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
        label = f"bh={bh} tq={tq} tk={tk} d={d} causal={causal} p={p}"
        for name, got, want, tol in (
                ("o", o, want_o, dict(rtol=1e-4, atol=1e-5)),
                ("lse", lse, want_lse, dict(rtol=1e-4, atol=1e-5)),
                ("dq", dq, tfa.flash_dq_ref(*args), GRAD_TOL),
                ("dk", dk, tfa.flash_dkv_ref(*args)[0], GRAD_TOL),
                ("dv", dv, tfa.flash_dkv_ref(*args)[1], GRAD_TOL)):
            torch.testing.assert_close(got, want, msg=f"{name} {label}",
                                       **tol)
    q = torch.randn(2, 8, 128, 64, device=cuda_device, requires_grad=True)
    n0 = dict(tfa.LAUNCHES)
    tfa.flash_attention(q, q, q, True).sum().backward()
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - n0[n] for n in n0} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert torch.isfinite(q.grad).all()
