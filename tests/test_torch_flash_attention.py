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
The keep masks are integer hashes and must agree bit for bit. bf16 and
fp16 operands are held to the JAX function's own roundings (LOW_TOL).

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
from paddle_tpu_torch.ops.kernels import fused_ce as tfc

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# bf16 / fp16 against the JAX function, which keeps its operands in their
# dtype and rounds p (x keep) to v's dtype before p . v, dS to the operands'
# dtype before the gradient products, and o, dq, dk, dv once at the end:
# every element within one step of the dtype at the tensor's largest
# magnitude (2^-7 of it for bf16, 2^-10 for fp16), and at most a third of
# the elements off by any amount. The rest is the Pallas kernel's online
# softmax, which rounds p against the running max of each key block where
# the plain version takes the row's max, and fp32 sums in another order.
# A version that rounds s, p or dP to the operand dtype moves most
# elements (65-83 % at seed-0 [2, 2, 32, 64] bf16).
LOW_STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
LOW_MOVED = 1.0 / 3.0


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


def _assert_low(got, want, dtype_name, label):
    """``got`` (torch) within LOW_STEP of ``want`` (JAX) at the largest
    magnitude, and, where ``got`` is itself bf16 / fp16, at most LOW_MOVED
    of its elements moved (an fp32 output moves by fp32's last bits
    wherever its sums run in another order)."""
    a = got.detach().float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert a.shape == w.shape, label
    diff = np.abs(a - w)
    bound = LOW_STEP[dtype_name] * float(np.abs(w).max())
    assert float(diff.max()) <= bound, \
        f"{label}: max |diff| {diff.max()} > {bound}"
    if got.dtype != torch.float32:
        moved = float((diff > 0).mean())
        assert moved <= LOW_MOVED, \
            f"{label}: {moved:.1%} of the elements moved"


def _low_inputs(case):
    """(causal, p, q, k, v, g, block): the CASES shapes at B 2, H 3, D 8
    and, as "seed0", seed-0 numpy [2, 2, 32, 64] for all four."""
    if case == "seed0":
        rng = np.random.RandomState(0)
        q, k, v, g = (rng.randn(2, 2, 32, 64).astype(np.float32)
                      for _ in range(4))
        return False, 0.0, q, k, v, g, 16
    causal, p, q, k, v, g = _inputs(case)
    return causal, p, q, k, v, g, 8


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


@pytest.mark.parametrize("case", sorted(CASES) + ["seed0"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_matches_pallas(jx, dtype, case):
    """bf16 / fp16 operands: the port's forward and its autograd gradients
    against the JAX function and its VJP (interpret mode), within LOW_TOL's
    two conditions; the outputs keep the operands' dtype."""
    jax, jnp, pfa = jx
    causal, p, q, k, v, g, block = _low_inputs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    seed = jnp.array([SEED], jnp.int32) if p else None
    want, vjp = jax.vjp(
        lambda a, b_, c: pfa.flash_attention(a, b_, c, causal, None, block,
                                             block, True, p, seed),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal, None, p, SEED)
    out.backward(torch.from_numpy(g).to(tdt))
    for name, got, w in zip(("o", "dq", "dk", "dv"),
                            (out, *(t.grad for t in leaves)),
                            (want, *want_grads)):
        assert got.dtype == tdt, name
        _assert_low(got, w.astype(jnp.float32), dtype, f"{dtype} {case} {name}")


@pytest.mark.parametrize("dtypes", [("bfloat16", "float32", "float32"),
                                    ("float32", "float32", "float16")],
                         ids=["q_bf16", "v_fp16"])
def test_mixed_dtypes_match_pallas(jx, dtypes):
    """q, k, v of different dtypes, as the JAX function takes them: o and
    dq in q's dtype, dk in k's, dv in v's, within LOW_TOL of the narrowest
    dtype. On the card the wrappers widen them to fp32 (exact) and pass the
    kernels the narrower dtypes to round p and dS to: p x keep to v's in
    the forward and to dO's (q's) before dV, dS to q's before dK and to
    k's before dQ."""
    jax, jnp, pfa = jx
    causal, p, q, k, v, g = _inputs("causal_dropout")
    jdts = [getattr(jnp, n) for n in dtypes]
    tdts = [getattr(torch, n) for n in dtypes]
    want, vjp = jax.vjp(
        lambda a, b_, c: pfa.flash_attention(
            a, b_, c, causal, None, 8, 8, True, p,
            jnp.array([SEED], jnp.int32)),
        *(jnp.asarray(x, dt) for x, dt in zip((q, k, v), jdts)))
    want_grads = vjp(jnp.asarray(g, jdts[0]))
    leaves = [torch.from_numpy(x).to(dt).requires_grad_()
              for x, dt in zip((q, k, v), tdts)]
    out = tfa.flash_attention(*leaves, causal, None, p, SEED)
    out.backward(torch.from_numpy(g).to(tdts[0]))
    narrow = next(n for n in dtypes if n != "float32")
    for name, got, w, dt in zip(("o", "dq", "dk", "dv"),
                                (out, *(t.grad for t in leaves)),
                                (want, *want_grads),
                                (tdts[0], *tdts)):
        assert got.dtype == dt, name
        _assert_low(got, w.astype(jnp.float32), narrow, f"{dtypes} {name}")
    detached = [x.detach() for x in leaves]
    widened, code = tfa._kernel_args("flash_fwd", detached)
    assert code == 0
    for a, b_ in zip(widened, detached):
        assert a.dtype == torch.float32 and torch.equal(a, b_.float())
    codes = [tfa.DTYPES[dt] for dt in tdts]
    assert tfa.rounds("flash_fwd", tdts[2]) == codes[2]
    assert tfa.rounds("flash_bwd", tdts[0], tdts[0], tdts[1]) == \
        codes[0] * 4 + codes[1] * 9


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_ref_matches_pallas_vjp_with_lse_cotangent(jx, case):
    """flash_bwd_ref (dq, dk, dv at once) against the VJP of the JAX
    ``flash_attention_lse`` with cotangents on both outputs, fed the JAX
    forward's own o and lse: the dLSE term enters dS as the reference's
    does."""
    jax, jnp, _ = jx
    causal, p, q, k, v, g = _inputs(case)
    (o, lse), vjp = jax.vjp(
        lambda a, b_, c: _jax_flash(jx, case, a, b_, c, lse=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    glse = _r(*lse.shape, seed=8)
    want = vjp((jnp.asarray(g), jnp.asarray(glse)))
    b, h, tq, d = q.shape
    t = [torch.from_numpy(np.array(x)).reshape(b * h, -1, d)
         for x in (q, k, v, g)]
    o_t = torch.from_numpy(np.array(o)).reshape(b * h, tq, d)
    lse_t = torch.from_numpy(np.array(lse)).reshape(b * h, tq)
    delta = (o_t * t[3]).sum(-1)
    got = tfa.flash_bwd_ref(*t, lse_t, delta, causal, d ** -0.5, p, SEED,
                            dlse=torch.from_numpy(glse).reshape(b * h, tq))
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.reshape(w.shape).numpy(), np.asarray(w),
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
    both = (tfa.flash_dq_ref(*args), *tfa.flash_dkv_ref(*args))
    for a, b_, c in zip(tfa.flash_bwd(*args), tfa.flash_bwd_ref(*args), both):
        assert torch.equal(a, b_) and torch.equal(a, c)
    assert tfa.LAUNCHES == before


def test_mixed_rounding_codes():
    """What the mixed library takes: one narrow dtype among the backward's
    rounding points, dO in q's dtype; the forward rounds to v's alone."""
    bf, hf, f = torch.bfloat16, torch.float16, torch.float32
    assert tfa.rounds("flash_fwd", hf, bf, bf) == 2 + 3 + 9
    assert tfa.rounds("flash_dq", k=hf) == 18
    assert tfa.rounds("flash_bwd", f, f, f) == 0
    with pytest.raises(ValueError, match="dO in q's dtype"):
        tfa.rounds("flash_bwd", f, bf, bf)
    with pytest.raises(ValueError, match="one of bfloat16 and float16"):
        tfa.rounds("flash_bwd", bf, bf, hf)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tfa._kernel_args("flash_fwd", [torch.zeros(2, 4, 8)] * 2
                         + [torch.zeros(2, 4, 8, dtype=torch.float64)])


def test_fwd_kernel_range():
    """Which kernel flash_fwd launches on the card: the tensor-core kernel
    at head widths up to 128 (after padding) and every length, the SIMT
    kernel on 256-wide tiles beyond."""
    for d, want in ((1, "tensor_cores"), (32, "tensor_cores"),
                    (48, "tensor_cores"), (128, "tensor_cores"),
                    (129, "simt"), (256, "simt"), (320, "simt")):
        assert tfa.fwd_kernel(d) == want, d


def test_bwd_kernel_range():
    """Which kernel flash_bwd launches on the card: the tensor-core kernel
    at head widths up to 128 (after padding) and key lengths up to 512 (up
    to 8 key tiles of 64, each a plane of dQ partials), the SIMT pair
    beyond."""
    assert tfa.BWD_MAX_TK == 512
    one = "flash_bwd"
    two = "flash_dq+flash_dkv"
    for tk, d, want in ((128, 64, one), (1, 1, one), (512, 128, one),
                        (33, 48, one), (513, 64, two), (128, 129, two),
                        (128, 256, two), (4096, 64, two), (64, 320, two)):
        assert tfa.bwd_kernel(tk, d) == want, (tk, d)


# (case, shape [BH, Tq, Tk, D]): the main path's attention shape and the
# CASES shapes, at which one TF32 term per product breaks GRAD_TOL
TF32_CASES = [(c, (256, 128, 128, 64)) for c in ("full", "causal",
                                                 "dropout")] + \
    [(c, (6, CASES[c][1], CASES[c][2], 8)) for c in sorted(CASES)]


@pytest.mark.parametrize("case,shape", TF32_CASES,
                         ids=[f"{c}-{s[0]}x{s[1]}x{s[2]}x{s[3]}"
                              for c, s in TF32_CASES])
def test_three_tf32_terms_hold_the_fp32_tolerance(monkeypatch, case, shape):
    """Why flash_bwd's fp32 kernel takes three TF32 products, and that the
    card's check (the kernel against flash_bwd_ref within GRAD_TOL) tells
    them from one. flash_bwd_ref runs with every product (S, dP, dV, dK,
    dQ) made as the kernel's wgmma makes it: each operand split hi =
    tf32(a), lo = tf32(a - hi), the two small products summed first, then
    hi * hi, in fp32 (three terms); or hi * hi alone (one term). Against
    the fp32 plain version, three terms stay far inside GRAD_TOL (below 5 %
    of it at these seeds), one term breaks it in each of dq, dk and dv
    (by 3.8 to 29 times at these seeds)."""
    bh, tq, tk, d = shape
    causal, p = CASES[case][0], (0.1 if case == "dropout" and bh == 256
                                 else CASES[case][3])
    rng = np.random.RandomState(5)
    q, g = (torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32))
            for _ in range(2))
    args = (causal, d ** -0.5, p, SEED)
    o, lse = tfa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, g, lse, (o * g).sum(-1))
    want = tfa.flash_bwd_ref(*bwd, *args)
    matmul = torch.matmul

    def one(a, b):
        return matmul(tfc.split_tf32(a.contiguous())[0],
                      tfc.split_tf32(b.contiguous())[0])

    def three(a, b):
        (ah, al), (bh_, bl) = (tfc.split_tf32(x.contiguous())
                               for x in (a, b))
        return (matmul(ah, bl) + matmul(al, bh_)) + matmul(ah, bh_)

    def excess(got, ref):
        return float(((got - ref).abs() / (GRAD_TOL["atol"] + GRAD_TOL[
            "rtol"] * ref.abs())).max())
    for terms, inside in ((three, True), (one, False)):
        monkeypatch.setattr(torch, "matmul", terms)
        got = tfa.flash_bwd_ref(*bwd, *args)
        monkeypatch.setattr(torch, "matmul", matmul)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            e = excess(a, w)
            assert (e < 0.05 if inside else e > 2.0), \
                (terms.__name__, name, e)


# the card's check of the forward (chip_smoke.py FLASH_FWD_TOL, the gpu
# tests): the kernel against flash_fwd_ref
CARD_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TF32_CASES = [(c, (256, 128, 128, 64)) for c in ("full", "causal",
                                                     "dropout")] + \
    [(c, (6, CASES[c][1], CASES[c][2], 8)) for c in sorted(CASES)]


@pytest.mark.parametrize("case,shape", FWD_TF32_CASES,
                         ids=[f"{c}-{s[0]}x{s[1]}x{s[2]}x{s[3]}"
                              for c, s in FWD_TF32_CASES])
def test_three_tf32_terms_hold_the_forward_tolerance(monkeypatch, case,
                                                     shape):
    """Why flash_fwd's fp32 kernel takes three TF32 products, and that the
    card's check (the kernel against flash_fwd_ref within CARD_FWD_TOL)
    tells them from one: flash_fwd_ref with both products (S = q k^T and
    p . v) made as the kernel's wgmma makes them, three terms or one (as
    in test_three_tf32_terms_hold_the_fp32_tolerance). Against the fp32
    plain version, three terms stay inside a tenth of CARD_FWD_TOL (o at
    0.9-9.4 % of it, lse at 0.1-2.5 %), one breaks it in o at every case
    (by 20 to 89 times at these seeds)."""
    bh, tq, tk, d = shape
    causal, p = CASES[case][0], (0.1 if case == "dropout" and bh == 256
                                 else CASES[case][3])
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32))
            for _ in range(2))
    args = (causal, d ** -0.5, p, SEED)
    want = tfa.flash_fwd_ref(q, k, v, *args)
    matmul = torch.matmul

    def one(a, b):
        return matmul(tfc.split_tf32(a.contiguous())[0],
                      tfc.split_tf32(b.contiguous())[0])

    def three(a, b):
        (ah, al), (bh_, bl) = (tfc.split_tf32(x.contiguous())
                               for x in (a, b))
        return (matmul(ah, bl) + matmul(al, bh_)) + matmul(ah, bh_)

    def excess(got, ref):
        return float(((got - ref).abs() / (CARD_FWD_TOL["atol"] + CARD_FWD_TOL[
            "rtol"] * ref.abs())).max())
    for terms, inside in ((three, True), (one, False)):
        monkeypatch.setattr(torch, "matmul", terms)
        o, lse = tfa.flash_fwd_ref(q, k, v, *args)
        monkeypatch.setattr(torch, "matmul", matmul)
        e_o, e_lse = excess(o, want[0]), excess(lse, want[1])
        if inside:
            assert e_o < 0.15 and e_lse < 0.15, (terms.__name__, e_o, e_lse)
        else:
            assert e_o > 10.0, (terms.__name__, e_o, e_lse)


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
    shapes (B 2, H 8, T 128, D 64), a ragged T = 100 and B*H 2 / T 33,
    dropout 0.1, causal cross lengths (Tq != Tk), D = 128 and D = 256, head
    widths the wrappers pad (48: d_model 96 over 2 heads; 8, 200), above 256
    in 256-wide chunks (257, 320: d_model 640 over 2 heads, 512), and the
    first key length past flash_bwd's range (513), which runs the SIMT dQ
    and dK/dV kernels; then bf16 and fp16 in the working type (within two
    steps of the dtype: one at the largest magnitude plus one of each
    element, for the forward's online softmax and sums in another order),
    and the lse cotangent on both routes.
    flash_bwd launches one kernel a call and repeats its bits; the autograd
    Function launches the forward and the backward once a call."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    fp32 = [(16, 128, 128, 64, False, 0.0), (16, 128, 128, 64, True, 0.0),
            (16, 100, 100, 64, True, 0.0), (16, 128, 128, 64, False, 0.1),
            (16, 100, 100, 64, True, 0.1), (8, 70, 130, 64, True, 0.1),
            (4, 128, 128, 128, True, 0.1), (4, 96, 80, 32, False, 0.2),
            (4, 128, 128, 48, True, 0.1), (4, 100, 100, 256, True, 0.0),
            (8, 70, 130, 256, True, 0.1), (4, 40, 40, 200, False, 0.2),
            (2, 33, 33, 8, True, 0.0), (2, 33, 33, 64, False, 0.1),
            (2, 64, 64, 320, True, 0.1), (2, 40, 40, 257, False, 0.0),
            (2, 33, 47, 512, True, 0.0), (2, 300, 512, 64, True, 0.1),
            (2, 40, 513, 64, False, 0.0), (2, 513, 513, 64, True, 0.1)]
    low = [(16, 128, 128, 64, False, 0.0), (16, 128, 128, 64, True, 0.1),
           (2, 33, 33, 64, True, 0.0), (8, 70, 130, 64, True, 0.1),
           (4, 128, 128, 128, False, 0.0), (4, 96, 80, 32, False, 0.2),
           (2, 40, 513, 64, False, 0.0)]
    cases = ([(torch.float32,) + c for c in fp32]
             + [(dt,) + c for dt in (torch.bfloat16, torch.float16)
                for c in low])
    for dt, bh, tq, tk, d, causal, p in cases:
        q, g = (torch.randn(bh, tq, d, generator=gen, device=cuda_device)
                .to(dt) for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=cuda_device)
                .to(dt) for _ in range(2))
        scale, seed = d ** -0.5, 4242
        label = (f"{dt} bh={bh} tq={tq} tk={tk} d={d} causal={causal} "
                 f"p={p}")
        n0 = dict(tfa.LAUNCHES)
        o, lse = tfa.flash_fwd(q, k, v, causal, scale, p, seed)
        want_o, want_lse = tfa.flash_fwd_ref(q, k, v, causal, scale, p, seed)
        delta = (want_o.float() * g.float()).sum(-1)
        args = (q, k, v, g, want_lse, delta, causal, scale, p, seed)
        dq = tfa.flash_dq(*args)
        dk, dv = tfa.flash_dkv(*args)
        n1 = dict(tfa.LAUNCHES)
        grads = tfa.flash_bwd(*args)
        torch.cuda.synchronize()
        assert {n: n1[n] - n0[n] for n in n0} == \
            {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_bwd": 0}
        one = tfa.bwd_kernel(tk, d) == "flash_bwd"
        assert {n: tfa.LAUNCHES[n] - n1[n] for n in n0} == \
            {"flash_fwd": 0, "flash_dq": int(not one),
             "flash_dkv": int(not one), "flash_bwd": int(one)}, label
        assert (tk <= tfa.BWD_MAX_TK and d <= 128) == one, label
        assert all(torch.equal(a, b_) for a, b_ in
                   zip(grads, tfa.flash_bwd(*args))), f"repeat {label}"
        want_grads = tfa.flash_bwd_ref(*args)
        if dt == torch.float32:
            tols = [dict(rtol=1e-4, atol=1e-5)] * 2 + [GRAD_TOL] * 6
        else:
            step = LOW_STEP[str(dt).split(".")[1]]
            tols = [dict(rtol=step, atol=step * float(w.abs().max()))
                    for w in (want_o, *want_grads, *want_grads)]
            tols.insert(1, dict(rtol=1e-4, atol=1e-5))    # lse is fp32
        for (name, got, want), tol in zip((
                ("o", o, want_o), ("lse", lse, want_lse),
                ("dq", dq, want_grads[0]), ("dk", dk, want_grads[1]),
                ("dv", dv, want_grads[2]), ("bwd dq", grads[0], want_grads[0]),
                ("bwd dk", grads[1], want_grads[1]),
                ("bwd dv", grads[2], want_grads[2])), tols):
            assert got.dtype == want.dtype, f"{name} {label}"
            torch.testing.assert_close(got.float(), want.float(),
                                       msg=f"{name} {label}", **tol)
    # the lse cotangent (flash_attention_lse's dLSE), in and out of range
    for tk in (130, 520):
        q, g = (torch.randn(4, 70, 64, generator=gen, device=cuda_device)
                for _ in range(2))
        k, v = (torch.randn(4, tk, 64, generator=gen, device=cuda_device)
                for _ in range(2))
        dlse = torch.randn(4, 70, generator=gen, device=cuda_device)
        o, lse = tfa.flash_fwd_ref(q, k, v, True, 0.125, 0.1, 7)
        args = (q, k, v, g, lse, (o * g).sum(-1), True, 0.125, 0.1, 7)
        for name, got, want in zip("qkv", tfa.flash_bwd(*args, dlse=dlse),
                                   tfa.flash_bwd_ref(*args, dlse=dlse)):
            torch.testing.assert_close(got, want, msg=f"dlse d{name} {tk}",
                                       **GRAD_TOL)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 8, 128, 64, device=cuda_device).to(dt) \
            .requires_grad_()
        n0 = dict(tfa.LAUNCHES)
        tfa.flash_attention(q, q, q, True).float().sum().backward()
        torch.cuda.synchronize()
        assert {n: tfa.LAUNCHES[n] - n0[n] for n in n0} == \
            {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0, "flash_bwd": 1}
        assert q.grad.dtype == dt and torch.isfinite(q.grad).all()


def _card_low_tol(want, narrow):
    """Within one step of the narrow dtype at the largest magnitude plus one
    of each element (the gpu tests' bf16 / fp16 tolerance)."""
    step = LOW_STEP[narrow]
    return dict(rtol=step, atol=step * float(want.float().abs().max()))


@pytest.mark.gpu
def test_cuda_tensor_core_forward_matches_plain_version(cuda_device,
                                                        monkeypatch):
    """The forward on the tensor cores against flash_fwd_ref at every head
    width it takes (32, 64, 128 and the widths padded to them) and at
    lengths off every tile multiple, above 512 and above 1000 keys, in
    fp32 (CARD_FWD_TOL), bf16 and fp16 (one step of the dtype at the
    largest magnitude plus one of each element), full, causal (tq <= tk)
    and with dropout; one launch a call, a second call bit-equal."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = [(3, 1, 1), (3, 33, 33), (2, 64, 200), (2, 127, 127),
              (2, 100, 513), (1, 700, 1100)]
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in (8, 32, 48, 64, 100, 128):
            assert tfa.fwd_kernel(d) == "tensor_cores"
            for bh, tq, tk in shapes:
                for causal, p in ((False, 0.0), (True, 0.0), (False, 0.2),
                                  (True, 0.1)):
                    q = torch.randn(bh, tq, d, generator=gen,
                                    device=cuda_device).to(dt)
                    k, v = (torch.randn(bh, tk, d, generator=gen,
                                        device=cuda_device).to(dt)
                            for _ in range(2))
                    args = (causal, d ** -0.5, p, 77)
                    n0 = tfa.LAUNCHES["flash_fwd"]
                    o, lse = tfa.flash_fwd(q, k, v, *args)
                    again = tfa.flash_fwd(q, k, v, *args)
                    want_o, want_lse = tfa.flash_fwd_ref(q, k, v, *args)
                    torch.cuda.synchronize()
                    label = f"{dt} d={d} {bh}x{tq}x{tk} {causal} {p}"
                    assert tfa.LAUNCHES["flash_fwd"] == n0 + 2, label
                    assert torch.equal(o, again[0]) and \
                        torch.equal(lse, again[1]), label
                    tol = CARD_FWD_TOL if dt == torch.float32 else \
                        _card_low_tol(want_o, str(dt).split(".")[1])
                    assert o.dtype == dt, label
                    torch.testing.assert_close(o.float(), want_o.float(),
                                               msg=f"o {label}", **tol)
                    torch.testing.assert_close(lse, want_lse,
                                               msg=f"lse {label}",
                                               **CARD_FWD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32", "float32"),
                                    ("float32", "float32", "float16"),
                                    ("float16", "float16", "float32"),
                                    ("float32", "bfloat16", "bfloat16")],
                         ids=["q_bf16", "v_fp16", "qk_fp16", "kv_bf16"])
def test_cuda_mixed_dtypes_match_plain_versions(cuda_device, monkeypatch,
                                                dtypes):
    """q, k, v of mixed dtypes on the card (the combinations of
    test_mixed_dtypes_match_pallas, and two more), dO in q's dtype: the
    forward, flash_bwd and the dQ / dK,dV pair against the plain versions,
    each output in the dtype the reference gives it (o and dq in q's, dk in
    k's, dv in v's), within one step of the narrow dtype at the largest
    magnitude plus one of each element: the kernels round p and dS to the
    narrow dtype where the reference does, and a value that lies at a
    rounding boundary may round the other way. Within the tensor cores'
    range and beyond it (key length 513, head width 320)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    dts = [getattr(torch, n) for n in dtypes]
    narrow = next(n for n in dtypes if n != "float32")
    for bh, tq, tk, d, causal, p in ((16, 128, 128, 64, True, 0.1),
                                     (4, 70, 130, 32, False, 0.2),
                                     (4, 40, 513, 64, False, 0.0),
                                     (2, 64, 64, 320, True, 0.1)):
        q, g = (torch.randn(bh, tq, d, generator=gen, device=cuda_device)
                .to(dts[0]) for _ in range(2))
        k = torch.randn(bh, tk, d, generator=gen, device=cuda_device) \
            .to(dts[1])
        v = torch.randn(bh, tk, d, generator=gen, device=cuda_device) \
            .to(dts[2])
        args = (causal, d ** -0.5, p, 5)
        o, lse = tfa.flash_fwd(q, k, v, *args)
        want_o, want_lse = tfa.flash_fwd_ref(q, k, v, *args)
        bwd = (q, k, v, g, want_lse,
               (want_o.float() * g.float()).sum(-1)) + args
        want = tfa.flash_bwd_ref(*bwd)
        got = {"bwd": tfa.flash_bwd(*bwd),
               "pair": (tfa.flash_dq(*bwd), *tfa.flash_dkv(*bwd))}
        torch.cuda.synchronize()
        label = f"{dtypes} {bh}x{tq}x{tk}x{d} {causal} {p}"
        assert o.dtype == dts[0], label
        torch.testing.assert_close(o.float(), want_o.float(),
                                   msg=f"o {label}",
                                   **_card_low_tol(want_o, narrow))
        torch.testing.assert_close(lse, want_lse, msg=f"lse {label}",
                                   **CARD_FWD_TOL)
        for route, grads in got.items():
            for name, a, w, dt in zip(("dq", "dk", "dv"), grads, want,
                                      (dts[0], dts[1], dts[2])):
                assert a.dtype == dt, f"{route} {name} {label}"
                torch.testing.assert_close(
                    a.float(), w.float(), msg=f"{route} {name} {label}",
                    **_card_low_tol(w, narrow))
