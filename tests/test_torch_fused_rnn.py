"""The PyTorch port's whole-sequence LSTM (paddle_tpu_torch/ops/kernels/
fused_rnn.py) against the JAX package's Pallas kernels
(paddle_tpu/ops/pallas/fused_rnn.py, in interpret mode, as
tests/test_fused_rnn_train.py runs them).

On the CPU the port's wrappers take the plain PyTorch versions and the
backward runs ``FusedLSTMTrain.backward`` over ``lstm_train_bwd_plain``.
Tolerances are the JAX package's own for these kernels
(tests/test_fused_rnn_train.py): the four outputs rtol/atol 2e-6, the five
gradients 3e-5 -- fp32 sums in XLA's order on one side and torch's on the
other, over 6 steps.

The CUDA kernels run only on the card: the ``gpu`` tests hold each against
its plain version there and skip elsewhere. JAX is imported inside a
fixture, so that the card's machine, which has no JAX, collects this file
and runs its ``gpu`` tests
(``pytest --noconftest -m gpu tests/test_torch_fused_rnn.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_rnn as tfr

OUT_TOL = dict(rtol=2e-6, atol=2e-6)
GRAD_TOL = dict(rtol=3e-5, atol=3e-5)
OUT_NAMES = ("hidden", "cell", "h_last", "c_last")
GRAD_NAMES = ("dx", "dw", "dpeep", "dh0", "dc0")


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's Pallas fused-RNN module)."""
    import importlib
    jax = pytest.importorskip("jax")
    return jax, jax.numpy, importlib.import_module(
        "paddle_tpu.ops.pallas.fused_rnn")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _make(seed=0, T=6, B=8, H=128, ragged=True, w_scale=0.2):
    """xproj, w, peep, seq_lens [B], h0, c0 as
    tests/test_fused_rnn_train.py ``_make`` scales them."""
    rng = np.random.RandomState(seed)
    xproj = rng.randn(T, B, 4 * H).astype(np.float32) * 0.4
    w = rng.randn(H, 4 * H).astype(np.float32) * w_scale
    peep = rng.randn(1, 3 * H).astype(np.float32) * 0.1
    h0 = rng.randn(B, H).astype(np.float32) * 0.3
    c0 = rng.randn(B, H).astype(np.float32) * 0.3
    if ragged:
        sl = rng.randint(1, T + 1, size=B).astype(np.int32)
        sl[0] = T                        # at least one full row
    else:
        sl = np.full(B, T, np.int32)
    return xproj, w, peep, sl, h0, c0


def _torch(arrays, dtype=None):
    return [torch.from_numpy(a).to(dtype) if dtype is not None
            and a.dtype == np.float32 else torch.from_numpy(a)
            for a in arrays]


def _jax_args(jnp, arrays):
    xproj, w, peep, sl, h0, c0 = arrays
    return [jnp.asarray(a) for a in (xproj, w, peep, sl[:, None], h0, c0)]


def _jax_scan(jax, jnp, xproj, w, peep, sl, h0, c0):
    """The scan of ops/rnn_ops.py ``_dynamic_lstm`` (peepholes and mask)."""
    hdim = w.shape[0]
    w_ic, w_fc, w_oc = (peep[:, k * hdim:(k + 1) * hdim] for k in range(3))

    def step(carry, xt):
        h, c, t = carry
        gates = xt + h @ w
        i = jax.nn.sigmoid(gates[:, :hdim] + c * w_ic)
        f = jax.nn.sigmoid(gates[:, hdim:2 * hdim] + c * w_fc)
        g = jnp.tanh(gates[:, 2 * hdim:3 * hdim])
        c_cand = f * c + i * g
        o = jax.nn.sigmoid(gates[:, 3 * hdim:] + c_cand * w_oc)
        h_cand = o * jnp.tanh(c_cand)
        m = (t < sl).astype(xproj.dtype)
        return ((m * h_cand + (1 - m) * h, m * c_cand + (1 - m) * c, t + 1),
                (m * h_cand, m * c_cand))

    (h_last, c_last, _), (hs, cs) = jax.lax.scan(
        step, (h0, c0, jnp.asarray(0, jnp.int32)), xproj)
    return hs, cs, h_last, c_last


def _loss(outs, ph, lib):
    """The loss of tests/test_fused_rnn_train.py:84-87: it touches all
    four outputs, so the carry-gradient path runs too."""
    hs, cs, hl, cl = outs
    return (lib.sum(hs * ph) + 0.5 * lib.sum(cs * ph) + lib.sum(hl ** 2)
            + lib.sum(cl * hl))


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_forward_matches_pallas(jx, ragged):
    _, jnp, pfr = jx
    arrays = _make(ragged=ragged)
    want = pfr.fused_lstm_train(*_jax_args(jnp, arrays), True)
    plain = tfr.lstm_train_fwd_plain(*_torch(arrays))
    routed = tfr.fused_lstm_train(*_torch(arrays))
    for name, w, p, r in zip(OUT_NAMES, want, plain, routed):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), err_msg=name,
                                   **OUT_TOL)
        assert torch.equal(p, r), name


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_gradients_match_pallas_vjp(jx, ragged):
    jax, jnp, pfr = jx
    arrays = _make(seed=3, ragged=ragged)
    ph_np = (np.random.RandomState(7).randn(6, 8, 128) * .1).astype(
        np.float32)
    args = _jax_args(jnp, arrays)

    def f(xproj, w, peep, h0, c0):
        return _loss(pfr.fused_lstm_train(xproj, w, peep, args[3], h0, c0,
                                          True), jnp.asarray(ph_np), jnp)
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        args[0], args[1], args[2], args[4], args[5])
    t = _torch(arrays)
    leaves = [t[i].requires_grad_() for i in (0, 1, 2, 4, 5)]
    _loss(tfr.fused_lstm_train(*t), torch.from_numpy(ph_np),
          torch).backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_backward_formulae_are_autograd_of_the_forward(ragged):
    """``lstm_train_bwd_plain`` against autograd through
    ``lstm_train_fwd_plain`` under non-uniform cotangents of all four
    outputs, in float64 (1e-12: the same arithmetic in another order)."""
    arrays = _make(seed=5, T=7, B=5, H=12, ragged=ragged)
    t = _torch(arrays, torch.float64)
    leaves = [t[i].requires_grad_() for i in (0, 1, 2, 4, 5)]
    outs = tfr.lstm_train_fwd_plain(*t)
    gen = torch.Generator().manual_seed(1)
    cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64)
           for o in outs]
    want = torch.autograd.grad(outs, leaves, cot)
    with torch.no_grad():
        got = tfr.lstm_train_bwd_plain(*t, outs[0], outs[1], *cot)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   rtol=1e-12, atol=1e-12)


def test_zero_peepholes_match_the_plain_cell():
    """peep = 0 with full lengths is the peephole-free cell (what
    ``dynamic_lstm`` passes with ``use_peepholes=False``)."""
    xproj, w, peep, sl, h0, c0 = _torch(_make(seed=11, ragged=False))
    hs, cs, hl, cl = tfr.fused_lstm_train(xproj, w, torch.zeros_like(peep),
                                          sl, h0, c0)
    h, c, hdim = h0, c0, w.shape[0]
    for t in range(xproj.shape[0]):
        gates = xproj[t] + h @ w
        i, f, o = (torch.sigmoid(gates[:, k * hdim:(k + 1) * hdim])
                   for k in (0, 1, 3))
        c = f * c + i * torch.tanh(gates[:, 2 * hdim:3 * hdim])
        h = o * torch.tanh(c)
        np.testing.assert_allclose(hs[t].numpy(), h.numpy(), **OUT_TOL)
        np.testing.assert_allclose(cs[t].numpy(), c.numpy(), **OUT_TOL)
    np.testing.assert_allclose(hl.numpy(), h.numpy(), **OUT_TOL)
    np.testing.assert_allclose(cl.numpy(), c.numpy(), **OUT_TOL)


def test_outputs_are_zero_past_each_length_and_last_states_are_held():
    arrays = _make(seed=2, T=9, B=6, H=16)
    sl = arrays[3]
    hs, cs, hl, cl = tfr.fused_lstm_train(*_torch(arrays))
    for b, n in enumerate(sl):
        assert torch.all(hs[n:, b] == 0) and torch.all(cs[n:, b] == 0)
        assert torch.equal(hl[b], hs[n - 1, b])
        assert torch.equal(cl[b], cs[n - 1, b])
        assert bool((hs[:n, b] != 0).any())


def test_edge_shape_matches_the_jax_scan(jx):
    """T 7, B 5, H 100 (off every tile multiple, where the JAX op would
    not engage its kernel): outputs and gradients against the scan."""
    jax, jnp, _ = jx
    arrays = _make(seed=4, T=7, B=5, H=100)
    ph_np = (np.random.RandomState(8).randn(7, 5, 100) * .1).astype(
        np.float32)
    args = _jax_args(jnp, arrays)
    want = _jax_scan(jax, jnp, *args)
    t = _torch(arrays)
    leaves = [t[i].requires_grad_() for i in (0, 1, 2, 4, 5)]
    got = tfr.fused_lstm_train(*t)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **OUT_TOL)

    def f(xproj, w, peep, h0, c0):
        return _loss(_jax_scan(jax, jnp, xproj, w, peep, args[3], h0, c0),
                     jnp.asarray(ph_np), jnp)
    want_grads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        args[0], args[1], args[2], args[4], args[5])
    _loss(got, torch.from_numpy(ph_np), torch).backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_seq_lens_get_no_gradient_and_cotangents_may_be_strided():
    t = _torch(_make(T=4, B=3, H=8))
    leaves = [t[i].requires_grad_() for i in (0, 1, 2, 4, 5)]
    outs = tfr.fused_lstm_train(*t)
    cot = (torch.ones(3, 4, 8).transpose(0, 1), torch.ones(4, 3, 8),
           torch.ones(3, 8), torch.ones(3, 8))
    grads = outs[0].grad_fn.apply(*cot)
    assert len(grads) == 6 and grads[3] is None
    for g, leaf in zip([grads[i] for i in (0, 1, 2, 4, 5)], leaves):
        assert g.shape == leaf.shape


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    t = _torch(_make(T=4, B=3, H=8))
    before = dict(tfr.LAUNCHES)
    outs = tfr.lstm_train_fwd(*t)
    for a, b in zip(outs, tfr.lstm_train_fwd_plain(*t)):
        assert torch.equal(a, b)
    cot = [torch.ones_like(o) for o in outs]
    got = tfr.lstm_train_bwd(*t, outs[0], outs[1], *cot)
    for a, b in zip(got, tfr.lstm_train_bwd_plain(*t, outs[0], outs[1],
                                                  *cot)):
        assert torch.equal(a, b)
    assert tfr.LAUNCHES == before
    tfr.reset_launches()
    assert set(tfr.LAUNCHES.values()) == {0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    xproj, w, peep, sl, h0, c0 = _torch(_make(T=4, B=3, H=8))
    with pytest.raises(ValueError, match="want xproj"):
        tfr.lstm_train_fwd(xproj[:, :, :30], w, peep, sl, h0, c0)
    with pytest.raises(ValueError, match="want w"):
        tfr.lstm_train_fwd(xproj, w[:4], peep, sl, h0, c0)
    with pytest.raises(ValueError, match="want peep"):
        tfr.lstm_train_fwd(xproj, w, peep[:, :8], sl, h0, c0)
    with pytest.raises(ValueError, match="want seq_lens"):
        tfr.lstm_train_fwd(xproj, w, peep, sl[:2], h0, c0)
    with pytest.raises(ValueError, match="integers"):
        tfr.lstm_train_fwd(xproj, w, peep, sl.float(), h0, c0)
    with pytest.raises(ValueError, match="want c0"):
        tfr.lstm_train_fwd(xproj, w, peep, sl, h0, c0[:2])
    with pytest.raises(ValueError, match="empty"):
        tfr.lstm_train_fwd(xproj[:0], w, peep, sl, h0, c0)
    outs = tfr.lstm_train_fwd(xproj, w, peep, sl, h0, c0)
    with pytest.raises(ValueError, match="want dhid"):
        tfr.lstm_train_bwd(xproj, w, peep, sl, h0, c0, outs[0], outs[1],
                           outs[0][:2], outs[1], h0, c0)
    meta = [torch.zeros(a.shape, dtype=a.dtype, device="meta")
            for a in (xproj, w, peep, sl, h0, c0)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.lstm_train_fwd(*meta)
    with pytest.raises(ValueError, match="several devices"):
        tfr.lstm_train_fwd(meta[0], w, peep, sl, h0, c0)


# the card's checks (chip_smoke.py LSTM_FWD_TOL / LSTM_GRAD_TOL, the gpu
# tests): the kernels against the plain versions
CARD_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
CARD_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", [(100, 64, 512), (6, 8, 128), (7, 5, 100)],
                         ids=["T100xB64xH512", "T6xB8xH128", "T7xB5xH100"])
def test_three_tf32_terms_hold_the_lstm_tolerances(monkeypatch, shape):
    """Why the cluster kernels (the forward's product, the backward's two
    and ``dw``) take three TF32 products, and that the card's checks tell
    them from one: the plain versions with every product made as the
    kernels' wgmma makes it (each operand split hi = tf32(a), lo = tf32(a -
    hi); the two small products, then hi * hi), three terms or one, at the
    training shape (T 100, B 64, H 512) and two small ones, ragged, w x
    H**-0.5. Against the fp32 plain versions, three terms stay within 5 %
    of the tolerances (the outputs at 0.4-3.1 % of CARD_FWD_TOL, the
    gradients at 0.04-0.9 % of CARD_GRAD_TOL), one breaks the outputs by
    3.3 to 15.6 times and the gradients in dw and dh0 (by 2.0 to 8.4
    times) at these seeds."""
    T, B, H = shape
    ins = _torch(_make(seed=3, T=T, B=B, H=H, w_scale=H ** -0.5))
    rng = np.random.RandomState(7)
    cot = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32))
           for s, k in (((T, B, H), .1), ((T, B, H), .1), ((B, H), 1.),
                        ((B, H), 1.))]
    want = tfr.lstm_train_fwd_plain(*ins)
    want_back = tfr.lstm_train_bwd_plain(*ins, want[0], want[1], *cot)
    matmul = torch.matmul
    from paddle_tpu_torch.ops.kernels import fused_ce as tfc

    def one(a, b):
        return matmul(tfc.split_tf32(a.contiguous())[0],
                      tfc.split_tf32(b.contiguous())[0])

    def three(a, b):
        (ah, al), (bh, bl) = (tfc.split_tf32(x.contiguous())
                              for x in (a, b))
        return (matmul(ah, bl) + matmul(al, bh)) + matmul(ah, bh)

    def excess(got, ref, tol):
        return float(((got - ref).abs() / (tol["atol"] + tol["rtol"]
                                           * ref.abs())).max())
    for terms, inside in ((three, True), (one, False)):
        monkeypatch.setattr(torch.Tensor, "__matmul__", terms)
        got = tfr.lstm_train_fwd_plain(*ins)
        back = tfr.lstm_train_bwd_plain(*ins, want[0], want[1], *cot)
        monkeypatch.undo()
        e_out = max(excess(a, b, CARD_FWD_TOL) for a, b in zip(got, want))
        e_grad = max(excess(a, b, CARD_GRAD_TOL)
                     for a, b in zip(back, want_back))
        if inside:
            assert e_out < 0.05 and e_grad < 0.05, (e_out, e_grad)
        else:
            assert e_out > 3.0 and e_grad > 1.5, (e_out, e_grad)


@pytest.mark.parametrize("h, sms, fit, plan", [
    (512, 132, 66, 128),               # the H100's plan
    (512, 132, 63, None),              # not every cluster fits: grid kernel
    (512, 120, 66, None),              # fewer SMs
    (480, 132, 66, 120),
    (100, 132, 66, 26),                # 25 groups, 13 clusters
    (4, 132, 66, 2),
    (8, 132, 1, 2),                    # one cluster, and it fits
    (500, 132, 66, 126),
    (102, 132, 66, None),              # not a multiple of 4
    (516, 132, 66, None),              # above H 512
    (1024, 132, 66, None),
    (512, 132, 0, None)])
def test_lstm_bwd_plan(h, sms, fit, plan):
    """The kernel of an LSTM direction (the plan the forward and the
    backward share, each with its own cluster kernel's occupancy) as a
    function of H, the SMs and how many clusters of 2 the card holds: the
    cluster kernel's blocks, ceil(H / 4) rounded up to whole clusters,
    where they all fit at once; the grid kernel (None) above H 512, off
    multiples of 4, or where they do not."""
    assert tfr.rnn_plan(h, sms, fit) == plan


def _card_check(dev, T, B, H, seed, w_scale):
    arrays = _make(seed=seed, T=T, B=B, H=H, w_scale=w_scale)
    if B > 2:
        arrays[3][-1] = 0                # a row of length 0 keeps h0, c0
    ins = [a.to(dev) for a in _torch(arrays)]
    rng = np.random.RandomState(seed + 100)
    cot = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32)).to(dev)
           for s, k in (((T, B, H), .1), ((T, B, H), .1), ((B, H), 1.),
                        ((B, H), 1.))]
    n0 = dict(tfr.LAUNCHES)
    got = tfr.lstm_train_fwd(*ins)
    want = tfr.lstm_train_fwd_plain(*ins)
    back = tfr.lstm_train_bwd(*ins, want[0], want[1], *cot)
    again = tfr.lstm_train_bwd(*ins, want[0], want[1], *cot)
    want_back = tfr.lstm_train_bwd_plain(*ins, want[0], want[1], *cot)
    torch.cuda.synchronize()
    assert {k: tfr.LAUNCHES[k] - n0[k] for k in n0} == \
        {"lstm_train_fwd": 1, "lstm_train_bwd": 2, "gru_train_fwd": 0,
         "gru_train_bwd": 0}
    label = f"T={T} B={B} H={H}"
    for name, a, b in zip(OUT_NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=f"{name} {label}")
    for name, a, a2, b in zip(GRAD_NAMES, back, again, want_back):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4,
                                   msg=f"{name} {label}")
        assert torch.equal(a, a2), f"{name} {label}: not repeatable"
    lens = ins[3]
    past = (torch.arange(T, device=dev)[:, None] >= lens[None, :])[:, :, None]
    assert not bool((got[0].masked_select(past) != 0).any())
    assert not bool((got[1].masked_select(past) != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 5, 100), (3, 70, 33), (4, 2, 1),
                                   (5, 130, 512), (100, 64, 512),
                                   (6, 8, 128), (1, 1, 257), (16, 64, 1024),
                                   (16, 64, 700), (2, 3, 513),
                                   (3, 70, 1500), (4, 2, 2113),
                                   (2, 3, 4225)])
def test_cuda_kernels_match_plain_versions(cuda_device, monkeypatch, shape):
    """Each kernel against its plain version on the card (rtol 1e-4 /
    atol 1e-5 outputs, rtol 1e-3 / atol 1e-4 gradients: fp32 sums in
    another order, compounded over the steps), off every tile multiple,
    above 64 rows, at every units-per-block variant; the zeroed tail; the
    backward bit-equal across two runs; above H 512 (U 8 and 16 units a
    block, the slices of w in global scratch) too, down to the smallest
    input that raised before (H 513), and above 16 units on every SM
    (H 2113, 4225: groups of 16 units in passes). The recurrent weight is scaled by
    min(0.2, H**-0.5): at 0.2 and H 512 the recurrence is chaotic over
    100 steps."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    T, B, H = shape
    _card_check(cuda_device, T, B, H, 0, min(0.2, H ** -0.5))


@pytest.mark.gpu
def test_cuda_function_launches_once_each_way_and_rejects(cuda_device):
    dev = cuda_device
    ins = [a.to(dev) for a in _torch(_make(T=5, B=4, H=64))]
    leaves = [ins[i].requires_grad_() for i in (0, 1, 2, 4, 5)]
    n0 = dict(tfr.LAUNCHES)
    outs = tfr.fused_lstm_train(*ins)
    sum(o.sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert {k: tfr.LAUNCHES[k] - n0[k] for k in n0} == \
        {"lstm_train_fwd": 1, "lstm_train_bwd": 1, "gru_train_fwd": 0,
         "gru_train_bwd": 0}
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    # wider than 16 units a block on every SM: groups of 16 units in
    # passes, still one launch
    too_wide = 16 * torch.cuda.get_device_properties(
        dev).multi_processor_count + 1
    wide = [a.to(dev) for a in _torch(_make(T=2, B=2, H=too_wide))]
    n0 = tfr.LAUNCHES["lstm_train_fwd"]
    assert all(torch.isfinite(o).all() for o in tfr.lstm_train_fwd(*wide))
    assert tfr.LAUNCHES["lstm_train_fwd"] == n0 + 1
    with pytest.raises(ValueError, match="float32"):
        tfr.lstm_train_fwd(*[a.double() if a.is_floating_point() else a
                             for a in ins])
    with pytest.raises(ValueError, match="contiguous"):
        tfr.lstm_train_fwd(ins[0].detach().transpose(0, 1).contiguous()
                           .transpose(0, 1), *[a.detach() for a in ins[1:]])


CLUSTER_SHAPES = [(100, 64, 512), (7, 5, 100), (5, 130, 512), (3, 1, 4),
                  (9, 64, 64), (3, 64, 288), (20, 64, 480)]


def _cluster_and_grid_agree(dev, monkeypatch, shape, name):
    """Where the plan of ``name`` picks its cluster kernel, it and the grid
    kernel (forced by emptying that plan) against the plain versions, each
    bit-equal across two runs; on an H100 (132 SMs) the plan at H 512 is
    128 blocks in clusters of 2. A stream's launches of both directions
    share one grid-barrier counter, never zeroed between them: each adds
    T x blocks, and the wrapper's value of it agrees (a new stream starts
    its own: one forward and two backward launches a check)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    T, B, H = shape
    report = tfr.rnn_kernel_for(name, H, dev)
    assert report["kernel"] == "cluster", report
    if H == 512 and torch.cuda.get_device_properties(
            dev).multi_processor_count == 132:
        assert (report["cluster"], report["blocks"]) == (2, 128), report
    _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))
    count, base = tfr._barrier(dev)
    assert int(count) % 2 ** 32 == base > 0
    blocks = {n: tfr.rnn_kernel_for(n, H, dev).get("blocks", 0)
              for n in ("lstm_train_fwd", "lstm_train_bwd")}
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))
        count, base = tfr._barrier(dev)
        assert int(count) % 2 ** 32 == base == T * (
            blocks["lstm_train_fwd"] + 2 * blocks["lstm_train_bwd"])
    key = (torch.cuda.current_device(), name, H)
    monkeypatch.setitem(tfr._plans, key, None)
    assert tfr.rnn_kernel_for(name, H, dev) == {"kernel": "grid"}
    _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cuda_cluster_and_grid_backward_agree(cuda_device, monkeypatch,
                                              shape):
    """The backward's cluster kernel and grid kernel against the plain
    versions (``_cluster_and_grid_agree``)."""
    _cluster_and_grid_agree(cuda_device, monkeypatch, shape,
                            "lstm_train_bwd")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cuda_cluster_and_grid_forward_agree(cuda_device, monkeypatch,
                                             shape):
    """The forward's cluster kernel and grid kernel against the plain
    versions (``_cluster_and_grid_agree``), and against each other within
    the forward's tolerance; each bit-equal across two runs."""
    T, B, H = shape
    blocks = tfr.rnn_kernel_for("lstm_train_fwd", H, cuda_device).get(
        "blocks")
    _cluster_and_grid_agree(cuda_device, monkeypatch, shape,
                            "lstm_train_fwd")      # leaves the grid kernel
    ins = [a.to(cuda_device) for a in _torch(_make(seed=2, T=T, B=B, H=H,
                                                   w_scale=H ** -0.5))]
    grid = tfr.lstm_train_fwd(*ins)
    monkeypatch.setitem(tfr._plans, (torch.cuda.current_device(),
                                     "lstm_train_fwd", H), blocks)
    cluster = tfr.lstm_train_fwd(*ins)
    again = tfr.lstm_train_fwd(*ins)
    torch.cuda.synchronize()
    for name, a, b, c in zip(OUT_NAMES, cluster, again, grid):
        assert torch.equal(a, b), f"{name}: not repeatable"
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5,
                                   msg=f"{name}: cluster against grid")
