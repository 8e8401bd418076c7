"""The PyTorch port's whole-sequence GRU (paddle_tpu_torch/ops/kernels/
fused_rnn.py) against the JAX package's Pallas kernels
(paddle_tpu/ops/pallas/fused_rnn.py ``fused_gru_train``, in interpret mode,
as tests/test_fused_rnn_train.py:156-200 runs them).

On the CPU the port's wrappers take the plain PyTorch versions and the
backward runs ``FusedGRUTrain.backward`` over ``gru_train_bwd_plain``.
Tolerances are the JAX package's own for these kernels
(tests/test_fused_rnn_train.py:175, :198): the two outputs rtol/atol 2e-6,
the three gradients 3e-5 -- fp32 sums in XLA's order on one side and
torch's on the other, over 6 steps.

The CUDA kernels run only on the card: the ``gpu`` tests hold each against
its plain version there and skip elsewhere. JAX is imported inside a
fixture, so that the card's machine, which has no JAX, collects this file
and runs its ``gpu`` tests
(``pytest --noconftest -m gpu tests/test_torch_fused_gru.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_rnn as tfr

OUT_TOL = dict(rtol=2e-6, atol=2e-6)
GRAD_TOL = dict(rtol=3e-5, atol=3e-5)
OUT_NAMES = ("hidden", "h_last")
GRAD_NAMES = ("dx", "dw", "dh0")


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
    """xproj, w, seq_lens [B], h0 as tests/test_fused_rnn_train.py
    ``_make_gru`` scales them."""
    rng = np.random.RandomState(seed)
    xproj = rng.randn(T, B, 3 * H).astype(np.float32) * 0.4
    w = rng.randn(H, 3 * H).astype(np.float32) * w_scale
    h0 = rng.randn(B, H).astype(np.float32) * 0.3
    if ragged:
        sl = rng.randint(1, T + 1, size=B).astype(np.int32)
        sl[0] = T                        # at least one full row
    else:
        sl = np.full(B, T, np.int32)
    return xproj, w, sl, h0


def _torch(arrays, dtype=None):
    return [torch.from_numpy(a).to(dtype) if dtype is not None
            and a.dtype == np.float32 else torch.from_numpy(a)
            for a in arrays]


def _jax_args(jnp, arrays):
    xproj, w, sl, h0 = arrays
    return [jnp.asarray(a) for a in (xproj, w, sl[:, None], h0)]


def _jax_scan(jax, jnp, xproj, w, sl, h0):
    """The scan of ops/rnn_ops.py ``_dynamic_gru`` (``:205-218``)."""
    hdim = w.shape[0]

    def step(carry, xt):
        h, t = carry
        ur = jax.nn.sigmoid(xt[:, :2 * hdim] + h @ w[:, :2 * hdim])
        u, r = ur[:, :hdim], ur[:, hdim:]
        c = jnp.tanh(xt[:, 2 * hdim:] + (r * h) @ w[:, 2 * hdim:])
        h_cand = (1.0 - u) * h + u * c
        m = (t < sl).astype(xproj.dtype)
        return (m * h_cand + (1 - m) * h, t + 1), m * h_cand

    (h_last, _), hs = jax.lax.scan(step, (h0, jnp.asarray(0, jnp.int32)),
                                   xproj)
    return hs, h_last


def _loss(outs, ph, lib):
    """The loss of tests/test_fused_rnn_train.py:187-193: it touches both
    outputs, so the carry-gradient path runs too."""
    hs, hl = outs
    return lib.sum(hs * ph) + lib.sum(hl ** 2)


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_forward_matches_pallas(jx, ragged):
    _, jnp, pfr = jx
    arrays = _make(ragged=ragged)
    want = pfr.fused_gru_train(*_jax_args(jnp, arrays), True)
    plain = tfr.gru_train_fwd_plain(*_torch(arrays))
    routed = tfr.fused_gru_train(*_torch(arrays))
    for name, w, p, r in zip(OUT_NAMES, want, plain, routed):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), err_msg=name,
                                   **OUT_TOL)
        assert torch.equal(p, r), name


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_gradients_match_pallas_vjp(jx, ragged):
    jax, jnp, pfr = jx
    arrays = _make(seed=5, ragged=ragged)
    ph_np = (np.random.RandomState(9).randn(6, 8, 128) * .1).astype(
        np.float32)
    args = _jax_args(jnp, arrays)

    def f(xproj, w, h0):
        return _loss(pfr.fused_gru_train(xproj, w, args[2], h0, True),
                     jnp.asarray(ph_np), jnp)
    want = jax.grad(f, argnums=(0, 1, 2))(args[0], args[1], args[3])
    t = _torch(arrays)
    leaves = [t[i].requires_grad_() for i in (0, 1, 3)]
    _loss(tfr.fused_gru_train(*t), torch.from_numpy(ph_np),
          torch).backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("ragged", [False, True],
                         ids=["full-length", "ragged"])
def test_backward_formulae_are_autograd_of_the_forward(ragged):
    """``gru_train_bwd_plain`` against autograd through
    ``gru_train_fwd_plain`` under non-uniform cotangents of both outputs,
    in float64 (1e-12: the same arithmetic in another order)."""
    arrays = _make(seed=5, T=7, B=5, H=12, ragged=ragged)
    t = _torch(arrays, torch.float64)
    leaves = [t[i].requires_grad_() for i in (0, 1, 3)]
    hidden, h_last, rh = tfr.gru_train_fwd_plain(*t)
    gen = torch.Generator().manual_seed(1)
    cot = [torch.randn(o.shape, generator=gen, dtype=torch.float64)
           for o in (hidden, h_last)]
    want = torch.autograd.grad((hidden, h_last), leaves, cot)
    with torch.no_grad():
        got = tfr.gru_train_bwd_plain(*t, hidden, rh, *cot)
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   rtol=1e-12, atol=1e-12)


def test_outputs_are_zero_past_each_length_and_last_state_is_held():
    arrays = _make(seed=2, T=9, B=6, H=16)
    sl = arrays[2]
    hs, hl, rh = tfr.gru_train_fwd(*_torch(arrays))
    for b, n in enumerate(sl):
        assert torch.all(hs[n:, b] == 0) and torch.all(rh[n:, b] == 0)
        assert torch.equal(hl[b], hs[n - 1, b])
        assert bool((hs[:n, b] != 0).any())


def test_rh_is_the_reset_gate_times_the_previous_state():
    """The extra residual: rh[t] = r_t * h_{t-1} inside each length."""
    xproj, w, sl, h0 = _torch(_make(seed=6, T=5, B=4, H=10))
    hs, _, rh = tfr.gru_train_fwd(xproj, w, sl, h0)
    h_prev = torch.cat([h0[None], hs[:-1]])
    r = torch.sigmoid(xproj[:, :, 10:20] + h_prev @ w[:, 10:20])
    inside = (torch.arange(5)[:, None] < sl[None, :])[:, :, None]
    torch.testing.assert_close(rh, torch.where(inside, r * h_prev,
                                               torch.zeros_like(rh)),
                               rtol=1e-6, atol=1e-7)


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
    leaves = [t[i].requires_grad_() for i in (0, 1, 3)]
    got = tfr.fused_gru_train(*t)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **OUT_TOL)

    def f(xproj, w, h0):
        return _loss(_jax_scan(jax, jnp, xproj, w, args[2], h0),
                     jnp.asarray(ph_np), jnp)
    want_grads = jax.grad(f, argnums=(0, 1, 2))(args[0], args[1], args[3])
    _loss(got, torch.from_numpy(ph_np), torch).backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_seq_lens_get_no_gradient_and_cotangents_may_be_strided():
    t = _torch(_make(T=4, B=3, H=8))
    for i in (0, 1, 3):
        t[i].requires_grad_()
    outs = tfr.fused_gru_train(*t)
    cot = (torch.ones(3, 4, 8).transpose(0, 1), torch.ones(3, 8))
    grads = outs[0].grad_fn.apply(*cot)
    assert len(grads) == 4 and grads[2] is None
    for g, leaf in zip([grads[i] for i in (0, 1, 3)], [t[0], t[1], t[3]]):
        assert g.shape == leaf.shape


def test_unused_last_state_still_carries_a_zero_cotangent():
    """An encoder uses hidden only: h_last's cotangent is zeros, and the
    gradients equal those of the same loss through the plain forward."""
    arrays = _make(seed=7, T=5, B=4, H=6)
    t = _torch(arrays)
    leaves = [t[i].requires_grad_() for i in (0, 1, 3)]
    tfr.fused_gru_train(*t)[0].square().sum().backward()
    got = [x.grad.clone() for x in leaves]
    for x in leaves:
        x.grad = None
    tfr.gru_train_fwd_plain(*t)[0].square().sum().backward()
    for name, g, x in zip(GRAD_NAMES, got, leaves):
        torch.testing.assert_close(g, x.grad, rtol=1e-6, atol=1e-7,
                                   msg=name)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    t = _torch(_make(T=4, B=3, H=8))
    before = dict(tfr.LAUNCHES)
    outs = tfr.gru_train_fwd(*t)
    for a, b in zip(outs, tfr.gru_train_fwd_plain(*t)):
        assert torch.equal(a, b)
    cot = [torch.ones_like(o) for o in outs[:2]]
    got = tfr.gru_train_bwd(*t, outs[0], outs[2], *cot)
    for a, b in zip(got, tfr.gru_train_bwd_plain(*t, outs[0], outs[2],
                                                 *cot)):
        assert torch.equal(a, b)
    assert tfr.LAUNCHES == before
    tfr.reset_launches()
    assert set(tfr.LAUNCHES.values()) == {0}
    assert {"gru_train_fwd", "gru_train_bwd"} <= set(tfr.LAUNCHES)


def test_wrappers_reject_what_the_kernels_do_not_take():
    xproj, w, sl, h0 = _torch(_make(T=4, B=3, H=8))
    with pytest.raises(ValueError, match="want xproj"):
        tfr.gru_train_fwd(xproj[:, :, :23], w, sl, h0)
    with pytest.raises(ValueError, match="want w"):
        tfr.gru_train_fwd(xproj, w[:4], sl, h0)
    with pytest.raises(ValueError, match="want seq_lens"):
        tfr.gru_train_fwd(xproj, w, sl[:2], h0)
    with pytest.raises(ValueError, match="integers"):
        tfr.gru_train_fwd(xproj, w, sl.float(), h0)
    with pytest.raises(ValueError, match="want h0"):
        tfr.gru_train_fwd(xproj, w, sl, h0[:2])
    with pytest.raises(ValueError, match="empty"):
        tfr.gru_train_fwd(xproj[:0], w, sl, h0)
    hidden, h_last, rh = tfr.gru_train_fwd(xproj, w, sl, h0)
    with pytest.raises(ValueError, match="want rh"):
        tfr.gru_train_bwd(xproj, w, sl, h0, hidden, rh[:2], hidden, h_last)
    with pytest.raises(ValueError, match="want dhlast"):
        tfr.gru_train_bwd(xproj, w, sl, h0, hidden, rh, hidden, h_last[:1])
    meta = [torch.zeros(a.shape, dtype=a.dtype, device="meta")
            for a in (xproj, w, sl, h0)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.gru_train_fwd(*meta)
    with pytest.raises(ValueError, match="several devices"):
        tfr.gru_train_fwd(meta[0], w, sl, h0)


# the tolerance of the kernels' gradients against the plain versions on the
# card (chip_smoke.py GRU_GRAD_TOL, the gpu tests below)
CARD_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", [(32, 64, 512), (7, 5, 100)],
                         ids=["T32xB64xH512", "T7xB5xH100"])
def test_three_tf32_terms_hold_the_gru_tolerance(monkeypatch, shape):
    """Why the cluster backward (the recompute, d_rh, Dh and dw) takes
    three TF32 products, and that the card's checks tell them from one:
    the plain backward with every product made as the kernels' wgmma
    makes it (each operand split hi = tf32(a), lo = tf32(a - hi); the two
    small products, then hi * hi), three terms or one, at the training
    shape (T 32, B 64, H 512) and at GRU_EDGE (T 7, B 5, H 100), ragged,
    w x H**-0.5, non-uniform cotangents of both outputs. Against the fp32
    plain backward, three terms stay within 5 % of CARD_GRAD_TOL and one
    breaks it by more than 1.5 times at these seeds."""
    T, B, H = shape
    ins = _torch(_make(seed=3, T=T, B=B, H=H, w_scale=H ** -0.5))
    rng = np.random.RandomState(7)
    cot = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32))
           for s, k in (((T, B, H), .1), ((B, H), 1.))]
    hidden, _, rh = tfr.gru_train_fwd_plain(*ins)
    want = tfr.gru_train_bwd_plain(*ins, hidden, rh, *cot)
    matmul = torch.matmul
    from paddle_tpu_torch.ops.kernels import fused_ce as tfc

    def one(a, b):
        return matmul(tfc.split_tf32(a.contiguous())[0],
                      tfc.split_tf32(b.contiguous())[0])

    def three(a, b):
        (ah, al), (bh, bl) = (tfc.split_tf32(x.contiguous())
                              for x in (a, b))
        return (matmul(ah, bl) + matmul(al, bh)) + matmul(ah, bh)

    def excess(got, ref):
        return float(((got - ref).abs() / (CARD_GRAD_TOL["atol"]
                                           + CARD_GRAD_TOL["rtol"]
                                           * ref.abs())).max())
    for terms, inside in ((three, True), (one, False)):
        monkeypatch.setattr(torch.Tensor, "__matmul__", terms)
        got = tfr.gru_train_bwd_plain(*ins, hidden, rh, *cot)
        monkeypatch.undo()
        e = max(excess(a, b) for a, b in zip(got, want))
        if inside:
            assert e < 0.05, e
        else:
            assert e > 1.5, e


# the tolerance of the kernels' outputs against the plain version on the
# card (chip_smoke.py GRU_FWD_TOL, the gpu tests below)
CARD_FWD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(32, 64, 512), (7, 5, 100)],
                         ids=["T32xB64xH512", "T7xB5xH100"])
def test_three_tf32_terms_hold_the_gru_forward_tolerance(monkeypatch,
                                                         shape):
    """Why the cluster forward takes three TF32 products a gate, and that
    the card's checks tell them from one: the plain forward with both of a
    step's products (u, r and c) made as the kernel's wgmma makes them
    (each operand split hi = tf32(a), lo = tf32(a - hi); the two small
    products, then hi * hi), three terms or one, at the training shape
    (T 32, B 64, H 512) and at GRU_EDGE (T 7, B 5, H 100), ragged, w x
    H**-0.5. Against the fp32 plain forward (hidden, h_last and rh), three
    terms stay within 5 % of CARD_FWD_TOL and one breaks it by more than
    1.5 times at these seeds."""
    T, B, H = shape
    ins = _torch(_make(seed=3, T=T, B=B, H=H, w_scale=H ** -0.5))
    want = tfr.gru_train_fwd_plain(*ins)
    matmul = torch.matmul
    from paddle_tpu_torch.ops.kernels import fused_ce as tfc

    def one(a, b):
        return matmul(tfc.split_tf32(a.contiguous())[0],
                      tfc.split_tf32(b.contiguous())[0])

    def three(a, b):
        (ah, al), (bh, bl) = (tfc.split_tf32(x.contiguous())
                              for x in (a, b))
        return (matmul(ah, bl) + matmul(al, bh)) + matmul(ah, bh)

    def excess(got, ref):
        return float(((got - ref).abs() / (CARD_FWD_TOL["atol"]
                                           + CARD_FWD_TOL["rtol"]
                                           * ref.abs())).max())
    for terms, inside in ((three, True), (one, False)):
        monkeypatch.setattr(torch.Tensor, "__matmul__", terms)
        got = tfr.gru_train_fwd_plain(*ins)
        monkeypatch.undo()
        e = max(excess(a, b) for a, b in zip(got, want))
        if inside:
            assert e < 0.05, e
        else:
            assert e > 1.5, e


class _Lib:
    """The kernels' library as the plan asks it: the clusters of 2 that
    each kind's cluster kernel fits (``fits``), and which kinds were
    asked."""

    def __init__(self, fits):
        self.fits, self.asked = fits, []

    def paddle_rnn_max_clusters(self, kind, h):
        self.asked.append(kind)
        return self.fits[kind]


@pytest.mark.parametrize("name, fits, h, plan", [
    ("gru_train_bwd", {3: 66}, 512, 128),       # the H100: 64 clusters
    ("gru_train_bwd", {3: 63}, 512, None),      # not every cluster fits
    ("gru_train_bwd", {3: 66}, 100, 26),
    ("gru_train_bwd", {3: 66}, 102, None),      # not a multiple of 4
    ("gru_train_bwd", {3: 66}, 516, None),      # above H 512
    ("gru_train_bwd", {3: 0}, 64, None),        # no cluster fits at all
    ("gru_train_fwd", {2: 66}, 512, 128),
    ("gru_train_fwd", {2: 63}, 512, None),      # not every cluster fits
    ("lstm_train_fwd", {0: 66}, 512, 128),
    ("lstm_train_bwd", {1: 66}, 480, 120)])
def test_plan_routes_each_kernel(monkeypatch, name, fits, h, plan):
    """The shared plan on a card of 132 SMs (the H100's): each kernel asks
    its own cluster kernel's occupancy (the GRU backward kind 3, the GRU
    forward kind 2) and takes it where all its clusters fit at once, H <=
    512 and H a multiple of 4; the LSTM's directions ask theirs. The plan
    is asked once per width."""
    lib = _Lib(fits)
    monkeypatch.setattr(tfr, "_kernels", lambda: lib)
    monkeypatch.setattr(tfr, "_plans", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132})())
    assert tfr._plan(name, h) == plan
    assert tfr._plan(name, h) == plan
    asks = [tfr.KINDS[name]] if h <= tfr.CLUSTER_MAX_H else []
    assert lib.asked == asks


@pytest.mark.parametrize("name, barriers", [
    ("gru_train_bwd", 2), ("lstm_train_bwd", 1), ("lstm_train_fwd", 1),
    ("gru_train_fwd", 2)])
def test_barrier_counter_advances_by_each_kernels_barriers(name, barriers):
    """A stream's grid-barrier counter: a launch from ``base`` ends at
    base + barriers a step x T x blocks (modulo 2^32; the GRU's kernels
    wait twice a step), and a failed launch leaves a new zeroed counter."""
    count = torch.zeros(1, dtype=torch.int32)
    bar = [count, 2 ** 32 - 100]
    tfr._advance(bar, bar[1], 0, name, 32, 128)
    assert bar[0] is count
    assert bar[1] == (2 ** 32 - 100 + barriers * 32 * 128) % 2 ** 32
    tfr._advance(bar, bar[1], 700, name, 32, 128)
    assert bar[1] == 0 and bar[0] is not count and int(bar[0]) == 0


def _card_check(dev, T, B, H, seed, w_scale):
    arrays = _make(seed=seed, T=T, B=B, H=H, w_scale=w_scale)
    if B > 2:
        arrays[2][-1] = 0                # a row of length 0 keeps h0
    ins = [a.to(dev) for a in _torch(arrays)]
    rng = np.random.RandomState(seed + 100)
    cot = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32)).to(dev)
           for s, k in (((T, B, H), .1), ((B, H), 1.))]
    n0 = dict(tfr.LAUNCHES)
    got = tfr.gru_train_fwd(*ins)
    want = tfr.gru_train_fwd_plain(*ins)
    back = tfr.gru_train_bwd(*ins, want[0], want[2], *cot)
    again = tfr.gru_train_bwd(*ins, want[0], want[2], *cot)
    want_back = tfr.gru_train_bwd_plain(*ins, want[0], want[2], *cot)
    torch.cuda.synchronize()
    assert {k: tfr.LAUNCHES[k] - n0[k] for k in n0} == \
        {"lstm_train_fwd": 0, "lstm_train_bwd": 0, "gru_train_fwd": 1,
         "gru_train_bwd": 2}
    label = f"T={T} B={B} H={H}"
    for name, a, b in zip(OUT_NAMES + ("rh",), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=f"{name} {label}")
    for name, a, a2, b in zip(GRAD_NAMES, back, again, want_back):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4,
                                   msg=f"{name} {label}")
        assert torch.equal(a, a2), f"{name} {label}: not repeatable"
    lens = ins[2]
    past = (torch.arange(T, device=dev)[:, None] >= lens[None, :])[:, :, None]
    assert not bool((got[0].masked_select(past) != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 5, 100), (3, 70, 33), (4, 2, 1),
                                   (5, 130, 512), (32, 64, 512),
                                   (6, 8, 128), (1, 1, 257), (16, 64, 1024),
                                   (16, 64, 700), (1, 1, 513),
                                   (3, 70, 1500), (1, 1, 2113), (4, 2, 2113),
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
    min(0.2, H**-0.5), as for the LSTM."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    T, B, H = shape
    _card_check(cuda_device, T, B, H, 0, min(0.2, H ** -0.5))


@pytest.mark.gpu
def test_cuda_function_launches_once_each_way_and_rejects(cuda_device):
    dev = cuda_device
    ins = [a.to(dev) for a in _torch(_make(T=5, B=4, H=64))]
    leaves = [ins[i].requires_grad_() for i in (0, 1, 3)]
    n0 = dict(tfr.LAUNCHES)
    outs = tfr.fused_gru_train(*ins)
    sum(o.sum() for o in outs).backward()
    torch.cuda.synchronize()
    assert {k: tfr.LAUNCHES[k] - n0[k] for k in n0} == \
        {"lstm_train_fwd": 0, "lstm_train_bwd": 0, "gru_train_fwd": 1,
         "gru_train_bwd": 1}
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    # wider than 16 units a block on every SM: groups of 16 units in
    # passes, still one launch
    too_wide = 16 * torch.cuda.get_device_properties(
        dev).multi_processor_count + 1
    wide = [a.to(dev) for a in _torch(_make(T=2, B=2, H=too_wide))]
    n0 = tfr.LAUNCHES["gru_train_fwd"]
    assert all(torch.isfinite(o).all() for o in tfr.gru_train_fwd(*wide))
    assert tfr.LAUNCHES["gru_train_fwd"] == n0 + 1
    with pytest.raises(ValueError, match="float32"):
        tfr.gru_train_fwd(*[a.double() if a.is_floating_point() else a
                            for a in ins])
    with pytest.raises(ValueError, match="contiguous"):
        tfr.gru_train_fwd(ins[0].detach().transpose(0, 1).contiguous()
                          .transpose(0, 1), *[a.detach() for a in ins[1:]])


CLUSTER_SHAPES = [(100, 64, 512), (7, 5, 100), (5, 130, 512), (3, 1, 4),
                  (9, 64, 64), (3, 64, 288), (20, 64, 480)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cuda_cluster_and_grid_gru_backward_agree(cuda_device, monkeypatch,
                                                  shape):
    """Where the plan picks the GRU backward's cluster kernel (on an H100
    at H 512: 128 blocks in clusters of 2), it and the grid kernel (forced
    by emptying the plan) against the plain versions, each bit-equal across
    two runs, and against each other within the gradients' tolerance. A
    new stream starts its own grid-barrier counter, which each GRU kernel
    advances by 2T x blocks a launch (two barriers a step): after one
    forward (the cluster kernel too, on the same plan) and two backward
    launches it stands at 6T x blocks, and the wrapper's value agrees."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dev = cuda_device
    T, B, H = shape
    report = tfr.rnn_kernel_for("gru_train_bwd", H, dev)
    assert report["kernel"] == "cluster", report
    assert tfr.rnn_kernel_for("gru_train_fwd", H, dev) == report
    if H == 512 and torch.cuda.get_device_properties(
            dev).multi_processor_count == 132:
        assert (report["cluster"], report["blocks"]) == (2, 128), report
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))
        count, base = tfr._barrier(dev)
        assert int(count) % 2 ** 32 == base == 6 * T * report["blocks"]
    ins = [a.to(dev) for a in _torch(_make(seed=2, T=T, B=B, H=H,
                                           w_scale=H ** -0.5))]
    rng = np.random.RandomState(3)
    cot = [torch.from_numpy((rng.randn(*s) * k).astype(np.float32)).to(dev)
           for s, k in (((T, B, H), .1), ((B, H), 1.))]
    hidden, _, rh = tfr.gru_train_fwd_plain(*ins)
    cluster = tfr.gru_train_bwd(*ins, hidden, rh, *cot)
    monkeypatch.setitem(tfr._plans, (torch.cuda.current_device(),
                                     "gru_train_bwd", H), None)
    assert tfr.rnn_kernel_for("gru_train_bwd", H, dev) == {"kernel": "grid"}
    grid = tfr.gru_train_bwd(*ins, hidden, rh, *cot)
    torch.cuda.synchronize()
    for name, a, b in zip(GRAD_NAMES, cluster, grid):
        torch.testing.assert_close(a, b, **CARD_GRAD_TOL,
                                   msg=f"{name}: cluster against grid")
    _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cuda_cluster_and_grid_gru_forward_agree(cuda_device, monkeypatch,
                                                 shape):
    """Where the plan picks the GRU forward's cluster kernel (on an H100 at
    H 512: 128 blocks in clusters of 2), it against the plain versions
    (``_card_check``), bit-equal across two runs, and against the grid
    kernel (forced by emptying the plan) within the forward's tolerance;
    the grid kernel against the plain versions too."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dev = cuda_device
    T, B, H = shape
    report = tfr.rnn_kernel_for("gru_train_fwd", H, dev)
    assert report["kernel"] == "cluster", report
    if H == 512 and torch.cuda.get_device_properties(
            dev).multi_processor_count == 132:
        assert (report["cluster"], report["blocks"]) == (2, 128), report
    _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))
    ins = [a.to(dev) for a in _torch(_make(seed=2, T=T, B=B, H=H,
                                           w_scale=H ** -0.5))]
    cluster = tfr.gru_train_fwd(*ins)
    again = tfr.gru_train_fwd(*ins)
    monkeypatch.setitem(tfr._plans, (torch.cuda.current_device(),
                                     "gru_train_fwd", H), None)
    assert tfr.rnn_kernel_for("gru_train_fwd", H, dev) == {"kernel": "grid"}
    grid = tfr.gru_train_fwd(*ins)
    torch.cuda.synchronize()
    for name, a, b, c in zip(OUT_NAMES + ("rh",), cluster, again, grid):
        assert torch.equal(a, b), f"{name}: not repeatable"
        torch.testing.assert_close(a, c, **CARD_FWD_TOL,
                                   msg=f"{name}: cluster against grid")
    _card_check(dev, T, B, H, 1, min(0.2, H ** -0.5))
