"""The PyTorch port's page-gather kernels (paddle_tpu_torch/ops/kernels/
paged_attention.py) against the JAX package's Pallas kernels
(paddle_tpu/ops/pallas/paged_attention.py, run in interpret mode on the
CPU as tests/test_kv_pool.py runs them).

On the CPU the port's wrappers take the plain PyTorch versions; both are
row copies or a single fp32 multiply, so they must agree EXACTLY with
the Pallas kernels. The CUDA kernels themselves run only on the card:
the ``gpu`` tests hold each against its plain version there, and the
paged engine on the card against the same engine on the CPU, and skip
elsewhere. JAX is imported inside a fixture, so that the card's machine,
which has no JAX, collects this file and runs its ``gpu`` tests
(``pytest --noconftest -m gpu tests/test_torch_paged_attention.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import metrics as tsm


@pytest.fixture(scope="module")
def pallas():
    """(jax.numpy, the JAX package's paged_attention kernels)."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops.pallas import paged_attention
    return jnp, paged_attention


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _rows(rng, r, k):
    """Row ids in [0, r + 6): the ones >= r are page-table sentinels."""
    return rng.randint(0, r + 6, size=k).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,w,k", [(24, 16, 13), (64, 128, 40)])
def test_gather_rows_matches_pallas(pallas, dtype, r, w, k):
    jnp, jpa = pallas
    rng = np.random.RandomState(r + k)
    pool = rng.randn(r, w).astype(np.float32)
    rows = _rows(rng, r, k)
    want = np.asarray(jpa.gather_rows(
        jnp.asarray(pool, getattr(jnp, dtype)), jnp.asarray(rows),
        interpret=True).astype(jnp.float32))
    got = tpa.gather_rows(torch.from_numpy(pool).to(getattr(torch, dtype)),
                          torch.from_numpy(rows))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("heads", [4, 8])
def test_gather_rows_dequant_matches_pallas(pallas, heads):
    jnp, jpa = pallas
    rng = np.random.RandomState(heads)
    r, w, k = 24, 64, 17
    codes = rng.randint(-127, 128, size=(r, w)).astype(np.int8)
    scales = np.abs(rng.randn(r, heads)).astype(np.float32)
    rows = _rows(rng, r, k)
    want = np.asarray(jpa.gather_rows_dequant(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(rows),
        heads=heads, interpret=True))
    got = tpa.gather_rows_dequant(torch.from_numpy(codes),
                                  torch.from_numpy(scales),
                                  torch.from_numpy(rows), heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.RandomState(5)
    pool = torch.from_numpy(rng.randn(10, 8).astype(np.float32))
    codes = torch.from_numpy(
        rng.randint(-127, 128, size=(10, 8)).astype(np.int8))
    scales = torch.from_numpy(np.abs(rng.randn(10, 2)).astype(np.float32))
    rows = torch.from_numpy(_rows(rng, 10, 7))
    before = dict(tpa.LAUNCHES)
    assert torch.equal(tpa.gather_rows(pool, rows),
                       tpa.gather_rows_ref(pool, rows))
    assert torch.equal(tpa.gather_rows_dequant(codes, scales, rows, 2),
                       tpa.gather_rows_dequant_ref(codes, scales, rows, 2))
    assert tpa.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    pool = torch.zeros(6, 8)
    with pytest.raises(ValueError, match="int32"):
        tpa.gather_rows(pool, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="int8"):
        tpa.gather_rows_dequant(pool, torch.zeros(6, 2),
                                torch.zeros(3, dtype=torch.int32), 2)
    codes = torch.zeros(6, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="divisible"):
        tpa.gather_rows_dequant(codes, torch.zeros(6, 3),
                                torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="scales"):
        tpa.gather_rows_dequant(codes, torch.zeros(6, 4, dtype=torch.float64),
                                torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.gather_rows(torch.zeros(6, 8, device="meta"),
                        torch.zeros(3, dtype=torch.int32, device="meta"))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_at_decode_shapes(cuda_device):
    """The decode step's shapes at Transformer-base width: 4096 pool rows
    of 512 values, 4096 gathered rows with sentinels; plus odd widths
    that take the kernels' scalar paths."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(4096, 512, 4096, torch.float32),
             (4096, 512, 4096, torch.bfloat16), (10, 3, 7, torch.bfloat16)]
    for r, w, k, dt in cases:
        pool = torch.randn(r, w, generator=gen, device=cuda_device).to(dt)
        rows = torch.randint(0, r + 16, (k,), generator=gen,
                             device=cuda_device, dtype=torch.int32)
        n0 = tpa.LAUNCHES["gather_rows"]
        got = tpa.gather_rows(pool, rows)
        torch.cuda.synchronize()
        assert tpa.LAUNCHES["gather_rows"] == n0 + 1
        assert torch.equal(got, tpa.gather_rows_ref(pool, rows))
    for r, heads, dk, k in [(4096, 8, 64, 4096), (30, 3, 5, 9)]:
        codes = torch.randint(-127, 128, (r, heads * dk), generator=gen,
                              device=cuda_device,
                              dtype=torch.int32).to(torch.int8)
        scales = torch.rand(r, heads, generator=gen, device=cuda_device)
        rows = torch.randint(0, r + 16, (k,), generator=gen,
                             device=cuda_device, dtype=torch.int32)
        n0 = tpa.LAUNCHES["gather_rows_dequant"]
        got = tpa.gather_rows_dequant(codes, scales, rows, heads)
        torch.cuda.synchronize()
        assert tpa.LAUNCHES["gather_rows_dequant"] == n0 + 1
        assert torch.equal(
            got, tpa.gather_rows_dequant_ref(codes, scales, rows, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("r, heads, dk, k, rows", [
    (4096, 8, 64, 4096, "random"), (4096, 8, 64, 1, "random"),
    (4096, 8, 64, 37, "random"), (300, 8, 64, 100, "sentinels"),
    (64, 4, 16, 50, "random"), (64, 8, 48, 33, "random"),
    (64, 3, 6, 70, "random")])
def test_cuda_dequant_gather_matches_plain_at_edges(cuda_device, r, heads,
                                                    dk, k, rows):
    """The dequantizing gather bit-equal to its plain version (the product
    through __fmul_rn, as the plain version's fp32 multiply) at the decode
    shape and the edges chip_smoke.py holds it at: one row, a count off a
    block's 32 rows, only sentinel rows, head widths 16 and 48 (the row
    kernel: head widths a multiple of 4) and 6 (the scalar kernel); one
    launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    codes = torch.randint(-127, 128, (r, heads * dk), generator=gen,
                          device=cuda_device, dtype=torch.int32).to(torch.int8)
    scales = torch.rand(r, heads, generator=gen, device=cuda_device) + 1e-3
    ids = (torch.randint(0, r + 16, (k,), generator=gen, device=cuda_device,
                         dtype=torch.int32) if rows == "random" else
           torch.full((k,), r + 3, dtype=torch.int32, device=cuda_device))
    n0 = tpa.LAUNCHES["gather_rows_dequant"]
    got = tpa.gather_rows_dequant(codes, scales, ids, heads)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["gather_rows_dequant"] == n0 + 1
    assert torch.equal(got, tpa.gather_rows_dequant_ref(codes, scales, ids,
                                                        heads))


def _random_lm_params(rng, vocab, m, inner, n_layer):
    """Seeded weights under the JAX scope names of decoder_lm."""
    def normal(*shape):
        return (rng.randn(*shape) * shape[0] ** -0.5).astype(np.float32)
    p = {"lm_emb": normal(vocab, m), "lm_head_w": normal(m, vocab),
         "lm_lnf_scale": np.ones(m, np.float32),
         "lm_lnf_bias": np.zeros(m, np.float32)}
    for i in range(n_layer):
        for w in ("wq", "wk", "wv", "wo"):
            p[f"lm_l{i}_attn.{w}"] = normal(m, m)
        for ln in ("ln1", "ln2"):
            p[f"lm_l{i}_{ln}_scale"] = np.ones(m, np.float32)
            p[f"lm_l{i}_{ln}_bias"] = np.zeros(m, np.float32)
        p[f"lm_l{i}_ffn1_w"] = normal(m, inner)
        p[f"lm_l{i}_ffn1_b"] = np.zeros(inner, np.float32)
        p[f"lm_l{i}_ffn2_w"] = normal(inner, m)
        p[f"lm_l{i}_ffn2_b"] = np.zeros(m, np.float32)
    return p


@pytest.mark.gpu
def test_paged_engine_on_the_card_matches_the_cpu(cuda_device,
                                                  monkeypatch):
    """The paged decoder-LM engine on the card (page gathers launched as
    kernels, twice per layer per decode step) serves the streams the
    same engine serves on the CPU (plain versions), for both codecs."""
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import DecoderLM
    from paddle_tpu_torch.serving.engine import make_slot_model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.RandomState(0)
    params = convert.params_from_jax(_random_lm_params(rng, 64, 32, 64, 2))
    prompts = [rng.randint(1, 64, (int(n),)) for n in (3, 9, 16, 5, 12)]
    for codec, kname in (("none", "gather_rows"),
                         ("int8", "gather_rows_dequant")):
        streams = {}
        for dev in ("cpu", cuda_device):
            lm = DecoderLM(64, 32, 64, 2, 2, cache_len=32, device=dev)
            lm.load_state_dict(params)
            e = make_slot_model("lm", lm, n_slots=3, prompt_buckets=(8, 16),
                                layout="paged", page_size=4, kv_codec=codec,
                                device=dev)
            n0 = tpa.LAUNCHES[kname]
            s0 = tsm.DECODE_STEPS.labels(model="lm").value
            streams[str(dev)] = e.generate(prompts, max_new=10,
                                           temperature=[0, .8, 0, .8, 0],
                                           top_k=5, seeds=[1, 2, 3, 4, 5])
            launched = tpa.LAUNCHES[kname] - n0
            steps = tsm.DECODE_STEPS.labels(model="lm").value - s0
            assert launched == (0 if dev == "cpu" else 4 * steps)
        for a, b in zip(streams["cpu"], streams[str(cuda_device)]):
            np.testing.assert_array_equal(b, a)
