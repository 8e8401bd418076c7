"""The contiguous KV layout and the wave engine of the PyTorch port on the
card (marked ``gpu``; they skip without one). This file imports no JAX:
the card's machine has none, so the references are the port's own
engines on the card.

- The fp32 contiguous and paged slot engines over one model give the
  same greedy and seeded streams: same batch shapes, the same attention
  function over the same rows. The contiguous engine launches no page
  gather; the paged one launches two a layer a decode step.
- The wave engine's greedy streams equal the contiguous slot engine's,
  each request's up to its budget, or part only after a near tie: the
  wave pads every row to its largest prompt's bucket, so the card may
  sum the masked softmax in another order, and a top-2 gap of the
  ``full`` view's logits under ``NEAR_TIE`` may then resolve the other
  way.

Seeded random weights at a small width (vocab 64, d_model 32, 2 heads,
2 layers, cache_len 32, prompt buckets 8/16, 4 slots).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_contiguous_gpu.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import transformer as tT
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import engine as teng

LM = dict(vocab=64, d_model=32, d_inner=64, n_head=2, n_layer=2)
CACHE_LEN = 32
BUCKETS = (8, 16)
N_SLOTS = 4
NEAR_TIE = 1e-3


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "`pytest --noconftest -m gpu`)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _lm(dev):
    rng = np.random.RandomState(0)
    lm = tT.DecoderLM(**LM, cache_len=CACHE_LEN, device=dev)
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32) * 0.5))
    return lm


def _prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, LM["vocab"], (int(n),))
            for n in (3, 4, 7, 8, 5, 2, 16, 11, 9)]


def _slots(lm, dev, layout, **kw):
    e = teng.make_slot_model(f"lm_{layout}", lm, n_slots=N_SLOTS,
                             prompt_buckets=BUCKETS, layout=layout,
                             device=dev, **kw)
    e.warmup()
    return e


@pytest.mark.gpu
def test_cuda_contiguous_and_paged_engines_give_the_same_streams(
        cuda_device):
    lm = _lm(cuda_device)
    contiguous = _slots(lm, cuda_device, "contiguous")
    paged = _slots(lm, cuda_device, "paged", page_size=4)
    prompts = _prompts()
    for kw in (dict(max_new=16),
               dict(max_new=12, temperature=0.8, top_k=8,
                    seeds=list(range(len(prompts))))):
        tpa.reset_launches()
        got = contiguous.generate(prompts, **kw)
        assert sum(tpa.LAUNCHES.values()) == 0, dict(tpa.LAUNCHES)
        steps = paged.decode_steps
        want = paged.generate(prompts, **kw)
        assert tpa.LAUNCHES["gather_rows"] == \
            2 * LM["n_layer"] * (paged.decode_steps - steps)
        for i, (a, b) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(b, a, err_msg=f"{kw} {i}")


def _near_tie(lm, prompt, stream, i, *tokens):
    """Is the greedy choice at stream position ``i`` a near tie of the
    ``full`` view, given the prompt and the stream before it: the top-2
    gap under ``NEAR_TIE`` and each of ``tokens`` within it of the top?"""
    seq = np.concatenate([prompt, stream[:i]])
    row = lm.full(torch.from_numpy(seq[None]))[0, -1].double()
    top2 = row.topk(2).values
    return float(top2[0] - top2[1]) < NEAR_TIE and all(
        float(top2[0] - row[int(t)]) < NEAR_TIE for t in tokens)


@pytest.mark.gpu
def test_cuda_wave_streams_equal_the_slot_engine(cuda_device):
    lm = _lm(cuda_device)
    prompts = _prompts()
    budgets = [16, 3, 9, 16, 1, 12, 16, 5, 7]
    slots = _slots(lm, cuda_device, "contiguous").generate(
        prompts, max_new=budgets)
    wave = teng.GenerativeModel("lm_wave", lm, BUCKETS,
                                tbk.BucketPolicy.pow2(8))
    wave.warmup()
    tpa.reset_launches()
    got = []
    for lo in range(0, len(prompts), 8):
        part = slice(lo, lo + 8)
        got += wave.generate(prompts[part], max_new=max(budgets[part]))
    assert sum(tpa.LAUNCHES.values()) == 0, dict(tpa.LAUNCHES)
    for n, (p, want, g) in enumerate(zip(prompts, slots, got)):
        g = g[:budgets[n]]
        bad = np.flatnonzero(g != want)
        if bad.size:
            i = int(bad[0])
            assert _near_tie(lm, p, want, i, want[i], g[i]), (n, i)
