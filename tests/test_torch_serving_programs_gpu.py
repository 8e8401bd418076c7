"""The decoder LM's serving programs on the card (marked ``gpu``; skips
without one). This file imports no JAX: the card's machine has none, so
the reference is the port's nn.Module engine on the same weights.

A paged family of ``fluid.models.transformer.build_decoder_lm_programs``
(vocab 64, d_model 32, 4 heads, 2 layers, prompt buckets 8/16, cache_len
32, 4 slots, pages of 4 rows; codecs none and int8) serves six seeded
requests through ``make_slot_model(name, programs)`` on the card, every
view run by the port's executor. Its streams equal the Module engine's
(``make_slot_model(name, DecoderLM, layout="paged", ...)``) on the same
seeded weights token for token, and every decode step launches the
codec's page-gather kernel 2 x n_layer times (the counters zeroed just
before the requests, read just after).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_serving_programs_gpu.py``.
"""

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.models import transformer as T
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models.transformer import DecoderLM
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.serving import engine as teng
from paddle_tpu_torch.serving import metrics as sm

LM = dict(vocab=64, d_model=32, d_inner=64, n_head=4, n_layer=2)
PROMPT_LEN, MAX_NEW, BUCKETS = 16, 16, (8, 16)
GEOM = dict(n_slots=4, page_size=4)
_NAMES = itertools.count()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the page-gather kernels have no "
                    "CPU build (their plain versions are held against JAX "
                    "in tests/test_torch_serving_programs.py)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _family(codec):
    with fluid.unique_name.guard():
        return T.build_decoder_lm_programs(
            prompt_len=PROMPT_LEN, max_new=MAX_NEW, **LM,
            prompt_buckets=BUCKETS, modes=T.slot_modes("paged"),
            kv_codec=codec, **GEOM)


def _requests():
    rng = np.random.RandomState(7)
    prefix = rng.randint(1, 64, 8)
    prompts = [np.concatenate([prefix, rng.randint(1, 64, 3)]), prefix[:6]]
    prompts += [rng.randint(1, 64, int(n)) for n in (16, 5, 9, 12)]
    return prompts, [16, 9, 12, 16, 7, 10]


@pytest.mark.gpu
@pytest.mark.parametrize("codec,kname", [("none", "gather_rows"),
                                         ("int8", "gather_rows_dequant")])
def test_paged_program_engine_on_the_card(cuda_device, codec, kname):
    progs = _family(codec)
    rng = np.random.RandomState(3)
    arrays = {p.name: rng.normal(0, 0.3, p.shape).astype(np.float32)
              for p in progs["decode_paged"][0].global_block()
              .all_parameters()}
    engine = teng.make_slot_model(f"sprog_gpu_{next(_NAMES)}", progs)
    for n, a in arrays.items():
        engine.scope.set_var(n, torch.from_numpy(a).to(cuda_device))
    lm = DecoderLM(**LM, cache_len=PROMPT_LEN + MAX_NEW)
    lm.load_state_dict(convert.params_from_jax(arrays))
    module = teng.make_slot_model(f"sprog_gpu_mod_{next(_NAMES)}", lm,
                                  prompt_buckets=BUCKETS, layout="paged",
                                  kv_codec=codec, **GEOM)
    engine.warmup()
    prompts, budgets = _requests()
    kw = dict(max_new=budgets, temperature=[0, .8, 0, .8, 0, 0],
              top_k=[0, 5, 0, 3, 0, 0], seeds=list(range(6)))
    steps0 = sm.DECODE_STEPS.labels(model=engine.name).value
    pa.reset_launches()
    got = engine.generate(prompts, **kw)
    launches = dict(pa.LAUNCHES)
    steps = sm.DECODE_STEPS.labels(model=engine.name).value - steps0
    want = module.generate(prompts, **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert steps > 0
    assert launches == {k: 2 * LM["n_layer"] * steps if k == kname else 0
                        for k in launches}
