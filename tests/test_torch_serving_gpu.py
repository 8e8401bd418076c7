"""The port's model server over a paged engine on the card (marked
``gpu``; skips without one). This file imports no JAX: the card's
machine has none, so the reference is the same server over the same
engine on the CPU (the plain versions of the page gathers).

For each codec ("none", "int8") one ``ModelServer`` on the card and one
on the CPU, each over a paged slot engine with the same seeded weights
(vocab 64, d_model 32, 2 heads, 2 layers, cache_len 32, prompt buckets
8/16, 3 slots, pages of 4), serve the same five requests, each from its
own ``ServingClient`` thread with its own seed, temperature, top-k and
budget. The streams over the wire must be equal, and the card's server
must have launched that codec's page gather twice a layer a decode step
from its scheduler thread (launch counts zeroed just before, read just
after).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_serving_gpu.py``.
"""

import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models.transformer import DecoderLM
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving import client as tcli
from paddle_tpu_torch.serving import server as tsrv
from paddle_tpu_torch.serving.engine import make_slot_model

VOCAB, D_MODEL, D_INNER, N_HEAD, N_LAYER = 64, 32, 64, 2, 2


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _params(rng):
    """Seeded weights under the JAX scope names of decoder_lm."""
    m, inner = D_MODEL, D_INNER

    def normal(*shape):
        return rng.normal(0.0, shape[0] ** -0.5, shape).astype(np.float32)
    p = {"lm_emb": normal(VOCAB, m), "lm_head_w": normal(m, VOCAB),
         "lm_lnf_scale": np.ones(m, np.float32),
         "lm_lnf_bias": np.zeros(m, np.float32)}
    for i in range(N_LAYER):
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


def _serve(dev, params, codec, reqs):
    """Host a paged engine on ``dev`` and send every request from its own
    client thread; returns (streams, decode steps, page-gather launches
    of the run)."""
    lm = DecoderLM(VOCAB, D_MODEL, D_INNER, N_HEAD, N_LAYER, cache_len=32,
                   device=dev)
    lm.load_state_dict(params)
    engine = make_slot_model(f"lm_{codec}_{dev.type}", lm, n_slots=3,
                             prompt_buckets=(8, 16), layout="paged",
                             page_size=4, kv_codec=codec, device=dev)
    server = tsrv.ModelServer()
    server.add_model(engine)
    endpoint = server.serve()
    out = [None] * len(reqs)

    def send(i):
        prompt, budget, temperature, seed = reqs[i]
        client = tcli.ServingClient(endpoint)
        try:
            (out[i],) = client.generate(engine.name, [prompt],
                                        max_new=budget,
                                        temperature=temperature, top_k=5,
                                        seed=seed)
        finally:
            client.close()
    steps0 = engine.decode_steps
    tpa.reset_launches()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        launches = dict(tpa.LAUNCHES)
    finally:
        server.stop()
    assert all(s is not None for s in out)
    return out, engine.decode_steps - steps0, launches


@pytest.mark.gpu
@pytest.mark.parametrize("codec,kname", [("none", "gather_rows"),
                                         ("int8", "gather_rows_dequant")])
def test_server_over_a_cuda_paged_engine_matches_the_cpu_server(
        cuda_device, codec, kname):
    rng = np.random.RandomState(0)
    params = convert.params_from_jax(_params(rng))
    reqs = [(rng.randint(1, VOCAB, (int(n),)), budget, temperature, seed)
            for n, budget, temperature, seed in (
                (3, 10, 0.0, 1), (9, 12, 0.8, 2), (16, 16, 0.0, 3),
                (5, 8, 0.8, 4), (12, 14, 0.0, 5))]
    cpu, _, cpu_launches = _serve(torch.device("cpu"), params, codec, reqs)
    card, steps, launches = _serve(cuda_device, params, codec, reqs)
    assert not any(cpu_launches.values())
    for a, b in zip(cpu, card):
        np.testing.assert_array_equal(b, a)
    assert steps > 0
    assert launches[kname] == 2 * N_LAYER * steps
    assert sum(launches.values()) == launches[kname]
