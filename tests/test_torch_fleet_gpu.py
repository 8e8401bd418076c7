"""The port's serving fleet on the card (marked ``gpu``; skips without
one). This file imports no JAX: the card's machine has none, so the
reference is a replica on the CPU from the same weights file.

One port ``Router`` spawns two replicas from one spec that differs only
in ``device``: slot 0 on the card, slot 1 on the CPU, each a paged slot
engine (vocab 64, d_model 32, 2 heads, 2 layers, prompt buckets 8/16,
cache_len 32, 3 slots, pages of 4) over the ``.npz`` of seeded weights
under their JAX names. The same requests (greedy, and sampled with
seeds) sent to each replica's endpoint must give the same streams, and
the router must route to both.

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_fleet_gpu.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving.client import ServingClient
from paddle_tpu_torch.serving.router import Router

VOCAB, D_MODEL, D_INNER, N_HEAD, N_LAYER = 64, 32, 64, 2, 2
PARAMS = dict(prompt_len=16, max_new=16, vocab=VOCAB, d_model=D_MODEL,
              d_inner=D_INNER, n_head=N_HEAD, n_layer=N_LAYER, n_slots=3,
              prompt_buckets=[8, 16], modes=["prefill_paged", "decode_paged"],
              page_size=4, kv_codec="none")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


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


@pytest.mark.gpu
def test_cuda_replica_gives_the_cpu_replica_streams(cuda_device, tmp_path):
    weights = str(tmp_path / "lm.npz")
    np.savez(weights, **_params(np.random.RandomState(0)))

    def spec(device):
        return {"model": {"kind": "decoder_lm", "name": "lm",
                          "weights": weights, "device": device,
                          "params": dict(PARAMS)}}
    router = Router(specs=[spec(cuda_device.type), spec("cpu")],
                    workdir=str(tmp_path / "fleet"))
    router.start()
    try:
        assert router.wait_ready(timeout_s=300), router.stats()
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, VOCAB, (int(n),)) for n in (3, 9, 16)]
        streams = {}
        for rep in router.stats()["replicas"]:
            client = ServingClient(rep["endpoint"])
            try:
                streams[rep["index"]] = (
                    client.generate("lm", prompts, max_new=12),
                    client.generate("lm", prompts, max_new=10,
                                    temperature=0.8, top_k=5, seed=7))
            finally:
                client.close()
        for kind, (a, b) in enumerate(zip(streams[0], streams[1])):
            for i, (x, y) in enumerate(zip(a, b)):
                np.testing.assert_array_equal(x, y, err_msg=f"{kind} {i}")
        routed = {router.route({"method": "models", "req_id": f"r{i}"})
                  ["routed_replica"] for i in range(8)}
        assert routed <= {0, 1} and routed
    finally:
        router.stop()
    assert [r.proc.returncode for r in router._replicas] == [0, 0]
