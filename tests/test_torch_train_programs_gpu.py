"""Training programs through the port's executor on the card (marked
``gpu``; skips without one). This file imports no JAX: the card's machine
has none, so the reference is a ``CPUPlace()`` executor on the same
program from the same scope.

The five tiny training pairs of ``tests/torch_programs/`` are initialised
by the port's own startup program (``random_seed`` 23, on the CPU), the
scope copied to ``CUDAPlace(0)`` and to the CPU, and each side trains 3
steps on the same feeds. The losses and every persistable after the steps
(the moments and beta powers included) must agree within rtol 1e-4 /
atol 1e-5: fp32 on both devices, TF32 off, the card's flash, fused-CE,
LSTM and GRU kernels taking 3xTF32 products (held to that bound in
``chip_smoke.py``), and three Adam steps. Every step on the card must
launch exactly its kernels: 3 flash forwards and 3 flash backwards and 1
fused-CE forward and backward (the Transformer: one layer's three
attentions; rows 1, 2, 4 and 5), 2 + 2 LSTM kernels (rows 6-7), 2 + 2 GRU
kernels (rows 8-9), none for mnist and deepfm.

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_train_programs_gpu.py``.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels import fused_rnn as fr

PROGRAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_programs")
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS = "mean_0.tmp_0"
STEPS = 3
KERNELS = (fa, fce, fr)

# pair -> (feeds(rng) of one batch, the launches of one step)
PAIRS = {
    "transformer_tiny_train": (
        lambda r: {k: r.randint(1, 64, (4, 8, 1)).astype(np.int64)
                   for k in ("src_ids", "tgt_ids", "lbl_ids")},
        {"flash_fwd": 3, "flash_bwd": 3, "fused_ce_fwd": 1,
         "fused_ce_bwd": 1}),
    "stacked_dynamic_lstm_tiny_train": (
        lambda r: {"words": r.randint(0, 50, (4, 8)).astype(np.int64),
                   "seq_lens": np.array([8, 5, 3, 1], np.int32),
                   "label": r.randint(0, 2, (4, 1)).astype(np.int64)},
        {"lstm_train_fwd": 2, "lstm_train_bwd": 2}),
    "machine_translation_tiny_train": (
        lambda r: {k: r.randint(0, 30, (4, 8)).astype(np.int64)
                   for k in ("src", "tgt_in", "tgt_out")},
        {"gru_train_fwd": 2, "gru_train_bwd": 2}),
    "mnist_train": (
        lambda r: {"pixel": r.randn(4, 1, 28, 28).astype(np.float32),
                   "label": r.randint(0, 10, (4, 1)).astype(np.int64)},
        {}),
    "deepfm_tiny_train": (
        lambda r: {"feat_ids": r.randint(0, 64, (8, 4, 1)).astype(np.int64),
                   "label": r.randint(0, 2, (8, 1)).astype(np.float32)},
        {}),
}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _launches():
    return {k: n for m in KERNELS for k, n in m.LAUNCHES.items()}


def _program(name, which):
    with open(os.path.join(PROGRAMS, name, which + ".json"), "rb") as f:
        return fluid.Program(ir.ProgramDesc.parse_from_string(f.read()))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_training_pair_on_the_card_matches_the_cpu(cuda_device, name):
    main = _program(name, "__main__")
    startup = _program(name, "__startup__")
    startup.random_seed = 23
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    names = sorted(n for n, v in main.desc.global_block.vars.items()
                   if v.persistable)
    scopes = {}
    for dev in ("cpu", "cuda"):
        scopes[dev] = fluid.Scope()
        for n in names:
            scopes[dev].set_var(n, s0.find_var(n).clone().to(dev))
    rng = np.random.RandomState(4)
    feeds = [PAIRS[name][0](rng) for _ in range(STEPS)]
    card = fluid.Executor(fluid.CUDAPlace(0))
    cpu = fluid.Executor(fluid.CPUPlace())
    want = PAIRS[name][1]
    for i, f in enumerate(feeds):
        before = _launches()
        got = card.run(main, feed=f, fetch_list=[LOSS],
                       scope=scopes["cuda"])[0]
        launched = {k: n - before[k] for k, n in _launches().items()
                    if n != before[k]}
        assert launched == want, (i, launched)
        ref = cpu.run(main, feed=f, fetch_list=[LOSS], scope=scopes["cpu"])[0]
        np.testing.assert_allclose(got, ref, err_msg=f"step {i}", **TOL)
    for n in names:
        np.testing.assert_allclose(scopes["cuda"].find_var(n).cpu().numpy(),
                                   scopes["cpu"].find_var(n).numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.gpu
def test_the_card_refuses_the_cpu_scope(cuda_device):
    main = _program("mnist_train", "__main__")
    startup = _program("mnist_train", "__startup__")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    feed = PAIRS["mnist_train"][0](np.random.RandomState(0))
    with pytest.raises(ValueError, match="executors of its own device"):
        fluid.Executor(fluid.CUDAPlace(0)).run(main, feed=feed,
                                               fetch_list=[LOSS],
                                               scope=scope)
