"""Programs built by the port's program builder, trained on the card
(marked ``gpu``; skips without one). This file imports no JAX: the
card's machine has none, so the reference is a ``CPUPlace()`` executor
on the same program from the same scope.

mnist, the tiny Transformer (fused attention and head, the Noam schedule
at warmup 40, dropout 0) and the tiny stacked LSTM are built by
``paddle_tpu_torch.fluid.models`` under a fresh guard, initialised by the
port's own startup (``random_seed`` 24, on the CPU), the scope copied to
the card and to the CPU, and each side trains 3 steps on the same feeds;
the card's run goes through ``fluid.Executor()`` (the default place) and
``exe.run()`` on the default main program. The losses, the rates and
every persistable after the steps agree within rtol 1e-4 / atol 1e-5
(fp32, TF32 off, three Adam steps), and every step on the card launches
exactly its kernels: 3 flash forwards and backwards and 1 fused-CE
forward and backward (rows 1, 2, 4, 5), 2 + 2 LSTM kernels (rows 6-7),
none for mnist.

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_builder_gpu.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels import fused_rnn as fr

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
KERNELS = (fa, fce, fr)

# builder -> (its arguments, feeds(rng) of one batch, one step's launches)
BUILDS = {
    "transformer": (
        dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32, d_inner=64,
             n_head=2, n_layer=1, dropout=0.0, fused_attention=True,
             fused_head=True, lr_scheduler="noam", lr=2.0, warmup=40),
        lambda r: {k: r.randint(1, 64, (4, 8, 1)).astype(np.int64)
                   for k in ("src_ids", "tgt_ids", "lbl_ids")},
        {"flash_fwd": 3, "flash_bwd": 3, "fused_ce_fwd": 1,
         "fused_ce_bwd": 1}),
    "stacked_dynamic_lstm": (
        dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2),
        lambda r: {"words": r.randint(0, 50, (4, 8)).astype(np.int64),
                   "seq_lens": np.array([8, 5, 3, 1], np.int32),
                   "label": r.randint(0, 2, (4, 1)).astype(np.int64)},
        {"lstm_train_fwd": 2, "lstm_train_bwd": 2}),
    "mnist": (
        {},
        lambda r: {"pixel": r.randn(4, 1, 28, 28).astype(np.float32),
                   "label": r.randint(0, 10, (4, 1)).astype(np.int64)},
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


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(BUILDS))
def test_built_program_on_the_card_matches_the_cpu(cuda_device, model):
    kwargs, feeds_of, want = BUILDS[model]
    mod = importlib.import_module("paddle_tpu_torch.fluid.models." + model)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = mod.build(**kwargs)
    rate = next(op for op in main.desc.global_block.ops
                if op.type == "adam").input("LearningRate")[0]
    startup.random_seed = 24
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    names = sorted(n for n, v in main.desc.global_block.vars.items()
                   if v.persistable)
    scopes = {}
    for dev in ("cpu", "cuda"):
        scopes[dev] = fluid.Scope()
        for n in names:
            scopes[dev].set_var(n, s0.find_var(n).clone().to(dev))
    rng = np.random.RandomState(5)
    feeds = [feeds_of(rng) for _ in range(STEPS)]
    cpu = fluid.Executor(fluid.CPUPlace())
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(scopes["cuda"]):
        card = fluid.Executor()
        assert card.device.type == "cuda"
        for i, f in enumerate(feeds):
            before = _launches()
            got = card.run(feed=f, fetch_list=[loss, rate])
            launched = {k: n - before[k] for k, n in _launches().items()
                        if n != before[k]}
            assert launched == want, (i, launched)
            ref = cpu.run(main, feed=f, fetch_list=[loss, rate],
                          scope=scopes["cpu"])
            for g, r, what in zip(got, ref, ("loss", "rate")):
                np.testing.assert_allclose(g, r, err_msg=f"{what} {i}",
                                           **TOL)
    for n in names:
        np.testing.assert_allclose(scopes["cuda"].find_var(n).cpu().numpy(),
                                   scopes["cpu"].find_var(n).numpy(),
                                   err_msg=n, **TOL)
