"""The port's executor on the card (marked ``gpu``; skips without one).
This file imports no JAX: the card's machine has none, so the reference
is a ``CPUPlace()`` executor on the same saved directory.

The two tiny committed programs of ``tests/torch_programs/``
(``transformer_tiny``: 1 + 1 layers, d_model 32, 2 heads, vocab 64,
max_len 8, the fused attention and the fused head; and
``stacked_dynamic_lstm_tiny``: dict 50, emb 16, hid 16, 2 layers), with
weights from ``convert.seeded_persistables`` written by the port's
``save_persistables``, are loaded onto ``CUDAPlace(0)`` and onto
``CPUPlace()`` into scopes of their own and run on the same feeds. The
fetches must agree within rtol 1e-4 / atol 1e-5 (fp32 on both devices,
TF32 off; the card's flash, fused-CE and LSTM kernels take 3xTF32
products, held to that bound in ``chip_smoke.py``), and one run on the
card must launch 3 flash forwards and 1 fused-CE forward (the
Transformer) or 2 LSTM forwards (the LSTM), and nothing else; the card's
executor refuses the CPU's scope.

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_executor_gpu.py``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels import fused_rnn as fr

PROGRAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_programs")
TOL = dict(rtol=1e-4, atol=1e-5)
KERNELS = (fa, fce, fr)


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


def _saved(name, d):
    """A saved-model directory of committed program ``name`` with seeded
    weights."""
    shutil.copy(os.path.join(PROGRAMS, name, "__model__.json"), d)
    with open(os.path.join(d, "__model__.json")) as f:
        desc = ir.ProgramDesc.parse_from_string(
            json.dumps(json.load(f)["program"]).encode())
    scope = fluid.Scope()
    for n, a in convert.seeded_persistables(desc.global_block, 3).items():
        scope.set_var(n, torch.from_numpy(a))
    fluid.io.save_persistables(None, str(d), fluid.Program(desc),
                               scope=scope)
    return str(d)


def _launches():
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": n
            for m in KERNELS for k, n in m.LAUNCHES.items() if n}


@pytest.mark.gpu
@pytest.mark.parametrize("name,feeds,want", [
    ("transformer_tiny",
     lambda rng: {k: rng.randint(1, 64, (4, 8, 1)).astype(np.int64)
                  for k in ("src_ids", "tgt_ids", "lbl_ids")},
     {"flash_attention.flash_fwd": 3, "fused_ce.fused_ce_fwd": 1}),
    ("stacked_dynamic_lstm_tiny",
     lambda rng: {"words": rng.randint(0, 50, (6, 8)).astype(np.int64),
                  "seq_lens": np.array([8, 1, 5, 3, 8, 2], np.int32)},
     {"fused_rnn.lstm_train_fwd": 2})])
def test_saved_program_on_the_card(cuda_device, tmp_path, name, feeds,
                                   want):
    d = _saved(name, tmp_path)
    f = feeds(np.random.RandomState(0))
    out, runs = {}, {}
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        prog, _, fetch = fluid.io.load_inference_model(d, exe, scope=scope)
        exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
        for m in KERNELS:
            m.reset_launches()
        key = type(place).__name__
        out[key] = exe.run(prog, feed=f, fetch_list=fetch, scope=scope)[0]
        runs[key] = (exe, prog, fetch, scope)
        if isinstance(place, fluid.CUDAPlace):
            assert _launches() == want
            assert all(v.is_cuda for _, v in scope.iter_vars())
        else:
            assert _launches() == {}
    got, ref = out["CUDAPlace"], out["CPUPlace"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    # a scope filled on one device is not read on the other
    exe, prog, fetch, _ = runs["CUDAPlace"]
    with pytest.raises(ValueError, match="executors of its own device"):
        exe.run(prog, feed=f, fetch_list=fetch, scope=runs["CPUPlace"][3])
