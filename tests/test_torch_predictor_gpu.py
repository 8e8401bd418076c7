"""The port's predictor on the card (marked ``gpu``; skips without one).
This file imports no JAX: the card's machine has none, so the reference
is a ``disable_gpu()`` predictor on the same saved directory.

Four committed programs of ``tests/torch_programs/`` with weights from
``convert.seeded_persistables`` written by the port's
``save_persistables``: ``fc_lstm_tiny`` and ``fc_gru_tiny`` (a bias-free
fc, then ``dynamic_lstm`` / ``dynamic_gru``: T 8, D 16, H 16), which the
passes rewrite into ``fusion_lstm`` / ``fusion_gru``;
``seqpool_concat_tiny`` (two SUM pools and a concat: one
``fusion_seqpool_concat``); and ``transformer_tiny`` (the fused attention
and head; its mul + add pairs become ``fc``), at batch 4 and 1. Each
runs through ``PaddlePredictor`` on ``CUDAPlace(0)`` (the default
config) and on the CPU; the fetches must agree within rtol 1e-4 / atol 1e-5 (fp32 on both
devices, TF32 off; the card's kernels take 3xTF32 products, held to that
bound in ``chip_smoke.py``), and one run on the card must launch the
kernels of PERF.md's rows 6 (LSTM forward), 8 (GRU forward), 11 (masked
sequence pool), 1 (flash forward) and 4 (fused-CE forward) exactly as
the rewritten program holds them, and nothing else.

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_predictor_gpu.py``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.inference import AnalysisConfig, PaddlePredictor
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels import fused_rnn as fr
from paddle_tpu_torch.ops.kernels import seqpool as sp

PROGRAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_programs")
TOL = dict(rtol=1e-4, atol=1e-5)
KERNELS = (fa, fce, fr, sp)


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
    for n, a in convert.seeded_persistables(desc.global_block, 5).items():
        scope.set_var(n, torch.from_numpy(a))
    fluid.io.save_persistables(None, str(d), fluid.Program(desc),
                               scope=scope)
    return str(d)


def _launches():
    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": n
            for m in KERNELS for k, n in m.LAUNCHES.items() if n}


def _seq(rng, *names):
    f = {n: rng.standard_normal((5, 8, 16)).astype(np.float32)
         for n in names}
    f["sl"] = np.array([8, 1, 5, 0, 3], np.int32)
    return f


@pytest.mark.gpu
@pytest.mark.parametrize("name,feeds,fused,want", [
    ("fc_lstm_tiny", lambda rng: _seq(rng, "x"), "fusion_lstm",
     {"fused_rnn.lstm_train_fwd": 1}),
    ("fc_gru_tiny", lambda rng: _seq(rng, "x"), "fusion_gru",
     {"fused_rnn.gru_train_fwd": 1}),
    ("seqpool_concat_tiny", lambda rng: _seq(rng, "a", "b"),
     "fusion_seqpool_concat", {"seqpool.seqpool": 2}),
    ("transformer_tiny",
     lambda rng: {k: rng.randint(1, 64, (4, 8, 1)).astype(np.int64)
                  for k in ("src_ids", "tgt_ids", "lbl_ids")},
     "fc", {"flash_attention.flash_fwd": 3, "fused_ce.fused_ce_fwd": 1}),
    # batch 1, ServedModel's first bucket (ROADMAP C10: the heads of a
    # [1,T,H,D] transpose reached the kernel as a strided view)
    ("transformer_tiny",
     lambda rng: {k: rng.randint(1, 64, (1, 8, 1)).astype(np.int64)
                  for k in ("src_ids", "tgt_ids", "lbl_ids")},
     "fc", {"flash_attention.flash_fwd": 3, "fused_ce.fused_ce_fwd": 1})])
def test_predictor_on_the_card(cuda_device, tmp_path, name, feeds, fused,
                               want):
    d = _saved(name, tmp_path)
    f = feeds(np.random.RandomState(0))
    card = PaddlePredictor(AnalysisConfig(model_dir=d))
    cfg = AnalysisConfig(model_dir=d)
    cfg.disable_gpu()
    cpu = PaddlePredictor(cfg)
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    assert card._program.desc.to_dict() == cpu._program.desc.to_dict()
    assert fused in {op.type for op in card._program.desc.global_block.ops}
    card.run(f)                                    # first use
    torch.cuda.synchronize()
    for m in KERNELS:
        m.reset_launches()
    got = card.run(f)[0]
    assert _launches() == want
    ref = cpu.run(f)[0]
    assert _launches() == want                     # the CPU launches none
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
