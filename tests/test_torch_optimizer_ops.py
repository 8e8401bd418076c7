"""The port's optimizer, clip and EMA ops (``paddle_tpu_torch/ops/
optimizer_ops.py``) against the JAX emitters (``paddle_tpu/ops/
optimizer_ops.py``), each called directly on the same numpy inputs made
from a seed: no program, no jit. The dense branch of every op, then the
sparse branches of ``sgd``, ``momentum`` (with and without Nesterov) and
``adam`` (lazy and not) on a row-sparse gradient with duplicate rows.

Tolerance: rtol 1e-6 / atol 1e-7, one fp32 elementwise pass on each side.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.ops import optimizer_ops as jops  # noqa: F401

from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.ops import optimizer_ops as tops  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-7)
V, D = 12, 5


def _f32(rng, *shape, positive=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + np.float32(0.1) if positive else a


def _scalar(x):
    return np.array([x], np.float32)


# op -> (attrs, {slot: maker(rng)}) of its dense inputs besides Param,
# Grad and LearningRate
_ACC = {
    "sgd": ({}, {}),
    "momentum": ({"mu": 0.9}, {"Velocity": lambda r: _f32(r, V, D)}),
    "momentum_nesterov": ({"mu": 0.8, "use_nesterov": True},
                          {"Velocity": lambda r: _f32(r, V, D)}),
    "lars_momentum": ({"mu": 0.9, "lars_coeff": 0.002,
                       "lars_weight_decay": 0.001},
                      {"Velocity": lambda r: _f32(r, V, D)}),
    "adam": ({"beta1": 0.9, "beta2": 0.997, "epsilon": 1e-9},
             {"Moment1": lambda r: _f32(r, V, D),
              "Moment2": lambda r: _f32(r, V, D, positive=True),
              "Beta1Pow": lambda r: _scalar(0.9 ** 3),
              "Beta2Pow": lambda r: _scalar(0.997 ** 3)}),
    "adamax": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
               {"Moment": lambda r: _f32(r, V, D),
                "InfNorm": lambda r: _f32(r, V, D, positive=True),
                "Beta1Pow": lambda r: _scalar(0.9 ** 2)}),
    "adagrad": ({"epsilon": 1e-6},
                {"Moment": lambda r: _f32(r, V, D, positive=True)}),
    "decayed_adagrad": ({"decay": 0.9, "epsilon": 1e-6},
                        {"Moment": lambda r: _f32(r, V, D, positive=True)}),
    "adadelta": ({"rho": 0.9, "epsilon": 1e-6},
                 {"AvgSquaredGrad": lambda r: _f32(r, V, D, positive=True),
                  "AvgSquaredUpdate": lambda r: _f32(r, V, D,
                                                     positive=True)}),
    "rmsprop": ({"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5},
                {"MeanSquare": lambda r: _f32(r, V, D, positive=True),
                 "Moment": lambda r: _f32(r, V, D)}),
    "rmsprop_centered": ({"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                          "centered": True},
                         {"MeanSquare": lambda r: _f32(r, V, D,
                                                       positive=True) + 2,
                          "MeanGrad": lambda r: _f32(r, V, D) * 0.1,
                          "Moment": lambda r: _f32(r, V, D)}),
    "ftrl": ({"l1": 0.05, "l2": 0.1, "lr_power": -0.5},
             {"SquaredAccumulator": lambda r: _f32(r, V, D, positive=True),
              "LinearAccumulator": lambda r: _f32(r, V, D)}),
    "proximal_gd": ({"l1": 0.05, "l2": 0.1}, {}),
    "proximal_adagrad": ({"l1": 0.05, "l2": 0.1},
                         {"Moment": lambda r: _f32(r, V, D, positive=True)}),
}


def _op_type(case):
    return case.split("_nesterov")[0].split("_centered")[0]


def _jax_ctx():
    return jreg.EmitContext(base_key=jax.random.key(0))


def _run_both(op_type, ins_np, attrs, jgrad=None, tgrad=None):
    """{slot: (jax array, port array)} of the op's outputs, with the
    gradient slot overridden by the given carriers (sparse cases)."""
    jins = {k: [jax.numpy.asarray(v)] for k, v in ins_np.items()}
    tins = {k: [torch.from_numpy(v.copy())] for k, v in ins_np.items()}
    if jgrad is not None:
        jins["Grad"], tins["Grad"] = [jgrad], [tgrad]
    jout = jreg.get_op(op_type).emit(_jax_ctx(), jins, attrs)
    tout = treg.get_op(op_type).emit(treg.EmitContext(), tins, attrs)
    assert sorted(tout) == sorted(jout)
    return {k: (np.asarray(jout[k][0]), tout[k][0].numpy()) for k in jout}


def _dense_ins(case, seed):
    rng = np.random.RandomState(seed)
    attrs, acc = _ACC[case]
    ins = {"Param": _f32(rng, V, D), "Grad": _f32(rng, V, D),
           "LearningRate": _scalar(0.01)}
    for slot, make in acc.items():
        ins[slot] = make(rng)
    return attrs, ins


@pytest.mark.parametrize("case", sorted(_ACC))
def test_dense_update_matches_jax(case):
    attrs, ins = _dense_ins(case, seed=sorted(_ACC).index(case))
    for slot, (want, got) in _run_both(_op_type(case), ins, attrs).items():
        np.testing.assert_allclose(got, want, err_msg=slot, **TOL)


@pytest.mark.parametrize("case", ["sgd", "momentum", "momentum_nesterov",
                                  "adam", "adam_lazy"])
def test_sparse_update_matches_jax(case):
    """K = 9 rows over a 12-row table, rows 3 and 7 repeated: the JAX
    ``RowSparseGrad`` and the port's uncoalesced COO tensor carry the same
    pairs. Untouched rows of lazy Adam keep their moments and values."""
    base = "adam" if case == "adam_lazy" else case
    attrs, ins = _dense_ins(base, seed=100 + len(case))
    attrs = dict(attrs, lazy_mode=case == "adam_lazy")
    rng = np.random.RandomState(7)
    rows = np.array([3, 0, 7, 3, 11, 7, 3, 5, 9], np.int32)
    vals = _f32(rng, rows.size, D)
    jgrad = jsr.RowSparseGrad(jax.numpy.asarray(rows),
                              jax.numpy.asarray(vals), V)
    tgrad = tsr.row_sparse(torch.from_numpy(rows), torch.from_numpy(vals), V)
    out = _run_both(_op_type(base), ins, attrs, jgrad, tgrad)
    for slot, (want, got) in out.items():
        np.testing.assert_allclose(got, want, err_msg=slot, **TOL)
    if case == "adam_lazy":
        off = np.setdiff1d(np.arange(V), rows)
        for slot, src in (("ParamOut", "Param"), ("Moment1Out", "Moment1"),
                          ("Moment2Out", "Moment2")):
            np.testing.assert_array_equal(out[slot][1][off], ins[src][off])


@pytest.mark.parametrize("op_type,attrs,make", [
    ("clip_by_norm", {"max_norm": 1.0},
     lambda r: {"X": _f32(r, V, D)}),
    ("clip_by_norm", {"max_norm": 100.0},
     lambda r: {"X": _f32(r, V, D)}),
    ("global_norm_clip_apply", {"clip_norm": 1.0},
     lambda r: {"X": _f32(r, V, D), "GlobalNorm": _scalar(3.5)}),
    ("global_norm_clip_apply", {"clip_norm": 5.0},
     lambda r: {"X": _f32(r, V, D), "GlobalNorm": _scalar(3.5)}),
    ("ema_accumulate", {"decay": 0.99},
     lambda r: {"Param": _f32(r, V, D), "Ema": _f32(r, V, D)}),
], ids=["clip_by_norm_clips", "clip_by_norm_passes",
        "global_norm_clip_scales", "global_norm_clip_passes", "ema"])
def test_clip_and_ema_match_jax(op_type, attrs, make):
    ins = make(np.random.RandomState(3))
    for slot, (want, got) in _run_both(op_type, ins, attrs).items():
        np.testing.assert_allclose(got, want, err_msg=slot, **TOL)


def test_sparse_apply_records_its_site():
    """A sparse apply inside a program registers (param -> rows, height)
    on the desc, which the executor's rows-touched counter reads."""
    from paddle_tpu_torch.core import ir as tir
    desc = tir.ProgramDesc()
    op = tir.OpDesc("sgd", {"Param": ["emb"], "Grad": ["emb@GRAD"],
                            "LearningRate": ["lr"]}, {"ParamOut": ["emb"]})
    grad = tsr.row_sparse(torch.tensor([1, 1, 4]), torch.ones(3, D), V)
    treg.get_op("sgd").emit(
        treg.EmitContext(program=desc, op=op),
        {"Param": [torch.zeros(V, D)], "Grad": [grad],
         "LearningRate": [torch.tensor([0.5])]}, {})
    assert desc._sparse_sites == {"emb": (3, V)}
