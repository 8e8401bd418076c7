"""The port's ``__vjp__`` op and ``append_backward_desc``
(``paddle_tpu_torch/ops/grad_ops.py``) against the JAX package's
(``paddle_tpu/ops/grad_ops.py``).

- ``__vjp__``, op by op: one parametrised test over every differentiable
  op type of the bench models' training programs, each emitter called
  directly on the same numpy inputs made from a seed (the port replays
  the forward, as it does for a dead forward). The lookup family twice:
  through the row-sparse fast path and densified (``disable_sparse_grad``
  on both sides), with a ``padding_idx``. Tolerance: rtol 1e-5 / atol
  1e-6, one fp32 backward whose sums run in another order on each side.
- ``append_backward_desc``: the block it appends over the forward part of
  committed training programs is the JAX one, ``to_dict()`` for
  ``to_dict()``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.ops import grad_ops as jgrad

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering as _tlow  # noqa: F401 (emitters)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.ops import grad_ops as tgrad

TOL = dict(rtol=1e-5, atol=1e-6)
PROGRAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_programs")


def _f(*shape):
    return ("f", shape)


def _w(*shape):
    """A weight at its initializer's scale, std 1 / sqrt(fan in)."""
    return ("w", shape)


def _i(hi, *shape, dtype=np.int64):
    return ("i", shape, hi, dtype)


def _lens(*vals):
    return ("lens", np.array(vals, np.int32))


# case id -> (op type, {slot: [input spec]}, {slot: n outputs}, attrs,
#             slots with a gradient flowing in, input slots not differentiated)
_LSTM_ATTRS = dict(use_peepholes=True, is_reverse=False,
                   gate_activation="sigmoid", cell_activation="tanh",
                   candidate_activation="tanh")
_GRU_ATTRS = dict(is_reverse=False, gate_activation="sigmoid",
                  activation="tanh")
CASES = {
    "mean": ("mean", {"X": [_f(4, 3)]}, {"Out": 1}, {}, ("Out",), ()),
    "cross_entropy": ("cross_entropy",
                      {"X": [("prob", (4, 5))], "Label": [_i(5, 4, 1)]},
                      {"Y": 1}, {"soft_label": False, "ignore_index": -100},
                      ("Y",), ("Label",)),
    "softmax": ("softmax", {"X": [_f(4, 5)]}, {"Out": 1}, {}, ("Out",), ()),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [_f(4, 5)], "Label": [_i(5, 4, 1)]},
        {"Loss": 1, "Softmax": 1},
        {"soft_label": False, "ignore_index": -100, "label_smoothing": 0.0},
        ("Loss",), ("Label",)),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(6, 1)], "Label": [("bits", (6, 1))]}, {"Out": 1},
        {"ignore_index": -100, "normalize": False}, ("Out",), ("Label",)),
    "elementwise_add": ("elementwise_add", {"X": [_f(4, 3)], "Y": [_f(3)]},
                        {"Out": 1}, {"axis": -1}, ("Out",), ()),
    "elementwise_sub": ("elementwise_sub",
                        {"X": [_f(4, 3, 2)], "Y": [_f(4, 3, 2)]},
                        {"Out": 1}, {"axis": -1}, ("Out",), ()),
    "elementwise_mul": ("elementwise_mul",
                        {"X": [_f(2, 3, 4)], "Y": [_f(3)]}, {"Out": 1},
                        {"axis": 1}, ("Out",), ()),
    "mul": ("mul", {"X": [_f(2, 4, 6)], "Y": [_f(6, 3)]}, {"Out": 1},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, ("Out",), ()),
    "matmul": ("matmul", {"X": [_f(2, 4, 3)], "Y": [_f(2, 5, 3)]},
               {"Out": 1}, {"transpose_X": False, "transpose_Y": True,
                            "alpha": 0.5}, ("Out",), ()),
    "sum": ("sum", {"X": [_f(4, 3), _f(4, 3), _f(4, 3)]}, {"Out": 1}, {},
            ("Out",), ()),
    "scale": ("scale", {"X": [_f(4, 3)]}, {"Out": 1},
              {"scale": 0.5, "bias": 0.1, "bias_after_scale": True},
              ("Out",), ()),
    "reshape": ("reshape", {"X": [_f(4, 6)]}, {"Out": 1},
                {"shape": [-1, 3, 2]}, ("Out",), ()),
    "transpose": ("transpose", {"X": [_f(2, 3, 4)]}, {"Out": 1},
                  {"axis": [0, 2, 1]}, ("Out",), ()),
    "concat": ("concat", {"X": [_f(2, 3, 2), _f(2, 3, 4)]}, {"Out": 1},
               {"axis": 2}, ("Out",), ()),
    "slice": ("slice", {"Input": [_f(3, 4, 6)]}, {"Out": 1},
              {"axes": [2], "starts": [1], "ends": [5]}, ("Out",), ()),
    "squeeze": ("squeeze", {"X": [_f(4, 1, 3)]}, {"Out": 1}, {"axes": [1]},
                ("Out",), ()),
    "reduce_sum": ("reduce_sum", {"X": [_f(4, 5)]}, {"Out": 1},
                   {"dim": [1], "keep_dim": True}, ("Out",), ()),
    "square": ("square", {"X": [_f(4, 5)]}, {"Out": 1}, {}, ("Out",), ()),
    "relu": ("relu", {"X": [_f(4, 5)]}, {"Out": 1}, {}, ("Out",), ()),
    "sigmoid": ("sigmoid", {"X": [_f(4, 5)]}, {"Out": 1}, {}, ("Out",), ()),
    "tanh": ("tanh", {"X": [_f(4, 5)]}, {"Out": 1}, {}, ("Out",), ()),
    "dropout": ("dropout", {"X": [_f(4, 5)]}, {"Out": 1, "Mask": 1},
                {"dropout_prob": 0.0, "is_test": False,
                 "dropout_implementation": "upscale_in_train"},
                ("Out",), ()),
    "layer_norm": ("layer_norm",
                   {"X": [_f(2, 3, 8)], "Scale": [_f(8)], "Bias": [_f(8)]},
                   {"Y": 1, "Mean": 1, "Variance": 1},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, ("Y",), ()),
    "batch_norm": ("batch_norm",
                   {"X": [_f(4, 3, 5, 5)], "Scale": [_f(3)],
                    "Bias": [_f(3)], "Mean": [_f(3)],
                    "Variance": [("pos", (3,))]},
                   {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
                    "SavedVariance": 1},
                   {"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
                    "use_global_stats": False}, ("Y",),
                   ("Mean", "Variance")),
    "conv2d": ("conv2d", {"Input": [_f(2, 3, 8, 8)],
                          "Filter": [_f(4, 3, 3, 3)]}, {"Output": 1},
               {"strides": [1, 1], "paddings": [1, 1],
                "dilations": [1, 1], "groups": 1}, ("Output",), ()),
    "pool2d_max": ("pool2d", {"X": [_f(2, 3, 8, 8)]}, {"Out": 1},
                   {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2], "paddings": [0, 0],
                    "global_pooling": False, "ceil_mode": False,
                    "exclusive": True}, ("Out",), ()),
    "pool2d_avg": ("pool2d", {"X": [_f(2, 3, 8, 8)]}, {"Out": 1},
                   {"pooling_type": "avg", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1],
                    "global_pooling": False, "ceil_mode": False,
                    "exclusive": True}, ("Out",), ()),
    "lookup_table_sparse": ("lookup_table",
                            {"W": [_f(10, 4)], "Ids": [("ids", (3, 4, 1))]},
                            {"Out": 1}, {"padding_idx": 2, "is_sparse": True},
                            ("Out",), ("Ids",)),
    "lookup_table_dense": ("lookup_table",
                           {"W": [_f(10, 4)], "Ids": [("ids", (3, 4, 1))]},
                           {"Out": 1}, {"padding_idx": 2, "is_sparse": True},
                           ("Out",), ("Ids",)),
    "fused_embedding_seq_pool_sparse": (
        "fused_embedding_seq_pool",
        {"W": [_f(10, 4)], "Ids": [("ids", (3, 5))],
         "SeqLens": [_lens(5, 2, 0)]}, {"Out": 1}, {}, ("Out",),
        ("Ids", "SeqLens")),
    "fused_embedding_seq_pool_dense": (
        "fused_embedding_seq_pool",
        {"W": [_f(10, 4)], "Ids": [("ids", (3, 5))],
         "SeqLens": [_lens(5, 2, 0)]}, {"Out": 1}, {}, ("Out",),
        ("Ids", "SeqLens")),
    "sequence_pool_max": ("sequence_pool",
                          {"X": [_f(3, 5, 4)], "SeqLens": [_lens(5, 3, 1)]},
                          {"Out": 1, "MaxIndex": 1}, {"pooltype": "MAX"},
                          ("Out",), ("SeqLens",)),
    "sequence_pool_sqrt": ("sequence_pool",
                           {"X": [_f(3, 5, 4)], "SeqLens": [_lens(5, 3, 1)]},
                           {"Out": 1}, {"pooltype": "SQRT"}, ("Out",),
                           ("SeqLens",)),
    "dynamic_lstm": ("dynamic_lstm",
                     {"Input": [_f(3, 5, 16)], "Weight": [_f(4, 16)],
                      "Bias": [_f(1, 28)], "SeqLens": [_lens(5, 3, 2)]},
                     {"Hidden": 1, "Cell": 1, "LastHidden": 1,
                      "LastCell": 1}, _LSTM_ATTRS, ("Hidden",),
                     ("SeqLens",)),
    "dynamic_gru": ("dynamic_gru",
                    {"Input": [_f(3, 5, 12)], "Weight": [_f(4, 12)],
                     "Bias": [_f(1, 12)], "H0": [_f(3, 4)]},
                    {"Hidden": 1, "LastHidden": 1}, _GRU_ATTRS,
                    ("Hidden", "LastHidden"), ()),
    "fused_attention_block": (
        "fused_attention_block",
        {"Xq": [_f(2, 4, 8)], "Xkv": [_f(2, 6, 8)], "Wq": [_w(8, 8)],
         "Wk": [_w(8, 8)], "Wv": [_w(8, 8)], "Wo": [_w(8, 8)]},
        {"Out": 1}, {"n_head": 2, "causal": False, "dropout_prob": 0.0},
        ("Out",), ()),
    "fused_linear_ce": ("fused_linear_ce",
                        {"X": [_f(6, 8)], "W": [_f(8, 11)],
                         "Label": [("labels", (6, 1))]}, {"Loss": 1},
                        {"ignore_index": -100, "label_smoothing": 0.1},
                        ("Loss",), ("Label",)),
}


def _make(spec, rng):
    kind = spec[0]
    if kind == "f":
        return rng.randn(*spec[1]).astype(np.float32)
    if kind == "w":
        return (rng.randn(*spec[1]) / np.sqrt(spec[1][0])).astype(np.float32)
    if kind == "pos":
        return (np.abs(rng.randn(*spec[1])) + 0.5).astype(np.float32)
    if kind == "prob":
        z = np.exp(rng.randn(*spec[1]))
        return (z / z.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "bits":
        return rng.randint(0, 2, spec[1]).astype(np.float32)
    if kind == "i":
        return rng.randint(0, spec[2], spec[1]).astype(spec[3])
    if kind == "ids":        # duplicates, and the padding row 2
        ids = rng.randint(0, 10, spec[1]).astype(np.int64)
        ids.flat[[0, 3]] = 2
        ids.flat[[1, 4]] = 7
        return ids
    if kind == "labels":     # one ignored row
        lab = rng.randint(0, 11, spec[1]).astype(np.int32)
        lab.flat[2] = -100
        return lab
    if kind == "lens":
        return spec[1]
    raise ValueError(kind)


def _vjp_attrs_and_ins(case, rng):
    op_type, ins_spec, outs, attrs, og_slots, nodiff = CASES[case]
    fwd = jir.OpDesc(
        type=op_type,
        inputs={s: [f"{s}{k}" for k in range(len(v))]
                for s, v in ins_spec.items()},
        outputs={s: [f"{s}_out{k}" for k in range(n)]
                 for s, n in outs.items()},
        attrs=attrs)
    arrays = {s: [_make(sp, rng) for sp in v] for s, v in ins_spec.items()}
    in_layout = jgrad._slot_layout(fwd.inputs)
    flat_in = jgrad._flatten(arrays, in_layout)
    in_mask = [slot not in nodiff for slot, n in in_layout for _ in range(n)]
    out_layout = jgrad._slot_layout(fwd.outputs)
    og_mask = [slot in og_slots for slot, n in out_layout for _ in range(n)]
    # the forward's output shapes, for the cotangents
    fwd_outs = jax.eval_shape(
        lambda a: jreg.get_op(op_type).emit(_jax_ctx(), a, attrs),
        {s: [jnp.asarray(a) for a in v] for s, v in arrays.items()})
    ograds = [np.asarray(rng.randn(*fwd_outs[slot][0].shape), np.float32)
              for slot, n in out_layout for _ in range(n)
              if slot in og_slots]
    vattrs = {"fwd_op": fwd.to_dict(), "fwd_op_index": 0,
              "in_grad_mask": in_mask, "out_grad_mask": og_mask}
    return vattrs, flat_in, ograds


def _jax_ctx():
    return jreg.EmitContext(base_key=jax.random.key(0))


def _jax_vjp(vattrs, flat_in, ograds):
    """The JAX emitter's InGrad, under one jit (one compile a case)."""
    return jax.jit(lambda fi, og: jgrad._vjp_emit(
        _jax_ctx(), {"FwdIn": list(fi), "OutGrad": list(og)},
        vattrs)["InGrad"])(
        [jnp.asarray(a) for a in flat_in], [jnp.asarray(g) for g in ograds])


@pytest.fixture
def sparse_grads(request):
    """Set ``disable_sparse_grad`` on both sides for a ``_dense`` case."""
    dense = request.node.callspec.params["case"].endswith("_dense")
    jflags.set("disable_sparse_grad", dense)
    tflags.set("disable_sparse_grad", dense)
    yield not dense
    jflags.reset("disable_sparse_grad")
    tflags.reset("disable_sparse_grad")


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_jax(case, sparse_grads):
    rng = np.random.RandomState(sorted(CASES).index(case))
    vattrs, flat_in, ograds = _vjp_attrs_and_ins(case, rng)
    want = _jax_vjp(vattrs, flat_in, ograds)
    tout = tgrad._vjp_emit(
        treg.EmitContext(), {"FwdIn": [torch.from_numpy(a.copy())
                                       for a in flat_in],
                             "OutGrad": [torch.from_numpy(g)
                                         for g in ograds]}, vattrs)
    got = tout["InGrad"]
    assert len(got) == len(want) == sum(vattrs["in_grad_mask"])
    lookup = CASES[case][0] in tgrad.SPARSE_EMB_OPS
    for k, (w, g) in enumerate(zip(want, got)):
        assert tsr.is_sparse(g) == (lookup and sparse_grads)
        assert jsr.is_sparse(w) == tsr.is_sparse(g)
        w = np.asarray(w.densify() if jsr.is_sparse(w) else w)
        g = tsr.densify(g).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape)
        np.testing.assert_allclose(g, w, err_msg=f"InGrad[{k}]", **TOL)
    if lookup:      # the padding row's gradient is dropped
        np.testing.assert_array_equal(tsr.densify(got[0])[2].numpy(), 0) \
            if CASES[case][0] == "lookup_table" else None


def test_vjp_zero_gradient_for_an_unreached_input():
    """An input that reaches no output with a gradient gets zeros: the
    Softmax output of softmax_with_cross_entropy alone takes no Label
    gradient, and a Loss-less cotangent gives Logits zeros."""
    rng = np.random.RandomState(5)
    vattrs, flat_in, _ = _vjp_attrs_and_ins("softmax_with_cross_entropy",
                                            rng)
    vattrs = dict(vattrs, out_grad_mask=[False, True])
    g = rng.randn(4, 5).astype(np.float32)
    want = _jax_vjp(vattrs, flat_in, [g])
    tout = tgrad._vjp_emit(
        treg.EmitContext(),
        {"FwdIn": [torch.from_numpy(a) for a in flat_in],
         "OutGrad": [torch.from_numpy(g)]}, vattrs)
    np.testing.assert_allclose(tout["InGrad"][0].numpy(),
                               np.asarray(want[0]), **TOL)
    # a mean whose input reaches it through an output with no cotangent
    vattrs, flat_in, _ = _vjp_attrs_and_ins("dropout", rng)
    vattrs = dict(vattrs, out_grad_mask=[True, False])   # Mask only
    tout = tgrad._vjp_emit(
        treg.EmitContext(), {"FwdIn": [torch.from_numpy(flat_in[0])],
                             "OutGrad": [torch.ones(4, 5)]}, vattrs)
    np.testing.assert_array_equal(tout["InGrad"][0].numpy(), 0)


def _forward_part(name):
    """The committed training program's main desc JSON cut before its
    backward: the ops before the loss gradient's ``fill_constant``, and no
    gradient variable."""
    with open(os.path.join(PROGRAMS, name, "__main__.json")) as f:
        d = json.load(f)
    block = d["blocks"][0]
    cut = next(i for i, op in enumerate(block["ops"])
               if op["type"] == "fill_constant"
               and op["outputs"]["Out"][0].endswith("@GRAD"))
    loss = block["ops"][cut]["outputs"]["Out"][0][:-len("@GRAD")]
    block["ops"] = block["ops"][:cut]
    block["vars"] = {n: v for n, v in block["vars"].items()
                     if "@GRAD" not in n}
    return json.dumps(d).encode(), loss


@pytest.mark.parametrize("name", ["transformer_tiny_train",
                                  "stacked_dynamic_lstm_tiny_train",
                                  "resnet50_train"])
def test_append_backward_desc_matches_jax(name):
    data, loss = _forward_part(name)
    jdesc = jir.ProgramDesc.parse_from_string(data)
    tdesc = tir.ProgramDesc.parse_from_string(data)
    want = jgrad.append_backward_desc(jdesc.global_block, loss)
    got = tgrad.append_backward_desc(tdesc.global_block, loss)
    assert got == want
    assert tdesc.global_block.to_dict() == jdesc.global_block.to_dict()
    assert sum(op.type == "__vjp__" for op in tdesc.global_block.ops) > 10


@pytest.mark.parametrize("op_type,attrs,kinds", [
    ("sum", {}, ("sparse", "sparse")),
    ("sum", {}, ("sparse", "dense")),
    ("scale", {"scale": 0.5, "bias": 0.0}, ("sparse",)),
    ("scale", {"scale": 0.5, "bias": 0.1}, ("sparse",)),
], ids=["sum_of_parts", "sum_mixed", "scale", "scale_with_bias"])
def test_sparse_plumbing_matches_jax(op_type, attrs, kinds):
    """``try_sparse_emit``: a sum of one table's row-sparse parts is their
    concatenation and a scale without bias scales the values, both kept
    sparse; anything else (a dense part, a bias) is left to the emitter
    over the exact densify, on both sides."""
    rng = np.random.RandomState(9)
    jx, tx = [], []
    for kind in kinds:
        if kind == "dense":
            a = rng.randn(10, 4).astype(np.float32)
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a))
            continue
        rows = rng.randint(0, 10, 6).astype(np.int32)
        vals = rng.randn(6, 4).astype(np.float32)
        jx.append(jsr.RowSparseGrad(jnp.asarray(rows), jnp.asarray(vals), 10))
        tx.append(tsr.row_sparse(torch.from_numpy(rows),
                                 torch.from_numpy(vals), 10))
    want = jsr.try_sparse_emit(op_type, {"X": jx}, attrs)
    got = tsr.try_sparse_emit(op_type, {"X": tx}, attrs)
    assert (got is None) == (want is None)
    if want is None:
        return
    w, g = want["Out"][0], got["Out"][0]
    assert jsr.is_sparse(w) and tsr.is_sparse(g)
    np.testing.assert_allclose(tsr.densify(g).numpy(),
                               np.asarray(w.densify()), **TOL)
