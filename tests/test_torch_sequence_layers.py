"""The sequence, recurrent and beam layers of the port (``paddle_tpu_torch/
fluid/layers/{sequence,rnn,nn,tensor}.py``, ``fluid/nets.py``) and the
emitters under them (``ops/sequence_ops.py``, ``ops/lod_ops.py``
``sequence_scatter`` / ``lstmp``, ``ops/rnn_ops.py`` ``lstm_unit`` /
``gru_unit``, ``ops/math_ops.py`` ``split``, ``ops/beam_ops.py``) against
the JAX package's.

- Layers: each builds the same main and startup ``ProgramDesc`` with both
  packages (ops, attrs, names, and each output's shape and dtype as each
  package's shape inference wrote it: the port's emitters over meta
  tensors).
- Emitters: each port emitter and the JAX emitter on the same seeded
  numpy inputs, with ragged ``SeqLens`` that hold 0 and T. Integer
  outputs, ``sequence_erase``, ``edit_distance``, ``beam_search`` and
  ``beam_search_decode`` exactly; float outputs at rtol 1e-5 / atol
  1e-6.
- ``__vjp__`` of each differentiable new op against the JAX ``__vjp__``
  at rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid  # noqa: F401  (registers the JAX ops)
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.ops import grad_ops as jgrad

from paddle_tpu_torch.core import lowering as _tlow  # noqa: F401 (emitters)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import grad_ops as tgrad
from paddle_tpu_torch.ops import sequence_ops as tseq

from test_torch_program_builder import assert_same_build, build

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


# -- the layers ---------------------------------------------------------------

def _x(L, shape, dtype="float32", name="x"):
    return L.data(name=name, shape=list(shape), dtype=dtype)


def _lens(L, name="lens"):
    return L.data(name=name, shape=[], dtype="int32")


def _seq_erase(f, L):
    return L.sequence_erase(_x(L, (7,), "int64"), tokens=[2, 5],
                            seq_lens=_lens(L))


def _beam_search(f, L):
    pre_ids = _x(L, (4,), "int32", "pre_ids")
    pre_scores = _x(L, (4,), name="pre_scores")
    scores = _x(L, (4, 11), name="scores")
    ids, sc, parent = L.beam_search(pre_ids, pre_scores, scores, 4, 0)
    seq_ids = _x(L, (2, 4), "int32", "seq_ids")
    seq_par = _x(L, (2, 4), "int32", "seq_par")
    return L.beam_search_decode(seq_ids, seq_par, sc, end_id=0)


LAYERS = {
    "sequence_conv": lambda f, L: L.sequence_conv(
        _x(L, (6, 5)), 4, filter_size=3, act="tanh", seq_lens=_lens(L)),
    "sequence_conv_len4_no_bias": lambda f, L: L.sequence_conv(
        _x(L, (6, 5)), 3, filter_size=4, bias_attr=False),
    "sequence_softmax": lambda f, L: L.sequence_softmax(
        _x(L, (6,)), seq_lens=_lens(L)),
    "sequence_softmax_3d": lambda f, L: L.sequence_softmax(_x(L, (6, 1))),
    "sequence_expand": lambda f, L: L.sequence_expand(
        _x(L, (5,)), _x(L, (6, 3), name="y"), seq_lens=_lens(L)),
    "sequence_expand_as": lambda f, L: L.sequence_expand_as(
        _x(L, (5,)), _x(L, (6, 3), name="y")),
    "sequence_concat": lambda f, L: L.sequence_concat(
        [_x(L, (4, 3)), _x(L, (5, 3), name="y")],
        seq_lens=[_lens(L), _lens(L, "lens_y")]),
    "sequence_reverse": lambda f, L: L.sequence_reverse(
        _x(L, (6, 3)), seq_lens=_lens(L)),
    "sequence_slice": lambda f, L: L.sequence_slice(
        _x(L, (6, 3)), _x(L, (1,), "int32", "off"),
        _x(L, (1,), "int32", "len")),
    "sequence_erase": _seq_erase,
    "sequence_enumerate": lambda f, L: L.sequence_enumerate(
        _x(L, (7,), "int64"), win_size=3, pad_value=9, seq_lens=_lens(L)),
    "sequence_pad": lambda f, L: L.sequence_pad(
        _x(L, (6, 3)), pad_value=-1.0, maxlen=8, seq_lens=_lens(L)),
    "sequence_pad_tensor_value_cut": lambda f, L: L.sequence_pad(
        _x(L, (6, 3)), pad_value=_x(L, (), name="pv"), maxlen=4),
    "sequence_unpad": lambda f, L: L.sequence_unpad(_x(L, (6, 3)),
                                                    _lens(L)),
    "sequence_reshape": lambda f, L: L.sequence_reshape(
        _x(L, (6, 4)), new_dim=8, seq_lens=_lens(L)),
    "sequence_mask": lambda f, L: L.sequence_mask(_lens(L), maxlen=6),
    "sequence_mask_float": lambda f, L: L.sequence_mask(
        _x(L, (3,), "int32"), maxlen=4, dtype="float32"),
    "edit_distance": lambda f, L: L.edit_distance(
        _x(L, (5,), "int64", "hyp"), _x(L, (6,), "int64", "ref"),
        input_length=_lens(L, "hl"), label_length=_lens(L, "rl")),
    "edit_distance_raw": lambda f, L: L.edit_distance(
        _x(L, (5,), "int64", "hyp"), _x(L, (6,), "int64", "ref"),
        normalized=False),
    "sequence_scatter": lambda f, L: L.sequence_scatter(
        _x(L, (9,)), _x(L, (4,), "int32", "ids"), _x(L, (4,), name="upd")),
    "sequence_pool_and_steps": lambda f, L: [
        L.sequence_pool(_x(L, (6, 3)), "average", _lens(L)),
        L.sequence_first_step(_x(L, (6, 3), name="a")),
        L.sequence_last_step(_x(L, (6, 3), name="b"), _lens(L, "lb"))],
    "lstm_unit": lambda f, L: L.lstm_unit(
        _x(L, (5,)), _x(L, (4,), name="h"), _x(L, (4,), name="c"),
        forget_bias=1.0),
    "gru_unit": lambda f, L: L.gru_unit(
        _x(L, (12,)), _x(L, (4,), name="h"), 12, activation="relu"),
    "dynamic_lstmp": lambda f, L: L.dynamic_lstmp(
        _x(L, (6, 16)), 16, proj_size=3),
    "dynamic_lstmp_named": lambda f, L: L.dynamic_lstmp(
        _x(L, (6, 16)), 16, proj_size=3,
        param_attr=f.ParamAttr(name="lp"), use_peepholes=False),
    "split_num": lambda f, L: L.split(_x(L, (6, 4)), 2, dim=-1),
    "split_sections": lambda f, L: L.split(_x(L, (6, 4)), [1, 2, 3], dim=1),
    "beam_search_and_decode": _beam_search,
    "sum": lambda f, L: L.sum([_x(L, (3,)), _x(L, (3,), name="y")]),
    "sum_one": lambda f, L: L.sum(_x(L, (3,))),
    "clip_by_norm": lambda f, L: L.clip_by_norm(_x(L, (3,)), max_norm=0.5),
    "sigmoid_cross_entropy_with_logits": lambda f, L:
        L.sigmoid_cross_entropy_with_logits(_x(L, (1,)),
                                            _x(L, (1,), name="lbl")),
    "create_tensor": lambda f, L: L.create_tensor("float32", name="t",
                                                  persistable=True),
    "create_parameter": lambda f, L: L.create_parameter(
        [3, 4], "float32", name="p",
        default_initializer=f.initializer.Constant(0.5)),
    "create_parameter_attr_bias": lambda f, L: L.create_parameter(
        [4], "float32", attr=f.ParamAttr(
            initializer=f.initializer.Uniform(-0.1, 0.1)), is_bias=True),
    "create_global_var": lambda f, L: L.create_global_var(
        [2], 3.5, "float32", persistable=True, name="g"),
    "sequence_conv_pool_sqrt": lambda f, L: f.nets.sequence_conv_pool(
        _x(L, (6, 5)), 4, 3, seq_lens=_lens(L), act="tanh",
        pool_type="sqrt"),
    "sequence_conv_pool_max": lambda f, L: f.nets.sequence_conv_pool(
        _x(L, (6, 5)), 4, 4),
    "glu": lambda f, L: f.nets.glu(_x(L, (6, 4)), dim=1),
    "scaled_dot_product_attention": lambda f, L:
        f.nets.scaled_dot_product_attention(
            _x(L, (5, 8), name="q"), _x(L, (6, 8), name="k"),
            _x(L, (6, 8), name="v"), num_heads=2, dropout_rate=0.1),
    "scaled_dot_product_attention_one_head": lambda f, L:
        f.nets.scaled_dot_product_attention(
            _x(L, (5, 8), name="q"), _x(L, (6, 8), name="k"),
            _x(L, (6, 8), name="v")),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    assert_same_build(lambda fluid: LAYERS[case](fluid, fluid.layers))


def test_composed_attention_stays_off_the_flash_kernels():
    main, _ = build("port", lambda fluid: LAYERS[
        "scaled_dot_product_attention"](fluid, fluid.layers))
    types = [op["type"] for op in main["blocks"][0]["ops"]]
    assert "fused_attention_block" not in types
    assert types.count("matmul") == 2 and "softmax" in types


def test_lstmp_weights_are_two_parameters():
    """A named ``param_attr`` gives the recurrent and the projection
    weights their own names, as the JAX layer does."""
    main, start = build("port", lambda fluid: LAYERS[
        "dynamic_lstmp_named"](fluid, fluid.layers))
    params = {n for n, v in main["blocks"][0]["vars"].items()
              if v["is_parameter"]}
    assert {"lp.weight", "lp.proj_weight"} <= params


# -- the emitters -------------------------------------------------------------

T = 6
# ragged lengths with an empty row and a full one
LENS = np.array([3, 0, T, 1], np.int32)


def _f(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _ids(r, hi, *shape, dtype=np.int64):
    return r.randint(0, hi, shape).astype(dtype)


def _beam_inputs(r):
    scores = np.log(r.dirichlet(np.ones(7), size=(3, 4))).astype(
        np.float32)
    pre_ids = _ids(r, 7, 3, 4, dtype=np.int32)
    pre_ids[0, 1] = 0                       # a finished lane (end_id 0)
    pre_scores = _f(r, 3, 4)
    pre_scores[2, 1:] = -1e9                # only lane 0 live
    scores[1, 2, 3] = scores[1, 2, 4]       # a tie across tokens
    return {"PreIds": [pre_ids], "PreScores": [pre_scores],
            "Scores": [scores]}


def _decode_inputs(r):
    return {"EncOut": [_f(r, 3, 5, 8)], "H0": [_f(r, 3, 8)],
            "Emb": [_f(r, 11, 6)], "ProjW": [_f(r, 6, 24) * 0.3],
            "ProjB": [np.zeros(24, np.float32)],
            "GruW": [_f(r, 8, 24) * 0.3], "GruB": [_f(r, 1, 24) * 0.1],
            "AttnW": [_f(r, 16, 8) * 0.3], "OutW": [_f(r, 8, 11)],
            "OutB": [_f(r, 11) * 0.1]}


def _hyp_ref(r):
    hyp = _ids(r, 4, 4, 5)
    ref = _ids(r, 4, 4, 6)
    return {"Hyps": [hyp], "Refs": [ref],
            "HypsLens": [np.array([5, 0, 2, 3], np.int32)],
            "RefsLens": [np.array([6, 3, 0, 4], np.int32)]}


def _scatter_ids(r):
    ids = _ids(r, 9, 4, 5, dtype=np.int32)
    ids[1, 3:] = -1                         # padding
    ids[2, 0] = ids[2, 1]                   # a duplicate
    return ids


# case -> (op type, inputs of a RandomState, attrs, exact)
EMITTERS = {
    "sequence_mask": ("sequence_mask", lambda r: {"X": [LENS]},
                      {"maxlen": T, "out_dtype": "int64"}, True),
    "sequence_mask_float": ("sequence_mask",
                            lambda r: {"X": [LENS.reshape(2, 2)]},
                            {"maxlen": T + 2, "out_dtype": "float32"}, True),
    "sequence_softmax": ("sequence_softmax",
                         lambda r: {"X": [_f(r, 4, T)], "SeqLens": [LENS]},
                         {}, False),
    "sequence_softmax_3d": ("sequence_softmax",
                            lambda r: {"X": [_f(r, 4, T, 1)]}, {}, False),
    "sequence_expand": ("sequence_expand",
                        lambda r: {"X": [_f(r, 4, 3)], "Y": [_f(r, 4, T, 2)],
                                   "SeqLens": [LENS]}, {"ref_level": -1},
                        False),
    "sequence_expand_as": ("sequence_expand_as",
                           lambda r: {"X": [_f(r, 4, 3)],
                                      "Y": [_f(r, 4, T)]}, {}, False),
    "sequence_concat": ("sequence_concat",
                        lambda r: {"X": [_f(r, 4, T, 3), _f(r, 4, 4, 3)],
                                   "SeqLens": [LENS,
                                               np.array([2, 4, 0, 3],
                                                        np.int32)]},
                        {}, False),
    "sequence_concat_no_lens": ("sequence_concat",
                                lambda r: {"X": [_f(r, 4, 2), _f(r, 4, 3)]},
                                {}, False),
    "sequence_reverse": ("sequence_reverse",
                         lambda r: {"X": [_f(r, 4, T, 3)],
                                    "SeqLens": [LENS]}, {}, False),
    "sequence_slice": ("sequence_slice",
                       lambda r: {"X": [_f(r, 4, T, 2)],
                                  "Offset": [np.array([1, 0, 4, 5],
                                                      np.int64)],
                                  "Length": [np.array([2, 0, 3, 1],
                                                      np.int64)]},
                       {}, False),
    "sequence_erase": ("sequence_erase",
                       lambda r: {"X": [_ids(r, 5, 4, T)],
                                  "SeqLens": [LENS]},
                       {"tokens": [2, 3]}, True),
    "sequence_erase_int32_no_tokens": ("sequence_erase",
                                       lambda r: {"X": [_ids(
                                           r, 5, 4, T, dtype=np.int32)]},
                                       {"tokens": []}, True),
    "sequence_enumerate": ("sequence_enumerate",
                           lambda r: {"X": [_ids(r, 9, 4, T)],
                                      "SeqLens": [LENS]},
                           {"win_size": 3, "pad_value": 7}, True),
    "sequence_pad": ("sequence_pad",
                     lambda r: {"X": [_f(r, 4, T, 2)], "SeqLens": [LENS]},
                     {"padded_length": T + 2, "pad_value": -1.5}, False),
    "sequence_pad_cut_tensor_value": ("sequence_pad",
                                      lambda r: {"X": [_f(r, 4, T)],
                                                 "SeqLens": [LENS],
                                                 "PadValue": [_f(r, 1)]},
                                      {"padded_length": 4}, False),
    "sequence_unpad": ("sequence_unpad",
                       lambda r: {"X": [_f(r, 4, T, 2)], "Length": [LENS]},
                       {}, False),
    "sequence_reshape": ("sequence_reshape",
                         lambda r: {"X": [_f(r, 4, T, 4)],
                                    "SeqLens": [LENS]}, {"new_dim": 2},
                         False),
    "sequence_reshape_widen": ("sequence_reshape",
                               lambda r: {"X": [_f(r, 4, T, 2)]},
                               {"new_dim": 4}, False),
    "edit_distance": ("edit_distance", _hyp_ref, {"normalized": True}, True),
    "edit_distance_raw_no_lens": ("edit_distance",
                                  lambda r: {"Hyps": [_ids(r, 3, 3, 4)],
                                             "Refs": [_ids(r, 3, 3, 5)]},
                                  {"normalized": False}, True),
    "sequence_scatter": ("sequence_scatter",
                         lambda r: {"X": [_f(r, 4, 9)],
                                    "Ids": [_scatter_ids(r)],
                                    "Updates": [_f(r, 4, 5)]}, {}, False),
    "lstm_unit": ("lstm_unit",
                  lambda r: {"X": [_f(r, 3, 16)], "C_prev": [_f(r, 3, 4)]},
                  {"forget_bias": 0.5}, False),
    "gru_unit": ("gru_unit",
                 lambda r: {"Input": [_f(r, 3, 12)],
                            "HiddenPrev": [_f(r, 3, 4)],
                            "Weight": [_f(r, 4, 12)],
                            "Bias": [_f(r, 1, 12)]},
                 {"activation": "tanh", "gate_activation": "sigmoid"},
                 False),
    "gru_unit_relu_no_bias": ("gru_unit",
                              lambda r: {"Input": [_f(r, 3, 12)],
                                         "HiddenPrev": [_f(r, 3, 4)],
                                         "Weight": [_f(r, 4, 12)]},
                              {"activation": "relu"}, False),
    "lstmp": ("lstmp",
              lambda r: {"Input": [_f(r, 4, T, 16)],
                         "Weight": [_f(r, 3, 16) * 0.5],
                         "ProjWeight": [_f(r, 4, 3) * 0.5],
                         "Bias": [_f(r, 1, 28)], "SeqLens": [LENS]},
              {}, False),
    "lstmp_h0_c0": ("lstmp",
                    lambda r: {"Input": [_f(r, 2, 3, 8)],
                               "Weight": [_f(r, 2, 8)],
                               "ProjWeight": [_f(r, 2, 2)],
                               "H0": [_f(r, 2, 2)], "C0": [_f(r, 2, 2)]},
                    {}, False),
    "split_num": ("split", lambda r: {"X": [_f(r, 4, 6)]},
                  {"axis": 1, "num": 3, "sections": []}, False),
    "split_sections": ("split", lambda r: {"X": [_f(r, 5, 3)]},
                       {"axis": 0, "num": 0, "sections": [1, 3, 1]}, False),
    "beam_search": ("beam_search", _beam_inputs,
                    {"beam_size": 4, "end_id": 0}, True),
    "beam_search_decode": ("beam_search_decode",
                           lambda r: {"Ids": [_ids(r, 9, 5, 3, 4)],
                                      "ParentIdx": [_ids(r, 4, 5, 3, 4)],
                                      "Scores": [_f(r, 3, 4)]},
                           {"end_id": 0}, True),
    "attention_gru_beam_decode": ("attention_gru_beam_decode",
                                  _decode_inputs,
                                  {"beam_size": 3, "max_len": 5,
                                   "start_id": 1, "end_id": 0}, False),
}


def _inputs(case):
    return EMITTERS[case][1](np.random.RandomState(
        sorted(EMITTERS).index(case)))


def _jax_emit(op_type, ins, attrs):
    return jreg.get_op(op_type).emit(
        jreg.EmitContext(base_key=jax.random.key(0)),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)


def _canonical(dtype):
    """A port dtype as the JAX package (64-bit types off) holds it."""
    return {np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.float64): np.dtype(np.float32)}.get(dtype, dtype)


def _port_emit(op_type, ins, attrs, device=None):
    return treg.get_op(op_type).emit(
        treg.EmitContext(device=device),
        {k: [torch.from_numpy(np.array(a)) for a in v]
         for k, v in ins.items()}, attrs)


@pytest.mark.parametrize("case", sorted(EMITTERS))
def test_emitter_matches_jax(case):
    op_type, _, attrs, exact = EMITTERS[case]
    ins = _inputs(case)
    want = _jax_emit(op_type, ins, attrs)
    got = _port_emit(op_type, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for k, (w, g) in enumerate(zip(want[slot], got[slot])):
            w, g = np.asarray(w), g.numpy()
            assert g.shape == w.shape and _canonical(g.dtype) == w.dtype, (
                slot, k, g.shape, g.dtype, w.shape, w.dtype)
            if exact or not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(g, w, err_msg=f"{slot}[{k}]")
            else:
                np.testing.assert_allclose(g, w, err_msg=f"{slot}[{k}]",
                                           **FLOAT_TOL)


def test_dropped_slots_stay_out_of_the_last_row():
    """``sequence_concat`` and ``sequence_erase`` send each padding step
    to the out-of-range slot T, which the JAX scatter drops. Here every
    padding step holds a large value, the rows end before the last slot,
    and the last slot must stay 0 (a clamped index would put the padding
    there), as in the JAX result."""
    r = np.random.RandomState(7)
    a = np.full((3, 4, 2), 1e3, np.float32)
    b = np.full((3, 3, 2), 1e3, np.float32)
    la = np.array([2, 4, 0], np.int32)
    lb = np.array([1, 2, 3], np.int32)
    for k in range(3):
        a[k, :la[k]] = r.randn(la[k], 2)
        b[k, :lb[k]] = r.randn(lb[k], 2)
    ins = {"X": [a, b], "SeqLens": [la, lb]}
    want = _jax_emit("sequence_concat", ins, {})
    got = _port_emit("sequence_concat", ins, {})
    np.testing.assert_allclose(got["Out"][0].numpy(), np.asarray(
        want["Out"][0]), **FLOAT_TOL)
    assert (got["Out"][0].numpy()[[0, 2], -1] == 0).all()
    np.testing.assert_array_equal(got["NewLens"][0].numpy(), la + lb)

    ids = np.array([[7, 2, 7, 3, 9], [2, 2, 4, 9, 9]], np.int64)
    ins = {"X": [ids], "SeqLens": [np.array([5, 3], np.int32)]}
    want = _jax_emit("sequence_erase", ins, {"tokens": [2]})
    got = _port_emit("sequence_erase", ins, {"tokens": [2]})
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  [[7, 7, 3, 9, 0], [4, 0, 0, 0, 0]])


def test_sequence_mask_needs_maxlen():
    with pytest.raises(ValueError, match="maxlen"):
        tseq.sequence_mask(torch.tensor([1, 2]), -1)


def test_beam_decode_runs_on_meta_tensors():
    """Shape inference of the whole decode loop: ``max_len`` steps of the
    stable sort and the backtrack on meta tensors give the JAX shapes."""
    from paddle_tpu_torch import device
    ins = _decode_inputs(np.random.RandomState(0))
    meta = {k: [torch.empty(a.shape, dtype=torch.float32, device="meta")
                for a in v] for k, v in ins.items()}
    attrs = {"beam_size": 3, "max_len": 5, "start_id": 1, "end_id": 0}
    with device.abstract_evaluation():
        out = treg.get_op("attention_gru_beam_decode").emit(
            treg.EmitContext(device=torch.device("meta")), meta, attrs)
    assert out["SentenceIds"][0].shape == (3, 3, 5)
    assert out["SentenceIds"][0].dtype == torch.int32
    assert out["SentenceScores"][0].shape == (3, 3)


# -- __vjp__ ------------------------------------------------------------------

# case -> (emitter case, output slots with a cotangent, input slots not
#          differentiated)
VJP = {
    "sequence_softmax": ("sequence_softmax", ("Out",), ("SeqLens",)),
    "sequence_expand": ("sequence_expand", ("Out",), ("SeqLens",)),
    "sequence_concat": ("sequence_concat", ("Out",), ("SeqLens",)),
    "sequence_reverse": ("sequence_reverse", ("Y",), ("SeqLens",)),
    "sequence_slice": ("sequence_slice", ("Out",), ("Offset", "Length")),
    "sequence_pad": ("sequence_pad_cut_tensor_value", ("Out",),
                     ("SeqLens",)),
    "sequence_unpad": ("sequence_unpad", ("Out",), ("Length",)),
    "sequence_reshape": ("sequence_reshape", ("Out",), ("SeqLens",)),
    "sequence_scatter": ("sequence_scatter", ("Out",), ("Ids",)),
    "lstm_unit": ("lstm_unit", ("C", "H"), ()),
    "gru_unit": ("gru_unit", ("Hidden",), ()),
    "lstmp": ("lstmp", ("Projection", "Cell"), ("SeqLens",)),
    "split": ("split_sections", ("Out",), ()),
}


@pytest.mark.parametrize("case", sorted(VJP))
def test_vjp_matches_jax(case):
    ecase, og_slots, nodiff = VJP[case]
    op_type, _, attrs, _ = EMITTERS[ecase]
    ins = _inputs(ecase)
    outs = _jax_emit(op_type, ins, attrs)
    fwd = jir.OpDesc(
        type=op_type,
        inputs={s: [f"{s}{k}" for k in range(len(v))]
                for s, v in ins.items()},
        outputs={s: [f"{s}_out{k}" for k in range(len(v))]
                 for s, v in outs.items()},
        attrs=attrs)
    in_layout = jgrad._slot_layout(fwd.inputs)
    flat_in = jgrad._flatten(ins, in_layout)
    in_mask = [s not in nodiff for s, n in in_layout for _ in range(n)]
    out_layout = jgrad._slot_layout(fwd.outputs)
    og_mask = [s in og_slots for s, n in out_layout for _ in range(n)]
    rng = np.random.RandomState(11)
    ograds = [rng.randn(*np.shape(outs[s][k])).astype(np.float32)
              for s, n in out_layout for k in range(n) if s in og_slots]
    vattrs = {"fwd_op": fwd.to_dict(), "fwd_op_index": 0,
              "in_grad_mask": in_mask, "out_grad_mask": og_mask}
    want = jgrad._vjp_emit(
        jreg.EmitContext(base_key=jax.random.key(0)),
        {"FwdIn": [jnp.asarray(a) for a in flat_in],
         "OutGrad": [jnp.asarray(g) for g in ograds]}, vattrs)["InGrad"]
    got = tgrad._vjp_emit(
        treg.EmitContext(),
        {"FwdIn": [torch.from_numpy(np.array(a)) for a in flat_in],
         "OutGrad": [torch.from_numpy(g) for g in ograds]},
        vattrs)["InGrad"]
    assert len(got) == len(want) == sum(in_mask)
    for k, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, err_msg=f"InGrad[{k}]", **GRAD_TOL)
