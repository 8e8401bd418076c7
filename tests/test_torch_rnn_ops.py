"""The PyTorch port's recurrent, sequence and classifier-head operators
(paddle_tpu_torch/ops/rnn_ops.py, sequence_ops.py, nn_ops.py) against the
JAX package's ops, each run as one op through the executor on the CPU
(tests/op_test.py ``run_single_op``).

Tolerances: ``dynamic_lstm`` and ``dynamic_gru`` rtol/atol 2e-6 (the JAX
package's own bound for its LSTM and GRU against their scans,
tests/test_fused_rnn_train.py: fp32 sums in XLA's order against torch's
over 6 steps); the pools, the cross entropy and
``fc`` rtol 1e-6 / atol 1e-6 (a handful of fp32 operations an element);
``accuracy`` and ``MaxIndex`` exactly."""

import numpy as np
import pytest
import torch

from op_test import run_single_op

from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops import rnn_ops as trnn
from paddle_tpu_torch.ops import sequence_ops as tseq
from paddle_tpu_torch.ops.kernels import fused_rnn as tfr

LSTM_TOL = dict(rtol=2e-6, atol=2e-6)
TOL = dict(rtol=1e-6, atol=1e-6)
LSTM_OUTS = ("Hidden", "Cell", "LastHidden", "LastCell")
B, T, H = 4, 6, 8

LSTM_CASES = {
    "peepholes": dict(peep=True),
    "no-peepholes": dict(peep=False),
    "no-peepholes-attr-7H-bias": dict(peep=True, attr_peep=False),
    "h0-c0": dict(peep=True, init=True),
    "seq-lens": dict(peep=True, lens=True),
    "h0-c0-seq-lens": dict(peep=True, init=True, lens=True),
    "reverse": dict(peep=True, lens=True, init=True, reverse=True),
    "reverse-no-peepholes": dict(peep=False, reverse=True),
    "relu-candidate": dict(peep=True, lens=True, cand="relu"),
    "identity-cell": dict(peep=False, lens=True, cell="identity"),
}


def _lstm_data(case, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, 4 * H) * 0.4).astype(np.float32)
    w = (rng.randn(H, 4 * H) * 0.2).astype(np.float32)
    bias = (rng.randn(1, (7 if case.get("peep") else 4) * H) * 0.1).astype(
        np.float32)
    h0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    lens = np.array([T, 1, 3, 5], np.int32)
    return x, w, bias, h0, c0, lens


@pytest.mark.parametrize("name", sorted(LSTM_CASES))
def test_dynamic_lstm_matches_the_jax_op(name):
    case = LSTM_CASES[name]
    x, w, bias, h0, c0, lens = _lstm_data(case)
    inputs = {"Input": {"x": x}, "Weight": {"w": w}, "Bias": {"b": bias}}
    kw = {}
    if case.get("init"):
        inputs["H0"], inputs["C0"] = {"h0": h0}, {"c0": c0}
        kw.update(h0=torch.from_numpy(h0), c0=torch.from_numpy(c0))
    if case.get("lens"):
        inputs["SeqLens"] = {"sl": lens}
        kw["seq_lens"] = torch.from_numpy(lens)
    attrs = {"use_peepholes": case.get("attr_peep", case["peep"]),
             "is_reverse": case.get("reverse", False),
             "gate_activation": "sigmoid",
             "cell_activation": case.get("cell", "tanh"),
             "candidate_activation": case.get("cand", "tanh")}
    want = run_single_op("dynamic_lstm", inputs, attrs, out_slots=LSTM_OUTS)
    before = dict(tfr.LAUNCHES)
    got = trnn.dynamic_lstm(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        use_peepholes=attrs["use_peepholes"], is_reverse=attrs["is_reverse"],
        cell_activation=attrs["cell_activation"],
        candidate_activation=attrs["candidate_activation"], **kw)
    assert tfr.LAUNCHES == before
    for slot, g in zip(LSTM_OUTS, got):
        np.testing.assert_allclose(g.numpy(), want[f"__out_{slot}_0"],
                                   err_msg=slot, **LSTM_TOL)
    if case.get("lens"):
        for b, n in enumerate(lens):
            assert torch.all(got[0][b, n:] == 0)


def test_dynamic_lstm_routes_by_the_attribute_rule(monkeypatch):
    """The default cell without reverse goes to ``fused_lstm_train``;
    reverse or another activation to the step loop."""
    calls = []
    real = tfr.fused_lstm_train
    monkeypatch.setattr(tfr, "fused_lstm_train",
                        lambda *a: calls.append(1) or real(*a))
    x, w, bias, _, _, _ = (torch.from_numpy(a) for a in
                           _lstm_data(dict(peep=True)))
    trnn.dynamic_lstm(x, w, bias)
    assert len(calls) == 1
    trnn.dynamic_lstm(x, w, bias, is_reverse=True)
    trnn.dynamic_lstm(x, w, bias, gate_activation="relu")
    trnn.dynamic_lstm(x, w, bias, cell_activation="relu")
    trnn.dynamic_lstm(x, w, bias, candidate_activation="identity")
    assert len(calls) == 1
    hidden = trnn.dynamic_lstm(x.to(torch.bfloat16), w, bias)[0]
    assert hidden.dtype == torch.float32 and len(calls) == 2


def test_dynamic_lstm_gradients_reach_every_input():
    x, w, bias, h0, c0, lens = (torch.from_numpy(a) for a in
                                _lstm_data(dict(peep=True)))
    leaves = [t.requires_grad_() for t in (x, w, bias, h0, c0)]
    outs = trnn.dynamic_lstm(x, w, bias, h0, c0, lens)
    sum((o * o).sum() for o in outs).backward()
    for t in leaves:
        assert t.grad is not None and bool((t.grad != 0).any())
    assert bool((bias.grad[:, 4 * H:] != 0).any())      # the peepholes


GRU_OUTS = ("Hidden", "LastHidden")
GRU_CASES = {
    "plain": dict(),
    "h0": dict(init=True),
    "seq-lens": dict(lens=True),
    "h0-seq-lens": dict(init=True, lens=True),
    "no-bias": dict(init=True, bias=False),
    "reverse": dict(init=True, lens=True, reverse=True),
    "relu-candidate": dict(lens=True, act="relu"),
    "identity-gates": dict(init=True, gate="identity"),
}


def _gru_data(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, 3 * H) * 0.4).astype(np.float32)
    w = (rng.randn(H, 3 * H) * 0.2).astype(np.float32)
    bias = (rng.randn(1, 3 * H) * 0.1).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    lens = np.array([T, 1, 3, 5], np.int32)
    return x, w, bias, h0, lens


@pytest.mark.parametrize("name", sorted(GRU_CASES))
def test_dynamic_gru_matches_the_jax_op(name):
    case = GRU_CASES[name]
    x, w, bias, h0, lens = _gru_data()
    inputs = {"Input": {"x": x}, "Weight": {"w": w}}
    kw = {}
    if case.get("bias", True):
        inputs["Bias"] = {"b": bias}
        kw["bias"] = torch.from_numpy(bias)
    if case.get("init"):
        inputs["H0"] = {"h0": h0}
        kw["h0"] = torch.from_numpy(h0)
    if case.get("lens"):
        inputs["SeqLens"] = {"sl": lens}
        kw["seq_lens"] = torch.from_numpy(lens)
    attrs = {"is_reverse": case.get("reverse", False),
             "gate_activation": case.get("gate", "sigmoid"),
             "activation": case.get("act", "tanh")}
    want = run_single_op("dynamic_gru", inputs, attrs, out_slots=GRU_OUTS)
    before = dict(tfr.LAUNCHES)
    got = trnn.dynamic_gru(torch.from_numpy(x), torch.from_numpy(w), **kw,
                           **attrs)
    assert tfr.LAUNCHES == before
    for slot, g in zip(GRU_OUTS, got):
        np.testing.assert_allclose(g.numpy(), want[f"__out_{slot}_0"],
                                   err_msg=slot, **LSTM_TOL)
    if case.get("lens"):
        for b, n in enumerate(lens):
            assert torch.all(got[0][b, n:] == 0)


def test_dynamic_gru_routes_by_the_attribute_rule(monkeypatch):
    """The default cell without reverse goes to ``fused_gru_train``;
    reverse or another activation to the step loop."""
    calls = []
    real = tfr.fused_gru_train
    monkeypatch.setattr(tfr, "fused_gru_train",
                        lambda *a: calls.append(1) or real(*a))
    x, w, bias, _, _ = (torch.from_numpy(a) for a in _gru_data())
    trnn.dynamic_gru(x, w, bias)
    assert len(calls) == 1
    trnn.dynamic_gru(x, w, bias, is_reverse=True)
    trnn.dynamic_gru(x, w, bias, gate_activation="relu")
    trnn.dynamic_gru(x, w, bias, activation="identity")
    assert len(calls) == 1
    hidden = trnn.dynamic_gru(x.to(torch.bfloat16), w, bias)[0]
    assert hidden.dtype == torch.float32 and len(calls) == 2


def test_dynamic_gru_gradients_reach_every_input():
    x, w, bias, h0, lens = (torch.from_numpy(a) for a in _gru_data())
    leaves = [t.requires_grad_() for t in (x, w, bias, h0)]
    outs = trnn.dynamic_gru(x, w, bias, h0, lens)
    sum((o * o).sum() for o in outs).backward()
    for t in leaves:
        assert t.grad is not None and bool((t.grad != 0).any())


def _pool_data(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(5, 7, 6).astype(np.float32)
    lens = np.array([7, 0, 3, 1, 5], np.int32)          # one empty row
    return x, lens


@pytest.mark.parametrize("with_lens", [True, False],
                         ids=["seq-lens", "full"])
@pytest.mark.parametrize("pooltype", tseq.POOL_TYPES)
def test_sequence_pool_matches_the_jax_op(pooltype, with_lens):
    # D = 6 is off the TPU lane width, so the JAX op takes its refer branch
    x, lens = _pool_data()
    inputs = {"X": {"x": x}}
    if with_lens:
        inputs["SeqLens"] = {"sl": lens}
    slots = ("Out", "MaxIndex") if pooltype == "MAX" else ("Out",)
    want = run_single_op("sequence_pool", inputs, {"pooltype": pooltype},
                         out_slots=slots)
    tl = torch.from_numpy(lens) if with_lens else None
    if pooltype == "MAX":
        got, index = tseq.sequence_pool(torch.from_numpy(x), tl, pooltype,
                                        return_max_index=True)
        assert index.dtype == torch.int32
        np.testing.assert_array_equal(index.numpy(),
                                      want["__out_MaxIndex_0"])
    else:
        got = tseq.sequence_pool(torch.from_numpy(x), tl, pooltype.lower())
    np.testing.assert_allclose(got.numpy(), want["__out_Out_0"], **TOL)
    if with_lens:
        assert torch.all(got[1] == 0)                   # the empty row


def test_sequence_pool_max_splits_its_gradient_among_ties():
    x = torch.tensor([[[1.0], [3.0], [3.0], [9.0]]], requires_grad=True)
    tseq.sequence_pool(x, torch.tensor([3]), "MAX").sum().backward()
    assert x.grad.reshape(-1).tolist() == [0.0, 0.5, 0.5, 0.0]
    with pytest.raises(ValueError, match="unknown pooltype"):
        tseq.sequence_pool(x, None, "median")
    with pytest.raises(ValueError, match="MaxIndex"):
        tseq.sequence_pool(x, None, "SUM", return_max_index=True)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy_matches_the_jax_op(soft):
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 5).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if soft:
        label = rng.dirichlet(np.ones(5), 6).astype(np.float32)
        attrs = {"soft_label": True}
    else:
        label = rng.randint(0, 5, (6, 1)).astype(np.int64)
        label[2, 0] = -100
        attrs = {"soft_label": False, "ignore_index": -100}
    want = run_single_op("cross_entropy",
                         {"X": {"x": prob}, "Label": {"l": label}}, attrs,
                         out_slots=("Y",))["__out_Y_0"]
    got = tnn.cross_entropy(torch.from_numpy(prob), torch.from_numpy(label),
                            soft_label=soft)
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if not soft:
        assert got[2, 0] == 0


def test_accuracy_matches_the_jax_op():
    rng = np.random.RandomState(3)
    prob = rng.rand(9, 4).astype(np.float32)
    label = rng.randint(0, 4, (9, 1)).astype(np.int64)
    for k in (1, 2):
        idx = np.argsort(-prob, axis=1)[:, :k].astype(np.int64)
        want = run_single_op(
            "accuracy", {"Out": {"v": np.take_along_axis(prob, idx, 1)},
                         "Indices": {"i": idx}, "Label": {"l": label}},
            out_slots=("Accuracy", "Correct", "Total"))
        acc, correct, total = tnn.accuracy(torch.from_numpy(prob),
                                           torch.from_numpy(label), k)
        np.testing.assert_array_equal(acc.numpy(),
                                      want["__out_Accuracy_0"])
        assert int(correct) == int(want["__out_Correct_0"][0])
        assert int(total) == int(want["__out_Total_0"][0]) == 9
        assert correct.dtype == total.dtype == torch.int32


@pytest.mark.parametrize("act", [None, "tanh", "softmax", "relu"])
def test_multi_input_fc_matches_the_jax_ops(act):
    """``layers.fc`` over two inputs: two ``mul`` ops, ``sum``, the bias,
    the activation, run as single ops and chained in numpy."""
    rng = np.random.RandomState(4)
    xs = [rng.randn(3, 5, 7).astype(np.float32),
          rng.randn(3, 5, 4).astype(np.float32)]
    ws = [rng.randn(7, 6).astype(np.float32),
          rng.randn(4, 6).astype(np.float32)]
    bias = rng.randn(6).astype(np.float32)
    muls = [run_single_op("mul", {"X": {"x": x}, "Y": {"y": w}},
                          {"x_num_col_dims": 2, "y_num_col_dims": 1}
                          )["__out_Out_0"] for x, w in zip(xs, ws)]
    want = run_single_op("sum", {"X": {"a": muls[0], "b": muls[1]}}
                         )["__out_Out_0"] + bias
    if act is not None:
        want = run_single_op(act, {"X": {"x": want}})["__out_Out_0"]
    got = tnn.fc([torch.from_numpy(x) for x in xs],
                 [torch.from_numpy(w) for w in ws], torch.from_numpy(bias),
                 act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="one weight per input"):
        tnn.fc([torch.from_numpy(xs[0])], torch.from_numpy(ws[0]))
    with pytest.raises(ValueError, match="unsupported activation"):
        tnn.fc(torch.from_numpy(xs[0]), torch.from_numpy(ws[0]), act="gelu")
