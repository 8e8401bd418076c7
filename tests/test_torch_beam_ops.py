"""The PyTorch port's beam-search ops (paddle_tpu_torch/ops/beam_ops.py)
against the JAX package's ops (paddle_tpu/ops/beam_ops.py), each run as one
op through the executor on the CPU (tests/op_test.py ``run_single_op``).

Ids, parents and sentences must be equal; scores rtol 1e-6 for one step
(one fp32 add a candidate) and 1e-5 for the whole decode (fp32 sums in
another order over the decoder's steps), with no near tie at these seeds
except the exact ties placed on purpose, which both sides break toward the
lower flat index."""

import numpy as np
import pytest
import torch

from op_test import run_single_op

from paddle_tpu_torch.ops import beam_ops as tbeam

STEP_SLOTS = ("SelectedIds", "SelectedScores", "ParentIdx")


def _jax_step(pre_ids, pre_scores, scores, beam_size, end_id):
    out = run_single_op(
        "beam_search",
        {"PreIds": {"pi": pre_ids}, "PreScores": {"ps": pre_scores},
         "Scores": {"s": scores}},
        attrs={"beam_size": beam_size, "end_id": end_id},
        out_slots=STEP_SLOTS)
    return [np.asarray(out[f"__out_{s}_0"]) for s in STEP_SLOTS]


def _port_step(pre_ids, pre_scores, scores, beam_size, end_id):
    return [t.numpy() for t in tbeam.beam_search(
        torch.from_numpy(pre_ids), torch.from_numpy(pre_scores),
        torch.from_numpy(scores), beam_size, end_id)]


@pytest.mark.parametrize("case", ["plain", "finished-lanes", "exact-ties",
                                  "first-step"])
def test_beam_step_matches_the_jax_op(case):
    rng = np.random.RandomState(0)
    b, w, v, end_id = 3, 4, 9, 0
    pre_ids = rng.randint(1, v, (b, w)).astype(np.int32)
    pre_scores = rng.randn(b, w).astype(np.float32)
    scores = np.log(rng.dirichlet(np.ones(v), (b, w))).astype(np.float32)
    if case == "finished-lanes":
        pre_ids[0, 1] = pre_ids[2, 0] = pre_ids[2, 3] = end_id
    elif case == "exact-ties":
        # every candidate on a quarter grid: many equal sums, within and
        # across lanes, and an equal pair at the selection boundary
        pre_scores = np.round(pre_scores * 4) / 4
        scores = (np.round(scores * 4) / 4).astype(np.float32)
        scores[1, 2, :] = scores[1, 0, :]
        pre_scores[1, 2] = pre_scores[1, 0]
        pre_scores = pre_scores.astype(np.float32)
    elif case == "first-step":
        pre_ids[:] = 1
        pre_scores = np.full((b, w), -1e9, np.float32)
        pre_scores[:, 0] = 0.0
    want = _jax_step(pre_ids, pre_scores, scores, w, end_id)
    got = _port_step(pre_ids, pre_scores, scores, w, end_id)
    for name, g, wv in zip(STEP_SLOTS, got, want):
        if name == "SelectedScores":
            np.testing.assert_allclose(g, wv, rtol=1e-6, err_msg=name)
        else:
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, wv, err_msg=name)
    if case == "exact-ties":
        flat = (pre_scores[:, :, None] + scores).reshape(b, -1)
        assert any(len(set(row.tolist())) < row.size for row in flat)
    if case == "finished-lanes":
        # a finished lane's only candidate is end_id at its frozen score
        ids, sc, par = got
        for k in range(w):
            if pre_ids[2, par[2, k]] == end_id:
                assert ids[2, k] == end_id
                assert sc[2, k] == pre_scores[2, par[2, k]]


def test_backtrack_matches_the_jax_op():
    rng = np.random.RandomState(1)
    t, b, w = 5, 3, 4
    ids = rng.randint(0, 50, (t, b, w)).astype(np.int32)
    par = rng.randint(0, w, (t, b, w)).astype(np.int32)
    scores = rng.randn(b, w).astype(np.float32)
    out = run_single_op(
        "beam_search_decode",
        {"Ids": {"i": ids}, "ParentIdx": {"p": par},
         "Scores": {"s": scores}},
        attrs={"end_id": 0}, out_slots=("SentenceIds", "SentenceScores"))
    sent, sc = tbeam.beam_search_decode(torch.from_numpy(ids),
                                        torch.from_numpy(par),
                                        torch.from_numpy(scores))
    assert sent.dtype == torch.int32 and tuple(sent.shape) == (b, w, t)
    np.testing.assert_array_equal(sent.numpy(),
                                  out["__out_SentenceIds_0"])
    np.testing.assert_array_equal(sc.numpy(), out["__out_SentenceScores_0"])
    # the hand-built history of tests/test_beam_search.py:45-62
    hand = tbeam.backtrack(
        torch.tensor([[[5, 6]], [[7, 8]], [[9, 10]]]),
        torch.tensor([[[0, 0]], [[1, 0]], [[0, 1]]]))
    assert hand[0].tolist() == [[6, 7, 9], [5, 8, 10]]


def _decode_inputs(seed, end_bias):
    """Seeded inputs of ``attention_gru_beam_decode`` at B 5, T 6, H 16,
    E 12, V 11; ``end_bias`` is added to ``OutB[end_id]``: raised, some
    lanes finish before ``max_len``; lowered, none does."""
    rng = np.random.RandomState(seed)
    b, t, h, e, v = 5, 6, 16, 12, 11

    def n(*shape, s=0.5):
        return (rng.randn(*shape) * s).astype(np.float32)
    out_b = n(v)
    out_b[0] += end_bias
    return {"EncOut": n(b, t, h), "H0": n(b, h), "Emb": n(v, e),
            "ProjW": n(e, 3 * h), "ProjB": n(3 * h, s=0.1),
            "GruW": n(h, 3 * h), "GruB": n(1, 3 * h, s=0.1),
            "AttnW": n(2 * h, h), "OutW": n(h, v, s=1.0), "OutB": out_b}


@pytest.mark.parametrize("end_bias", [-6.0, 1.5],
                         ids=["no-early-end", "early-ends"])
def test_attention_gru_beam_decode_matches_the_jax_op(end_bias):
    ins = _decode_inputs(3, end_bias)
    attrs = {"beam_size": 3, "max_len": 6, "start_id": 1, "end_id": 0}
    out = run_single_op(
        "attention_gru_beam_decode",
        {slot: {slot.lower(): a} for slot, a in ins.items()}, attrs=attrs,
        out_slots=("SentenceIds", "SentenceScores"))
    ids, scores = tbeam.attention_gru_beam_decode(
        *(torch.from_numpy(ins[s]) for s in
          ("EncOut", "H0", "Emb", "ProjW", "ProjB", "GruW", "GruB", "AttnW",
           "OutW", "OutB")), **attrs)
    want_ids = out["__out_SentenceIds_0"]
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), out["__out_SentenceScores_0"],
                               rtol=1e-5)
    ended = ids.numpy()[:, :, :-1] == 0
    if end_bias > 0:
        # some lanes end early and then re-emit end_id to max_len
        assert ended.any() and not ended.all()
        for lane in ids.numpy().reshape(-1, 6):
            hits = np.flatnonzero(lane == 0)
            if hits.size:
                assert np.all(lane[hits[0]:] == 0)
    else:
        assert not ended.any()
