"""Programs that the port's builders make (``paddle_tpu_torch/fluid/
models``, ``fluid/nets.py``), trained through the port's executor against
the JAX executor on the JAX package's build of the same program.

- The tiny machine translation (the builder's defaults) trains 3 lazy
  Adam steps; then its inference program (``build(is_train=False)``:
  the encoder and one ``attention_gru_beam_decode`` op) decodes a batch
  in the trained scope. ``SentenceIds`` token for token,
  ``SentenceScores`` at rtol 1e-5.
- The text-conv classifier (``tests/test_book.py:173-209``, as user code:
  a sparse ``embedding``, two ``nets.sequence_conv_pool`` with filter
  sizes 3 and 4, tanh and ``"sqrt"`` pools, a softmax ``fc``,
  ``cross_entropy``, ``mean``, Adagrad 0.002; V 40, T 12, B 12, emb 16,
  128 filters, as ``tests/test_torch_textconv_train.py``) trains 3 steps;
  Adagrad takes the table's densified row-sparse gradient on both sides.
- The tiny deepfm and smallnet train 2 steps each.

Each program is built by each package under a fresh ``Program`` pair and
``unique_name.guard()``; the JAX startup scope is carried across (the
port's initializers cannot draw the JAX bits). The loss curve at rtol
1e-4 / atol 1e-5, every persistable after the steps at rtol 1e-4 / atol
1e-6. A subprocess builds and trains the tiny machine translation and
decodes with ``paddle_tpu_torch.fluid`` alone, from the port's own
startup program, and finds neither ``jax`` nor ``paddle_tpu`` in
``sys.modules``.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import smallnet as jsmallnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.models import deepfm as tdeepfm
from paddle_tpu_torch.fluid.models import machine_translation as tmt
from paddle_tpu_torch.fluid.models import smallnet as tsmallnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
B = 4
MT_LEN, MT_VOCAB = 8, 30                 # the builder's defaults
V, T, TB, E, F = 40, 12, 12, 16, 128     # the text-conv classifier


def textconv(fluid):
    """The text-conv classifier, the same user code for both packages."""
    L = fluid.layers
    words = L.data(name="words", shape=[T], dtype="int64")
    sl = L.data(name="sl", shape=[], dtype="int32")
    label = L.data(name="label", shape=[1], dtype="int64")
    emb = L.embedding(words, size=[V, E], is_sparse=True)
    pools = [fluid.nets.sequence_conv_pool(
        emb, num_filters=F, filter_size=k, seq_lens=sl, act="tanh",
        pool_type="sqrt") for k in (3, 4)]
    pred = L.fc(pools, size=2, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    fluid.optimizer.Adagrad(learning_rate=0.002).minimize(loss)
    return loss


def _mt_feed(r):
    return {k: r.randint(2, MT_VOCAB, (B, MT_LEN)).astype(np.int64)
            for k in ("src", "tgt_in", "tgt_out")}


def _textconv_feed(r):
    words = r.randint(0, V, (TB, T)).astype(np.int64)
    lens = r.randint(0, T + 1, TB).astype(np.int32)
    lens[:2] = (T, 0)
    label = r.randint(0, 2, (TB, 1)).astype(np.int64)
    return {"words": words, "sl": lens, "label": label}


def _deepfm_feed(r):
    return {"feat_ids": r.randint(0, 64, (B, 4, 1)).astype(np.int64),
            "label": r.randint(0, 2, (B, 1)).astype(np.float32)}


def _smallnet_feed(r):
    return {"data": r.randn(B, 3, 32, 32).astype(np.float32),
            "label": r.randint(0, 10, (B, 1)).astype(np.int64)}


# case -> (build of a fluid package, steps, feeds of a RandomState)
CASES = {
    "machine_translation": (
        lambda f: (jmt if f is jfluid else tmt).build()[0], 3, _mt_feed),
    "textconv": (textconv, 3, _textconv_feed),
    "deepfm": (lambda f: (jdeepfm if f is jfluid else tdeepfm).build(
        num_fields=4, vocab_size=64, embed_dim=8)[0], 2, _deepfm_feed),
    "smallnet": (lambda f: (jsmallnet if f is jfluid else tsmallnet).build(
        )[0], 2, _smallnet_feed),
}


def _build(fluid, unique, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique.guard():
        out = fn(fluid)
    return main, startup, out


def _persistables(main):
    return sorted(n for n, v in main.desc.global_block.vars.items()
                  if v.persistable)


def _mt_infer(fluid, unique):
    return _build(fluid, unique, lambda f: (
        jmt if f is jfluid else tmt).build(is_train=False))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX build's scope before the steps, its feeds, losses and
    persistables after the steps (and, for machine translation, the
    decode of a batch in the trained scope), once a process."""
    fn, steps, feeds_of = CASES[case]
    main, startup, loss = _build(jfluid, junique, fn)
    rng = np.random.RandomState(sorted(CASES).index(case))
    feeds = [feeds_of(rng) for _ in range(steps)]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = _persistables(main)
    if case == "textconv":   # live biases: the layer starts them at 0
        for n in names:
            if n.startswith("sequence_conv_") and n.endswith(".b_0"):
                scope.set_var(n, (rng.randn(F) * 0.1).astype(np.float32))
    start = {n: np.array(scope.find_var(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=f, scope=scope,
                                       fetch_list=[loss.name])[0]))
              for f in feeds]
    after = {n: np.array(scope.find_var(n)) for n in names}
    out = dict(start=start, feeds=feeds, losses=np.asarray(losses),
               after=after, loss=loss.name)
    if case == "machine_translation":
        imain, istart, (ids, scores, _) = _mt_infer(jfluid, junique)
        out["src"] = _mt_feed(rng)["src"]
        out["decode"] = [np.asarray(a) for a in exe.run(
            imain, feed={"src": out["src"]}, scope=scope,
            fetch_list=[ids.name, scores.name])]
    return out


def _port_scope(arrays):
    s = tfluid.Scope()
    for n, a in arrays.items():
        s.set_var(n, torch.from_numpy(a.copy()))
    return s


def _port_train(case):
    ref = _jax_run(case)
    main, startup, loss = _build(tfluid, tunique, CASES[case][0])
    assert loss.name == ref["loss"]
    assert _persistables(main) == sorted(ref["start"])
    scope = _port_scope(ref["start"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]))
              for f in ref["feeds"]]
    return ref, scope, exe, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_built_program_trains_as_jax(case):
    ref, scope, _, losses = _port_train(case)
    assert np.isfinite(losses).all(), losses
    np.testing.assert_allclose(losses, ref["losses"], **CURVE_TOL)
    for n, want in ref["after"].items():
        got = scope.find_var(n).numpy()
        assert got.shape == want.shape, n
        np.testing.assert_allclose(got, want, err_msg=n, **STATE_TOL)


def test_port_beam_decode_matches_jax_in_the_trained_scope():
    ref, scope, exe, _ = _port_train("machine_translation")
    imain, _, (ids, scores, feeds) = _mt_infer(tfluid, tunique)
    assert list(feeds) == ["src"]
    got_ids, got_scores = exe.run(imain, feed={"src": ref["src"]},
                                  fetch_list=[ids, scores], scope=scope)
    want_ids, want_scores = ref["decode"]
    got_ids, got_scores = np.asarray(got_ids), np.asarray(got_scores)
    assert got_ids.shape == want_ids.shape == (B, 4, MT_LEN)
    assert got_ids.dtype == want_ids.dtype == np.int32
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)


def test_textconv_runs_two_sqrt_pools():
    """The classifier's program holds the two SQRT pools that run the
    masked pooling kernel on the card, and ``sequence_conv`` sees the
    lengths."""
    main, _, _ = _build(tfluid, tunique, textconv)
    ops = main.desc.global_block.ops
    pools = [op for op in ops if op.type == "sequence_pool"]
    assert [op.attrs["pooltype"] for op in pools] == ["SQRT", "SQRT"]
    assert all(op.input("SeqLens") == ["sl"] for op in ops
               if op.type in ("sequence_conv", "sequence_pool"))


def test_machine_translation_alone_without_jax():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch.fluid as fluid\n"
        "from paddle_tpu_torch.fluid.models import machine_translation "
        "as mt\n"
        "train, tstart = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(train, tstart), fluid.unique_name.guard():\n"
        "    loss, _, feeds = mt.build()\n"
        "infer, istart = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(infer, istart), fluid.unique_name.guard():\n"
        "    ids, scores, _ = mt.build(is_train=False)\n"
        "tstart.random_seed = 5\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "exe.run(tstart)\n"
        "r = np.random.RandomState(0)\n"
        "batch = {k: r.randint(2, 30, (4, 8)).astype(np.int64)\n"
        "         for k in ('src', 'tgt_in', 'tgt_out')}\n"
        "ls = [float(exe.run(train, feed=batch, fetch_list=[loss])[0])\n"
        "      for _ in range(2)]\n"
        "assert np.isfinite(ls).all() and ls[1] < ls[0], ls\n"
        "i, s = exe.run(infer, feed={'src': batch['src']},\n"
        "               fetch_list=[ids, scores])\n"
        "assert np.asarray(i).shape == (4, 4, 8), np.asarray(i).shape\n"
        "assert np.isfinite(np.asarray(s)).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
