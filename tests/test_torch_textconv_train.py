"""The PyTorch port's pooling slice, as a whole, against the JAX package's
executor:

- the text-conv sentiment classifier (the ``convolution_net`` of the
  PaddlePaddle book's understand_sentiment chapter; the repo trains a
  small copy in tests/test_book.py:173-209): a sparse ``embedding``, two
  ``nets.sequence_conv_pool`` (filter sizes 3 and 4, tanh, ``"sqrt"``
  pools), a softmax ``fc`` over both, ``cross_entropy``, ``mean`` and
  Adagrad at 0.002. Small: V 40, T 12, B 12, emb 16, and 128 filters, so
  that the JAX ``sequence_pool`` may take its Pallas kernel.
- the ``fused_embedding_seq_pool`` op program of tests/test_sparse_grad.py
  :295-337 (the op, ``mean``, Adam over its row-sparse table gradient) at
  D 128, lens 6, 3, 1, 6, 2, for 3 steps, lazy and not.

JAX side: the program under ``program_guard``, its startup run in a
fresh scope, ``Executor.run`` per step fetching the loss (and, for the
classifier, every ``<param>@GRAD`` at step 1). Each runs twice: through
the ops' composed branches (the only ones on the CPU), then with
``pk.kernel_enabled`` patched and the Pallas kernel wrapped to run in
interpret mode, a call counter as witness (``sequence_ops.py:74`` passes
``interpret=False``, so patching ``kernel_enabled`` alone would call a
compiled TPU kernel). Port side: the same model assembled from
``lookup_table(sparse=True)``, ``nets.SequenceConvPool``, ``fc``,
``cross_entropy``, ``mean`` and ``optimizer.Adagrad`` (the port has no
model module for it, as the JAX package has none), or
``lod_ops.fused_embedding_seq_pool`` and ``optimizer.Adam``, on
``device="cpu"``, with the JAX scope carried across by
``convert.textconv_params_from_jax`` / ``convert.table_from_jax``.

Tolerances: losses, step-1 gradients and the final table within rtol
1e-4 / atol 1e-6 (fp32 sums in another order, over 10 steps at most). A
loss curve that is not finite fails outright."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu.fluid as fluid
from paddle_tpu.fluid import layers
from paddle_tpu.ops import pallas as pk

from paddle_tpu_torch import nets
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.ops import lod_ops as tlod
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import embed_pool as tep
from paddle_tpu_torch.ops.kernels import seqpool as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, T, B, E, F = 40, 12, 12, 16, 128
STEPS = 10
LR = 0.002
TOL = dict(rtol=1e-4, atol=1e-6)
OP_V, OP_D, OP_STEPS = 40, 128, 3
OP_LENS = np.array([6, 3, 1, 6, 2], np.int32)
PLANTED = OP_V - 1             # live in step 1, only masked in step 2


def _finite(curve):
    if not all(np.isfinite(curve)):
        raise AssertionError(f"non-finite loss curve: {curve}")
    return curve


def _aligned(align=128, *dims):
    return all(d % align == 0 for d in dims)


def _patched(name, run):
    """``run()`` with the JAX ops' Pallas tier on: ``kernel_enabled`` by
    the alignment rule alone and ``pk.<name>`` in interpret mode, counted.
    Returns (run's result, kernel calls)."""
    enabled, kernel, calls = pk.kernel_enabled, getattr(pk, name), []

    def interpreted(*args):
        calls.append(1)
        return kernel(*args[:-1], True)
    pk.kernel_enabled = _aligned
    setattr(pk, name, interpreted)
    try:
        return run(), len(calls)
    finally:
        pk.kernel_enabled = enabled
        setattr(pk, name, kernel)


# -- the classifier -----------------------------------------------------------

def _feeds():
    """Seeded ragged batches (one full row); the label says whether most
    of a row's valid words lie in the upper half of the vocabulary."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        words = rng.randint(0, V, (B, T)).astype(np.int64)
        lens = rng.randint(1, T + 1, B).astype(np.int32)
        lens[0] = T
        valid = np.arange(T)[None, :] < lens[:, None]
        label = (2 * ((words >= V // 2) & valid).sum(1) > lens).astype(
            np.int64)[:, None]
        out.append((words, lens, label))
    return out


def _jax_classifier():
    """(initial parameters, step-1 gradients, loss curve)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = layers.data(name="words", shape=[T], dtype="int64")
        sl = layers.data(name="sl", shape=[], dtype="int32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        emb = layers.embedding(words, size=[V, E], is_sparse=True)
        pools = [fluid.nets.sequence_conv_pool(
            emb, num_filters=F, filter_size=k, seq_lens=sl, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
        pred = layers.fc(pools, size=2, act="softmax")
        loss = layers.mean(layers.cross_entropy(pred, label))
        fluid.optimizer.Adagrad(learning_rate=LR).minimize(loss)
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(8)
    for n in names:           # live biases: the JAX layer starts them at 0
        if n.startswith("sequence_conv_") and n.endswith(".b_0"):
            scope.set_var(n, (rng.randn(F) * 0.1).astype(np.float32))
    init = {n: np.array(scope.find_var(n)) for n in names}
    fetch = [loss.name] + [n + "@GRAD" for n in names]
    curve, grads = [], None
    for w, lens, lab in _feeds():
        out = exe.run(main, feed={"words": w, "sl": lens, "label": lab},
                      fetch_list=fetch, scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        if grads is None:
            grads = {n: np.asarray(g) for n, g in zip(names, out[1:])}
    return init, grads, _finite(curve)


class TextConv(nn.Module):
    """The classifier from the port's entry points; its state keys are
    those of ``convert.TEXTCONV_LAYOUT``."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(V, E))
        self.conv3, self.conv4 = (nets.SequenceConvPool(
            E, F, k, act="tanh", pool_type="sqrt", device="cpu")
            for k in (3, 4))
        self.fc_w0 = nn.Parameter(torch.zeros(F, 2))
        self.fc_w1 = nn.Parameter(torch.zeros(F, 2))
        self.fc_b = nn.Parameter(torch.zeros(2))

    def forward(self, words, lens, label):
        x = tnn.lookup_table(self.emb, words, sparse=True)
        pred = tnn.fc([self.conv3(x, lens), self.conv4(x, lens)],
                      [self.fc_w0, self.fc_w1], self.fc_b, act="softmax")
        return tnn.mean(tnn.cross_entropy(pred, label))


def _port_classifier(init):
    model = TextConv()
    model.load_state_dict(convert.textconv_params_from_jax(init))
    params = dict(model.named_parameters())
    opt = topt.Adagrad(model.parameters(), learning_rate=LR)
    curve, grads = [], None
    for feed in _feeds():
        opt.zero_grad(set_to_none=True)
        loss = model(*(torch.from_numpy(a) for a in feed))
        loss.backward()
        if grads is None:
            grads = {k: (p.grad.to_dense() if p.grad.is_sparse
                         else p.grad).numpy().copy()
                     for k, p in params.items()}
        opt.step()
        curve.append(float(loss.detach()))
    return grads, _finite(curve)


@pytest.fixture(scope="module")
def classifier_runs():
    """The JAX classifier through its composed branch and through the
    interpret-mode Pallas kernel (with the witness's count)."""
    composed = _jax_classifier()
    pallas, calls = _patched("masked_seqpool", _jax_classifier)
    return {"composed": (composed, None), "pallas": (pallas, calls)}


@pytest.mark.parametrize("branch", ["composed", "pallas"])
def test_classifier_matches_the_jax_executor(classifier_runs, branch):
    (init, want_grads, want_curve), calls = classifier_runs[branch]
    if branch == "pallas":
        # two pools a forward, traced at least once
        assert calls and calls % 2 == 0, calls
    before = dict(tsp.LAUNCHES)
    grads, curve = _port_classifier(init)
    assert tsp.LAUNCHES == before
    np.testing.assert_allclose(curve, want_curve, **TOL)
    assert curve[-1] != curve[0]
    names = convert.textconv_state_keys(init)
    assert set(names.values()) == set(grads)
    for name, g in want_grads.items():
        assert bool(np.any(g != 0)), name
        np.testing.assert_allclose(grads[names[name]], g, err_msg=name,
                                   **TOL)


def test_classifier_converter_raises_on_missing_and_unused_names(
        classifier_runs):
    init = classifier_runs["composed"][0][0]
    conv = sorted(n for n in init if n.startswith("sequence_conv_"))
    with pytest.raises(KeyError, match="sequence_conv"):
        convert.textconv_params_from_jax(
            {n: v for n, v in init.items() if n not in conv[:2]})
    with pytest.raises(KeyError, match="not a text-conv parameter"):
        convert.textconv_params_from_jax({**init, "layer_norm_0.w_0": 0})
    bad = dict(init)
    bad[conv[1]] = init[conv[1]][1:]        # sequence_conv_0.w_0
    with pytest.raises(ValueError, match="conv3.filter"):
        convert.textconv_params_from_jax(bad)
    shifted = {n.replace("fc_", "fc_7"): v for n, v in init.items()}
    assert set(convert.textconv_params_from_jax(shifted)) == set(
        TextConv().state_dict())


# -- the fused_embedding_seq_pool op program ----------------------------------

def _op_feeds():
    """Fresh ids a step; id PLANTED is live in step 1 and appears in step
    2 only past row 2's length (1), so lazy Adam moves it in step 2 only
    if the masked positions carry their zero gradient rows, as in JAX."""
    rng = np.random.RandomState(8)
    out = []
    for s in range(OP_STEPS):
        ids = rng.randint(0, OP_V - 1, (5, 6)).astype(np.int64)
        if s == 0:
            ids[0, 0] = PLANTED
        if s == 1:
            ids[2, 5] = PLANTED
        out.append(ids)
    return out


def _jax_op_program(lazy):
    """(initial table, loss curve, final table)."""
    from paddle_tpu.fluid.layer_helper import LayerHelper
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup):
        block = main.global_block()
        layers.data(name="ids", shape=[6], dtype="int64")
        layers.data(name="lens", shape=[1], dtype="int32")
        LayerHelper("fesp").create_parameter(
            fluid.ParamAttr(name="emb_w"), shape=[OP_V, OP_D])
        out = block.create_var(name="fesp_out", dtype="float32")
        block.append_op("fused_embedding_seq_pool",
                        inputs={"W": ["emb_w"], "Ids": ["ids"],
                                "SeqLens": ["lens"]},
                        outputs={"Out": ["fesp_out"]})
        loss = layers.mean(out)
        fluid.optimizer.Adam(learning_rate=0.05,
                             lazy_mode=lazy).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = np.array(scope.find_var("emb_w"))
    curve = [float(np.asarray(exe.run(
        main, feed={"ids": ids, "lens": OP_LENS.reshape(5, 1)},
        fetch_list=[loss], scope=scope)[0]).reshape(()))
        for ids in _op_feeds()]
    return init, _finite(curve), np.array(scope.find_var("emb_w"))


def _port_op_program(init, lazy):
    w = nn.Parameter(convert.table_from_jax({"emb_w": init}))
    opt = topt.Adam([w], learning_rate=0.05, lazy_mode=lazy)
    lens = torch.from_numpy(OP_LENS.reshape(5, 1))
    curve = []
    for ids in _op_feeds():
        opt.zero_grad(set_to_none=True)
        loss = tnn.mean(tlod.fused_embedding_seq_pool(
            w, torch.from_numpy(ids), lens))
        loss.backward()
        opt.step()
        curve.append(float(loss.detach()))
    return _finite(curve), w.detach().numpy()


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "dense"])
@pytest.mark.parametrize("branch", ["composed", "pallas"])
def test_op_program_matches_the_jax_executor(branch, lazy):
    if branch == "composed":
        (init, want_curve, want_table), calls = _jax_op_program(lazy), None
    else:
        (init, want_curve, want_table), calls = _patched(
            "fused_embed_seq_pool", lambda: _jax_op_program(lazy))
        assert calls, "the JAX run did not reach its Pallas kernel"
    before = dict(tep.LAUNCHES)
    curve, table = _port_op_program(init, lazy)
    assert tep.LAUNCHES == before
    np.testing.assert_allclose(curve, want_curve, **TOL)
    np.testing.assert_allclose(table, want_table, **TOL)
    moved = set(np.flatnonzero(np.any(table != init, axis=1)).tolist())
    live_mask = np.arange(6)[None, :] < OP_LENS[:, None]
    live = {int(i) for f in _op_feeds() for i in f[live_mask]}
    named = {int(i) for f in _op_feeds() for i in f.ravel()}
    # every row read inside a length moves; with lazy Adam no row that no
    # batch names does (a row named only past the lengths has zero moments
    # and stays too)
    assert live <= moved and PLANTED in live
    if lazy:
        assert moved <= named


def test_table_converter_takes_the_one_table():
    t = convert.table_from_jax({"emb_w": np.ones((3, 2), np.float32)})
    assert t.shape == (3, 2) and t.dtype == torch.float32
    with pytest.raises(KeyError, match="emb_w"):
        convert.table_from_jax({"emb": np.ones((3, 2))})
    with pytest.raises(ValueError, match="V, D"):
        convert.table_from_jax({"emb_w": np.ones(3)})


def test_adagrad_matches_the_jax_op():
    from op_test import run_single_op
    rng = np.random.RandomState(9)
    p, g = rng.randn(6, 4).astype(np.float32), rng.randn(6, 4).astype(
        np.float32)
    mom = rng.rand(6, 4).astype(np.float32)
    want = run_single_op(
        "adagrad", {"Param": {"p": p}, "Grad": {"g": g},
                    "Moment": {"m": mom},
                    "LearningRate": {"lr": np.array([0.01], np.float32)}},
        {"epsilon": 1e-6}, out_slots=("ParamOut", "MomentOut"))
    pt = nn.Parameter(torch.from_numpy(p.copy()))
    opt = topt.Adagrad([pt], learning_rate=0.01)
    pt.grad = torch.from_numpy(g)
    opt.state[pt]["moment"] = torch.from_numpy(mom.copy())
    opt.step()
    np.testing.assert_allclose(pt.detach().numpy(),
                               want["__out_ParamOut_0"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(opt.state[pt]["moment"].numpy(),
                               want["__out_MomentOut_0"], rtol=1e-6)
    # a sparse gradient is densified first: duplicates summed, every row's
    # moment takes g * g
    q = nn.Parameter(torch.zeros(4, 2))
    q.grad = torch.sparse_coo_tensor(torch.tensor([[1, 1, 3]]),
                                     torch.ones(3, 2), (4, 2),
                                     check_invariants=False)
    opt = topt.Adagrad([q], learning_rate=0.5)
    opt.step()
    np.testing.assert_allclose(opt.state[q]["moment"][:, 0].numpy(),
                               [0.0, 4.0, 0.0, 1.0])
    assert bool((q[0] == 0).all()) and bool((q[1] < 0).all())


def test_new_modules_import_no_jax():
    """Importing the slice's modules pulls in neither jax nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.nets\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.ops.lod_ops\n"
        "import paddle_tpu_torch.ops.sequence_ops\n"
        "import paddle_tpu_torch.ops.kernels.seqpool\n"
        "import paddle_tpu_torch.ops.kernels.embed_pool\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
