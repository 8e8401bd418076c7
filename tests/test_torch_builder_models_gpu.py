"""Programs of the rest of the bench builders, built by the port and
trained on the card (marked ``gpu``; skips without one). This file
imports no JAX: the reference is a ``CPUPlace()`` executor on the same
program from the same scope.

- The tiny machine translation (``fluid.models.machine_translation``
  at its defaults) trains 3 lazy-Adam steps: every step launches 2 GRU
  forwards and 2 GRU backwards (rows 8-9). Then its inference program
  decodes a batch in the trained scope: 1 GRU forward a run, the
  ``SentenceIds`` of the CPU's decode token for token.
- The text-conv classifier (user code: ``nets.sequence_conv_pool`` with
  ``"sqrt"`` pools, Adagrad) trains 3 steps: every step launches 2
  masked pools (row 11).

The port's own startup (``random_seed`` 24, on the CPU) initialises the
scope, copied to the card and to the CPU; losses, scores and every
persistable after the steps agree within rtol 1e-4 / atol 1e-5 (fp32,
TF32 off).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_builder_models_gpu.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.models import machine_translation as mt
from paddle_tpu_torch.ops.kernels import fused_rnn as fr
from paddle_tpu_torch.ops.kernels import seqpool as sp

TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
V, T, B, E, F = 40, 12, 12, 16, 128


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


def textconv():
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
    return {k: r.randint(2, 30, (4, 8)).astype(np.int64)
            for k in ("src", "tgt_in", "tgt_out")}


def _textconv_feed(r):
    lens = r.randint(0, T + 1, B).astype(np.int32)
    lens[:2] = (T, 0)
    return {"words": r.randint(0, V, (B, T)).astype(np.int64), "sl": lens,
            "label": r.randint(0, 2, (B, 1)).astype(np.int64)}


# case -> (the build, feeds of a RandomState, one step's launches)
CASES = {
    "machine_translation": (lambda: mt.build()[0], _mt_feed,
                            {"gru_train_fwd": 2, "gru_train_bwd": 2}),
    "textconv": (textconv, _textconv_feed, {"seqpool": 2}),
}


def _launches():
    return {k: n for m in (fr, sp) for k, n in m.LAUNCHES.items()}


def _built(fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = fn()
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
    return main, loss, names, scopes


def _train(case):
    fn, feeds_of, want = CASES[case]
    main, loss, names, scopes = _built(fn)
    rng = np.random.RandomState(7)
    exes = {"cpu": fluid.Executor(fluid.CPUPlace()),
            "cuda": fluid.Executor(fluid.CUDAPlace(0))}
    for i in range(STEPS):
        f = feeds_of(rng)
        before = _launches()
        got = exes["cuda"].run(main, feed=f, fetch_list=[loss],
                               scope=scopes["cuda"])[0]
        launched = {k: n - before[k] for k, n in _launches().items()
                    if n != before[k]}
        assert launched == want, (i, launched)
        ref = exes["cpu"].run(main, feed=f, fetch_list=[loss],
                              scope=scopes["cpu"])[0]
        np.testing.assert_allclose(got, ref, err_msg=f"loss {i}", **TOL)
    for n in names:
        np.testing.assert_allclose(scopes["cuda"].find_var(n).cpu().numpy(),
                                   scopes["cpu"].find_var(n).numpy(),
                                   err_msg=n, **TOL)
    return exes, scopes


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_built_program_on_the_card_matches_the_cpu(cuda_device, case):
    _train(case)


@pytest.mark.gpu
def test_built_decode_on_the_card_matches_the_cpu(cuda_device):
    exes, scopes = _train("machine_translation")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids, scores, _ = mt.build(is_train=False)
    src = np.random.RandomState(9).randint(2, 30, (4, 8)).astype(np.int64)
    before = _launches()
    got = exes["cuda"].run(main, feed={"src": src},
                           fetch_list=[ids, scores], scope=scopes["cuda"])
    launched = {k: n - before[k] for k, n in _launches().items()
                if n != before[k]}
    assert launched == {"gru_train_fwd": 1}, launched
    ref = exes["cpu"].run(main, feed={"src": src}, fetch_list=[ids, scores],
                          scope=scopes["cpu"])
    assert np.asarray(got[0]).shape == (4, 4, 8)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], **TOL)
