"""Saved inference models, written by the JAX package, run by the port's
executor: ``paddle_tpu_torch.fluid.io.load_inference_model`` +
``Executor(CPUPlace()).run`` against the JAX ``load_inference_model`` +
``Executor.run`` on the same directory and feeds.

Each model is a bench model's ``build`` at a small size, ``is_train=False``
under a fresh ``Program`` pair, its JAX startup program run in a fresh
scope, then saved by the JAX ``save_inference_model`` once with its single
fetch (the prediction, or the Transformer's loss) and, where the model
has an accuracy, once with ``[loss, acc]`` (ResNet-50, whose JAX compile
costs the most, once with ``[prediction, loss, acc]``):

- mnist: batch 4;
- ResNet-50 at 32 px, 10 classes (depth 50 is its ``build``'s least): batch
  2;
- the stacked LSTM: dict 50, max_len 8, emb 16, hid 16, 2 layers, ragged
  lengths, batch 4 (its JAX op takes the ``lax.scan`` branch on the CPU,
  the port the plain version of its LSTM kernel);
- the Transformer with ``fused_attention`` and ``fused_head`` (the
  ``fused_attention_block`` and ``fused_linear_ce`` ops), and its composed
  twin (``matmul``, ``transpose``, ``softmax``, ``softmax_with_cross_
  entropy``): vocab 64, max_len 8, d_model 32, d_inner 64, 2 heads, 2
  layers, batch 2; dropout is 0 in an inference build;
- deepfm: 4 fields, vocab 50 (its hidden widths are fixed at 400), batch
  8.

Each JAX program is built, saved and run once, in the one test that
uses it. Tolerances, fp32 throughout, each with its reason:
- ``TOL`` rtol 1e-5 / atol 1e-6: one fp32 forward whose sums run in
  another order on each side (XLA's dots and convs against PyTorch's);
- ``RESNET_TOL`` rtol 1e-4 / atol 1e-6: the same over 53 convolutions and
  batch norms in a chain;
- the accuracies (a count over the batch) are equal.
"""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import transformer as jtf

import paddle_tpu_torch.fluid as tfluid

TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=1e-4, atol=1e-6)
TF = dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32, d_inner=64,
          n_head=2, n_layer=2)
LSTM = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2)


def _save_jax(tmp_path, model, kwargs, fetch_sets):
    """``model.build`` at ``kwargs`` (is_train False), run its startup in
    a fresh scope and save one directory per ``(feed names, fetches)`` of
    ``fetch_sets``; a fetch is ``"loss"``, ``"acc"`` or an op type, whose
    last output in the program it is (the prediction). Returns the
    directories."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), unique_name.guard():
        loss, extra, _ = model.build(is_train=False, **kwargs)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = {"loss": loss.name, "acc": extra[0].name if extra else None}
    dirs = []
    for i, (feed_names, fetch) in enumerate(fetch_sets):
        targets = []
        for f in fetch:
            if f in names:
                targets.append(names[f])
            else:
                ops = [op for op in main.global_block().desc.ops
                       if op.type == f]
                targets.append(ops[-1].output("Out")[0])
        d = str(tmp_path / f"model{i}")
        jfluid.io.save_inference_model(d, feed_names, targets, exe,
                                       main_program=main, scope=scope)
        dirs.append(d)
    return dirs


def _run_both(d, feeds):
    """(JAX fetches, port fetches) of saved directory ``d``, each loaded
    into a scope of its own."""
    jscope, tscope = jfluid.Scope(), jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jprog, jfeeds, jfetch = jfluid.io.load_inference_model(d, jexe,
                                                           scope=jscope)
    want = jexe.run(jprog, feed={n: feeds[n] for n in jfeeds},
                    fetch_list=jfetch, scope=jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tprog, tfeeds, tfetch = tfluid.io.load_inference_model(d, texe,
                                                           scope=tscope)
    assert (tfeeds, tfetch) == (jfeeds, jfetch)
    got = texe.run(tprog, feed={n: feeds[n] for n in tfeeds},
                   fetch_list=tfetch, scope=tscope)
    return [np.asarray(w) for w in want], got


def _check(d, feeds, tol, acc_index=None):
    want, got = _run_both(d, feeds)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        if i == acc_index:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)


def _label(rng, b, classes):
    return rng.randint(0, classes, (b, 1)).astype(np.int64)


def test_mnist(tmp_path):
    rng = np.random.RandomState(0)
    feeds = {"pixel": rng.rand(4, 1, 28, 28).astype(np.float32),
             "label": _label(rng, 4, 10)}
    dirs = _save_jax(tmp_path, jmnist, {},
                     [(["pixel"], ["softmax"]),
                      (["pixel", "label"], ["loss", "acc"])])
    _check(dirs[0], feeds, TOL)
    _check(dirs[1], feeds, TOL, acc_index=1)


def test_resnet50_at_32px(tmp_path):
    rng = np.random.RandomState(1)
    feeds = {"data": rng.rand(2, 3, 32, 32).astype(np.float32),
             "label": _label(rng, 2, 10)}
    dirs = _save_jax(tmp_path, jresnet, dict(image_size=32, class_dim=10),
                     [(["data", "label"], ["softmax", "loss", "acc"])])
    _check(dirs[0], feeds, RESNET_TOL, acc_index=2)


def test_stacked_lstm(tmp_path):
    rng = np.random.RandomState(2)
    lens = np.array([8, 3, 5, 1], np.int32)
    feeds = {"words": rng.randint(0, LSTM["dict_dim"], (4, 8)).astype(
        np.int64), "seq_lens": lens, "label": _label(rng, 4, 2)}
    dirs = _save_jax(tmp_path, jlstm, LSTM,
                     [(["words", "seq_lens"], ["softmax"]),
                      (["words", "seq_lens", "label"], ["loss", "acc"])])
    _check(dirs[0], feeds, TOL)
    _check(dirs[1], feeds, TOL, acc_index=1)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused", "composed"])
def test_transformer(tmp_path, fused):
    rng = np.random.RandomState(3)
    feeds = {n: rng.randint(1, TF["src_vocab"], (2, TF["max_len"], 1))
             .astype(np.int64) for n in ("src_ids", "tgt_ids", "lbl_ids")}
    dirs = _save_jax(tmp_path, jtf, dict(TF, fused_attention=fused,
                                         fused_head=fused),
                     [(sorted(feeds), ["loss"])])
    with open(os.path.join(dirs[0], "__model__.json")) as f:
        text = f.read()
    for op in (("fused_attention_block", "fused_linear_ce") if fused
               else ("matmul", "transpose", "softmax_with_cross_entropy")):
        assert f'"type": "{op}"' in text, op
    _check(dirs[0], feeds, TOL)


def test_deepfm(tmp_path):
    rng = np.random.RandomState(4)
    feeds = {"feat_ids": rng.randint(0, 50, (8, 4, 1)).astype(np.int64),
             "label": rng.randint(0, 2, (8, 1)).astype(np.float32)}
    dirs = _save_jax(tmp_path, jdeepfm, dict(num_fields=4, vocab_size=50),
                     [(["feat_ids"], ["sigmoid"]),
                      (["feat_ids", "label"], ["loss"])])
    _check(dirs[0], feeds, TOL)
    _check(dirs[1], feeds, TOL)
