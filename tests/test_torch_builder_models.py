"""The bench builders that the port's program builder adds to mnist, the
stacked LSTM and the Transformer (``paddle_tpu_torch/fluid/models``:
``smallnet``, ``alexnet``, ``vgg``, ``resnet``, ``se_resnext``,
``googlenet``, ``deepfm``, ``machine_translation``) against the JAX
package's builders.

Every case builds the same program with both packages, each under a
fresh ``Program`` pair and a fresh ``unique_name.guard()``, and holds the
two main and the two startup ``ProgramDesc``s equal as JSON values (ops,
inputs, outputs, attrs, and every variable's shape, dtype and flags as
each package's shape inference wrote them). The image classifiers run at
the JAX ``build`` defaults (full width, 224 px) and a test-mode build
each; ResNet also at depths 101 and 152; deepfm at the export tool's full
and tiny arguments; machine translation, both branches, at full width
(emb / hid 512, vocab 10000, T 32) and at its defaults. Then the
committed training pairs of these models (``tests/torch_programs``) built
by the port alone, each ``build``'s signature, and ``conv2d``'s and
``batch_norm``'s parameters under ``ParamAttr``s that carry an
initializer and a regularizer.
"""

import functools
import importlib
import inspect
import json
import os

import pytest

from test_torch_program_builder import PROGRAMS, _diffs, build

NAMES = ("smallnet", "alexnet", "vgg", "resnet", "se_resnext", "googlenet",
         "deepfm", "machine_translation")
MT_FULL = dict(src_vocab=10000, tgt_vocab=10000, max_len=32, emb_dim=512,
               hid_dim=512)
DEEPFM_FULL = dict(num_fields=26, vocab_size=100000, embed_dim=16, lr=1e-3)
DEEPFM_TINY = dict(num_fields=4, vocab_size=64, embed_dim=8)

BUILDS = {
    "smallnet": ("smallnet", {}),
    "smallnet_test": ("smallnet", dict(is_train=False, class_dim=5)),
    "alexnet": ("alexnet", {}),
    "alexnet_test": ("alexnet", dict(is_train=False, image_size=64)),
    "vgg": ("vgg", {}),
    "vgg_test": ("vgg", dict(is_train=False, image_size=32)),
    "resnet50": ("resnet", {}),
    "resnet101_test": ("resnet", dict(depth=101, is_train=False)),
    "resnet152_test": ("resnet", dict(depth=152, is_train=False,
                                      image_size=32, class_dim=10)),
    "se_resnext": ("se_resnext", {}),
    "se_resnext_test": ("se_resnext", dict(is_train=False,
                                           image_size=64)),
    "googlenet": ("googlenet", {}),
    "googlenet_test": ("googlenet", dict(is_train=False)),
    "deepfm": ("deepfm", DEEPFM_FULL),
    "deepfm_tiny": ("deepfm", DEEPFM_TINY),
    "deepfm_test": ("deepfm", dict(DEEPFM_TINY, is_train=False)),
    "machine_translation": ("machine_translation", MT_FULL),
    "machine_translation_infer": ("machine_translation",
                                  dict(MT_FULL, is_train=False)),
    "machine_translation_default": ("machine_translation", {}),
    "machine_translation_default_infer": ("machine_translation",
                                          dict(is_train=False)),
}


def _module(side, name):
    pkg = "paddle_tpu" if side == "jax" else "paddle_tpu_torch.fluid"
    return importlib.import_module(f"{pkg}.models.{name}")


def _build(side, case):
    model, kwargs = BUILDS[case]
    out = {}

    def fn(fluid):
        out["returned"] = _module(side, model).build(**kwargs)

    main, startup = build(side, fn)
    return main, startup, out["returned"]


@functools.lru_cache(maxsize=None)
def _jax_build(case):
    """The JAX build of ``case``, once a process."""
    main, startup, _ = _build("jax", case)
    return main, startup


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_builder_matches_jax(case):
    jmain, jstart = _jax_build(case)
    tmain, tstart, returned = _build("port", case)
    assert tmain == jmain, _diffs(tmain, jmain)
    assert tstart == jstart, _diffs(tstart, jstart)
    first, second, feeds = returned
    if BUILDS[case][1].get("is_train", True):
        assert first.name == "mean_0.tmp_0" or case.startswith("googlenet")
        assert isinstance(second, list)
    else:
        assert first.dtype in ("float32", "int32")
    assert all(name in tmain["blocks"][0]["vars"] for name in feeds)


@pytest.mark.parametrize("name,case", [
    ("resnet50_train", "resnet50"),
    ("deepfm_train", "deepfm"),
    ("deepfm_tiny_train", "deepfm_tiny"),
    ("machine_translation_train", "machine_translation"),
    ("machine_translation_tiny_train", "machine_translation_default"),
])
def test_builder_matches_committed_pair(name, case):
    """The committed training pairs, built by the port alone."""
    tmain, tstart, _ = _build("port", case)
    for got, fname in ((tmain, "__main__"), (tstart, "__startup__")):
        with open(os.path.join(PROGRAMS, name, fname + ".json")) as fh:
            want = json.load(fh)
        assert got == want, (fname, _diffs(got, want))


@pytest.mark.parametrize("name", NAMES)
def test_builder_signature_matches_jax(name):
    jmod, tmod = _module("jax", name), _module("port", name)
    assert inspect.signature(tmod.build) == inspect.signature(jmod.build)
    # the helpers a user composes from, with their JAX signatures
    for fn in ("conv_bn_layer", "shortcut", "bottleneck_block", "resnet",
               "squeeze_excitation", "se_resnext50", "inception",
               "_aux_head", "googlenet", "deepfm", "vgg16", "alexnet",
               "smallnet", "_encoder", "_dec_h0"):
        if hasattr(jmod, fn):
            assert (inspect.signature(getattr(tmod, fn))
                    == inspect.signature(getattr(jmod, fn))), fn


def _img_loss(fluid, body):
    L = fluid.layers
    img = L.data(name="img", shape=[3, 8, 8], dtype="float32")
    loss = L.mean(body(fluid, img))
    fluid.optimizer.Momentum(0.1, 0.9, regularization=fluid.regularizer.
                             L2Decay(1e-4)).minimize(loss)


def _attr(fluid, init, reg, **kw):
    return fluid.ParamAttr(initializer=init, regularizer=reg, **kw)


# conv2d's and batch_norm's parameters under ParamAttrs that carry an
# initializer and a regularizer (the builders pass such attrs to fc and
# embedding), with the optimizer's own decay beside them
PARAM_ATTRS = {
    "conv2d": lambda f, x: f.layers.conv2d(
        x, 4, 3, padding=1, act="relu",
        param_attr=_attr(f, f.initializer.Uniform(-0.2, 0.2),
                         f.regularizer.L1Decay(1e-3)),
        bias_attr=_attr(f, f.initializer.Constant(0.1),
                        f.regularizer.L2Decay(1e-2), learning_rate=0.5)),
    "conv2d_named_no_bias": lambda f, x: f.layers.conv2d(
        x, 4, 3, groups=1, bias_attr=False,
        param_attr=_attr(f, f.initializer.MSRA(), None, name="cw")),
    "batch_norm": lambda f, x: f.layers.batch_norm(
        f.layers.conv2d(x, 4, 1, bias_attr=False), act="relu",
        param_attr=_attr(f, f.initializer.Constant(0.5),
                         f.regularizer.L2Decay(1e-3)),
        bias_attr=_attr(f, f.initializer.Normal(0.0, 0.1),
                        f.regularizer.L1Decay(1e-4))),
    "batch_norm_named_stats_test": lambda f, x: f.layers.batch_norm(
        x, is_test=True, param_attr=_attr(f, None, None, name="bn_s"),
        bias_attr=_attr(f, None, None, name="bn_b", trainable=False),
        moving_mean_name="bn_m", moving_variance_name="bn_v"),
}


@pytest.mark.parametrize("case", sorted(PARAM_ATTRS))
def test_param_attr_paths_match_jax(case):
    def fn(fluid):
        _img_loss(fluid, PARAM_ATTRS[case])

    jmain, jstart = build("jax", fn)
    tmain, tstart = build("port", fn)
    assert tmain == jmain, _diffs(tmain, jmain)
    assert tstart == jstart, _diffs(tstart, jstart)
