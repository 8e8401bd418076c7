"""The PyTorch port's image classifiers, as a whole, against the JAX
package's executor on the CPU: ``paddle_tpu_torch/models/{mnist,
smallnet,alexnet,vgg,resnet,se_resnext,googlenet}.py`` against
``paddle_tpu/models/*.py``.

Each model's JAX ``build`` runs under ``program_guard`` at the small sizes
of tests/test_models.py:23-70 (class_dim 10; alexnet at 64 px, vgg,
resnet and se_resnext at 32 px, googlenet at 128 px; batch 8 where batch
norm is present, so that the 1x1 last stage normalizes over 8 values, 4
elsewhere), its startup in a fresh scope, 3 steps on fresh seeded images
and labels, each fetching the loss and every ``<param>@GRAD``. Every
dropout runs at probability 0 on both sides (the JAX ops' attribute and
their ``__vjp__`` snapshots', the port's ``layers.Dropout.p``): the JAX
op draws its seed from the step key and the port from a generator, so
their masks agree only for a seed passed in directly, which
tests/test_torch_image_ops.py holds. The port's model starts from the
JAX scope (``convert.classifier_params_from_jax``: parameters and running
statistics) and takes the same steps on ``device="cpu"``.

Checks, per model: the step-1 gradients, the loss curve, every batch
norm's running mean and variance after the steps and the parameters'
moves; then the program cloned for test (``clone(for_test=True)``, pruned
to its forward, dropouts back at their built probability: in test mode
``downgrade_in_infer`` scales by 1 - p) against ``model.eval()``, the
logits of a fresh batch. For the models with batch norm also the
gradients of the test program (``build(is_train=False)`` with a backward,
cloned for test) against ``model.eval()``'s. Under pure AMP
(``rewrite_program_amp`` on both sides; ``pure=None`` picks pure for a
model with no recurrent op), smallnet and resnet: the losses, the eval
logits and the dtypes.

Why the models with batch norm are held apart. At these sizes their fp32
gradients are ill-conditioned in any implementation: vgg, resnet and
se_resnext at 32 px lie 0.6-2.8 % (relative L2 over all parameters) from
the same model run in fp64, on the port's side as on the JAX side, where
alexnet and googlenet lie 5e-7 away (the port in fp32 against fp64 on the
CPU). Batch norm over the 8 or 32 values of
a channel in the last stages turns last-digit differences into percents
(batch norm's gradient explosion at initialization), and three steps at
the builds' rates (0.1 for the ResNets) take the loss from 2.5 to 5 on
random labels. So those three train at lr 1e-5 and are held to
``CHAOTIC``; the test program, whose batch norms are affine maps on the
running statistics, is as well conditioned as a plain conv net, and its
gradients are held to ``TIGHT``.

Tolerances, each with its reason:
- ``TIGHT`` (fp32, well conditioned): the first loss rtol 1e-4, the curve
  1e-4, each gradient 1e-3 relative L2, each parameter's move over the
  steps 1e-3, the eval logits 1e-4: fp32 sums in another order. A conv
  bias ahead of a batch norm has gradient 0 in exact arithmetic and is
  held to 1e-3 of the gradient over all parameters.
- ``STEM_TOL`` 2e-2 for the first conv's gradient and move: a max pool
  follows it, and where two values of a window are equal to the last
  bits each side may route the window's gradient to another one;
  googlenet's inception pools do so everywhere, so its moves and eval
  logits are held to 5e-2 (``STATE_TOL``).
- ``CHAOTIC`` (the models with batch norm, train mode): the first loss
  rtol 1e-4, the curve 1e-2, each gradient 0.15 and all of them 0.05
  relative L2, the running statistics 0.1, the eval logits 0.05 (the
  spread of two correct fp32 runs measured above, with room).
- pure AMP: smallnet's curve rtol 2e-2 and eval logits 2e-2 relative L2;
  resnet's first loss 1e-2 and eval logits 0.1. The bf16 activations
  round at other points on each side (XLA's CPU runtime may fuse bf16
  elementwise ops and round once, its bf16 pools sum in bf16 where
  PyTorch sums in fp32), ~2**-8 of an activation; in resnet the batch
  norms carry that to 4-13 % of the later losses on either side (the
  port's AMP run lies as far from its fp32 run). The op tests hold the
  bf16 numerics op by op.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu import models as jmodels
from paddle_tpu.fluid import unique_name

from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.layers import Dropout
from paddle_tpu_torch.models import (alexnet, convert, googlenet, mnist,
                                     resnet, se_resnext, smallnet, vgg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LR_BN = 1e-5
FIRST_RTOL = 1e-4
TIGHT = dict(curve=1e-4, grad=1e-3, state=1e-3, logits=1e-4)
STEM_TOL = 2e-2
CHAOTIC = dict(curve=1e-2, grad=0.15, grads=0.05, state=0.1, logits=0.05)
# pure AMP: (losses compared, their rtol, eval logits' relative L2)
AMP_TOL = {"smallnet": (STEPS, 2e-2, 2e-2), "resnet": (1, 1e-2, 0.1)}
STATE_TOL = {"googlenet": 5e-2}
BN_STAT = re.compile(r"batch_norm_\d+\.(mean|var)_0$")

# name: (JAX module, port module, build kwargs, image size, batch)
MODELS = {
    "mnist": (jmodels.mnist, mnist, {}, 28, 4),
    "smallnet": (jmodels.smallnet, smallnet, {}, 32, 4),
    "alexnet": (jmodels.alexnet, alexnet,
                dict(class_dim=10, image_size=64), 64, 4),
    "vgg": (jmodels.vgg, vgg, dict(class_dim=10, image_size=32, lr=LR_BN),
            32, 8),
    "resnet": (jmodels.resnet, resnet,
               dict(class_dim=10, image_size=32, lr=LR_BN), 32, 8),
    "se_resnext": (jmodels.se_resnext, se_resnext,
                   dict(class_dim=10, image_size=32, lr=LR_BN), 32, 8),
    "googlenet": (jmodels.googlenet, googlenet,
                  dict(class_dim=10, image_size=128, lr=1e-3), 128, 4),
}
BN_MODELS = ("vgg", "resnet", "se_resnext")


def _feeds(name, seed, n):
    """``n`` seeded batches (images in [0, 1), labels of 10 classes)."""
    _, _, _, size, batch = MODELS[name]
    channels = 1 if name == "mnist" else 3
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, channels, size, size).astype(np.float32),
             rng.randint(0, 10, (batch, 1)).astype(np.int64))
            for _ in range(n)]


def _feed_dict(name, feed):
    return {"pixel" if name == "mnist" else "data": feed[0],
            "label": feed[1]}


def _finite(curve):
    if not all(np.isfinite(curve)):
        raise AssertionError(f"non-finite loss curve: {curve}")
    return curve


def _set_dropout(ops, probs=None):
    """Set every dropout op's probability, and its ``__vjp__`` snapshot's
    (``probs`` in op order; None: 0). Returns the probabilities before."""
    before = []
    for op in ops:
        attrs = op.attrs if op.type == "dropout" else (
            op.attrs.get("fwd_op", {}).get("attrs")
            if op.type == "__vjp__"
            and op.attrs.get("fwd_op", {}).get("type") == "dropout"
            else None)
        if attrs is not None and op.type == "dropout":
            before.append(attrs["dropout_prob"])
            attrs["dropout_prob"] = 0.0 if probs is None \
                else probs[len(before) - 1]
        elif attrs is not None:
            attrs["dropout_prob"] = 0.0
    return before


def _logits_name(main):
    """The logits the first ``softmax_with_cross_entropy`` (mnist: the
    ``cross_entropy``) reads: the main head's output."""
    for op in main.desc.global_block.ops:
        if op.type == "softmax_with_cross_entropy":
            return op.inputs["Logits"][0]
        if op.type == "cross_entropy":
            return op.inputs["X"][0]
    raise AssertionError("no loss op")


def _forward_only(program):
    """``program`` without its backward and optimizer ops: what
    ``clone(for_test=True)`` gives when taken before ``minimize``, as a
    user's test program is (one compile of the forward, not of the
    step)."""
    ops = program.desc.global_block.ops
    n = [op.type for op in ops].index("__vjp__")
    del ops[n:]
    del program.global_block().ops[n:]
    return program


def _jax_run(name, amp=False, steps=STEPS):
    """The JAX side: (initial state, step-1 gradients, loss curve, state
    after ``steps`` steps, eval logits of the program cloned for test)."""
    jmod, _, kw, _, _ = MODELS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = jmod.build(**kw)
    if amp:
        from paddle_tpu.contrib import mixed_precision as jmp
        jmp.rewrite_program_amp(main)
    probs = _set_dropout(main.desc.global_block.ops)
    main.desc.bump_version()
    block = main.global_block()
    params = [p.name for p in block.all_parameters()]
    names = params + sorted(n for n in block.vars if BN_STAT.match(n))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in names}
    fetch = [loss.name] + [n + "@GRAD" for n in params]
    curve, grads = [], None
    for feed in _feeds(name, 1, steps):
        out = exe.run(main, feed=_feed_dict(name, feed), fetch_list=fetch,
                      scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        if grads is None:
            grads = {n: np.asarray(g) for n, g in zip(params, out[1:])}
    final = {n: np.array(scope.find_var(n)) for n in names}
    test = _forward_only(main.clone(for_test=True))
    _set_dropout(test.desc.global_block.ops, probs)
    test.desc.bump_version()
    (logits,) = exe.run(test, feed=_feed_dict(name, _feeds(name, 2, 1)[0]),
                        fetch_list=[_logits_name(main)], scope=scope)
    return init, grads, _finite(curve), final, np.asarray(
        logits, np.float32)


def _port_run(name, init, amp=False, steps=STEPS):
    """The port's side of :func:`_jax_run`, from the JAX initial state."""
    _, tmod, kw, _, _ = MODELS[name]
    model, opt, specs = tmod.build(device="cpu", **kw)
    assert set(specs) == ({"pixel", "label"} if name == "mnist"
                          else {"data", "label"})
    model.load_state_dict(convert.classifier_params_from_jax(init, model))
    if amp:
        tmp.rewrite_program_amp(model)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    probs = [m.p for m in drops]
    for m in drops:
        m.p = 0.0
    params = dict(model.named_parameters())
    curve, grads = [], None
    for x, label in _feeds(name, 1, steps):
        opt.zero_grad(set_to_none=True)
        loss, acc = model(torch.from_numpy(x), torch.from_numpy(label))
        assert acc.shape == (1,)
        loss.backward()
        if grads is None:
            grads = {k: p.grad.numpy().copy() for k, p in params.items()}
        opt.step()
        curve.append(float(loss.detach()))
    final = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    model.eval()
    for m, p in zip(drops, probs):
        m.p = p
    with torch.no_grad():
        logits = model.predict(torch.from_numpy(_feeds(name, 2, 1)[0][0]))
    return model, grads, _finite(curve), final, logits.float().numpy()


def _rel(got, want):
    """The relative L2 distance of two arrays (0 against 0)."""
    den = float(np.linalg.norm(want))
    num = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    return num / den if den else num


def _stem(names):
    """The JAX name of the first conv's weight: the conv ahead of the
    first max pool, held to ``STEM_TOL`` (module docstring)."""
    return min((n for n in names if n.startswith("conv2d_")
                and n.endswith(".w_0")),
               key=lambda n: int(n.split("_")[1].split(".")[0]))


def _grads_close(names, grads, want_g, tol, label):
    """Every parameter's gradient within ``tol`` (relative L2; the stem
    conv's within ``STEM_TOL``). A conv bias ahead of a batch norm has
    gradient 0 in exact arithmetic: it is held to ``tol`` of the
    gradient's size over all parameters instead."""
    total = float(np.sqrt(sum(np.square(g).sum() for g in want_g.values())))
    stem = _stem(want_g)
    for n, g in want_g.items():
        err = float(np.linalg.norm(grads[names[n]] - g)) / max(
            float(np.linalg.norm(g)), 1e-3 * total)
        bound = max(tol, STEM_TOL) if n == stem else tol
        assert err <= bound, f"{label}: {n} gradient off by {err:.3g}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_classifier_matches_the_jax_executor(name):
    """Step-1 gradients, the 3-step curve, the state after the steps and
    the test program's logits. The models with batch norm train at lr
    1e-5 and are held to the ``CHAOTIC`` bounds (module docstring)."""
    init, want_g, want_curve, want_final, want_logits = _jax_run(name)
    model, grads, curve, final, logits = _port_run(name, init)
    tol = CHAOTIC if name in BN_MODELS else TIGHT
    np.testing.assert_allclose(curve[0], want_curve[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(curve, want_curve, rtol=tol["curve"])
    assert curve[-1] != curve[0]
    names = convert.classifier_state_keys(init, model)
    assert set(names.values()) == set(final)
    _grads_close(names, grads, want_g, tol["grad"], name)
    if name in BN_MODELS:
        keys = [names[n] for n in want_g]
        err = _rel(np.concatenate([grads[k].ravel() for k in keys]),
                   np.concatenate([want_g[n].ravel() for n in want_g]))
        assert err <= tol["grads"], f"all gradients off by {err:.3g}"
    stats = [n for n in want_final if BN_STAT.match(n)]
    assert bool(stats) == (name in BN_MODELS)
    for n, v in want_final.items():
        k = names[n]
        assert not np.array_equal(v, init[n]), f"{n} did not move"
        if name in BN_MODELS and n not in stats:
            continue             # a chaotic move; the stats are held
        err = _rel(final[k] - init[n], v - init[n])
        bound = STEM_TOL if n == _stem(want_g) \
            else STATE_TOL.get(name, tol["state"])
        assert err <= bound, f"{n} after {STEPS} steps: {err:.3g}"
    err = _rel(logits, want_logits)
    assert err <= STATE_TOL.get(name, tol["logits"]), \
        f"eval logits off by {err:.3g}"


def _test_program(name):
    """(main, startup, loss, params_grads) of ``build(is_train=False)`` with
    a backward, under a fresh ``unique_name`` guard: the names, and so the
    running statistics drawn in their sorted order, do not depend on what
    the worker built before."""
    jmod, _, kw, _, _ = MODELS[name]
    kw = {k: v for k, v in kw.items() if k != "lr"}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        loss, _, _ = jmod.build(is_train=False, **kw)
        params_grads = fluid.backward.append_backward(loss)
    return main, startup, loss, params_grads


@pytest.mark.parametrize("name", BN_MODELS)
def test_test_program_gradients_match_the_jax_program(name):
    """The gradients of the test program: ``build(is_train=False)`` with a
    backward, cloned for test, against ``model.eval()``. Every batch norm
    runs on the running statistics and every dropout scales by 1 - p, so
    the model's gradient is as well conditioned as a plain conv net's and
    is held to ``TIGHT``."""
    _, tmod, kw, _, _ = MODELS[name]
    kw = {k: v for k, v in kw.items() if k != "lr"}
    main, startup, loss, params_grads = _test_program(name)
    block = main.global_block()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in
            [p.name for p in block.all_parameters()]
            + sorted(n for n in block.vars if BN_STAT.match(n))}
    rng = np.random.RandomState(4)      # running statistics off 0 and 1
    for n in init:
        if BN_STAT.match(n):
            init[n] = (rng.rand(*init[n].shape) + 0.5).astype(np.float32) \
                if n.endswith("var_0") else \
                (0.1 * rng.randn(*init[n].shape)).astype(np.float32)
            scope.set_var(n, init[n])
    feed = _feeds(name, 3, 1)[0]
    out = exe.run(main.clone(for_test=True), feed=_feed_dict(name, feed),
                  fetch_list=[loss.name] + [g.name for _, g in params_grads],
                  scope=scope)
    model, opt, _ = tmod.build(is_train=False, device="cpu", **kw)
    assert opt is None
    model.load_state_dict(convert.classifier_params_from_jax(init, model))
    model.eval()
    loss_t, _ = model(*(torch.from_numpy(a) for a in feed))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(np.asarray(out[0])),
                               rtol=FIRST_RTOL)
    names = convert.classifier_state_keys(init, model)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = dict(zip([p.name for p, _ in params_grads],
                    (np.asarray(g) for g in out[1:])))
    _grads_close(names, grads, want, TIGHT["grad"], name)


def test_test_program_names_ignore_names_drawn_before():
    """81 ``batch_norm`` names drawn first (outside the guard) leave the
    test program's names as a fresh process builds them. Unguarded, they
    took resnet's names across ``batch_norm_99`` / ``batch_norm_100``,
    where the sorted order draws other running statistics: there
    ``batch_norm_99.w_0``'s fp32 gradient lies 1.4 % from fp64 on both
    sides, and the two sides 1.44e-3 apart by ``_grads_close``'s measure
    (7.6e-6 at the fresh names)."""
    fresh = sorted(_test_program("resnet")[0].global_block().vars)
    with unique_name.guard():
        for _ in range(81):
            unique_name.generate("batch_norm")
        drawn = sorted(_test_program("resnet")[0].global_block().vars)
    assert drawn == fresh
    assert "batch_norm_0.mean_0" in fresh


@pytest.mark.parametrize("name", sorted(AMP_TOL))
def test_pure_amp_classifier_follows_the_jax_amp_program(name):
    """``rewrite_program_amp`` on both sides (``pure=None``: pure): the
    convs and products run on bf16 operands and keep bf16 outputs, the
    batch norms take the low-precision path, the weights and their
    gradients stay fp32, and the curve and eval logits follow the JAX AMP
    program's within ``AMP_TOL`` (module docstring)."""
    from paddle_tpu_torch import layers
    steps, rtol, logits_tol = AMP_TOL[name]
    init, _, want_curve, _, want_logits = _jax_run(name, True, steps)
    model, grads, curve, _, logits = _port_run(name, init, True, steps)
    assert model.amp["conv2d"].keep_bf16 and model.amp["mul"].keep_bf16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(g.dtype == np.float32 for g in grads.values())
    x = torch.from_numpy(_feeds(name, 2, 1)[0][0])
    conv = next(m for m in model.modules() if isinstance(m, layers.Conv2D))
    with torch.no_grad():
        out = conv(x, model.amp)
        assert out.dtype == torch.bfloat16
        norms = [m for m in model.modules()
                 if isinstance(m, layers.BatchNorm)]
        if norms:
            assert norms[0](out).dtype == torch.bfloat16
    np.testing.assert_allclose(curve, want_curve, rtol=rtol)
    err = _rel(logits, want_logits)
    assert err <= logits_tol, f"eval logits off by {err:.3g}"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_op_sites_are_the_jax_forward_ops(name):
    """Each model's op sites are the JAX program's forward ops of the types
    the AMP rewrite reads, in order, and both rewrites tag as many."""
    from paddle_tpu.contrib import mixed_precision as jmp
    jmod, tmod, kw, _, _ = MODELS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        jmod.build(**kw)
    ops = list(main.desc.global_block.ops)
    types = [op.type for op in ops]
    fwd = types[:types.index("__vjp__")]
    read = set(tmp.AMP_OP_TYPES) | set(tmp.ELEMENTWISE_OPS) | set(
        tmp.RECURRENT_OPS) | {"lookup_table"}
    model, _, _ = tmod.build(device="cpu", **kw)
    assert model.op_sites() == [t for t in fwd if t in read]
    n_jax = sum(1 for t in fwd if t in jmp.AMP_OP_TYPES)
    assert tmp.rewrite_program_amp(model) == n_jax
    assert not any(t in tmp.RECURRENT_OPS for t in fwd)


def test_build_is_train_false_keeps_the_programs_own_test_flags():
    """``build(is_train=False)`` is the program as built: the batch norms
    the JAX model passes ``is_test`` read the running statistics even in
    training mode, the others (vgg's conv blocks) and the dropouts without
    ``is_test`` still train; ``eval()`` puts every one in test mode."""
    model, opt, _ = vgg.build(is_train=False, class_dim=10, image_size=32,
                              device="cpu")
    assert opt is None and model.training
    assert model.bn.is_test and not model.blocks[0].steps[0][1].is_test
    assert not model.drop.is_test
    x = torch.rand(8, 3, 32, 32)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith(("mean", "variance"))}
    model.predict(x)
    after = model.state_dict()
    assert torch.equal(after["bn.mean"], before["bn.mean"])
    assert not torch.equal(after["blocks.0.steps.0.1.mean"],
                           before["blocks.0.steps.0.1.mean"])
    model.eval()
    now = {k: v.clone() for k, v in model.state_dict().items()}
    model.predict(x)
    assert all(torch.equal(now[k], v) for k, v in
               model.state_dict().items())
    g, _, _ = googlenet.build(is_train=False, class_dim=10, image_size=128,
                              device="cpu")
    assert g.aux is None and g.drop.is_test


def test_converter_raises_on_missing_unused_and_misshapen_names():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        jmodels.smallnet.build()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    init = {p.name: np.array(scope.find_var(p.name))
            for p in main.global_block().all_parameters()}
    model, _, _ = smallnet.build(device="cpu")
    state = convert.classifier_params_from_jax(init, model)
    assert set(state) == set(model.state_dict())
    conv = sorted(n for n in init
                  if n.startswith("conv2d_") and n.endswith(".w_0"))
    with pytest.raises(KeyError, match="conv2d"):
        convert.classifier_params_from_jax(
            {n: v for n, v in init.items() if n != conv[0]}, model)
    with pytest.raises(KeyError, match="not a image-classifier"):
        convert.classifier_params_from_jax({**init, "layer_norm_0.w_0": 0},
                                           model)
    bad = dict(init)
    bad[conv[0]] = init[conv[0]][1:]
    with pytest.raises(ValueError, match="conv1.weight"):
        convert.classifier_params_from_jax(bad, model)
    vgg_model, _, _ = vgg.build(class_dim=10, image_size=32, device="cpu")
    with pytest.raises(KeyError, match="batch_norm"):
        convert.classifier_params_from_jax(init, vgg_model)


def test_new_modules_import_no_jax():
    """Importing the slice's modules pulls in neither jax nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.layers\n"
        "import paddle_tpu_torch.nets\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.models.convert\n"
        "import paddle_tpu_torch.models.classifier\n"
        "import paddle_tpu_torch.models.mnist\n"
        "import paddle_tpu_torch.models.smallnet\n"
        "import paddle_tpu_torch.models.alexnet\n"
        "import paddle_tpu_torch.models.vgg\n"
        "import paddle_tpu_torch.models.resnet\n"
        "import paddle_tpu_torch.models.se_resnext\n"
        "import paddle_tpu_torch.models.googlenet\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
