"""The image classifiers of the PyTorch port on the card (marked ``gpu``;
they skip without one). This file imports no JAX: the card's machine has
none, so the references are the port's own CPU runs.

- An fp32 ``conv2d`` gives the same bits whichever way
  ``torch.backends.cudnn.allow_tf32`` is set, forward and backward, on an
  input whose result moves under TF32, each output within 1e-4 of an
  fp64 conv; a planted TF32 copy (``F.conv2d`` with
  ``torch.backends.cudnn.conv.fp32_precision`` "tf32") moves past it, and
  the op leaves both settings as it found them.
- Each of the seven models takes 3 steps on the card and
  on the CPU from the same weights and batches: the losses within rtol
  1e-3. mnist, smallnet, alexnet and googlenet at the CPU tests' sizes
  (28-128 px, batch 4); the models with batch norm at their build
  defaults (224 px, class_dim 1000), batch 8, lr 1e-5: at the CPU tests'
  32 px their last stages normalize 8 values a channel and two correct
  fp32 runs part by percents within 3 steps (tests/test_torch_image_train.py;
  the card against the CPU 2.2 % at resnet's third loss), and at 224 px
  with class_dim 10 and lr 1e-4 vgg's third loss parted by 1.3e-3 (the
  batch norm after its first ``fc`` normalizes 8 values a channel).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_image_gpu.py``.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.layers import Dropout
from paddle_tpu_torch.ops import nn_ops

LOSS_RTOL = 1e-3
# name: (module, build kwargs, image size, channels, batch)
MODELS = {
    "mnist": ("mnist", {}, 28, 1, 4),
    "smallnet": ("smallnet", {}, 32, 3, 4),
    "alexnet": ("alexnet", dict(class_dim=10, image_size=64), 64, 3, 4),
    "vgg": ("vgg", dict(lr=1e-5), 224, 3, 8),
    "resnet": ("resnet", dict(lr=1e-5), 224, 3, 8),
    "se_resnext": ("se_resnext", dict(lr=1e-5), 224, 3, 8),
    "googlenet": ("googlenet", dict(class_dim=10, image_size=128, lr=1e-3),
                  128, 3, 4),
}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "`pytest --noconftest -m gpu`)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fp32_conv_ignores_cudnn_allow_tf32(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 28, 28, generator=gen).to(cuda_device)
    w = (torch.randn(64, 64, 3, 3, generator=gen) * 0.05).to(cuda_device)
    cot = torch.randn(8, 64, 28, 28, generator=gen).to(cuda_device)
    saved = torch.backends.cudnn.allow_tf32
    precision = torch.backends.cudnn.conv.fp32_precision
    deterministic = torch.backends.cudnn.deterministic
    runs = {}
    try:
        # cuDNN's default data-gradient algorithm sums with atomics: two
        # runs under one setting part in the last bits; bit-equality asks
        # for its deterministic algorithms
        torch.backends.cudnn.deterministic = True
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            before = torch.backends.cudnn.conv.fp32_precision
            xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = nn_ops.conv2d(xt, wt, 1, 1)
            out.backward(cot)
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.backends.cudnn.conv.fp32_precision == before
            runs[flag] = (out.detach(), xt.grad, wt.grad)
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        planted = F.conv2d(x, w, None, 1, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        torch.backends.cudnn.conv.fp32_precision = precision
        torch.backends.cudnn.deterministic = deterministic
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b)
    xd, wd = (t.double().cpu().requires_grad_() for t in (x, w))
    exact = F.conv2d(xd, wd, None, 1, 1)
    exact.backward(cot.double().cpu())
    for got, want in zip(runs[True], (exact.detach(), xd.grad, wd.grad)):
        err = float((got.double().cpu() - want).abs().max()
                    / want.abs().max())
        assert err < 1e-4, err            # fp32: 2e-7 to 1.1e-5
    err = float((planted.double().cpu() - exact.detach()).abs().max()
                / exact.detach().abs().max())
    assert err > 1e-4, err                # TF32: 3.3e-4


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
def test_classifier_losses_on_the_card_match_the_cpu(cuda_device, name):
    module, kw, size, channels, batch = MODELS[name]
    mod = importlib.import_module(f"paddle_tpu_torch.models.{module}")
    rng = np.random.RandomState(0)
    classes = kw.get("class_dim", 10 if size < 224 else 1000)
    feeds = [(rng.rand(batch, channels, size, size).astype(np.float32),
              rng.randint(0, classes, (batch, 1)).astype(np.int64))
             for _ in range(3)]
    state = None
    curves = {}
    for dev in ("cpu", cuda_device):
        model, opt, _ = mod.build(device=dev, **kw)
        if state is None:
            state = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        curve = []
        for x, y in feeds:
            opt.zero_grad(set_to_none=True)
            loss, _ = model(torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
            loss.backward()
            opt.step()
            curve.append(float(loss.detach()))
        curves[str(dev)[:4]] = curve
    assert all(np.isfinite(curves["cuda"]))
    np.testing.assert_allclose(curves["cuda"], curves["cpu"],
                               rtol=LOSS_RTOL)
