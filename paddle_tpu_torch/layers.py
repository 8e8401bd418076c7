"""The layers of the image classifiers (counterpart of ``conv2d``,
``batch_norm``, ``fc`` and ``dropout`` in ``paddle_tpu/fluid/layers/nn.py``):
each an ``nn.Module`` that owns the layer's parameters and calls the
port's ops (``ops/nn_ops.py``) as the JAX layer appends its ops. The
program-building layers, which append those ops to a ``Program``, are
``paddle_tpu_torch/fluid/layers``.

- :class:`Conv2D` -- ``layers.conv2d`` (``:72-98``): the ``conv2d`` op,
  then the bias [O] as an ``elementwise_add`` at axis 1 (none with
  ``bias=False``), then the activation. The filter starts N(0, (2 / (kh *
  kw * C))**0.5), C the input channels.
- :class:`BatchNorm` -- ``layers.batch_norm`` (``:161-199``): parameters
  ``scale`` (ones) and ``bias`` (zeros), buffers ``mean`` (zeros) and
  ``variance`` (ones), the JAX program's persistable running statistics.
- :class:`FC` -- ``layers.fc`` (``:20-45``) with ``num_flatten_dims=1``:
  an [N, C, H, W] input is flattened to [N, C*H*W]. The weight starts
  Xavier-uniform, or uniform in (-bound, bound) with ``bound``.
- :class:`Dropout` -- ``layers.dropout`` (``:229-240``), by default
  ``downgrade_in_infer``.

Two test modes, as in the JAX package. ``is_test`` is the op's own
attribute, fixed when the layer is made (``build(is_train=False)`` sets it
where the JAX models pass ``is_test=not is_train``); ``module.eval()`` is
the program's test mode, which ``Program.clone(for_test=True)`` sets
(``core/executor.py:236``). A layer runs in test mode when either says
so. Each layer lists in ``JAX_FAMILY`` and ``JAX_PARAMS`` the JAX names of
its state (``<family>_<k>.<suffix>``), which ``models/convert.py``
matches in creation order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.ops import nn_ops

ACTS = {None: lambda x: x, "relu": nn_ops.relu, "sigmoid": nn_ops.sigmoid,
        "tanh": torch.tanh, "softmax": nn_ops.softmax}


def activation(act):
    """The activation function named ``act`` (None: the identity)."""
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    return ACTS[act]


class Conv2D(nn.Module):
    """x [N, C, H, W] -> [N, num_filters, H', W']; ``weight`` [num_filters,
    C / groups, kh, kw], ``bias`` [num_filters]. :meth:`forward` takes the
    caller's AMP dict, which tags the ``conv2d`` and the bias add."""

    JAX_FAMILY = "conv2d"
    JAX_PARAMS = (("w_0", "weight"), ("b_0", "bias"))

    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias: bool = True, act: Optional[str] = None):
        super().__init__()
        kh, kw = nn_ops._pair(filter_size)
        self.num_channels = int(num_channels)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = int(groups)
        self.act = activation(act)
        self.weight = nn.Parameter(torch.zeros(
            num_filters, num_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(num_filters)) if bias else None
        self.reset_parameters()

    def op_sites(self):
        return ["conv2d"] + (["elementwise_add"] if self.bias is not None
                             else [])

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        kh, kw = self.weight.shape[2:]
        std = (2.0 / (kh * kw * self.num_channels)) ** 0.5
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, amp=None):
        out = nn_ops.conv2d(x, self.weight, self.stride, self.padding,
                            self.dilation, self.groups, amp)
        if self.bias is not None:
            out = nn_ops.elementwise_add(out, self.bias, amp, axis=1)
        return self.act(out)


class BatchNorm(nn.Module):
    """x [N, C, ...] -> the same shape (``nn_ops.batch_norm``), then the
    activation. In training mode it updates ``mean`` and ``variance`` in
    place; in test mode (``is_test`` or ``eval()``) it reads them."""

    JAX_FAMILY = "batch_norm"
    JAX_PARAMS = (("w_0", "scale"), ("b_0", "bias"), ("mean_0", "mean"),
                  ("var_0", "variance"))

    def __init__(self, num_channels: int, act: Optional[str] = None,
                 is_test: bool = False, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.act = activation(act)
        self.is_test = bool(is_test)
        self.momentum, self.epsilon = float(momentum), float(epsilon)
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("variance", torch.ones(num_channels))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.variance.fill_(1.0)

    def forward(self, x):
        return self.act(nn_ops.batch_norm(
            x, self.scale, self.bias, self.mean, self.variance,
            self.is_test or not self.training, self.momentum,
            self.epsilon))


class FC(nn.Module):
    """x [N, ...] -> [N, size]: ``weight`` [prod(x.shape[1:]), size],
    ``bias`` [size]. :meth:`forward` takes the caller's AMP dict, which
    tags the product (``mul``) and the bias add."""

    JAX_FAMILY = "fc"
    JAX_PARAMS = (("w_0", "weight"), ("b_0", "bias"))

    def __init__(self, in_features: int, size: int,
                 act: Optional[str] = None, bound: Optional[float] = None):
        super().__init__()
        self.act = activation(act)
        self.bound = bound
        self.weight = nn.Parameter(torch.zeros(in_features, size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.reset_parameters()

    def op_sites(self):
        return ["mul", "elementwise_add"]

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        fan_in, fan_out = self.weight.shape
        bound = self.bound if self.bound is not None \
            else (6.0 / (fan_in + fan_out)) ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()

    def forward(self, x, amp=None):
        return self.act(nn_ops.fc(x, self.weight, self.bias, amp=amp,
                                  num_flatten_dims=1))


class Dropout(nn.Module):
    """``nn_ops.dropout`` with probability ``p`` (a field that may be set,
    as parity runs set it to 0). In training mode each call draws a fresh
    int32 seed from ``generator`` (a CPU ``torch.Generator``; torch's
    default one when None)."""

    def __init__(self, p: float, is_test: bool = False,
                 implementation: str = "downgrade_in_infer",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = float(p)
        self.is_test = bool(is_test)
        self.implementation = implementation
        self.generator = generator

    def forward(self, x):
        if self.p == 0.0:                # keeps every element: x itself
            return x
        is_test = self.is_test or not self.training
        seed = 0
        if not is_test:
            gen = self.generator if self.generator is not None \
                else torch.default_generator
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        return nn_ops.dropout(x, self.p, seed, is_test, self.implementation)
