"""What the seven image classifiers share (``mnist``, ``smallnet``,
``alexnet``, ``vgg``, ``resnet``, ``se_resnext``, ``googlenet``): the
trainer's interface, the softmax cross-entropy loss and the accuracy that
their JAX ``build`` functions append, and the pooled sizes their ``fc``
layers are made for.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.ops import nn_ops


def pooled(size: int, k: int, stride: int, pad: int = 0) -> int:
    """The side of a conv or pool output: ``(size + 2 pad - k) // stride +
    1`` (the JAX ops floor)."""
    return (size + 2 * pad - k) // stride + 1


def feed_specs(image_size: int, channels: int = 3, name: str = "data"):
    return {name: ([-1, channels, image_size, image_size], "float32"),
            "label": ([-1, 1], "int64")}


class ImageClassifier(nn.Module):
    """``forward(data [N, C, H, W] float32, label [N, 1] int64)`` -> (mean
    loss, top-1 accuracy [1]): :meth:`predict`'s logits through
    ``softmax_with_cross_entropy`` and ``mean``, the accuracy of their
    softmax, as the JAX ``build`` functions append them. ``amp`` holds
    the AMP tags of each op type (empty: fp32), set by
    ``contrib.mixed_precision.rewrite_program_amp`` from ``op_sites()``;
    every op of the forward reads its own. In training mode the batch
    norms update their running statistics; ``eval()`` is the JAX program
    cloned for test (batch norms on the running statistics, dropout
    off)."""

    def __init__(self):
        super().__init__()
        self.amp = {}

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Every layer's initialization (``paddle_tpu_torch.layers``), in
        creation order, from ``generator`` (a CPU ``torch.Generator``;
        the parameters must be on the CPU)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def loss(self, logits, label):
        return nn_ops.mean(nn_ops.softmax_with_cross_entropy(logits, label))

    def forward(self, data, label):
        logits = self.predict(data)
        acc, _, _ = nn_ops.accuracy(nn_ops.softmax(logits), label)
        return self.loss(logits, label), acc
