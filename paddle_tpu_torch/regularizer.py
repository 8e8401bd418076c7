"""Weight-decay regularizers of the nn.Module trainers (counterpart of
``paddle_tpu/fluid/regularizer.py``; the program-building ones are
``paddle_tpu_torch/fluid/regularizer.py``).

An optimizer given ``regularization=`` adds the decay term to every
parameter's gradient before its update rule, as ``apply_gradients``
appends the regularization ops in front of the optimizer ops
(``fluid/optimizer.py:106-112``): BN scales and biases included. The
decay is added to the gradient the rule reads, not to ``p.grad``, which
keeps the gradient before decay (the JAX program's ``<param>@GRAD``).
"""

from __future__ import annotations

import torch


class L2DecayRegularizer:
    """``g + coeff * p`` (the ``scale`` and ``sum`` ops of
    ``regularizer.py:16-31``)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = float(regularization_coeff)

    def __call__(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return g + p * self.coeff


class L1DecayRegularizer:
    """``g + coeff * sign(p)`` (``regularizer.py:34-51``)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = float(regularization_coeff)

    def __call__(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return g + torch.sign(p) * self.coeff


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
