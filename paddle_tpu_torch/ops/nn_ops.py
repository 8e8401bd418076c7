"""Dense operators of the decoder-LM path, as plain functions with the
numerics of their JAX emitters:

- :func:`layer_norm` -- ``paddle_tpu/ops/nn_ops.py:392``: population
  variance, eps 1e-5, normalized over the trailing dims.
- :func:`lookup_table` -- ``nn_ops.py:504`` (and ``gather``,
  ``paddle_tpu/ops/math_ops.py:245``): rows of a table by index.
- :func:`fc` -- ``paddle_tpu/ops/misc_ops.py:485`` (and the ``mul`` +
  bias + act chain ``layers.fc`` emits): weights in [in, out] layout.
- :func:`scale` -- ``paddle_tpu/ops/math_ops.py:74``.
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], begin_norm_axis: int = -1,
               eps: float = 1e-5) -> torch.Tensor:
    axes = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = x.shape[axes[0]:]
    if weight is not None:
        y = y * weight.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return y


def lookup_table(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] int -> [..., D] rows of ``w`` [V, D]."""
    return w[ids.long()]


def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
       act: Optional[str] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b) (+ relu)."""
    out = x @ w
    if b is not None:
        out = out + b
    if act == "relu":
        out = torch.relu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out


def scale(x: torch.Tensor, factor: float, bias: float = 0.0) -> torch.Tensor:
    return x * factor + bias

