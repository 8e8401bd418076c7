"""Dense operators of the decoder-LM path, as plain functions with the
numerics of their JAX emitters:

- :func:`layer_norm` -- ``paddle_tpu/ops/nn_ops.py:392``: population
  variance, eps 1e-5, normalized over the trailing dims.
- :func:`lookup_table` -- ``nn_ops.py:504`` (and ``gather``,
  ``paddle_tpu/ops/math_ops.py:245``): rows of a table by index, a
  trailing id dim of 1 dropped, ``padding_idx`` rows zeroed; with
  ``sparse=True`` the table's gradient is row-sparse (a sparse COO tensor
  over the looked-up rows), as the JAX ``__vjp__`` emits a
  ``RowSparseGrad`` for it (``paddle_tpu/ops/grad_ops.py:38``,
  ``:137-150``).
- :func:`fc` -- ``paddle_tpu/ops/misc_ops.py:485`` (and the ``mul`` +
  ``sum`` + bias + act chain ``layers.fc`` emits): weights in [in, out]
  layout, one per input.
- :func:`scale` -- ``paddle_tpu/ops/math_ops.py:74``.

and those the training path adds (differentiable through autograd, like
the ops above):

- :func:`dropout` -- ``nn_ops.py:462`` in training, ``upscale_in_train``:
  the counter-hash keep mask over the flat element index
  (``hash_keep_mask(seed, 0, index, 0, p)``).
- :func:`softmax` -- ``nn_ops.py:528``, over the last axis.
- :func:`softmax_with_cross_entropy` -- ``nn_ops.py:563``, hard labels:
  ``lse - picked`` with closed-form label smoothing ``+ eps * (picked -
  mean(logits))`` and ``ignore_index`` rows at 0.
- :func:`matmul` -- ``paddle_tpu/ops/math_ops.py:51`` (batched, optional
  ``transpose_y``).
- :func:`mean` -- ``math_ops.py:122``.
- :func:`fused_linear_ce` -- ``nn_ops.py:610``: the vocabulary projection
  and the label-smoothed CE as one op, whose fused kernels run on the
  card (``ops/kernels/fused_ce.py``).

and those of the LSTM classifier's head:

- :func:`cross_entropy` -- ``nn_ops.py:544``, on probabilities:
  ``-log(p[label] + 1e-9)`` with ``ignore_index`` rows at 0, or
  ``-sum(label * log(p + 1e-9))`` for soft labels.
- :func:`accuracy` -- ``paddle_tpu/ops/metric_ops.py:13``, fed the top-k
  indices as ``layers.accuracy`` feeds it (``fluid/layers/nn.py:531``).

and those of deepfm:

- :func:`sigmoid_cross_entropy_with_logits` -- ``nn_ops.py:650-664``:
  ``max(x, 0) - x * label + log1p(exp(-|x|))``, 0 where the label is
  ``ignore_index``, divided by the count of the others with
  ``normalize``.
- :func:`sigmoid`, :func:`square` (the activations of
  ``paddle_tpu/ops/basic.py:197-203``), :func:`reduce_sum`
  (``math_ops.py:100-115``), :func:`slice` (``math_ops.py:218``, the
  bounds clipped as there) and :func:`reshape` (``math_ops.py:147``, a 0
  copying the input's dim).
"""

from __future__ import annotations

from builtins import slice as builtins_slice
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import fused_ce as _fused_ce
from paddle_tpu_torch.ops.kernels.flash_attention import hash_keep_mask


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


def lookup_table(w: torch.Tensor, ids: torch.Tensor, sparse: bool = False,
                 padding_idx: Optional[int] = None) -> torch.Tensor:
    """ids [..., 1] or [...] int -> [..., D] rows of ``w`` [V, D]: a
    trailing id dim of 1 is dropped (``nn_ops.py:513``), so ids [B, T]
    give [B, T, D] and so do ids [B, T, 1]. ``padding_idx`` >= 0: the rows
    whose id equals it are zeros, and their gradient is too
    (``:508-512``, ``grad_ops.py:68-71``). ``sparse``: the gradient of
    ``w`` is a sparse tensor with one row per looked-up id (duplicates not
    yet summed)."""
    ids = ids.long()
    keep = ids.shape[:-1] if ids.dim() and ids.shape[-1] == 1 else ids.shape
    flat = ids.reshape(-1)
    if sparse:
        out = torch.nn.functional.embedding(flat, w, sparse=True)
    else:
        out = w[flat]
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((flat == padding_idx)[:, None], 0.0)
    return out.reshape(*keep, w.shape[-1])


def fc(x, w, b: Optional[torch.Tensor] = None,
       act: Optional[str] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b) (+ act: relu, tanh or softmax over
    the last axis). With a list of inputs and a list of as many weights,
    the products are summed before the one bias (``layers.fc``,
    ``fluid/layers/nn.py:25-45``)."""
    if isinstance(x, (list, tuple)):
        if not isinstance(w, (list, tuple)) or len(w) != len(x):
            raise ValueError("a multi-input fc takes one weight per input")
        out = x[0] @ w[0]
        for xi, wi in zip(x[1:], w[1:]):
            out = out + xi @ wi
    else:
        out = x @ w
    if b is not None:
        out = out + b
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    elif act == "softmax":
        out = torch.softmax(out, dim=-1)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out


def scale(x: torch.Tensor, factor: float, bias: float = 0.0) -> torch.Tensor:
    return x * factor + bias


def dropout(x: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """Training-mode dropout, ``upscale_in_train``, with the JAX op's keep
    mask: element ``i`` of the flattened ``x`` is kept (and scaled by
    1 / (1 - p)) iff ``hash_keep_mask(seed, 0, i, 0, p)`` is non-zero, so
    the same seed drops the same elements as the JAX op. ``seed`` is an
    int32 value (the JAX op draws it from its step key)."""
    if p >= 1.0:
        return torch.zeros_like(x)      # everything dropped, no 0 * inf
    idx = torch.arange(x.numel(), device=x.device).view(x.shape)
    return x * hash_keep_mask(seed, 0, idx, 0, p).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               label_smoothing: float = 0.0,
                               ignore_index: int = -100) -> torch.Tensor:
    """logits [..., V], integer label [..., 1] (or [...]) -> loss [..., 1]
    (fp32). The max is taken off the graph, as the JAX op stops its
    gradient; the result and its gradient are those of ``-sum(q *
    log_softmax(logits))`` with ``q = (1 - eps) * onehot + eps / V``."""
    lg = logits.to(torch.float32)
    m = lg.detach().amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(lg - m).sum(dim=-1, keepdim=True))
    lab = label.reshape(logits.shape[:-1] + (1,)).long()
    picked = lg.gather(-1, lab.clamp(0, logits.shape[-1] - 1))
    loss = lse - picked
    if label_smoothing:
        loss = loss + label_smoothing * (picked
                                         - lg.mean(dim=-1, keepdim=True))
    return torch.where(lab == ignore_index, torch.zeros_like(loss), loss)


def matmul(x: torch.Tensor, y: torch.Tensor,
           transpose_y: bool = False) -> torch.Tensor:
    return torch.matmul(x, y.transpose(-1, -2) if transpose_y else y)


def mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def cross_entropy(prob: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False,
                  ignore_index: int = -100) -> torch.Tensor:
    """prob [N, D] probabilities, label [N, 1] (or [N]) integers, or
    [N, D] weights with ``soft_label`` -> loss [N, 1] in fp32."""
    if prob.dtype in (torch.bfloat16, torch.float16):
        prob = prob.to(torch.float32)
    eps = 1e-9
    if soft_label:
        return -(label * torch.log(prob + eps)).sum(dim=-1, keepdim=True)
    lab = label.reshape(-1, 1).long()
    picked = prob.gather(-1, lab.clamp(0, prob.shape[-1] - 1))
    loss = -torch.log(picked + eps)
    return torch.where(lab == ignore_index, torch.zeros_like(loss), loss)


def accuracy(prob: torch.Tensor, label: torch.Tensor, k: int = 1):
    """-> (accuracy [1] fp32, correct [1] int32, total [1] int32): the
    share of rows whose label is among the k largest of ``prob`` [N, D].
    Carries no gradient."""
    with torch.no_grad():
        idx = prob.topk(k, dim=-1).indices
        hit = (idx == label.reshape(-1, 1)).any(dim=1)
        correct = hit.to(torch.float32).sum()
        total = idx.shape[0]
        return ((correct / total).reshape(1),
                correct.to(torch.int32).reshape(1),
                torch.tensor([total], dtype=torch.int32, device=prob.device))


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, label: torch.Tensor,
                    label_smoothing: float = 0.0,
                    ignore_index: int = -100) -> torch.Tensor:
    """X [N, D] @ W [D, V] and the label-smoothed softmax CE of Label
    [N, 1] int -> Loss [N, 1], the logits never materialized on the card.
    Every shape goes to the fused function: the JAX op's ``supported``
    gate is a TPU tiling rule, and its composed branch computes the same
    function."""
    return _fused_ce.fused_linear_ce(x, w, label.reshape(-1),
                                     label_smoothing, ignore_index)


def sigmoid_cross_entropy_with_logits(x: torch.Tensor, label: torch.Tensor,
                                      ignore_index: int = -100,
                                      normalize: bool = False
                                      ) -> torch.Tensor:
    """Elementwise loss of logits ``x`` against labels of x's shape (fp32
    for fp16 and bf16 logits)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    loss = torch.clamp_min(x, 0.0) - x * label \
        + torch.log1p(torch.exp(-x.abs()))
    ignored = label == ignore_index
    loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if normalize:
        loss = loss / torch.clamp_min((~ignored).to(x.dtype).sum(), 1.0)
    return loss


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def square(x: torch.Tensor) -> torch.Tensor:
    return torch.square(x)


def reduce_sum(x: torch.Tensor, dim=None, keep_dim: bool = False
               ) -> torch.Tensor:
    """The sum over ``dim`` (an int or a list; None: every axis)."""
    if dim is None:
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(d % x.dim() for d in ([dim] if isinstance(dim, int)
                                           else dim))
    return x.sum(dim=dims, keepdim=keep_dim)


def slice(x: torch.Tensor, axes, starts, ends) -> torch.Tensor:  # noqa: A001
    """``x[..., s:e, ...]`` on each of ``axes``, negative bounds counted
    from the end and every bound clipped into the axis."""
    idx = [builtins_slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = builtins_slice(s, e)
    return x[tuple(idx)]


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` in ``shape``, where a 0 copies x's dim at that position and
    one -1 takes the rest."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)
