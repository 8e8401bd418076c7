"""Metric operators (counterpart of ``paddle_tpu/ops/metric_ops.py``).

:func:`accuracy` is the ``accuracy`` op (``:13``): fed the top-k indices
as ``layers.accuracy`` feeds it (the ``top_k`` op's ``Indices``), it
counts the rows whose label is among them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import first, register_op


def accuracy(indices: torch.Tensor, label: torch.Tensor):
    """indices [N, k], label [N, 1] (or [N]) -> (accuracy [1] fp32,
    correct [1] int32, total [1] int32)."""
    hit = (indices == label.reshape(-1, 1)).any(dim=1)
    correct = hit.to(torch.float32).sum()
    total = indices.shape[0]
    return ((correct / total).reshape(1),
            correct.to(torch.int32).reshape(1),
            torch.tensor([total], dtype=torch.int32, device=indices.device))


@register_op("accuracy", no_grad=True, ref="operators/metrics/accuracy_op.cc")
def _accuracy(ctx, ins, attrs):
    acc, correct, total = accuracy(first(ins, "Indices"), first(ins, "Label"))
    return {"Accuracy": [acc], "Correct": [correct], "Total": [total]}
