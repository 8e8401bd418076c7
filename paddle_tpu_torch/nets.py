"""Composite layers (counterpart of ``paddle_tpu/fluid/nets.py``).

:class:`SequenceConvPool` is ``sequence_conv_pool`` (``:55-67``): the
``sequence_conv`` layer (``fluid/layers/sequence.py:54-75``: the op, then
a bias over the last axis, then the activation) followed by a
``sequence_pool`` over the same lengths. It is the text-conv classifier's
building block; its SUM, AVERAGE and SQRT pools run on the masked
sequence-pool kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.ops import nn_ops, sequence_ops

ACTS = {None: lambda x: x, "tanh": torch.tanh, "sigmoid": torch.sigmoid}


class SequenceConvPool(nn.Module):
    """X [B,T,D] (+ seq_lens [B]) -> [B, num_filters]. Parameters:
    ``filter`` [filter_size * D, num_filters] and ``bias``
    [num_filters] (zeros, as the JAX layer's bias starts; ``bias=False``
    for none). ``context_start`` defaults to the layer's
    ``-(filter_size - 1) // 2``. :meth:`forward` takes the caller's AMP
    dict (``contrib/mixed_precision.py``), which tags the bias add; its
    op sites are :meth:`op_sites`."""

    def __init__(self, input_dim: int, num_filters: int, filter_size: int,
                 act: Optional[str] = "sigmoid", pool_type: str = "max",
                 bias: bool = True, context_start: Optional[int] = None,
                 device=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unsupported activation {act!r}")
        dev = _device.resolve(device)
        self.filter_size = filter_size
        self.context_start = sequence_ops.default_context_start(filter_size) \
            if context_start is None else context_start
        self.act = act
        self.pool_type = pool_type
        self.filter = nn.Parameter(torch.empty(filter_size * input_dim,
                                               num_filters, device=dev))
        nn.init.xavier_uniform_(self.filter)
        self.bias = nn.Parameter(torch.zeros(num_filters, device=dev)) \
            if bias else None

    def op_sites(self):
        """The op types the AMP rewrite reads, one entry a site: the
        bias's ``elementwise_add`` (``sequence_conv`` is none of them)."""
        return ["elementwise_add"] if self.bias is not None else []

    def forward(self, x: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None,
                amp=None) -> torch.Tensor:
        conv = sequence_ops.sequence_conv(x, self.filter, seq_lens,
                                          self.filter_size,
                                          self.context_start)
        if self.bias is not None:
            conv = nn_ops.elementwise_add(conv, self.bias, amp)
        return sequence_ops.sequence_pool(ACTS[self.act](conv), seq_lens,
                                          self.pool_type)
