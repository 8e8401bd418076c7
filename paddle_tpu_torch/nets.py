"""Composite layers (counterpart of ``paddle_tpu/fluid/nets.py``).

:class:`SequenceConvPool` is ``sequence_conv_pool`` (``:55-67``): the
``sequence_conv`` layer (``fluid/layers/sequence.py:54-75``: the op, then
a bias over the last axis, then the activation) followed by a
``sequence_pool`` over the same lengths. It is the text-conv classifier's
building block; its SUM, AVERAGE and SQRT pools run on the masked
sequence-pool kernel on the card.

:class:`SimpleImgConvPool` and :class:`ImgConvGroup` are
``simple_img_conv_pool`` and ``img_conv_group`` (``:10-52``), the conv
blocks of the mnist CNN and of VGG, built from ``paddle_tpu_torch.layers``.
The program-building ``simple_img_conv_pool`` and ``img_conv_group`` are
``paddle_tpu_torch/fluid/nets.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.ops import nn_ops, sequence_ops

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
        layers.activation(act)            # raises on an unknown one
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
        return sequence_ops.sequence_pool(layers.activation(self.act)(conv),
                                          seq_lens, self.pool_type)


class SimpleImgConvPool(nn.Module):
    """``simple_img_conv_pool`` (``fluid/nets.py:10-24``): a
    :class:`~paddle_tpu_torch.layers.Conv2D` (bias, ``act``) and a
    ``pool2d``. :meth:`forward` takes the caller's AMP dict."""

    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 pool_size, pool_stride, pool_padding=0,
                 pool_type: str = "max", global_pooling: bool = False,
                 conv_stride=1, conv_padding=0, conv_dilation=1,
                 conv_groups: int = 1, act: Optional[str] = None):
        super().__init__()
        self.conv = layers.Conv2D(num_channels, num_filters, filter_size,
                                  conv_stride, conv_padding, conv_dilation,
                                  conv_groups, act=act)
        self.pool = dict(pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)

    def op_sites(self):
        return self.conv.op_sites()

    def forward(self, x, amp=None):
        return nn_ops.pool2d(self.conv(x, amp), **self.pool)


class ImgConvGroup(nn.Module):
    """``img_conv_group`` (``fluid/nets.py:27-52``): per entry of
    ``conv_num_filter`` a :class:`~paddle_tpu_torch.layers.Conv2D` (bias;
    ``conv_act`` unless followed by batch norm), with
    ``conv_with_batchnorm`` a :class:`~paddle_tpu_torch.layers.BatchNorm`
    carrying ``conv_act`` and a dropout of ``conv_batchnorm_drop_rate``
    where it exceeds 1e-5, then one ``pool2d``. The per-conv arguments take
    a value or a list. The batch norms and dropouts get no ``is_test``, as
    in the JAX helper: only ``eval()`` puts them in test mode."""

    def __init__(self, num_channels: int, conv_num_filter, pool_size,
                 conv_padding=1, conv_filter_size=3,
                 conv_act: Optional[str] = None,
                 conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                 pool_stride=1, pool_type: str = "max"):
        super().__init__()

        def ith(arg, i):
            return arg[i] if isinstance(arg, (list, tuple)) else arg
        self.steps = nn.ModuleList()
        c = num_channels
        for i, nf in enumerate(conv_num_filter):
            bn = ith(conv_with_batchnorm, i)
            step = nn.ModuleList([layers.Conv2D(
                c, nf, ith(conv_filter_size, i), padding=ith(conv_padding, i),
                act=None if bn else conv_act)])
            if bn:
                step.append(layers.BatchNorm(nf, act=conv_act))
                drop = ith(conv_batchnorm_drop_rate, i)
                if abs(drop) > 1e-5:
                    step.append(layers.Dropout(drop))
            self.steps.append(step)
            c = nf
        self.pool = dict(pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)

    def op_sites(self):
        return [site for step in self.steps for site in step[0].op_sites()]

    def forward(self, x, amp=None):
        for step in self.steps:
            x = step[0](x, amp)
            for layer in step[1:]:
                x = layer(x)
        return nn_ops.pool2d(x, **self.pool)
