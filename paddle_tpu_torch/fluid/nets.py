"""Composite program-building helpers of the port (counterpart of
``paddle_tpu/fluid/nets.py``; reference: python/paddle/fluid/nets.py):
``simple_img_conv_pool`` (the mnist builder's) and ``img_conv_group``.
They append ops to the default programs; the nn.Module blocks of the same
names are ``paddle_tpu_torch/nets.py``. ``sequence_conv_pool``, ``glu``
and ``scaled_dot_product_attention`` are ROADMAP A6.4b."""

from __future__ import annotations

from paddle_tpu_torch.fluid import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """reference: nets.py simple_img_conv_pool."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """reference: nets.py img_conv_group (VGG's)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _ith(arg, i):
        return arg[i] if isinstance(arg, (list, tuple)) else arg

    for i, nf in enumerate(conv_num_filter):
        local_conv_act = None if _ith(conv_with_batchnorm, i) else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=nf,
            filter_size=_ith(conv_filter_size, i),
            padding=_ith(conv_padding, i),
            param_attr=_ith(param_attr, i)
            if isinstance(param_attr, (list, tuple)) else param_attr,
            act=local_conv_act)
        if _ith(conv_with_batchnorm, i):
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop = _ith(conv_batchnorm_drop_rate, i)
            if abs(drop) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
