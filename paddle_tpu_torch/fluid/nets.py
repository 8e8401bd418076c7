"""Composite program-building helpers of the port (counterpart of
``paddle_tpu/fluid/nets.py``; reference: python/paddle/fluid/nets.py):
``simple_img_conv_pool`` (the mnist builder's), ``img_conv_group``
(VGG's), ``sequence_conv_pool`` (a ``sequence_conv`` then a
``sequence_pool``: on the card the masked pooling kernel for every pool
type but MAX), ``glu`` and the composed ``scaled_dot_product_attention``.
They append ops to the default programs; the nn.Module blocks of the same
names are ``paddle_tpu_torch/nets.py``."""

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


def sequence_conv_pool(input, num_filters, filter_size, seq_lens=None,
                       param_attr=None, bias_attr=None, act="sigmoid",
                       pool_type="max"):
    """reference: nets.py:248 sequence_conv_pool — context-window conv
    over a padded [B, T, D] sequence followed by a sequence pool (the
    text-classification building block; SeqLens masks padding in both
    halves, the LoD redesign's convention)."""
    conv = layers.sequence_conv(input, num_filters=num_filters,
                                filter_size=filter_size, seq_lens=seq_lens,
                                param_attr=param_attr, bias_attr=bias_attr,
                                act=act)
    return layers.sequence_pool(conv, pool_type=pool_type,
                                seq_lens=seq_lens)


def glu(input, dim=-1):
    """reference: nets.py glu — gated linear unit via split+sigmoid."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """reference: nets.py scaled_dot_product_attention — multi-head
    attention composed from ``matmul`` and ``softmax`` ops; it does not
    reach the flash kernels (``layers.fused_multi_head_attention`` does)."""
    head_dim = queries.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(x, shape=[0, 0, num_heads, head_dim])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scaled_q = layers.scale(q, scale=head_dim ** -0.5)
    logits = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    if num_heads == 1:
        return ctx
    ctx_t = layers.transpose(ctx, perm=[0, 2, 1, 3])
    return layers.reshape(ctx_t, shape=[0, 0, num_heads * head_dim])
