"""SE-ResNeXt-50 as a program (counterpart of
``paddle_tpu/models/se_resnext.py:12-93``): the ResNet stem, bottlenecks
of cardinality 32 whose output passes ``squeeze_excitation`` (a global
average pool, ``fc`` C/16 relu, ``fc`` C sigmoid, both with
Uniform(-1/sqrt(fan-in), 1/sqrt(fan-in)) weights, the gate multiplied in
at axis 0), the residual add with relu, a global average pool, dropout
0.5, ``fc`` class_dim, softmax cross entropy, ``accuracy`` and Momentum
0.9, built from the port's ``fluid.layers``. The nn.Module trainer is
``paddle_tpu_torch/models/se_resnext.py``."""

from __future__ import annotations

import math

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_train=True):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    squeeze = layers.fc(
        input=pool, size=num_channels // reduction_ratio, act="relu",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))
    stdv = 1.0 / math.sqrt(squeeze.shape[1] * 1.0)
    excitation = layers.fc(
        input=squeeze, size=num_channels, act="sigmoid",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))
    return layers.elementwise_mul(input, excitation, axis=0)


def shortcut(input, ch_out, stride, is_train):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_train=is_train)
    return input


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_train):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_train=is_train)
    se = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_train)
    return layers.elementwise_add(short, se, act="relu")


def se_resnext50(input, class_dim=1000, is_train=True):
    cardinality = 32
    reduction_ratio = 16
    depth = [3, 4, 6, 3]
    num_filters = [128, 256, 512, 1024]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                         is_train=is_train)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for block, n in enumerate(depth):
        for i in range(n):
            conv = bottleneck_block(
                conv, num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality, reduction_ratio=reduction_ratio,
                is_train=is_train)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.5)
    stdv = 1.0 / math.sqrt(drop.shape[1] * 1.0)
    return layers.fc(
        input=drop, size=class_dim,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.1,
          image_size: int = 224):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = se_resnext50(img, class_dim, is_train)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
