"""ResNet-50 / 101 / 152 as a program (counterpart of
``paddle_tpu/models/resnet.py:17-79``): ``conv_bn_layer`` (a conv
without bias and a batch norm), bottleneck blocks with a projection
``shortcut`` where the width or the stride changes, a global average
pool, ``fc`` class_dim with a Uniform(-1/sqrt(C), 1/sqrt(C)) weight,
softmax cross entropy, ``accuracy`` and Momentum 0.9 with L2 decay 1e-4,
built from the port's ``fluid.layers``. On the card the convs run
cuDNN's kernels (``ops/nn_ops.py``). The nn.Module trainer is
``paddle_tpu_torch/models/resnet.py``."""

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


def shortcut(input, ch_out, stride, is_train):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_train=is_train)
    return input


def bottleneck_block(input, num_filters, stride, is_train):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_train=is_train)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          is_train=is_train)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          is_train=is_train)
    short = shortcut(input, num_filters * 4, stride, is_train)
    return layers.elementwise_add(short, conv2, act="relu")


def resnet(input, class_dim=1000, depth=50, is_train=True):
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    num_filters = [64, 128, 256, 512]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                         is_train=is_train)
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for block, n in enumerate(cfg):
        for i in range(n):
            conv = bottleneck_block(
                conv, num_filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                is_train=is_train)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    return layers.fc(
        input=pool, size=class_dim,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))


def build(is_train: bool = True, class_dim: int = 1000, depth: int = 50,
          lr: float = 0.1, image_size: int = 224):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = resnet(img, class_dim, depth, is_train)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
