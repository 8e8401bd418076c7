"""SmallNet, the Caffe cifar10_quick network, as a program (counterpart of
``paddle_tpu/models/smallnet.py:11-38``): three 5x5 convs (padding 2), a
max and two average 3x3 stride-2 pools, ``fc`` 64 and ``fc`` class_dim,
softmax cross entropy, ``accuracy`` and Momentum 0.9, built from the
port's ``fluid.layers``. The nn.Module trainer is
``paddle_tpu_torch/models/smallnet.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def smallnet(input, class_dim=10):
    x = layers.conv2d(input, num_filters=32, filter_size=5, padding=2)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.relu(x)
    x = layers.conv2d(x, num_filters=32, filter_size=5, padding=2,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="avg")
    x = layers.conv2d(x, num_filters=64, filter_size=5, padding=2,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="avg")
    x = layers.fc(x, size=64)
    return layers.fc(x, size=class_dim)


def build(is_train: bool = True, class_dim: int = 10, lr: float = 0.001,
          image_size: int = 32):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = smallnet(img, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
