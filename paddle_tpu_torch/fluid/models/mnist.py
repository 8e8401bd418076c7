"""The MNIST CNN training program (counterpart of
``paddle_tpu/models/mnist.py``: two ``simple_img_conv_pool`` blocks and a
softmax fc, ``cross_entropy``, ``mean``, ``accuracy`` and Adam) built
from the port's ``fluid.layers``. The nn.Module trainer is
``paddle_tpu_torch/models/mnist.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def cnn_model(data):
    conv1 = fluid.nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv2 = fluid.nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return layers.fc(input=conv2, size=10, act="softmax")


def build(is_train: bool = True, lr: float = 0.001):
    img = layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = cnn_model(img)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    if is_train:
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    feed_specs = {"pixel": ([-1, 1, 28, 28], "float32"),
                  "label": ([-1, 1], "int64")}
    return avg_cost, [acc], feed_specs
