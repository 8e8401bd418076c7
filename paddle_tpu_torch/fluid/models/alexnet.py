"""AlexNet as a program (counterpart of ``paddle_tpu/models/alexnet.py:
11-44``): five convs with relu, three 3x3 stride-2 max pools, ``fc`` 4096
relu and dropout 0.5 twice, ``fc`` class_dim, softmax cross entropy,
``accuracy`` and Momentum 0.9, built from the port's ``fluid.layers``.
The nn.Module trainer is ``paddle_tpu_torch/models/alexnet.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def alexnet(input, class_dim=1000):
    conv1 = layers.conv2d(input, num_filters=64, filter_size=11, stride=4,
                          padding=2, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=192, filter_size=5, padding=2,
                          act="relu")
    pool2 = layers.pool2d(conv2, pool_size=3, pool_stride=2)
    conv3 = layers.conv2d(pool2, num_filters=384, filter_size=3, padding=1,
                          act="relu")
    conv4 = layers.conv2d(conv3, num_filters=256, filter_size=3, padding=1,
                          act="relu")
    conv5 = layers.conv2d(conv4, num_filters=256, filter_size=3, padding=1,
                          act="relu")
    pool5 = layers.pool2d(conv5, pool_size=3, pool_stride=2)
    fc6 = layers.fc(pool5, size=4096, act="relu")
    drop6 = layers.dropout(fc6, dropout_prob=0.5)
    fc7 = layers.fc(drop6, size=4096, act="relu")
    drop7 = layers.dropout(fc7, dropout_prob=0.5)
    return layers.fc(drop7, size=class_dim, act=None)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = alexnet(img, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
