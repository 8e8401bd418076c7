"""VGG16 as a program (counterpart of ``paddle_tpu/models/vgg.py:10-42``):
five ``fluid.nets.img_conv_group`` blocks (3x3 convs, each with batch
norm and relu, a 2x2 max pool a block), ``fc`` 4096, batch norm with
relu, dropout 0.5, ``fc`` 4096, ``fc`` class_dim, softmax cross entropy,
``accuracy`` and Momentum 0.9, built from the port's ``fluid.layers``.
The nn.Module trainer is ``paddle_tpu_torch/models/vgg.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def vgg16(input, class_dim=1000, is_train=True):
    def conv_block(inp, num_filter, groups):
        return fluid.nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True, pool_type="max")

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)

    fc1 = layers.fc(conv5, size=4096, act=None)
    bn = layers.batch_norm(fc1, act="relu", is_test=not is_train)
    drop = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop, size=4096, act=None)
    return layers.fc(fc2, size=class_dim)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits = vgg16(img, class_dim, is_train)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
