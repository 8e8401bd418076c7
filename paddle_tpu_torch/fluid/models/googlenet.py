"""GoogLeNet / Inception-v1 as a program (counterpart of
``paddle_tpu/models/googlenet.py:17-99``): the stem, nine ``inception``
modules (1x1, reduced 3x3, reduced 5x5 and pool-projection branches
concatenated on the channels), a global average pool, dropout 0.4 and
``fc`` class_dim; in training two ``_aux_head`` classifiers on the
outputs of 4a and 4d add their losses at 0.3 each. Momentum 0.9, built
from the port's ``fluid.layers``. The nn.Module trainer is
``paddle_tpu_torch/models/googlenet.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def _conv(inp, num_filters, filter_size, stride=1, padding=0):
    return layers.conv2d(inp, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act="relu")


def inception(inp, c1, c3r, c3, c5r, c5, proj):
    """One inception module: 1x1 / 3x3 (reduced) / 5x5 (reduced) /
    pool-projection branches concatenated on the channels."""
    b1 = _conv(inp, c1, 1)
    b3 = _conv(_conv(inp, c3r, 1), c3, 3, padding=1)
    b5 = _conv(_conv(inp, c5r, 1), c5, 5, padding=2)
    bp = _conv(layers.pool2d(inp, pool_size=3, pool_stride=1, pool_padding=1,
                             pool_type="max"), proj, 1)
    return layers.concat([b1, b3, b5, bp], axis=1)


def _aux_head(inp, class_dim):
    """An auxiliary classifier (loss1 / loss2 of the BVLC prototxt)."""
    p = layers.pool2d(inp, pool_size=5, pool_stride=3, pool_type="avg")
    c = _conv(p, 128, 1)
    f = layers.fc(c, size=1024, act="relu")
    d = layers.dropout(f, dropout_prob=0.7)
    return layers.fc(d, size=class_dim)


def googlenet(input, class_dim=1000, is_train=True):
    x = _conv(input, 64, 7, stride=2, padding=3)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = _conv(x, 64, 1)
    x = _conv(x, 192, 3, padding=1)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")

    x = inception(x, 64, 96, 128, 16, 32, 32)      # 3a
    x = inception(x, 128, 128, 192, 32, 96, 64)    # 3b
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")

    x = inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    aux1 = x
    x = inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    aux2 = x
    x = inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")

    x = inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = inception(x, 384, 192, 384, 48, 128, 128)  # 5b

    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    x = layers.dropout(x, dropout_prob=0.4, is_test=not is_train)
    logits = layers.fc(x, size=class_dim)
    if not is_train:
        return logits, None, None
    return logits, _aux_head(aux1, class_dim), _aux_head(aux2, class_dim)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224):
    img = layers.data(name="data", shape=[3, image_size, image_size],
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    logits, aux1, aux2 = googlenet(img, class_dim, is_train)

    def _ce(lg):
        return layers.mean(layers.softmax_with_cross_entropy(lg, label))

    loss = _ce(logits)
    if is_train:
        # the BVLC weighting: the auxiliary losses at 0.3 each
        aux = layers.scale(layers.sums([_ce(aux1), _ce(aux2)]), scale=0.3)
        loss = layers.sums([loss, aux])
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    if is_train:
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    feed_specs = {"data": ([-1, 3, image_size, image_size], "float32"),
                  "label": ([-1, 1], "int64")}
    return loss, [acc], feed_specs
