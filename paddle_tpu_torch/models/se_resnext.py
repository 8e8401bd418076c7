"""SE-ResNeXt-50 (counterpart of ``paddle_tpu/models/se_resnext.py``): the
ResNet stem, then bottlenecks of cardinality 32 (the 3x3 conv in 32
groups; 128-1024 filters, the last conv 2x wider) whose output passes a
squeeze-excitation gate (global average pool, ``fc`` C/16 relu, ``fc`` C
sigmoid, the [N, C] gate multiplied in at axis 0) before the residual add
with relu; a global average pool, dropout 0.5, ``fc`` class_dim; softmax
cross entropy and Momentum 0.9 (``:12-93``). The dropout takes no
``is_test``: only ``eval()`` turns it off.
The training program of the same model is
``paddle_tpu_torch/fluid/models/se_resnext.py``.
"""

from __future__ import annotations

import math

from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.models.classifier import ImageClassifier, feed_specs
from paddle_tpu_torch.models.resnet import ConvBN, shortcut
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Momentum

DEPTH = (3, 4, 6, 3)
FILTERS = (128, 256, 512, 1024)
CARDINALITY = 32
REDUCTION = 16


def _fc(cin: int, size: int, act=None):
    """An ``fc`` whose weight starts uniform in +-1/sqrt(cin)."""
    return layers.FC(cin, size, act=act, bound=1.0 / math.sqrt(cin))


class SqueezeExcitation(nn.Module):

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.squeeze = _fc(channels, channels // reduction, "relu")
        self.excite = _fc(channels // reduction, channels, "sigmoid")

    def op_sites(self):
        return (self.squeeze.op_sites() + self.excite.op_sites()
                + ["elementwise_mul"])

    def forward(self, x, amp=None):
        pool = nn_ops.pool2d(x, 0, "avg", global_pooling=True)
        gate = self.excite(self.squeeze(pool, amp), amp)
        return nn_ops.elementwise_mul(x, gate, amp, axis=0)


class Bottleneck(nn.Module):

    def __init__(self, cin: int, filters: int, stride: int, is_test: bool):
        super().__init__()
        self.conv0 = ConvBN(cin, filters, 1, act="relu", is_test=is_test)
        self.conv1 = ConvBN(filters, filters, 3, stride, CARDINALITY,
                            act="relu", is_test=is_test)
        self.conv2 = ConvBN(filters, filters * 2, 1, is_test=is_test)
        self.se = SqueezeExcitation(filters * 2, REDUCTION)
        self.short = shortcut(cin, filters * 2, stride, is_test)

    def op_sites(self):
        return (self.conv0.op_sites() + self.conv1.op_sites()
                + self.conv2.op_sites() + self.se.op_sites()
                + (self.short.op_sites() if self.short is not None else [])
                + ["elementwise_add"])

    def forward(self, x, amp=None):
        out = self.conv2(self.conv1(self.conv0(x, amp), amp), amp)
        out = self.se(out, amp)
        short = self.short(x, amp) if self.short is not None else x
        return nn_ops.relu(nn_ops.elementwise_add(short, out, amp))


class SEResNeXt50(ImageClassifier):

    def __init__(self, class_dim: int = 1000, is_test: bool = False,
                 device=None):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2, act="relu", is_test=is_test)
        self.blocks = nn.ModuleList()
        cin = 64
        for stage, (n, filters) in enumerate(zip(DEPTH, FILTERS)):
            for i in range(n):
                stride = 2 if i == 0 and stage != 0 else 1
                self.blocks.append(Bottleneck(cin, filters, stride, is_test))
                cin = filters * 2
        self.drop = layers.Dropout(0.5)
        self.fc = _fc(cin, class_dim)
        self.to(_device.resolve(device))

    def op_sites(self):
        return (self.stem.op_sites()
                + [site for b in self.blocks for site in b.op_sites()]
                + self.fc.op_sites())

    def predict(self, data):
        x = nn_ops.pool2d(self.stem(data, self.amp), 3, "max", 2, 1)
        for block in self.blocks:
            x = block(x, self.amp)
        x = self.drop(nn_ops.pool2d(x, 0, "avg", global_pooling=True))
        return self.fc(x, self.amp)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.1,
          image_size: int = 224, device=None):
    """-> (model, Momentum 0.9 at ``lr`` or None with ``is_train=False``,
    feed specs). ``is_train=False`` puts every batch norm in test mode;
    the dropout stays on until ``eval()``. Runs on ``device`` (``cuda``
    unless ``"cpu"``)."""
    model = SEResNeXt50(class_dim, not is_train, device)
    return model, (Momentum(model.parameters(), lr, 0.9)
                   if is_train else None), feed_specs(image_size)
