"""ResNet-50 / 101 / 152 (counterpart of ``paddle_tpu/models/resnet.py``):
a 7x7 stride-2 ``conv_bn_layer`` with relu, a 3x3 stride-2 max pool
(padding 1), bottleneck blocks (1x1, 3x3, 1x1 ``conv_bn_layer``s of
64-512 filters, the last 4x wider; a projection ``shortcut`` where the
width or the stride changes; the residual add with relu), a global
average pool and ``fc`` class_dim; softmax cross entropy and Momentum 0.9
with L2 decay 1e-4 on every parameter (``:17-84``). Every conv has no
bias; every batch norm takes ``is_test=not is_train``.
The training program of the same model is
``paddle_tpu_torch/fluid/models/resnet.py``.
"""

from __future__ import annotations

import math

from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.models.classifier import ImageClassifier, feed_specs
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.regularizer import L2Decay

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ConvBN(nn.Module):
    """``conv_bn_layer``: a k x k conv without bias (padding (k - 1) // 2,
    ``groups``) and a batch norm carrying ``act``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act=None, is_test: bool = False):
        super().__init__()
        self.conv = layers.Conv2D(cin, cout, k, stride, (k - 1) // 2,
                                  groups=groups, bias=False)
        self.bn = layers.BatchNorm(cout, act=act, is_test=is_test)

    def op_sites(self):
        return self.conv.op_sites()

    def forward(self, x, amp=None):
        return self.bn(self.conv(x, amp))


def shortcut(cin: int, cout: int, stride: int, is_test: bool):
    """The projection ``shortcut`` (a 1x1 ``ConvBN``) where the width or
    the stride changes, else None (the identity)."""
    if cin != cout or stride != 1:
        return ConvBN(cin, cout, 1, stride, is_test=is_test)
    return None


class Bottleneck(nn.Module):

    def __init__(self, cin: int, filters: int, stride: int, is_test: bool):
        super().__init__()
        self.conv0 = ConvBN(cin, filters, 1, act="relu", is_test=is_test)
        self.conv1 = ConvBN(filters, filters, 3, stride, act="relu",
                            is_test=is_test)
        self.conv2 = ConvBN(filters, filters * 4, 1, is_test=is_test)
        self.short = shortcut(cin, filters * 4, stride, is_test)

    def op_sites(self):
        return (self.conv0.op_sites() + self.conv1.op_sites()
                + self.conv2.op_sites()
                + (self.short.op_sites() if self.short is not None else [])
                + ["elementwise_add"])

    def forward(self, x, amp=None):
        out = self.conv2(self.conv1(self.conv0(x, amp), amp), amp)
        short = self.short(x, amp) if self.short is not None else x
        return nn_ops.relu(nn_ops.elementwise_add(short, out, amp))


class ResNet(ImageClassifier):

    def __init__(self, class_dim: int = 1000, depth: int = 50,
                 is_test: bool = False, device=None):
        super().__init__()
        if depth not in DEPTHS:
            raise ValueError(f"depth {depth} is none of {sorted(DEPTHS)}")
        self.stem = ConvBN(3, 64, 7, 2, act="relu", is_test=is_test)
        self.blocks = nn.ModuleList()
        cin = 64
        for stage, (n, filters) in enumerate(zip(DEPTHS[depth],
                                                 (64, 128, 256, 512))):
            for i in range(n):
                stride = 2 if i == 0 and stage != 0 else 1
                self.blocks.append(Bottleneck(cin, filters, stride, is_test))
                cin = filters * 4
        self.fc = layers.FC(cin, class_dim, bound=1.0 / math.sqrt(cin))
        self.to(_device.resolve(device))

    def op_sites(self):
        return (self.stem.op_sites()
                + [site for b in self.blocks for site in b.op_sites()]
                + self.fc.op_sites())

    def predict(self, data):
        x = nn_ops.pool2d(self.stem(data, self.amp), 3, "max", 2, 1)
        for block in self.blocks:
            x = block(x, self.amp)
        x = nn_ops.pool2d(x, 0, "avg", global_pooling=True)
        return self.fc(x, self.amp)


def build(is_train: bool = True, class_dim: int = 1000, depth: int = 50,
          lr: float = 0.1, image_size: int = 224, device=None):
    """-> (model, Momentum 0.9 at ``lr`` with ``L2Decay(1e-4)``, or None
    with ``is_train=False``; feed specs). ``is_train=False`` puts every
    batch norm in test mode, as the JAX build passes them ``is_test``.
    ``image_size`` only shapes the feed specs: the global pool takes any
    size. Runs on ``device`` (``cuda`` unless ``"cpu"``)."""
    model = ResNet(class_dim, depth, not is_train, device)
    opt = Momentum(model.parameters(), lr, 0.9,
                   regularization=L2Decay(1e-4)) if is_train else None
    return model, opt, feed_specs(image_size)
