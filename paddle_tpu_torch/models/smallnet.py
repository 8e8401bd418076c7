"""SmallNet, the Caffe cifar10_quick network (counterpart of
``paddle_tpu/models/smallnet.py``): three 5x5 convs of 32, 32 and 64
filters (padding 2), a 3x3 stride-2 max pool then relu, two 3x3 stride-2
average pools, ``fc`` 64 and ``fc`` class_dim, softmax cross entropy and
Momentum 0.9 (``:11-41``). Input [N, 3, 32, 32].
The training program of the same model is
``paddle_tpu_torch/fluid/models/smallnet.py``.
"""

from __future__ import annotations

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.models.classifier import (ImageClassifier,
                                                feed_specs, pooled)
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Momentum


class SmallNet(ImageClassifier):

    def __init__(self, class_dim: int = 10, image_size: int = 32,
                 device=None):
        super().__init__()
        self.conv1 = layers.Conv2D(3, 32, 5, padding=2)
        self.conv2 = layers.Conv2D(32, 32, 5, padding=2, act="relu")
        self.conv3 = layers.Conv2D(32, 64, 5, padding=2, act="relu")
        side = image_size
        for _ in range(3):
            side = pooled(side, 3, 2)
        self.fc1 = layers.FC(64 * side * side, 64)
        self.fc2 = layers.FC(64, class_dim)
        self.to(_device.resolve(device))

    def op_sites(self):
        return [site for m in (self.conv1, self.conv2, self.conv3, self.fc1,
                               self.fc2) for site in m.op_sites()]

    def predict(self, data):
        amp = self.amp
        x = nn_ops.pool2d(self.conv1(data, amp), 3, "max", 2)
        x = nn_ops.relu(x)
        x = nn_ops.pool2d(self.conv2(x, amp), 3, "avg", 2)
        x = nn_ops.pool2d(self.conv3(x, amp), 3, "avg", 2)
        return self.fc2(self.fc1(x, amp), amp)


def build(is_train: bool = True, class_dim: int = 10, lr: float = 0.001,
          image_size: int = 32, device=None):
    """-> (model, Momentum 0.9 at ``lr`` or None with ``is_train=False``,
    feed specs). Runs on ``device`` (``cuda`` unless ``"cpu"``)."""
    model = SmallNet(class_dim, image_size, device)
    return model, (Momentum(model.parameters(), lr, 0.9)
                   if is_train else None), feed_specs(image_size)
