"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``): five convs
with relu (11x11 stride 4, 5x5, three 3x3), 3x3 stride-2 max pools after
the first, second and fifth, ``fc`` 4096 relu, dropout 0.5, ``fc`` 4096
relu, dropout 0.5, ``fc`` class_dim, softmax cross entropy and Momentum
0.9 (``:11-44``). The dropouts take no ``is_test``: only ``eval()`` turns
them off.
The training program of the same model is
``paddle_tpu_torch/fluid/models/alexnet.py``.
"""

from __future__ import annotations

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.models.classifier import (ImageClassifier,
                                                feed_specs, pooled)
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Momentum


class AlexNet(ImageClassifier):

    def __init__(self, class_dim: int = 1000, image_size: int = 224,
                 device=None):
        super().__init__()
        self.conv1 = layers.Conv2D(3, 64, 11, stride=4, padding=2,
                                   act="relu")
        self.conv2 = layers.Conv2D(64, 192, 5, padding=2, act="relu")
        self.conv3 = layers.Conv2D(192, 384, 3, padding=1, act="relu")
        self.conv4 = layers.Conv2D(384, 256, 3, padding=1, act="relu")
        self.conv5 = layers.Conv2D(256, 256, 3, padding=1, act="relu")
        side = pooled(image_size, 11, 4, 2)
        for _ in range(3):
            side = pooled(side, 3, 2)
        self.fc6 = layers.FC(256 * side * side, 4096, act="relu")
        self.drop6 = layers.Dropout(0.5)
        self.fc7 = layers.FC(4096, 4096, act="relu")
        self.drop7 = layers.Dropout(0.5)
        self.fc8 = layers.FC(4096, class_dim)
        self.to(_device.resolve(device))

    def op_sites(self):
        return [site for m in (self.conv1, self.conv2, self.conv3,
                               self.conv4, self.conv5, self.fc6, self.fc7,
                               self.fc8) for site in m.op_sites()]

    def predict(self, data):
        amp = self.amp
        x = nn_ops.pool2d(self.conv1(data, amp), 3, "max", 2)
        x = nn_ops.pool2d(self.conv2(x, amp), 3, "max", 2)
        x = self.conv5(self.conv4(self.conv3(x, amp), amp), amp)
        x = nn_ops.pool2d(x, 3, "max", 2)
        x = self.drop6(self.fc6(x, amp))
        x = self.drop7(self.fc7(x, amp))
        return self.fc8(x, amp)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224, device=None):
    """-> (model, Momentum 0.9 at ``lr`` or None with ``is_train=False``,
    feed specs). Runs on ``device`` (``cuda`` unless ``"cpu"``)."""
    model = AlexNet(class_dim, image_size, device)
    return model, (Momentum(model.parameters(), lr, 0.9)
                   if is_train else None), feed_specs(image_size)
