"""The MNIST CNN (counterpart of ``paddle_tpu/models/mnist.py``): two
``simple_img_conv_pool`` blocks (5x5 convs of 20 and 50 filters, relu, 2x2
max pools) and a softmax ``fc`` of 10 classes, ``cross_entropy``,
``mean`` and Adam (``:10-32``). Input [N, 1, 28, 28]. The training
program of the same model is ``paddle_tpu_torch/fluid/models/mnist.py``.
"""

from __future__ import annotations

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers, nets
from paddle_tpu_torch.models.classifier import ImageClassifier, feed_specs
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Adam


class MNIST(ImageClassifier):
    """``predict`` gives the class probabilities [N, 10] (the ``fc``'s
    softmax); the loss is their ``cross_entropy``."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = nets.SimpleImgConvPool(1, 20, 5, 2, 2, act="relu")
        self.conv2 = nets.SimpleImgConvPool(20, 50, 5, 2, 2, act="relu")
        self.fc = layers.FC(50 * 4 * 4, 10, act="softmax")
        self.to(_device.resolve(device))

    def op_sites(self):
        return (self.conv1.op_sites() + self.conv2.op_sites()
                + self.fc.op_sites())

    def predict(self, pixel):
        return self.fc(self.conv2(self.conv1(pixel, self.amp), self.amp),
                       self.amp)

    def forward(self, pixel, label):
        pred = self.predict(pixel)
        acc, _, _ = nn_ops.accuracy(pred, label)
        return nn_ops.mean(nn_ops.cross_entropy(pred, label)), acc


def build(is_train: bool = True, lr: float = 0.001, device=None):
    """-> (model, Adam at ``lr`` or None with ``is_train=False``, feed
    specs ``pixel`` and ``label``). Runs on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for)."""
    model = MNIST(device)
    specs = feed_specs(28, 1, "pixel")
    return model, (Adam(model.parameters(), learning_rate=lr)
                   if is_train else None), specs
