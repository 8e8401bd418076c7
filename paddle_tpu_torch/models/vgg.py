"""VGG16 (counterpart of ``paddle_tpu/models/vgg.py``): five
``img_conv_group`` blocks of 2, 2, 3, 3 and 3 3x3 convs (64, 128, 256, 512
and 512 filters), each conv with bias then batch norm with relu, a 2x2
max pool a block; ``fc`` 4096, batch norm with relu, dropout 0.5, ``fc``
4096, ``fc`` class_dim; softmax cross entropy and Momentum 0.9
(``:10-43``). The block's batch norms and the dropout take no
``is_test``; the batch norm after the first ``fc`` does.
The training program of the same model is
``paddle_tpu_torch/fluid/models/vgg.py``.
"""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers, nets
from paddle_tpu_torch.models.classifier import ImageClassifier, feed_specs
from paddle_tpu_torch.optimizer import Momentum

BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(ImageClassifier):

    def __init__(self, class_dim: int = 1000, image_size: int = 224,
                 is_test: bool = False, device=None):
        super().__init__()
        self.blocks = nn.ModuleList()
        c, side = 3, image_size
        for filters, n in BLOCKS:
            self.blocks.append(nets.ImgConvGroup(
                c, [filters] * n, 2, conv_act="relu",
                conv_with_batchnorm=True, pool_stride=2))
            c, side = filters, side // 2
        self.fc1 = layers.FC(512 * side * side, 4096)
        self.bn = layers.BatchNorm(4096, act="relu", is_test=is_test)
        self.drop = layers.Dropout(0.5)
        self.fc2 = layers.FC(4096, 4096)
        self.fc3 = layers.FC(4096, class_dim)
        self.to(_device.resolve(device))

    def op_sites(self):
        return ([site for b in self.blocks for site in b.op_sites()]
                + self.fc1.op_sites() + self.fc2.op_sites()
                + self.fc3.op_sites())

    def predict(self, data):
        x = data
        for block in self.blocks:
            x = block(x, self.amp)
        x = self.drop(self.bn(self.fc1(x, self.amp)))
        return self.fc3(self.fc2(x, self.amp), self.amp)


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224, device=None):
    """-> (model, Momentum 0.9 at ``lr`` or None with ``is_train=False``,
    feed specs). ``is_train=False`` puts the batch norm after the first
    ``fc`` in test mode, as the JAX build passes it ``is_test``; the
    model stays in training mode, the program as built (``eval()`` for
    the test program). Runs on ``device`` (``cuda`` unless ``"cpu"``)."""
    model = VGG16(class_dim, image_size, not is_train, device)
    return model, (Momentum(model.parameters(), lr, 0.9)
                   if is_train else None), feed_specs(image_size)
