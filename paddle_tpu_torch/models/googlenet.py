"""GoogLeNet / Inception-v1 (counterpart of
``paddle_tpu/models/googlenet.py``): a 7x7 stride-2 conv, 3x3 stride-2 max
pools (padding 1), a 1x1 and a 3x3 conv, nine inception modules (1x1,
reduced 3x3, reduced 5x5 and pool-projection branches concatenated on
the channels), a global average pool, dropout 0.4 and ``fc`` class_dim.
In training two auxiliary heads on the outputs of 4a and 4d (a 5x5
stride-3 average pool, a 1x1 conv of 128, ``fc`` 1024 relu, dropout 0.7,
``fc`` class_dim) add their losses at 0.3 each: ``sums([main,
scale(sums([aux1, aux2]), 0.3)])`` (``:85-92``). Every conv has a bias
and relu; Momentum 0.9. The last dropout takes ``is_test=not is_train``,
the heads' dropouts none.
The training program of the same model is
``paddle_tpu_torch/fluid/models/googlenet.py``.
"""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch import layers
from paddle_tpu_torch.models.classifier import (ImageClassifier,
                                                feed_specs, pooled)
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.optimizer import Momentum

# (c1, c3r, c3, c5r, c5, proj) of 3a-3b, 4a-4e, 5a-5b; a max pool before
# the first of 4 and of 5
INCEPTIONS = (((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64)),
              ((192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
               (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
               (256, 160, 320, 32, 128, 128)),
              ((256, 160, 320, 32, 128, 128),
               (384, 192, 384, 48, 128, 128)))
AUX_AFTER = ((1, 0), (1, 3))             # 4a and 4d
AUX_WEIGHT = 0.3


def _conv(cin, cout, k, stride=1, padding=0):
    return layers.Conv2D(cin, cout, k, stride, padding, act="relu")


class Inception(nn.Module):

    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv(cin, c1, 1)
        self.b3r, self.b3 = _conv(cin, c3r, 1), _conv(c3r, c3, 3, padding=1)
        self.b5r, self.b5 = _conv(cin, c5r, 1), _conv(c5r, c5, 5, padding=2)
        self.proj = _conv(cin, proj, 1)
        self.width = c1 + c3 + c5 + proj

    def op_sites(self):
        return [site for m in (self.b1, self.b3r, self.b3, self.b5r,
                               self.b5, self.proj) for site in m.op_sites()]

    def forward(self, x, amp=None):
        pool = nn_ops.pool2d(x, 3, "max", 1, 1)
        return nn_ops.concat([self.b1(x, amp),
                              self.b3(self.b3r(x, amp), amp),
                              self.b5(self.b5r(x, amp), amp),
                              self.proj(pool, amp)], axis=1)


class AuxHead(nn.Module):

    def __init__(self, cin: int, side: int, class_dim: int):
        super().__init__()
        side = pooled(side, 5, 3)
        self.conv = _conv(cin, 128, 1)
        self.fc1 = layers.FC(128 * side * side, 1024, act="relu")
        self.drop = layers.Dropout(0.7)
        self.fc2 = layers.FC(1024, class_dim)

    def op_sites(self):
        return self.conv.op_sites() + self.fc1.op_sites() \
            + self.fc2.op_sites()

    def forward(self, x, amp=None):
        x = self.conv(nn_ops.pool2d(x, 5, "avg", 3), amp)
        return self.fc2(self.drop(self.fc1(x, amp)), amp)


class GoogLeNet(ImageClassifier):
    """With ``is_train`` the model has the two auxiliary heads and
    :meth:`forward`'s loss is the weighted sum of the three; without, the
    main head's loss alone."""

    def __init__(self, class_dim: int = 1000, image_size: int = 224,
                 is_train: bool = True, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.conv2 = _conv(64, 64, 1)
        self.conv3 = _conv(64, 192, 3, padding=1)
        side = pooled(pooled(pooled(image_size, 7, 2, 3), 3, 2, 1), 3, 2, 1)
        self.stages = nn.ModuleList()
        cin, aux_in = 192, []
        for s, widths in enumerate(INCEPTIONS):
            if s:
                side = pooled(side, 3, 2, 1)
            stage = nn.ModuleList()
            for i, w in enumerate(widths):
                stage.append(Inception(cin, *w))
                cin = stage[-1].width
                if (s, i) in AUX_AFTER:
                    aux_in.append((cin, side))
            self.stages.append(stage)
        self.drop = layers.Dropout(0.4, is_test=not is_train)
        self.fc = layers.FC(cin, class_dim)
        self.aux = nn.ModuleList(AuxHead(c, sd, class_dim)
                                 for c, sd in aux_in) if is_train else None
        self.to(_device.resolve(device))

    def op_sites(self):
        stem = [site for m in (self.conv1, self.conv2, self.conv3)
                for site in m.op_sites()]
        body = [site for stage in self.stages for m in stage
                for site in m.op_sites()]
        aux = [site for h in self.aux for site in h.op_sites()] \
            if self.aux is not None else []
        return stem + body + self.fc.op_sites() + aux

    def _heads(self, data):
        """(the main logits, the auxiliary heads' logits)."""
        amp = self.amp
        x = nn_ops.pool2d(self.conv1(data, amp), 3, "max", 2, 1)
        x = self.conv3(self.conv2(x, amp), amp)
        taps = []
        for s, stage in enumerate(self.stages):
            x = nn_ops.pool2d(x, 3, "max", 2, 1)
            for i, module in enumerate(stage):
                x = module(x, amp)
                if (s, i) in AUX_AFTER:
                    taps.append(x)
        x = self.drop(nn_ops.pool2d(x, 0, "avg", global_pooling=True))
        aux = [h(t, amp) for h, t in zip(self.aux, taps)] \
            if self.aux is not None else []
        return self.fc(x, amp), aux

    def predict(self, data):
        return self._heads(data)[0]

    def forward(self, data, label):
        logits, aux = self._heads(data)
        loss = self.loss(logits, label)
        if aux:
            aux_loss = nn_ops.sums([self.loss(a, label) for a in aux])
            loss = nn_ops.sums([loss, nn_ops.scale(aux_loss, AUX_WEIGHT)])
        acc, _, _ = nn_ops.accuracy(nn_ops.softmax(logits), label)
        return loss, acc


def build(is_train: bool = True, class_dim: int = 1000, lr: float = 0.01,
          image_size: int = 224, device=None):
    """-> (model, Momentum 0.9 at ``lr`` or None with ``is_train=False``,
    feed specs). ``is_train=False`` drops the auxiliary heads and puts the
    last dropout in test mode; the heads' dropouts would stay on until
    ``eval()``. Runs on ``device`` (``cuda`` unless ``"cpu"``)."""
    model = GoogLeNet(class_dim, image_size, is_train, device)
    return model, (Momentum(model.parameters(), lr, 0.9)
                   if is_train else None), feed_specs(image_size)
