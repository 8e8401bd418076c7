"""DeepFM CTR model (counterpart of ``paddle_tpu/models/deepfm.py``).

One combined table [V, 1 + K], looked up with a row-sparse gradient
(``lookup_table(sparse=True)``): column 0 is each id's first-order
weight, columns 1..K its embedding. Per example of F fields:

- first order: the sum of the F first-order weights;
- FM: ``0.5 * sum_k((sum_f e_fk)^2 - sum_f e_fk^2)``;
- deep: the [F * K] embeddings through ``fc`` 400, 400, 400 (relu) and
  ``fc`` 1;
- logit = (first order + FM) + deep; the loss is the mean
  ``sigmoid_cross_entropy_with_logits`` against the label, ``prob`` the
  sigmoid of the logit.

:func:`build` has the JAX ``build``'s defaults and its lazy Adam: only
the rows a batch touched move. The table can live on a hot-rows cache
over a sharded fleet (``ops/embed_cache.py`` ``enable_sharded_table``):
then :meth:`DeepFM.forward` takes cache slots in place of vocab ids, as
``HotRowsCache.translate`` gives them. Scope weights carry across with
``convert.deepfm_params_from_jax``.
The training program of the same model is
``paddle_tpu_torch/fluid/models/deepfm.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ops import nn_ops

HIDDEN = (400, 400, 400)


def param_shapes(num_fields: int, vocab_size: int, embed_dim: int,
                 hidden_sizes=HIDDEN):
    """{state key: shape} of :class:`DeepFM`'s parameters: ``emb``, then
    ``fc_w<i>`` / ``fc_b<i>`` of each ``fc`` in order (the last to 1)."""
    shapes = {"emb": (vocab_size, 1 + embed_dim)}
    widths = [num_fields * embed_dim, *hidden_sizes, 1]
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"fc_w{i}"] = (a, b)
        shapes[f"fc_b{i}"] = (b,)
    return shapes


class DeepFM(nn.Module):
    """``forward(ids [B, F] or [B, F, 1], label [B, 1])`` -> (mean loss,
    prob [B, 1])."""

    def __init__(self, num_fields: int = 26, vocab_size: int = 100000,
                 embed_dim: int = 16, hidden_sizes=HIDDEN, device=None):
        super().__init__()
        self.num_fields, self.vocab_size = int(num_fields), int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.n_fc = len(hidden_sizes) + 1
        for key, shape in param_shapes(num_fields, vocab_size, embed_dim,
                                       hidden_sizes).items():
            setattr(self, key, nn.Parameter(torch.zeros(shape)))
        self.reset_parameters()
        self.to(_device.resolve(device))

    @torch.no_grad()
    def reset_parameters(self):
        """The table uniform in [-0.01, 0.01] (the JAX model's
        initializer), the ``fc`` weights Xavier-uniform, the biases 0."""
        self.emb.uniform_(-0.01, 0.01)
        for i in range(self.n_fc):
            w = getattr(self, f"fc_w{i}")
            bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            w.uniform_(-bound, bound)
            getattr(self, f"fc_b{i}").zero_()

    def logit(self, ids):
        if ids.dim() == 3:
            ids = ids[..., 0]
        k = self.embed_dim
        both = nn_ops.lookup_table(self.emb, ids[..., None],
                                   sparse=True)          # [B, F, 1+K]
        w1 = nn_ops.slice(both, axes=[2], starts=[0], ends=[1])
        first_order = nn_ops.reduce_sum(w1, dim=1)               # [B, 1]
        emb = nn_ops.slice(both, axes=[2], starts=[1], ends=[1 + k])
        sum_sq = nn_ops.square(nn_ops.reduce_sum(emb, dim=1))    # [B, K]
        sq_sum = nn_ops.reduce_sum(nn_ops.square(emb), dim=1)
        fm = nn_ops.scale(nn_ops.reduce_sum(sum_sq - sq_sum, dim=1,
                                            keep_dim=True), 0.5)  # [B, 1]
        deep = nn_ops.reshape(emb, [-1, self.num_fields * k])
        for i in range(self.n_fc - 1):
            deep = nn_ops.fc(deep, getattr(self, f"fc_w{i}"),
                             getattr(self, f"fc_b{i}"), act="relu")
        last = self.n_fc - 1
        deep_out = nn_ops.fc(deep, getattr(self, f"fc_w{last}"),
                             getattr(self, f"fc_b{last}"))
        return (first_order + fm) + deep_out

    def forward(self, ids, label):
        logit = self.logit(ids)
        loss = nn_ops.mean(nn_ops.sigmoid_cross_entropy_with_logits(
            logit, label.reshape(logit.shape).to(logit.dtype)))
        return loss, nn_ops.sigmoid(logit)


def build(num_fields: int = 26, vocab_size: int = 100000,
          embed_dim: int = 16, lr: float = 1e-3, device=None):
    """-> (model, optimizer, feed specs). The optimizer is the JAX
    package's Adam at ``lr`` with ``lazy_mode=True`` (beta1 0.9, beta2
    0.999, epsilon 1e-8). Runs on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for)."""
    model = DeepFM(num_fields, vocab_size, embed_dim, device=device)
    feed_specs = {"feat_ids": ([-1, num_fields, 1], "int64"),
                  "label": ([-1, 1], "float32")}
    return model.train(), Adam(model.parameters(), learning_rate=lr,
                               beta1=0.9, beta2=0.999, epsilon=1e-8,
                               lazy_mode=True), feed_specs
