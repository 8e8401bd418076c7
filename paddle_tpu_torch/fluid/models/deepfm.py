"""The DeepFM CTR program (counterpart of ``paddle_tpu/models/deepfm.py:
22-76``): one combined [V, 1 + K] table (column 0 the first-order weight,
columns 1..K the embedding) named ``deepfm_emb``, the first-order sum,
the FM term, the deep tower (``fc`` 400 x 3 relu, ``fc`` 1), the mean
``sigmoid_cross_entropy_with_logits`` and lazy Adam, built from the
port's ``fluid.layers``. The table's gradient is row-sparse through the
port's executor (``ops/grad_ops.py``), so lazy Adam moves only the
gathered rows. The nn.Module trainer is
``paddle_tpu_torch/models/deepfm.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def deepfm(field_ids, num_fields, vocab_size, embed_dim=16,
           hidden_sizes=(400, 400, 400), name="deepfm"):
    # one table [V, 1 + K] gathered once: column 0 first order, 1..K the
    # FM / deep embedding
    both = layers.embedding(
        field_ids, size=[vocab_size, 1 + embed_dim],
        param_attr=fluid.ParamAttr(
            name=name + "_emb",
            initializer=fluid.initializer.Uniform(-0.01, 0.01)))
    w1 = layers.slice(both, axes=[2], starts=[0], ends=[1])
    first_order = layers.reduce_sum(w1, dim=1)          # [B, 1]

    # the second-order FM term over the field embeddings [B, F, K]
    emb = layers.slice(both, axes=[2], starts=[1], ends=[1 + embed_dim])
    sum_emb = layers.reduce_sum(emb, dim=1)             # [B, K]
    sum_sq = layers.square(sum_emb)
    sq_emb = layers.square(emb)
    sq_sum = layers.reduce_sum(sq_emb, dim=1)
    fm = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True),
        scale=0.5)                                      # [B, 1]

    # the deep component
    deep = layers.reshape(emb, shape=[-1, num_fields * embed_dim])
    for h in hidden_sizes:
        deep = layers.fc(deep, size=h, act="relu")
    deep_out = layers.fc(deep, size=1)

    logit = layers.elementwise_add(
        layers.elementwise_add(first_order, fm), deep_out)
    return logit


def build(is_train: bool = True, num_fields: int = 26,
          vocab_size: int = 100000, embed_dim: int = 16, lr: float = 1e-3):
    ids = layers.data(name="feat_ids", shape=[num_fields, 1], dtype="int64")
    label = layers.data(name="label", shape=[1], dtype="float32")
    logit = deepfm(ids, num_fields, vocab_size, embed_dim)
    loss_vec = layers.sigmoid_cross_entropy_with_logits(logit, label)
    loss = layers.mean(loss_vec)
    prob = layers.sigmoid(logit)
    if is_train:
        fluid.optimizer.Adam(learning_rate=lr,
                             lazy_mode=True).minimize(loss)
    feed_specs = {"feat_ids": ([-1, num_fields, 1], "int64"),
                  "label": ([-1, 1], "float32")}
    return loss, [prob], feed_specs
