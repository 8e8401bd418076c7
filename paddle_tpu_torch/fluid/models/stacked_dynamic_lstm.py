"""The stacked dynamic-LSTM classifier's training program (counterpart of
``paddle_tpu/models/stacked_dynamic_lstm.py``: embedding -> fc + LSTM
stack -> max sequence pools -> softmax fc) built from the port's
``fluid.layers``. Batches are padded ``words`` [B, T] with ``seq_lens``
[B]; on the card each ``dynamic_lstm`` trains through the LSTM kernels.
The nn.Module trainer is ``paddle_tpu_torch/models/
stacked_dynamic_lstm.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers


def lstm_net(data, seq_lens, dict_dim, emb_dim=512, hid_dim=512,
             stacked_num=3, class_dim=2):
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                   seq_lens=seq_lens)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4, num_flatten_dims=2)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                      is_reverse=False, seq_lens=seq_lens)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], pool_type="max",
                                   seq_lens=seq_lens)
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max",
                                     seq_lens=seq_lens)
    return layers.fc(input=[fc_last, lstm_last], size=class_dim,
                     act="softmax")


def build(is_train: bool = True, dict_dim: int = 5000, max_len: int = 100,
          emb_dim: int = 512, hid_dim: int = 512, stacked_num: int = 3,
          lr: float = 0.001):
    data = layers.data(name="words", shape=[max_len], dtype="int64")
    seq_lens = layers.data(name="seq_lens", shape=[], dtype="int32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    prediction = lstm_net(data, seq_lens, dict_dim, emb_dim, hid_dim,
                          stacked_num)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    if is_train:
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    feed_specs = {"words": ([-1, max_len], "int64"),
                  "seq_lens": ([-1], "int32"),
                  "label": ([-1, 1], "int64")}
    return avg_cost, [acc], feed_specs
