"""Stacked dynamic-LSTM sentiment classifier (counterpart of
``paddle_tpu/models/stacked_dynamic_lstm.py``): embedding -> ``fc`` ->
``dynamic_lstm``, then ``stacked_num - 1`` times a two-input ``fc`` over
the previous ``[fc, lstm]`` pair and another ``dynamic_lstm``, a max pool
over time of the last pair, and a two-input softmax ``fc`` (``lstm_net``,
``:17-34``).

Batches are padded ``words`` [B, T] ids with ``seq_lens`` [B]; the LSTMs
and the pools mask the padding. Every ``dynamic_lstm`` uses peepholes and
the default cell, so on the card each runs the whole-sequence LSTM kernels
(``ops/kernels/fused_rnn.py``): one forward and one backward launch per
layer and step. The input projections are ``torch.matmul``, as the JAX
package leaves them to XLA.

:func:`build` makes the model, its Adam and the feed specs, with the JAX
``build``'s names and defaults (``:37-53``). Scope weights carry across
with ``convert.lstm_params_from_jax``. The training program of the same
model is ``paddle_tpu_torch/fluid/models/stacked_dynamic_lstm.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ops import nn_ops, rnn_ops, sequence_ops


class LSTMLayer(nn.Module):
    """One ``fc`` + ``dynamic_lstm`` pair: ``fc_w0`` projects the previous
    ``fc`` output (the embedding, in the first layer) and ``fc_w1`` the
    previous LSTM output (absent in the first layer) to the 4H gate
    pre-activations; ``lstm_w`` [H, 4H] is recurrent and ``lstm_b`` [1, 7H]
    holds the gate bias and the three peephole vectors."""

    def __init__(self, in_dim: int, hid_dim: int, first: bool):
        super().__init__()
        h4 = 4 * hid_dim
        self.fc_w0 = nn.Parameter(torch.zeros(in_dim, h4))
        if not first:
            self.fc_w1 = nn.Parameter(torch.zeros(hid_dim, h4))
        self.fc_b = nn.Parameter(torch.zeros(h4))
        self.lstm_w = nn.Parameter(torch.zeros(hid_dim, h4))
        self.lstm_b = nn.Parameter(torch.zeros(1, 7 * hid_dim))

    def forward(self, inputs, seq_lens, amp=None):
        if len(inputs) == 1:
            proj = nn_ops.fc(inputs[0], self.fc_w0, self.fc_b, amp=amp)
        else:
            proj = nn_ops.fc(inputs, [self.fc_w0, self.fc_w1], self.fc_b,
                             amp=amp)
        hidden, _, _, _ = rnn_ops.dynamic_lstm(
            proj, self.lstm_w, self.lstm_b, seq_lens=seq_lens,
            use_peepholes=True)
        return [proj, hidden]


class StackedDynamicLSTM(nn.Module):
    """``forward(words [B,T] int64, seq_lens [B] int32, label [B,1] int64)``
    -> (mean cross entropy, top-1 accuracy [1]); :meth:`predict` gives the
    class probabilities [B, class_dim]. ``amp`` holds the AMP tags of
    each op type (empty: fp32), set by
    ``contrib.mixed_precision.rewrite_program_amp`` from
    :meth:`op_sites`."""

    def __init__(self, dict_dim: int = 5000, emb_dim: int = 512,
                 hid_dim: int = 512, stacked_num: int = 3,
                 class_dim: int = 2, device=None):
        super().__init__()
        if stacked_num < 1:
            raise ValueError(f"stacked_num {stacked_num} < 1")
        self.dict_dim, self.emb_dim = int(dict_dim), int(emb_dim)
        self.hid_dim, self.stacked_num = int(hid_dim), int(stacked_num)
        self.class_dim = int(class_dim)
        self.amp = {}
        self.emb = nn.Parameter(torch.zeros(dict_dim, emb_dim))
        self.layers = nn.ModuleList(
            LSTMLayer(emb_dim if i == 0 else 4 * hid_dim, hid_dim, i == 0)
            for i in range(stacked_num))
        self.head_w0 = nn.Parameter(torch.zeros(4 * hid_dim, class_dim))
        self.head_w1 = nn.Parameter(torch.zeros(hid_dim, class_dim))
        self.head_b = nn.Parameter(torch.zeros(class_dim))
        self.reset_parameters()
        self.to(_device.resolve(device))

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def op_sites(self):
        """The op type of each site of ``lstm_net``'s forward that the AMP
        rewrite reads, one entry a site: its ``dynamic_lstm`` ops make
        ``pure=None`` choose conservative mode."""
        layer = ["mul", "elementwise_add", "dynamic_lstm"]
        return (["lookup_table"] + layer
                + (["mul"] + layer) * (self.stacked_num - 1)
                + ["mul", "mul", "elementwise_add"])

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Matrices and the embedding Xavier-uniform, biases (the LSTMs'
        peepholes among them) 0: the JAX layers' defaults."""
        for name, p in self.named_parameters():
            if name.endswith("_b"):
                p.zero_()
            else:
                bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                p.uniform_(-bound, bound, generator=generator)

    def predict(self, words, seq_lens):
        inputs = [nn_ops.lookup_table(self.emb, words[..., None],
                                      amp=self.amp)]
        for layer in self.layers:
            inputs = layer(inputs, seq_lens, self.amp)
        pooled = [sequence_ops.sequence_pool(x, seq_lens, "MAX")
                  for x in inputs]
        return nn_ops.fc(pooled, [self.head_w0, self.head_w1], self.head_b,
                         act="softmax", amp=self.amp)

    def forward(self, words, seq_lens, label):
        prediction = self.predict(words, seq_lens)
        cost = nn_ops.cross_entropy(prediction, label)
        acc, _, _ = nn_ops.accuracy(prediction, label)
        return nn_ops.mean(cost), acc


def build(is_train: bool = True, dict_dim: int = 5000, max_len: int = 100,
          emb_dim: int = 512, hid_dim: int = 512, stacked_num: int = 3,
          lr: float = 0.001, device=None):
    """-> (model, optimizer, feed specs). The optimizer is the JAX
    package's Adam at ``lr`` (beta1 0.9, beta2 0.999, epsilon 1e-8), None
    with ``is_train=False``. ``max_len`` only shapes the feed specs: the
    model takes any T. Runs on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for)."""
    model = StackedDynamicLSTM(dict_dim, emb_dim, hid_dim, stacked_num,
                               device=device)
    feed_specs = {"words": ([-1, max_len], "int64"),
                  "seq_lens": ([-1], "int32"),
                  "label": ([-1, 1], "int64")}
    if not is_train:
        return model.eval(), None, feed_specs
    return model.train(), Adam(model.parameters(), learning_rate=lr,
                               beta1=0.9, beta2=0.999,
                               epsilon=1e-8), feed_specs
