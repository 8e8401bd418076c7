"""Attention-GRU seq2seq machine translation with beam-search decoding
(counterpart of ``paddle_tpu/models/machine_translation.py``).

Encoder (``_encoder``, ``:29-38``): the source embedding, ``fc`` with bias
to 3H, ``dynamic_gru``. The decoder's first state (``_dec_h0``,
``:41-46``): ``tanh(enc[:, max_len - 1] @ h0_w + h0_b)``. Training
(``build(is_train=True)``, ``:58-90``): the target embedding, ``fc``
without bias, ``dynamic_gru`` from that state over the whole teacher-forced
target, Luong attention over all decoder states at once (scores scaled by
``hid_dim ** -0.5``, softmax, context), the tanh combiner without bias over
``[dec, ctx]``, the vocabulary head and the mean
``softmax_with_cross_entropy``. Both ``dynamic_gru`` ops take the default
cell, so on the card each runs the whole-sequence GRU kernels
(``ops/kernels/fused_rnn.py``): two forward and two backward launches a
training step. The projections, the attention and the head are
``torch.matmul``, as the JAX package leaves them to XLA.

Decoding (:meth:`MachineTranslation.generate`, the inference program of
``:92-123``): the encoder on the same parameters (one forward GRU launch),
then ``attention_gru_beam_decode`` (``ops/beam_ops.py``) with a zero
``ProjB``. The two tables' gradients are row-sparse (``lookup_table(...,
sparse=True)``) and :func:`build`'s Adam is ``lazy_mode=True`` (``:86``):
only the rows a batch touched move.

:func:`build` has the JAX ``build``'s names and defaults (``:49-51``).
Scope weights carry across with ``convert.mt_params_from_jax``.
The training and inference programs of the same model are
``paddle_tpu_torch/fluid/models/machine_translation.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ops import beam_ops, nn_ops, rnn_ops


def param_shapes(src_vocab: int, tgt_vocab: int, emb_dim: int,
                 hid_dim: int):
    """{state key: shape} of :class:`MachineTranslation`'s parameters."""
    h3 = 3 * hid_dim
    return {"src_emb": (src_vocab, emb_dim), "enc_proj_w": (emb_dim, h3),
            "enc_proj_b": (h3,), "enc_gru_w": (hid_dim, h3),
            "enc_gru_b": (1, h3), "h0_w": (hid_dim, hid_dim),
            "h0_b": (hid_dim,), "tgt_emb": (tgt_vocab, emb_dim),
            "dec_proj_w": (emb_dim, h3), "dec_gru_w": (hid_dim, h3),
            "dec_gru_b": (1, h3), "attn_w": (2 * hid_dim, hid_dim),
            "out_w": (hid_dim, tgt_vocab), "out_b": (tgt_vocab,)}


class MachineTranslation(nn.Module):
    """``forward(src, tgt_in, tgt_out)`` ([B, max_len] int64 each) -> the
    mean cross entropy; :meth:`generate` (src) -> (ids [B, beam_size,
    max_len] int32, lane scores [B, beam_size]). ``amp`` holds the AMP
    tags of each op type of the training forward (empty: fp32), set by
    ``contrib.mixed_precision.rewrite_program_amp`` from :meth:`op_sites`;
    :meth:`generate` stays fp32, as the reference rewrites only its
    training program."""

    def __init__(self, src_vocab: int = 30, tgt_vocab: int = 30,
                 max_len: int = 8, emb_dim: int = 32, hid_dim: int = 32,
                 beam_size: int = 4, start_id: int = 1, end_id: int = 0,
                 device=None):
        super().__init__()
        self.src_vocab, self.tgt_vocab = int(src_vocab), int(tgt_vocab)
        self.max_len, self.emb_dim = int(max_len), int(emb_dim)
        self.hid_dim, self.beam_size = int(hid_dim), int(beam_size)
        self.start_id, self.end_id = int(start_id), int(end_id)
        self.amp = {}
        for key, shape in param_shapes(src_vocab, tgt_vocab, emb_dim,
                                       hid_dim).items():
            setattr(self, key, nn.Parameter(torch.zeros(shape)))
        self.reset_parameters()
        self.to(_device.resolve(device))

    @torch.no_grad()
    def reset_parameters(self):
        """Matrices and tables Xavier-uniform, biases 0: the JAX layers'
        defaults."""
        for name, p in self.named_parameters():
            if name.endswith("_b"):
                p.zero_()
            else:
                bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                p.uniform_(-bound, bound)

    def op_sites(self):
        """The op type of each site of the training forward that the AMP
        rewrite reads, one entry a site: its ``dynamic_gru`` ops make
        ``pure=None`` choose conservative mode."""
        add = "elementwise_add"
        return (["lookup_table", "mul", add, "dynamic_gru", "mul", add,
                 "lookup_table", "mul", "dynamic_gru", "matmul", "matmul",
                 "mul", "mul", add])

    def encode(self, src, amp=None):
        """-> (enc [B, T, H], the decoder's first state [B, H])."""
        emb = nn_ops.lookup_table(self.src_emb, src[..., None],
                                  sparse=True, amp=amp)
        proj = nn_ops.fc(emb, self.enc_proj_w, self.enc_proj_b, amp=amp)
        enc, _ = rnn_ops.dynamic_gru(proj, self.enc_gru_w, self.enc_gru_b)
        dec_h0 = nn_ops.fc(enc[:, self.max_len - 1], self.h0_w, self.h0_b,
                           act="tanh", amp=amp)
        return enc, dec_h0

    def forward(self, src, tgt_in, tgt_out):
        amp = self.amp
        enc, dec_h0 = self.encode(src, amp)
        temb = nn_ops.lookup_table(self.tgt_emb, tgt_in[..., None],
                                   sparse=True, amp=amp)
        dproj = nn_ops.fc(temb, self.dec_proj_w, amp=amp)
        dec, _ = rnn_ops.dynamic_gru(dproj, self.dec_gru_w, self.dec_gru_b,
                                     h0=dec_h0)
        # Luong attention over all decoder states at once
        scores = nn_ops.matmul(dec, enc, transpose_y=True, amp=amp)
        probs = nn_ops.softmax(nn_ops.scale(scores, self.hid_dim ** -0.5))
        ctx = nn_ops.matmul(probs, enc, amp=amp)
        combined = nn_ops.fc(torch.cat([dec, ctx], dim=2), self.attn_w,
                             act="tanh", amp=amp)
        logits = nn_ops.fc(combined, self.out_w, self.out_b, amp=amp)
        loss = nn_ops.softmax_with_cross_entropy(
            logits.reshape(-1, self.tgt_vocab), tgt_out.reshape(-1, 1))
        return nn_ops.mean(loss)

    @torch.no_grad()
    def generate(self, src):
        enc, dec_h0 = self.encode(src)
        # dec_proj has no bias in training; the decoder takes a zero ProjB
        zero_b = torch.zeros(3 * self.hid_dim, dtype=enc.dtype,
                             device=enc.device)
        return beam_ops.attention_gru_beam_decode(
            enc, dec_h0, self.tgt_emb, self.dec_proj_w, zero_b,
            self.dec_gru_w, self.dec_gru_b, self.attn_w, self.out_w,
            self.out_b, self.beam_size, self.max_len, self.start_id,
            self.end_id)


def build(is_train: bool = True, src_vocab: int = 30, tgt_vocab: int = 30,
          max_len: int = 8, emb_dim: int = 32, hid_dim: int = 32,
          beam_size: int = 4, start_id: int = 1, end_id: int = 0,
          lr: float = 1e-3, device=None):
    """-> (model, optimizer, feed specs). The optimizer is the JAX
    package's Adam at ``lr`` with ``lazy_mode=True`` (beta1 0.9, beta2
    0.999, epsilon 1e-8), None with ``is_train=False``, whose feed is the
    source alone. Runs on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for)."""
    model = MachineTranslation(src_vocab, tgt_vocab, max_len, emb_dim,
                               hid_dim, beam_size, start_id, end_id,
                               device=device)
    if not is_train:
        return model.eval(), None, {"src": ([-1, max_len], "int64")}
    feed_specs = {"src": ([-1, max_len], "int64"),
                  "tgt_in": ([-1, max_len], "int64"),
                  "tgt_out": ([-1, max_len], "int64")}
    return model.train(), Adam(model.parameters(), learning_rate=lr,
                               beta1=0.9, beta2=0.999, epsilon=1e-8,
                               lazy_mode=True), feed_specs
