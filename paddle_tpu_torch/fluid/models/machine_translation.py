"""The attention-GRU seq2seq translation programs (counterpart of
``paddle_tpu/models/machine_translation.py:25-123``), built from the
port's ``fluid.layers``.

- Training (``is_train=True``): the source embedding, ``fc`` to 3H and
  ``dynamic_gru`` (the encoder); the decoder's first state ``tanh(fc(
  enc[:, max_len - 1]))``; the target embedding, ``fc`` without bias and
  ``dynamic_gru`` from that state; Luong attention over all decoder
  states at once, the tanh combiner, the vocabulary head, the mean
  ``softmax_with_cross_entropy`` and lazy Adam. On the card both
  ``dynamic_gru`` ops run the whole-sequence GRU kernels
  (``ops/kernels/fused_rnn.py``): two forward and two backward launches
  a step.
- Inference (``is_train=False``): the same encoder and first state, then
  the decoder's parameters declared under their training names with
  ``LayerHelper.create_parameter`` and one ``attention_gru_beam_decode``
  op (``ops/beam_ops.py``), so the program reads the trained weights
  from the scope. Its encoder GRU is one forward launch a run.

The nn.Module trainer and beam decoder are
``paddle_tpu_torch/models/machine_translation.py``."""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def _p(name):
    return fluid.ParamAttr(name=name)


def _encoder(src, src_vocab, emb_dim, hid_dim):
    emb = layers.embedding(src, size=[src_vocab, emb_dim],
                           param_attr=_p("mt.src_emb"))
    proj = layers.fc(emb, size=3 * hid_dim, num_flatten_dims=2,
                     param_attr=_p("mt.enc_proj.w"),
                     bias_attr=_p("mt.enc_proj.b"))
    enc = layers.dynamic_gru(proj, size=hid_dim,
                             param_attr=_p("mt.enc_gru.w"),
                             bias_attr=_p("mt.enc_gru.b"))
    return enc


def _dec_h0(enc, max_len, hid_dim):
    enc_last = layers.squeeze(
        layers.slice(enc, axes=[1], starts=[max_len - 1], ends=[max_len]),
        axes=[1])
    return layers.fc(enc_last, size=hid_dim, act="tanh",
                     param_attr=_p("mt.h0.w"), bias_attr=_p("mt.h0.b"))


def build(is_train=True, src_vocab=30, tgt_vocab=30, max_len=8,
          emb_dim=32, hid_dim=32, beam_size=4, start_id=1, end_id=0,
          lr=1e-3):
    """Returns (loss, fetches, feed_specs) for training, or
    (sentence_ids, sentence_scores, feed_specs) for inference."""
    src = layers.data(name="src", shape=[max_len], dtype="int64")
    enc = _encoder(src, src_vocab, emb_dim, hid_dim)
    dec_h0 = _dec_h0(enc, max_len, hid_dim)

    if is_train:
        tgt_in = layers.data(name="tgt_in", shape=[max_len], dtype="int64")
        tgt_out = layers.data(name="tgt_out", shape=[max_len], dtype="int64")
        temb = layers.embedding(tgt_in, size=[tgt_vocab, emb_dim],
                                param_attr=_p("mt.tgt_emb"))
        dproj = layers.fc(temb, size=3 * hid_dim, num_flatten_dims=2,
                          param_attr=_p("mt.dec_proj.w"), bias_attr=False)
        dec = layers.dynamic_gru(dproj, size=hid_dim, h_0=dec_h0,
                                 param_attr=_p("mt.dec_gru.w"),
                                 bias_attr=_p("mt.dec_gru.b"))
        # Luong attention over all decoder states at once
        scores = layers.matmul(dec, layers.transpose(enc, perm=[0, 2, 1]))
        probs = layers.softmax(layers.scale(scores, scale=hid_dim ** -0.5))
        ctx = layers.matmul(probs, enc)
        combined = layers.fc(layers.concat([dec, ctx], axis=2),
                             size=hid_dim, num_flatten_dims=2, act="tanh",
                             param_attr=_p("mt.attn.w"), bias_attr=False)
        logits = layers.fc(combined, size=tgt_vocab, num_flatten_dims=2,
                           param_attr=_p("mt.out.w"),
                           bias_attr=_p("mt.out.b"))
        loss = layers.softmax_with_cross_entropy(
            layers.reshape(logits, shape=[-1, tgt_vocab]),
            layers.reshape(tgt_out, shape=[-1, 1]))
        avg = layers.mean(loss)
        # lazy Adam: the two tables' row-sparse gradients move only the
        # B*T gathered rows
        fluid.optimizer.Adam(learning_rate=lr, lazy_mode=True).minimize(avg)
        feed_specs = {"src": ([-1, max_len], "int64"),
                      "tgt_in": ([-1, max_len], "int64"),
                      "tgt_out": ([-1, max_len], "int64")}
        return avg, [avg], feed_specs

    # inference: the decoder's parameters under their training names,
    # handed to the whole-loop beam decoder
    helper = LayerHelper("mt_decode")
    temb = helper.create_parameter(_p("mt.tgt_emb"),
                                   shape=[tgt_vocab, emb_dim])
    proj_w = helper.create_parameter(_p("mt.dec_proj.w"),
                                     shape=[emb_dim, 3 * hid_dim])
    gru_w = helper.create_parameter(_p("mt.dec_gru.w"),
                                    shape=[hid_dim, 3 * hid_dim])
    gru_b = helper.create_parameter(_p("mt.dec_gru.b"),
                                    shape=[1, 3 * hid_dim], is_bias=True)
    attn_w = helper.create_parameter(_p("mt.attn.w"),
                                     shape=[2 * hid_dim, hid_dim])
    out_w = helper.create_parameter(_p("mt.out.w"),
                                    shape=[hid_dim, tgt_vocab])
    out_b = helper.create_parameter(_p("mt.out.b"), shape=[tgt_vocab],
                                    is_bias=True)
    # dec_proj has no bias in training; the op takes a ProjB slot
    zero_b = layers.fill_constant([3 * hid_dim], "float32", 0.0)
    sent = helper.create_variable_for_type_inference("int32")
    ssc = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "attention_gru_beam_decode",
        inputs={"EncOut": [enc], "H0": [dec_h0], "Emb": [temb],
                "ProjW": [proj_w], "ProjB": [zero_b],
                "GruW": [gru_w], "GruB": [gru_b], "AttnW": [attn_w],
                "OutW": [out_w], "OutB": [out_b]},
        outputs={"SentenceIds": [sent], "SentenceScores": [ssc]},
        attrs={"beam_size": beam_size, "max_len": max_len,
               "start_id": start_id, "end_id": end_id})
    feed_specs = {"src": ([-1, max_len], "int64")}
    return sent, ssc, feed_specs
