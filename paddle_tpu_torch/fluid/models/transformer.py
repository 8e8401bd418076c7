"""The Transformer-base training program (counterpart of
``paddle_tpu/models/transformer.py``: ``_const_var``,
``multi_head_attention``, ``ffn``, the encoder and decoder layers and
``transformer`` (``:21-227``), and ``build`` (``:701-769``)): the
encoder-decoder with pre-norm residuals, built from the port's
``fluid.layers`` into the default programs.

With ``fused_attention`` every attention is one ``fused_attention_block``
op (the flash kernels on the card); with ``fused_head`` the vocabulary
projection and the label-smoothed loss are one ``fused_linear_ce`` op
(the fused-CE kernels). ``lr_scheduler="noam"`` appends the Noam
schedule (``fluid/learning_rate_scheduler.py`` ``noam_decay``). The
nn.Module trainer of the same model is ``paddle_tpu_torch/models/
transformer.py``, whose ``position_encoding`` gives the table here.
"""

from __future__ import annotations

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import layers
from paddle_tpu_torch.fluid.initializer import NumpyArrayInitializer
from paddle_tpu_torch.fluid.learning_rate_scheduler import noam_decay
from paddle_tpu_torch.models.transformer import position_encoding

__all__ = ["build", "transformer", "position_encoding"]


def _const_var(name, value):
    """A non-trainable persistable table (positional encodings, masks)."""
    main = fluid.default_main_program()
    startup = fluid.default_startup_program()
    value = np.asarray(value, dtype=np.float32)
    v = main.global_block().create_var(
        name=name, shape=list(value.shape), dtype="float32",
        persistable=True, stop_gradient=True)
    sv = startup.global_block().create_var(
        name=name, shape=list(value.shape), dtype="float32", persistable=True)
    NumpyArrayInitializer(value)(sv, startup.global_block())
    return v


def multi_head_attention(q_in, kv_in, d_model, n_head, dropout, mask=None,
                         fused=False, causal=False, name=""):
    d_k = d_model // n_head
    if fused:
        # the fused block expresses causality via `causal`; an additive
        # mask would be silently ignored — fail loudly (ValueError, not
        # assert: must survive python -O)
        if mask is not None:
            raise ValueError(
                "fused attention takes causal=True, not an additive mask")
        # one fused op spanning the projections and the attention
        # (layers.fused_multi_head_attention -> ops/attention_block.py,
        # the flash kernels on the card); attention-weight dropout runs
        # inside, as the composed graph's softmax -> dropout -> matmul
        return layers.fused_multi_head_attention(
            q_in, kv_in, d_model, n_head, causal=causal,
            dropout_prob=dropout)

    q = layers.fc(q_in, size=d_model, num_flatten_dims=2, bias_attr=False)
    k = layers.fc(kv_in, size=d_model, num_flatten_dims=2, bias_attr=False)
    v = layers.fc(kv_in, size=d_model, num_flatten_dims=2, bias_attr=False)

    def split_heads(x):
        # [B, L, D] -> [B, H, L, dk]
        r = layers.reshape(x, shape=[0, 0, n_head, d_k])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    q = layers.scale(q, scale=d_k ** -0.5)
    logits = layers.matmul(q, k, transpose_y=True)   # [B, H, Lq, Lk]
    if mask is not None:
        logits = layers.elementwise_add(logits, mask)
    weights = layers.softmax(logits)
    if dropout:
        weights = layers.dropout(weights, dropout_prob=dropout,
                                 dropout_implementation="upscale_in_train")
    ctx = layers.matmul(weights, v)                  # [B, H, Lq, dk]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False)


def ffn(x, d_model, d_inner, dropout):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu")
    if dropout:
        h = layers.dropout(h, dropout_prob=dropout,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, size=d_model, num_flatten_dims=2)


def _residual(x, sub, dropout):
    if dropout:
        sub = layers.dropout(sub, dropout_prob=dropout,
                             dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, sub)


def encoder_layer(x, d_model, d_inner, n_head, dropout, fused=False):
    attn_in = layers.layer_norm(x, begin_norm_axis=2)
    attn = multi_head_attention(attn_in, attn_in, d_model, n_head, dropout,
                                fused=fused)
    x = _residual(x, attn, dropout)
    ffn_in = layers.layer_norm(x, begin_norm_axis=2)
    return _residual(x, ffn(ffn_in, d_model, d_inner, dropout), dropout)


def decoder_layer(x, enc_out, causal_mask, d_model, d_inner, n_head,
                  dropout, fused=False):
    self_in = layers.layer_norm(x, begin_norm_axis=2)
    self_attn = multi_head_attention(
        self_in, self_in, d_model, n_head, dropout,
        mask=None if fused else causal_mask, fused=fused, causal=fused)
    x = _residual(x, self_attn, dropout)
    cross_in = layers.layer_norm(x, begin_norm_axis=2)
    cross = multi_head_attention(cross_in, enc_out, d_model, n_head, dropout,
                                 fused=fused)
    x = _residual(x, cross, dropout)
    ffn_in = layers.layer_norm(x, begin_norm_axis=2)
    return _residual(x, ffn(ffn_in, d_model, d_inner, dropout), dropout)


def transformer(src_ids, tgt_ids, src_vocab, tgt_vocab, max_len,
                d_model=512, d_inner=2048, n_head=8, n_layer=6,
                dropout=0.1, fused_attention=False, name="transformer",
                project=True):
    pe = _const_var(name + "_pos_enc",
                    position_encoding(max_len, d_model))
    # causal mask [1, 1, L, L]: -1e9 above the diagonal
    causal = np.triu(np.full((max_len, max_len), -1e9, np.float32), k=1)
    causal_mask = _const_var(name + "_causal_mask",
                             causal[None, None, :, :])

    def embed(ids, vocab, scope):
        emb = layers.embedding(
            ids, size=[vocab, d_model],
            param_attr=fluid.ParamAttr(
                name=f"{name}_{scope}_emb",
                initializer=fluid.initializer.Normal(0.0, d_model ** -0.5)))
        emb = layers.scale(emb, scale=d_model ** 0.5)
        return layers.elementwise_add(emb, pe, axis=1)

    enc = embed(src_ids, src_vocab, "src")
    if dropout:
        enc = layers.dropout(enc, dropout_prob=dropout,
                             dropout_implementation="upscale_in_train")
    for _ in range(n_layer):
        enc = encoder_layer(enc, d_model, d_inner, n_head, dropout,
                            fused=fused_attention)
    enc = layers.layer_norm(enc, begin_norm_axis=2)

    dec = embed(tgt_ids, tgt_vocab, "tgt")
    if dropout:
        dec = layers.dropout(dec, dropout_prob=dropout,
                             dropout_implementation="upscale_in_train")
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, causal_mask, d_model, d_inner, n_head,
                            dropout, fused=fused_attention)
    dec = layers.layer_norm(dec, begin_norm_axis=2)
    if not project:
        # caller fuses the vocab projection into the loss
        # (layers.fused_linear_cross_entropy)
        return dec
    return layers.fc(dec, size=tgt_vocab, num_flatten_dims=2,
                     bias_attr=False)


def build(is_train: bool = True, src_vocab: int = 32000,
          tgt_vocab: int = 32000, max_len: int = 128, d_model: int = 512,
          d_inner: int = 2048, n_head: int = 8, n_layer: int = 6,
          dropout: float = 0.1, lr: float = 1e-4, warmup: int = 4000,
          label_smooth_eps: float = 0.1, fused_attention: bool = False,
          fused_head: bool = False, lr_scheduler: str = "const"):
    """The Transformer-base training program (Vaswani config:
    512/2048/8/6) in the default programs, with the JAX ``build``'s
    signature and defaults; returns (loss, fetches, feed_specs).
    ``fused_head`` routes the loss through
    ``layers.fused_linear_cross_entropy`` (the [N, V] logits never
    exist)."""
    src = layers.data(name="src_ids", shape=[max_len, 1], dtype="int64")
    tgt = layers.data(name="tgt_ids", shape=[max_len, 1], dtype="int64")
    lbl = layers.data(name="lbl_ids", shape=[max_len, 1], dtype="int64")
    flat_label = layers.reshape(lbl, shape=[-1, 1])
    eps = label_smooth_eps if is_train else 0.0
    if fused_head:
        # fused loss head: vocab projection + label-smoothed CE in one
        # op (layers.fused_linear_cross_entropy)
        dec = transformer(src, tgt, src_vocab, tgt_vocab, max_len, d_model,
                          d_inner, n_head, n_layer,
                          dropout if is_train else 0.0,
                          fused_attention=fused_attention, project=False)
        flat_dec = layers.reshape(dec, shape=[-1, d_model])
        loss_vec = layers.fused_linear_cross_entropy(
            flat_dec, flat_label, tgt_vocab, label_smoothing=eps)
    else:
        logits = transformer(src, tgt, src_vocab, tgt_vocab, max_len,
                             d_model, d_inner, n_head, n_layer,
                             dropout if is_train else 0.0,
                             fused_attention=fused_attention)
        flat_logits = layers.reshape(logits, shape=[-1, tgt_vocab])
        # closed-form smoothing inside the CE op (no [N, V] one-hot)
        loss_vec = layers.softmax_with_cross_entropy(
            flat_logits, flat_label,
            label_smoothing=eps) if eps else \
            layers.softmax_with_cross_entropy(flat_logits, flat_label)
    loss = layers.mean(loss_vec)
    if is_train:
        if lr_scheduler == "noam":
            # the Vaswani schedule: lr * d_model^-0.5 * min(n^-0.5,
            # n * warmup^-1.5). NOTE: under "noam", `lr` is the Noam
            # MULTIPLIER (conventionally ~1.0-2.0), not an absolute
            # rate — the default 1e-4 would freeze training at ~7e-8
            if lr < 1e-2:
                raise ValueError(
                    f"lr_scheduler='noam' interprets lr as the Noam "
                    f"multiplier (use ~1.0); lr={lr} would give a peak "
                    f"rate of ~{lr * d_model ** -0.5 * warmup ** -0.5:.1e}")
            rate = noam_decay(d_model, warmup, learning_rate=lr)
        elif lr_scheduler == "const":
            rate = lr
        else:
            raise ValueError(
                f"unknown lr_scheduler {lr_scheduler!r} "
                f"(expected 'const' or 'noam')")
        fluid.optimizer.Adam(learning_rate=rate, beta1=0.9,
                             beta2=0.997, epsilon=1e-9).minimize(loss)
    feed_specs = {"src_ids": ([-1, max_len, 1], "int64"),
                  "tgt_ids": ([-1, max_len, 1], "int64"),
                  "lbl_ids": ([-1, max_len, 1], "int64")}
    return loss, [], feed_specs
