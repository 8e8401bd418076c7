"""The transformer family's programs (counterpart of
``paddle_tpu/models/transformer.py``): the Transformer-base training
program (``_const_var``, ``multi_head_attention``, ``ffn``, the encoder
and decoder layers and ``transformer`` (``:21-227``), and ``build``
(``:701-769``)), the encoder-decoder with pre-norm residuals, and the
decoder-only LM's serving views (``decoder_lm``,
``build_decoder_lm_programs``, ``slot_modes``, ``:228-634``), built from
the port's ``fluid.layers`` into the default programs.

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
from paddle_tpu_torch.fluid.initializer import (ConstantInitializer,
                                                NumpyArrayInitializer)
from paddle_tpu_torch.fluid.learning_rate_scheduler import noam_decay
from paddle_tpu_torch.models.transformer import position_encoding

__all__ = ["build", "transformer", "position_encoding", "decoder_lm",
           "build_decoder_lm_programs", "slot_modes"]


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


# ---------------------------------------------------------------------------
# The decoder-only LM's serving programs (transformer.py:228-634)
# ---------------------------------------------------------------------------
#
# One ``decoder_lm`` view a program pair, every parameter explicitly named
# (LayerHelper's auto names are unique across programs, so sharing weights
# across the views needs explicit names):
#   "full"                 logits over a whole sequence (the oracle);
#   "prefill" / "decode"   the wave pair over per-layer caches the prefill
#                          creates in the scope;
#   "prefill_slot" / "decode_slot" / "decode_verify"
#                          the in-flight pool of n_slots contiguous rows;
#   "prefill_paged" / "decode_paged" / "decode_verify_paged"
#                          the paged pool behind a [n_slots, max_pages]
#                          page-table feed (codec none, bf16 or int8).
# The slot and paged views sample their tokens on the device
# (``layers.token_sample``). The nn.Module views of the same model are
# ``paddle_tpu_torch/models/transformer.py`` ``DecoderLM``.

def decoder_lm(mode: str, prompt_len: int = 16, max_new: int = 16,
               vocab: int = 64, d_model: int = 32, d_inner: int = 64,
               n_head: int = 2, n_layer: int = 2, name: str = "lm",
               cache_len=None, n_slots=None, page_size=None,
               n_pages=None, kv_codec=None, spec_k=None):
    """Emit the ``mode`` view of the decoder-only LM into the current
    default programs (``transformer.py:228``); returns (output var,
    feed_specs): the logits for full / prefill / decode, the token
    sampled on the device for the slot and paged views. The geometry is
    normalized once by ``analysis.contracts.validate_geometry`` and kept
    on the program as ``main._geometry``. ``cache_len`` decouples the
    caches from this view's prompt bucket; the slot and paged views need
    ``n_slots``; ``page_size`` must divide ``cache_len``; ``n_pages``
    defaults to the contiguous pool's capacity; ``kv_codec`` to
    ``FLAGS_kv_cache_codec``; ``spec_k`` (the verify views' drafted
    tokens) to 4."""
    from paddle_tpu_torch.analysis.contracts import validate_geometry
    geom = validate_geometry(mode, prompt_len, max_new,
                             cache_len=cache_len, n_slots=n_slots,
                             page_size=page_size, n_pages=n_pages,
                             kv_codec=kv_codec, spec_k=spec_k)
    cache_len = geom.cache_len
    spec_k = geom.spec_k
    page_size = geom.page_size
    n_pages = geom.n_pages
    max_pages = geom.max_pages
    kv_codec = geom.kv_codec
    store_dt = geom.store_dtype
    d_k = d_model // n_head
    main = fluid.default_main_program()
    startup = fluid.default_startup_program()
    main._geometry = geom
    pe = _const_var(name + "_pos_enc",
                    position_encoding(cache_len, d_model))

    def attn_pa(i):
        return fluid.ParamAttr(name=f"{name}_l{i}_attn")

    def pa(pname):
        return fluid.ParamAttr(name=f"{name}_{pname}")

    # the pools: persistable in main (read and written by the slot and
    # paged ops), zero-filled by the startup AFTER every parameter
    # initializer, so each parameter's initializer sits at the same
    # startup index in every view
    _pool_fills = []

    def pool_var(pname, shape=None, dtype="float32"):
        shape = shape or [int(n_slots), cache_len, n_head, d_k]
        v = main.global_block().create_var(
            name=pname, shape=shape, dtype=dtype,
            persistable=True, stop_gradient=True)
        _pool_fills.append((pname, shape, dtype))
        return v

    def sdata(nm, shape, dtype="int64"):
        return layers.data(name=nm, shape=shape, dtype=dtype,
                           append_batch_size=False)

    if mode == "decode":
        tok = layers.data(name="tok", shape=[1, 1], dtype="int64")
        pos = layers.data(name="pos", shape=[1], dtype="int64")
        seq_len = layers.data(name="seq_len", shape=[1], dtype="int64")
        gen_start = layers.data(name="gen_start", shape=[1],
                                dtype="int64")
        active = layers.data(name="active", shape=[1], dtype="int64")
        feed_specs = {"tok": ([-1, 1, 1], "int64"),
                      "pos": ([-1, 1], "int64"),
                      "seq_len": ([-1, 1], "int64"),
                      "gen_start": ([-1, 1], "int64"),
                      "active": ([-1, 1], "int64")}
        x_ids, t = tok, 1
    elif mode in ("decode_slot", "decode_paged"):
        S = int(n_slots)
        tok = sdata("tok", [S, 1, 1])
        pos = sdata("pos", [S, 1])
        seq_len = sdata("seq_len", [S, 1])
        gen_start = sdata("gen_start", [S, 1])
        active = sdata("active", [S, 1])
        seed_in = sdata("seed", [S, 1])
        sample_step = sdata("sample_step", [S, 1])
        temp = sdata("temperature", [S, 1], "float32")
        top_k = sdata("top_k", [S, 1])
        feed_specs = {"tok": ([S, 1, 1], "int64"),
                      "pos": ([S, 1], "int64"),
                      "seq_len": ([S, 1], "int64"),
                      "gen_start": ([S, 1], "int64"),
                      "active": ([S, 1], "int64"),
                      "seed": ([S, 1], "int64"),
                      "sample_step": ([S, 1], "int64"),
                      "temperature": ([S, 1], "float32"),
                      "top_k": ([S, 1], "int64")}
        if mode == "decode_paged":
            page_table = sdata("page_table", [S, max_pages])
            feed_specs["page_table"] = ([S, max_pages], "int64")
        x_ids, t = tok, 1
    elif mode in ("decode_verify", "decode_verify_paged"):
        S = int(n_slots)
        k1 = int(spec_k) + 1
        # the window: position 0 the row's last committed token, 1..K
        # the drafts; the sampling feeds are per window position
        tok = sdata("tok", [S, k1, 1])
        pos = sdata("pos", [S, 1])
        seq_len = sdata("seq_len", [S, 1])
        gen_start = sdata("gen_start", [S, 1])
        active = sdata("active", [S, 1])
        win_len = sdata("win_len", [S, 1])
        seed_in = sdata("seed", [S, k1])
        sample_step = sdata("sample_step", [S, k1])
        temp = sdata("temperature", [S, k1], "float32")
        top_k = sdata("top_k", [S, k1])
        feed_specs = {"tok": ([S, k1, 1], "int64"),
                      "pos": ([S, 1], "int64"),
                      "seq_len": ([S, 1], "int64"),
                      "gen_start": ([S, 1], "int64"),
                      "active": ([S, 1], "int64"),
                      "win_len": ([S, 1], "int64"),
                      "seed": ([S, k1], "int64"),
                      "sample_step": ([S, k1], "int64"),
                      "temperature": ([S, k1], "float32"),
                      "top_k": ([S, k1], "int64")}
        if mode == "decode_verify_paged":
            page_table = sdata("page_table", [S, max_pages])
            feed_specs["page_table"] = ([S, max_pages], "int64")
        x_ids, t = tok, k1
    elif mode in ("prefill_slot", "prefill_paged"):
        # one request at a time joins the pool (batch 1, static)
        t = prompt_len
        ids = sdata("ids", [1, t, 1])
        seq_len = sdata("seq_len", [1, 1])
        seed_in = sdata("seed", [1, 1])
        temp = sdata("temperature", [1, 1], "float32")
        top_k = sdata("top_k", [1, 1])
        feed_specs = {"ids": ([1, t, 1], "int64"),
                      "seq_len": ([1, 1], "int64"),
                      "seed": ([1, 1], "int64"),
                      "temperature": ([1, 1], "float32"),
                      "top_k": ([1, 1], "int64")}
        if mode == "prefill_slot":
            slot = sdata("slot", [1, 1])
            feed_specs["slot"] = ([1, 1], "int64")
        else:
            # the flat pool row of each prompt position from the page
            # lease; sentinel rows skip prefix-shared pages
            page_rows = sdata("page_rows", [t, 1])
            feed_specs["page_rows"] = ([t, 1], "int64")
        x_ids = ids
    else:
        t = prompt_len if mode == "prefill" else cache_len
        ids = layers.data(name="ids", shape=[t, 1], dtype="int64")
        feed_specs = {"ids": ([-1, t, 1], "int64")}
        x_ids = ids

    emb = layers.embedding(x_ids, size=[vocab, d_model],
                           param_attr=pa("emb"))
    x = layers.scale(emb, scale=d_model ** 0.5)
    if mode in ("decode", "decode_slot", "decode_paged"):
        # row b's token sits at semantic position seq_len + (pos -
        # gen_start): prompts are right-padded to their bucket, the
        # cache row is storage only
        gen = layers.elementwise_sub(pos, gen_start)
        pos_ids = layers.elementwise_add(seq_len, gen)
        pe_t = layers.gather(pe, pos_ids)                  # [B, M]
        pe_t = layers.reshape(pe_t, shape=[-1, 1, d_model])
        x = layers.elementwise_add(x, pe_t)
    elif mode in ("decode_verify", "decode_verify_paged"):
        # window position i of row b: seq_len + sample_step - 1
        sl = layers.expand(seq_len, expand_times=[1, k1])   # [S, K1]
        one = layers.fill_constant([S, k1], "int64", 1)
        off = layers.elementwise_sub(sample_step, one)
        pos_ids = layers.elementwise_add(sl, off)           # [S, K1]
        pe_t = layers.gather(pe, pos_ids)                  # [S*K1, M]
        pe_t = layers.reshape(pe_t, shape=[-1, k1, d_model])
        x = layers.elementwise_add(x, pe_t)
    elif t != cache_len:
        pe_t = layers.slice(pe, axes=[0], starts=[0], ends=[t])
        x = layers.elementwise_add(x, pe_t, axis=1)
    else:
        x = layers.elementwise_add(x, pe, axis=1)

    for i in range(n_layer):
        attn_in = layers.layer_norm(x, begin_norm_axis=2,
                                    param_attr=pa(f"l{i}_ln1_scale"),
                                    bias_attr=pa(f"l{i}_ln1_bias"))
        if mode == "full":
            attn = layers.fused_multi_head_attention(
                attn_in, attn_in, d_model, n_head, causal=True,
                param_attr=attn_pa(i))
        elif mode.endswith("_slot"):
            pk = pool_var(f"{name}_slot_k_{i}")
            pv = pool_var(f"{name}_slot_v_{i}")
            if mode == "prefill_slot":
                attn = layers.kv_attention_prefill_slot(
                    attn_in, slot, d_model, n_head, pk, pv,
                    param_attr=attn_pa(i))
            else:
                attn = layers.kv_attention_decode(
                    attn_in, pos, seq_len, gen_start, active, d_model,
                    n_head, pk, pv, param_attr=attn_pa(i))
        elif mode == "decode_verify":
            # the contiguous slot pool's vars: one scope serves the slot
            # views and their verify view
            pk = pool_var(f"{name}_slot_k_{i}")
            pv = pool_var(f"{name}_slot_v_{i}")
            attn = layers.kv_attention_verify(
                attn_in, pos, seq_len, gen_start, active, win_len,
                d_model, n_head, pk, pv, param_attr=attn_pa(i))
        elif mode.endswith("_paged"):
            pshape = [n_pages, page_size, n_head, d_k]
            pk = pool_var(f"{name}_page_k_{i}", pshape, store_dt)
            pv = pool_var(f"{name}_page_v_{i}", pshape, store_dt)
            pks = pvs = None
            if kv_codec == "int8":
                sshape = [n_pages, page_size, n_head]
                pks = pool_var(f"{name}_page_ks_{i}", sshape)
                pvs = pool_var(f"{name}_page_vs_{i}", sshape)
            if mode == "prefill_paged":
                attn = layers.kv_attention_prefill_paged(
                    attn_in, page_rows, d_model, n_head, pk, pv,
                    pks, pvs, codec=kv_codec, param_attr=attn_pa(i))
            elif mode == "decode_verify_paged":
                attn = layers.kv_attention_verify_paged(
                    attn_in, page_table, pos, seq_len, gen_start,
                    active, win_len, d_model, n_head, pk, pv, pks,
                    pvs, codec=kv_codec, param_attr=attn_pa(i))
            else:
                attn = layers.kv_attention_decode_paged(
                    attn_in, page_table, pos, seq_len, gen_start,
                    active, d_model, n_head, pk, pv, pks, pvs,
                    codec=kv_codec, param_attr=attn_pa(i))
        else:
            ck = main.global_block().create_var(
                name=f"{name}_cache_k_{i}",
                shape=[-1, cache_len, n_head, d_k], dtype="float32",
                persistable=True, stop_gradient=True)
            cv = main.global_block().create_var(
                name=f"{name}_cache_v_{i}",
                shape=[-1, cache_len, n_head, d_k], dtype="float32",
                persistable=True, stop_gradient=True)
            if mode == "prefill":
                attn = layers.kv_attention_prefill(
                    attn_in, d_model, n_head, ck, cv,
                    param_attr=attn_pa(i))
            else:
                attn = layers.kv_attention_decode(
                    attn_in, pos, seq_len, gen_start, active, d_model,
                    n_head, ck, cv, param_attr=attn_pa(i))
        x = layers.elementwise_add(x, attn)
        ffn_in = layers.layer_norm(x, begin_norm_axis=2,
                                   param_attr=pa(f"l{i}_ln2_scale"),
                                   bias_attr=pa(f"l{i}_ln2_bias"))
        h = layers.fc(ffn_in, size=d_inner, num_flatten_dims=2,
                      act="relu", param_attr=pa(f"l{i}_ffn1_w"),
                      bias_attr=pa(f"l{i}_ffn1_b"))
        h = layers.fc(h, size=d_model, num_flatten_dims=2,
                      param_attr=pa(f"l{i}_ffn2_w"),
                      bias_attr=pa(f"l{i}_ffn2_b"))
        x = layers.elementwise_add(x, h)

    x = layers.layer_norm(x, begin_norm_axis=2,
                          param_attr=pa("lnf_scale"),
                          bias_attr=pa("lnf_bias"))
    logits = layers.fc(x, size=vocab, num_flatten_dims=2,
                       param_attr=pa("head_w"), bias_attr=False)

    # the deferred pool fills, after every parameter initializer
    for pname, shape, fdt in _pool_fills:
        sv = startup.global_block().create_var(
            name=pname, shape=shape, dtype=fdt, persistable=True)
        ConstantInitializer(0.0)(sv, startup.global_block())

    if mode in ("prefill_slot", "prefill_paged"):
        # the first token, sampled on the device from the logits row at
        # the prompt's true end (batch 1: [1, P, V] -> [P, V])
        flat = layers.reshape(logits, shape=[-1, vocab])
        one = layers.fill_constant([1, 1], "int64", 1)
        last_idx = layers.elementwise_sub(seq_len, one)
        last = layers.gather(flat, last_idx)               # [1, V]
        zero = layers.fill_constant([1, 1], "int64", 0)
        tok_out = layers.token_sample(last, temp, top_k, seed_in, zero)
        return tok_out, feed_specs
    if mode in ("decode_slot", "decode_paged",
                "decode_verify", "decode_verify_paged"):
        # every slot's (every window position's) token: [S * K1, V]
        flat = layers.reshape(logits, shape=[-1, vocab])
        tok_out = layers.token_sample(flat, temp, top_k, seed_in,
                                      sample_step)
        return tok_out, feed_specs
    return logits, feed_specs


def build_decoder_lm_programs(prompt_len: int = 16, max_new: int = 16,
                              vocab: int = 64, d_model: int = 32,
                              d_inner: int = 64, n_head: int = 2,
                              n_layer: int = 2, name: str = "lm",
                              seed: int = 7, modes=("prefill", "decode",
                                                    "full"),
                              prompt_buckets=None, n_slots=None,
                              page_size=None, n_pages=None,
                              kv_codec=None, spec_k=None):
    """The serving program family (``transformer.py:563``): {key: (main,
    startup, feed_specs, fetch_name)}. Every main shares every parameter
    name: one startup (any of them) fills a scope that serves every view.
    ``prompt_buckets`` (ascending, the largest == ``prompt_len``) emits
    one prefill view per bucket, ``prefill@P`` (``prefill_slot@P``,
    ``prefill_paged@P``), the bare name aliasing the largest. ``n_slots``
    sizes the slot and paged pools; ``page_size`` / ``n_pages`` /
    ``kv_codec`` the paged pool; ``spec_k`` the verify window."""
    cache_len = prompt_len + max_new
    buckets = tuple(sorted(set(int(b)
                               for b in (prompt_buckets or (prompt_len,)))))
    if buckets[-1] != prompt_len:
        raise ValueError(f"largest prompt bucket {buckets[-1]} must "
                         f"equal prompt_len {prompt_len}")
    cfg = dict(max_new=max_new, vocab=vocab, d_model=d_model,
               d_inner=d_inner, n_head=n_head, n_layer=n_layer,
               name=name, cache_len=cache_len, n_slots=n_slots,
               page_size=page_size, n_pages=n_pages, kv_codec=kv_codec,
               spec_k=spec_k)
    out = {}

    def emit(key, mode, p_len):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main, startup):
            outv, feed_specs = decoder_lm(mode, prompt_len=p_len, **cfg)
        main._is_test = True
        out[key] = (main, startup, feed_specs, outv.name)

    for mode in modes:
        if mode in ("prefill", "prefill_slot", "prefill_paged"):
            for p in buckets:
                emit(f"{mode}@{p}", mode, p)
            out[mode] = out[f"{mode}@{buckets[-1]}"]
        else:
            emit(mode, mode, prompt_len)
    return out


def slot_modes(layout=None, spec=False):
    """The slot engine's program modes for a KV-cache layout
    (``transformer.py:617``; ``FLAGS_kv_cache_layout`` by default): pass
    them as ``modes=`` to :func:`build_decoder_lm_programs` and the
    family to ``serving.engine.make_slot_model``. ``spec=True`` adds the
    verify view."""
    from paddle_tpu_torch import flags as _flags
    layout = layout or _flags.get("kv_cache_layout")
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"FLAGS_kv_cache_layout {layout!r} not in "
                         f"('contiguous', 'paged')")
    if layout == "paged":
        modes = ("prefill_paged", "decode_paged")
        return modes + ("decode_verify_paged",) if spec else modes
    modes = ("prefill_slot", "decode_slot")
    return modes + ("decode_verify",) if spec else modes
