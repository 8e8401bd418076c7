"""Neural-network layers of the port (counterpart of ``paddle_tpu/fluid/
layers/nn.py``; reference: python/paddle/fluid/layers/nn.py): the layers
the bench builders call (deepfm's ``sigmoid_cross_entropy_with_logits``
among them), ``split``, ``beam_search`` / ``beam_search_decode``, ``sum``,
``clip_by_norm``, ``gather`` and ``expand``, and the decoder LM's serving
layers (the seven ``kv_attention_*`` and ``token_sample``). Each appends
the JAX layer's ops, with its attrs and names, through
:class:`LayerHelper`. On the card ``fused_multi_head_attention`` trains
through the flash kernels, ``fused_linear_cross_entropy`` through the
fused-CE kernels, and the paged decode and verify layers read their
pools through the page-gather kernels. The layers whose ops the port
lacks (``reduce_mean`` and the other reductions, the image resizes,
``dice_loss``, the logical ops, ``one_hot`` and the rest) are ROADMAP
A6.4b's dense layers."""

from __future__ import annotations

import copy

import numpy as np

from paddle_tpu_torch.fluid.initializer import (ConstantInitializer,
                                                NormalInitializer)
from paddle_tpu_torch.fluid.layer_helper import LayerHelper
from paddle_tpu_torch.fluid import unique_name


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """``nn.py:21`` (reference nn.py:191) — mul (+ sum of several inputs)
    + bias + act."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        param_shape = [int(np.prod(inp.shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(param_attr, shape=param_shape,
                                    dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, bias_attr, size,
                                    dim_start=num_flatten_dims)
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """``nn.py:48`` (reference nn.py:300) — lookup_table; ``is_sparse`` /
    ``is_distributed`` are recorded as the table's sharding hint."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    if is_distributed or is_sparse:
        w.desc.attrs["dist_hint"] = ["__model__"] + \
            [None] * (len(size) - 1)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """``nn.py:72`` (reference nn.py:1753) — an NCHW conv."""
    helper = LayerHelper("conv2d", name=name)
    num_channels = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 2
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    std = (2.0 / (fsize[0] * fsize[1] * num_channels)) ** 0.5
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0,
                                                                      std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        with_b = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [with_b]}, attrs={"axis": 1})
        out = with_b
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """``nn.py:146`` — pool_op.cc."""
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """``nn.py:161`` (reference nn.py:2713) — Scale / Bias trainable,
    Mean / Variance persistable running statistics."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype,
                                   is_bias=True)
    mean_name = moving_mean_name or unique_name.generate(
        helper.name + ".mean")
    var_name = moving_variance_name or unique_name.generate(
        helper.name + ".var")
    block = helper.main_program.global_block()
    mean = block.create_var(name=mean_name, shape=[c], dtype=input.dtype,
                            persistable=True, stop_gradient=True)
    variance = block.create_var(name=var_name, shape=[c], dtype=input.dtype,
                                persistable=True, stop_gradient=True)
    sb = helper.startup_program.global_block()
    if not sb.has_var(mean_name):
        ConstantInitializer(0.0)(sb.create_var(
            name=mean_name, shape=[c], dtype=input.dtype, persistable=True),
            sb)
        ConstantInitializer(1.0)(sb.create_var(
            name=var_name, shape=[c], dtype=input.dtype, persistable=True),
            sb)
    saved_mean = helper.create_variable_for_type_inference(input.dtype)
    saved_var = helper.create_variable_for_type_inference(input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """``nn.py:203`` — layer_norm_op.cc."""
    helper = LayerHelper("layer_norm", name=name)
    norm_size = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=[norm_size], dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=[norm_size],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """``nn.py:229``."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0,
                            "dropout_implementation": dropout_implementation})
    return out


# -- losses -----------------------------------------------------------------

def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """``nn.py:244``."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, label_smoothing=0.0):
    """``nn.py:255``; ``label_smoothing`` is the closed-form uniform
    smoothing of hard labels."""
    if soft_label and label_smoothing:
        raise ValueError(
            "label_smoothing applies to hard integer labels; for soft "
            "labels smooth the distribution yourself")
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Loss": [loss], "Softmax": [softmax]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index,
                            "label_smoothing": float(label_smoothing)})
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    """``nn.py:280`` — deepfm's loss."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


# -- reductions / math ------------------------------------------------------

def mean(x, name=None):
    """``nn.py:324``."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim}
    helper.append_op("reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    helper = LayerHelper("mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    """``nn.py:374``."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``nn.py:384``."""
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def softmax(input, use_cudnn=True, name=None):
    """``nn.py:393``."""
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


# -- shape ------------------------------------------------------------------

def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    """``nn.py:419``."""
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def transpose(x, perm, name=None):
    """``nn.py:443``."""
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``nn.py:451`` — ``num_or_sections`` equal parts, or parts of the
    given sizes, along ``dim``."""
    helper = LayerHelper("split", name=name)
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        n_out = num
    else:
        num = 0
        sections = list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


# -- metrics ----------------------------------------------------------------

def expand(x, expand_times, name=None):
    """``nn.py:477`` — ``expand_op.cc``: tile ``x`` ``expand_times``."""
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def gather(input, index):
    """``nn.py:495`` — ``gather_op.cc``: rows ``index`` of ``input``."""
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """``nn.py:531`` (reference layers/metric_op.py) — top_k + accuracy."""
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32")
    if total is None:
        total = helper.create_variable_for_type_inference("int32")
    helper.append_op("accuracy",
                     inputs={"Out": [values], "Indices": [indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


# -- beam search ------------------------------------------------------------

def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None):
    """``nn.py:1036`` — one step over dense [B, W] lanes (``ops/
    beam_ops.py``). Returns (selected_ids, selected_scores, parent_idx)."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference("int32")
    sc = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "beam_search",
        inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                "Scores": [scores]},
        outputs={"SelectedIds": [ids], "SelectedScores": [sc],
                 "ParentIdx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, sc, parent


def beam_search_decode(ids, parent_idx, scores, end_id=0, name=None):
    """``nn.py:1054`` — backtrack the stacked per-step selections
    [T, B, W]. Returns (sentence_ids [B, W, T], sentence_scores [B, W])."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference("int32")
    ssc = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        "beam_search_decode",
        inputs={"Ids": [ids], "ParentIdx": [parent_idx],
                "Scores": [scores]},
        outputs={"SentenceIds": [sent], "SentenceScores": [ssc]},
        attrs={"end_id": end_id})
    return sent, ssc


# -- lists and norms --------------------------------------------------------

def sum(x):
    """``nn.py:1690`` — the elementwise sum of a list (``sum_op.cc``)."""
    helper = LayerHelper("sum")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": list(xs)}, outputs={"Out": [out]})
    return out


def clip_by_norm(x, max_norm, name=None):
    """``nn.py:1713`` — ``clip_by_norm_op.cc``."""
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


# -- fused blocks -----------------------------------------------------------

def _attention_projection_params(helper, d_model, param_attr):
    """``nn.py:638``: the four [M, M] projection weights, named exactly
    like ``fused_multi_head_attention``'s (``<base>.wq`` ... ``.wo``), so
    one scope serves the training graph, the ``full`` view and every
    serving view of the decoder LM."""
    if isinstance(param_attr, (list, tuple)):
        attrs4 = list(param_attr)           # one ParamAttr per projection
    elif param_attr is None:
        attrs4 = [None] * 4
    else:
        attrs4 = []
        for tag in ("wq", "wk", "wv", "wo"):
            a = copy.deepcopy(param_attr)
            if a.name is not None:
                a.name = f"{a.name}.{tag}"
            attrs4.append(a)
    return [helper.create_parameter(a, shape=[d_model, d_model],
                                    dtype="float32") for a in attrs4]


def fused_multi_head_attention(q_in, kv_in, d_model, n_head, causal=False,
                               dropout_prob=0.0, param_attr=None,
                               name=None):
    """``nn.py:599`` — the whole attention block (q / k / v / out
    projections and the scaled-dot attention) as one
    ``fused_attention_block`` op, which on the card runs the flash
    forward and backward kernels. q_in [B, Tq, M], kv_in [B, Tk, M] ->
    [B, Tq, M]; the four weights are named as fc's."""
    helper = LayerHelper("fused_multi_head_attention", name=name)
    ws = _attention_projection_params(helper, d_model, param_attr)
    out = helper.create_variable_for_type_inference(q_in.dtype)
    helper.append_op("fused_attention_block",
                     inputs={"Xq": [q_in], "Xkv": [kv_in],
                             "Wq": [ws[0]], "Wk": [ws[1]],
                             "Wv": [ws[2]], "Wo": [ws[3]]},
                     outputs={"Out": [out]},
                     attrs={"n_head": int(n_head), "causal": bool(causal),
                            "dropout_prob": float(dropout_prob)})
    return out


# -- the decoder LM's serving layers (nn.py:659-883) ------------------------
#
# Each appends one op of ``ops/kv_attention.py``. The caches and pools are
# persistable vars the op reads and writes under one name (its ``*Out``
# slots name the same var), so the block runner keeps them as state and the
# emitters update them in place.

def _kv_op(op_type, x, d_model, n_head, param_attr, name, inputs, outputs,
           attrs):
    """Append ``op_type`` over X and the four projection weights, plus
    ``inputs``; ``outputs`` and ``attrs`` beside Out [like X]."""
    helper = LayerHelper(op_type, name=name)
    ws = _attention_projection_params(helper, d_model, param_attr)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type,
                     inputs={"X": [x], "Wq": [ws[0]], "Wk": [ws[1]],
                             "Wv": [ws[2]], "Wo": [ws[3]], **inputs},
                     outputs={"Out": [out], **outputs}, attrs=attrs)
    return out


def kv_attention_prefill(x, d_model, n_head, cache_k, cache_v,
                         param_attr=None, name=None):
    """``nn.py:659`` — causal self-attention over the padded prompt that
    also fills the persistable caches ``cache_k`` / ``cache_v`` [B, S, H,
    D] (S from their shape). x [B, T, M] -> [B, T, M]."""
    return _kv_op("kv_attention_prefill", x, d_model, n_head, param_attr,
                  name, {}, {"CacheK": [cache_k], "CacheV": [cache_v]},
                  {"n_head": int(n_head),
                   "cache_len": int(cache_k.shape[1])})


def kv_attention_prefill_slot(x, slot, d_model, n_head, pool_k, pool_v,
                              param_attr=None, name=None):
    """``nn.py:683`` — the in-flight prefill: the prompt's K/V, zeros
    beyond it, overwrite the whole rows ``slot`` [B, 1] of the pools
    ``pool_k`` / ``pool_v`` [n_slots, S, H, D]. x [B, T, M] -> [B, T, M]."""
    return _kv_op("kv_attention_prefill_slot", x, d_model, n_head,
                  param_attr, name,
                  {"PoolK": [pool_k], "PoolV": [pool_v], "Slot": [slot]},
                  {"PoolKOut": [pool_k], "PoolVOut": [pool_v]},
                  {"n_head": int(n_head)})


def kv_attention_decode(x, pos, seq_len, gen_start, active, d_model,
                        n_head, cache_k, cache_v, param_attr=None,
                        name=None):
    """``nn.py:709`` — one token a row over the static cache: writes each
    active row's K/V at ``pos`` and attends over {j < seq_len} U
    {gen_start <= j <= pos}. x [B, 1, M], pos / seq_len / gen_start /
    active [B, 1] int -> [B, 1, M]."""
    return _kv_op("kv_attention_decode", x, d_model, n_head, param_attr,
                  name,
                  {"CacheK": [cache_k], "CacheV": [cache_v], "Pos": [pos],
                   "SeqLen": [seq_len], "GenStart": [gen_start],
                   "Active": [active]},
                  {"CacheKOut": [cache_k], "CacheVOut": [cache_v]},
                  {"n_head": int(n_head)})


def _paged_slots(page_k, page_v, page_ks, page_vs, codec):
    """The pool inputs and outputs of a paged op (the scale planes only
    under int8)."""
    inputs = {"PageK": [page_k], "PageV": [page_v]}
    outputs = {"PageKOut": [page_k], "PageVOut": [page_v]}
    if codec == "int8":
        inputs["PageKS"], inputs["PageVS"] = [page_ks], [page_vs]
        outputs["PageKSOut"], outputs["PageVSOut"] = [page_ks], [page_vs]
    return inputs, outputs


def kv_attention_prefill_paged(x, rows, d_model, n_head, page_k, page_v,
                               page_ks=None, page_vs=None, codec="none",
                               param_attr=None, name=None):
    """``nn.py:735`` — causal prefill whose K/V land in the paged pools at
    the flat rows ``rows`` [B*T, 1] (sentinels drop: prefix-shared pages).
    x [B, T, M] -> [B, T, M]."""
    inputs, outputs = _paged_slots(page_k, page_v, page_ks, page_vs, codec)
    inputs["Rows"] = [rows]
    return _kv_op("kv_attention_prefill_paged", x, d_model, n_head,
                  param_attr, name, inputs, outputs,
                  {"n_head": int(n_head), "codec": str(codec)})


def kv_attention_decode_paged(x, page_table, pos, seq_len, gen_start,
                              active, d_model, n_head, page_k, page_v,
                              page_ks=None, page_vs=None, codec="none",
                              param_attr=None, name=None):
    """``nn.py:766`` — one token a row over the paged pools through the
    page table [B, max_pages]; on the card the page gathers run the
    hand-written kernels. x [B, 1, M] -> [B, 1, M]."""
    inputs, outputs = _paged_slots(page_k, page_v, page_ks, page_vs, codec)
    inputs.update({"PageTable": [page_table], "Pos": [pos],
                   "SeqLen": [seq_len], "GenStart": [gen_start],
                   "Active": [active]})
    return _kv_op("kv_attention_decode_paged", x, d_model, n_head,
                  param_attr, name, inputs, outputs,
                  {"n_head": int(n_head), "codec": str(codec)})


def kv_attention_verify(x, pos, seq_len, gen_start, active, win_len,
                        d_model, n_head, cache_k, cache_v,
                        param_attr=None, name=None):
    """``nn.py:799`` — the speculative verify window over the contiguous
    cache: window position i writes row ``pos + i`` where active and
    ``i < win_len``, and attends causally. x [B, K+1, M] -> [B, K+1, M]."""
    return _kv_op("kv_attention_verify", x, d_model, n_head, param_attr,
                  name,
                  {"CacheK": [cache_k], "CacheV": [cache_v], "Pos": [pos],
                   "SeqLen": [seq_len], "GenStart": [gen_start],
                   "Active": [active], "WinLen": [win_len]},
                  {"CacheKOut": [cache_k], "CacheVOut": [cache_v]},
                  {"n_head": int(n_head)})


def kv_attention_verify_paged(x, page_table, pos, seq_len, gen_start,
                              active, win_len, d_model, n_head, page_k,
                              page_v, page_ks=None, page_vs=None,
                              codec="none", param_attr=None, name=None):
    """``nn.py:832`` — the verify window over the paged pools, each
    position's write row through the page table (past the lease: the
    sentinel, dropped). x [B, K+1, M] -> [B, K+1, M]."""
    inputs, outputs = _paged_slots(page_k, page_v, page_ks, page_vs, codec)
    inputs.update({"PageTable": [page_table], "Pos": [pos],
                   "SeqLen": [seq_len], "GenStart": [gen_start],
                   "Active": [active], "WinLen": [win_len]})
    return _kv_op("kv_attention_verify_paged", x, d_model, n_head,
                  param_attr, name, inputs, outputs,
                  {"n_head": int(n_head), "codec": str(codec)})


def token_sample(logits, temperature, top_k, seed, step_idx, name=None):
    """``nn.py:864`` — next-token selection on the device: the argmax
    where ``temperature <= 0`` or ``top_k == 1``, else top-k Gumbel
    sampling keyed by (seed, step_idx) alone. logits [B, V]; temperature
    [B, 1] float; top_k, seed, step_idx [B, 1] int -> [B, 1] int64."""
    helper = LayerHelper("token_sample", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("token_sample",
                     inputs={"Logits": [logits],
                             "Temperature": [temperature],
                             "TopK": [top_k], "Seed": [seed],
                             "StepIdx": [step_idx]},
                     outputs={"Out": [out]})
    return out


def fused_linear_cross_entropy(input, label, num_classes,
                               label_smoothing=0.0, ignore_index=-100,
                               param_attr=None, name=None):
    """``nn.py:884`` — ``fc(input, num_classes)`` and the label-smoothed
    softmax cross entropy as one ``fused_linear_ce`` op, which on the
    card runs the fused-CE kernels (the [N, V] logits never exist).
    input [N, D], label [N, 1] int -> the per-row loss [N, 1]."""
    helper = LayerHelper("fused_linear_ce", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[d, num_classes],
                                dtype="float32")
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op("fused_linear_ce",
                     inputs={"X": [input], "W": [w], "Label": [label]},
                     outputs={"Loss": [loss]},
                     attrs={"label_smoothing": float(label_smoothing),
                            "ignore_index": ignore_index})
    return loss
