"""Sequence layers of the port (counterpart of ``paddle_tpu/fluid/
layers/sequence.py``; reference: python/paddle/fluid/layers/nn.py
sequence_*, edit_distance): padded [B, T, ...] inputs with an explicit
``seq_lens`` [B] in place of LoD, the whole file. Their ops are in
``ops/sequence_ops.py`` and ``ops/lod_ops.py`` (``sequence_scatter``).
On the card ``sequence_pool`` of SUM / AVERAGE / SQRT runs the masked
pooling kernel (``ops/kernels/seqpool.py``); the others are plain
torch."""

from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def _seq_inputs(x, seq_lens, slot="X"):
    ins = {slot: [x]}
    if seq_lens is not None:
        ins["SeqLens"] = [seq_lens]
    return ins


def sequence_pool(input, pool_type, seq_lens=None):
    """reference: nn.py sequence_pool — SUM/AVERAGE/SQRT/MAX/LAST/FIRST."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    outs = {"Out": [out]}
    if pool_type.upper() == "MAX":
        idx = helper.create_variable_for_type_inference("int32")
        outs["MaxIndex"] = [idx]
    helper.append_op("sequence_pool", inputs=_seq_inputs(input, seq_lens),
                     outputs=outs, attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, seq_lens=None):
    return sequence_pool(input, "FIRST", seq_lens)


def sequence_last_step(input, seq_lens=None):
    return sequence_pool(input, "LAST", seq_lens)


def sequence_softmax(input, seq_lens=None):
    helper = LayerHelper("sequence_softmax")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_softmax", inputs=_seq_inputs(input, seq_lens),
                     outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  seq_lens=None):
    """reference: nn.py sequence_conv over context windows."""
    if filter_stride != 1:
        raise ValueError("sequence_conv only supports filter_stride=1 "
                         "(the reference enforces the same, "
                         "sequence_conv_op.cc contextStride check)")
    helper = LayerHelper("sequence_conv")
    D = input.shape[-1]
    filter_shape = [filter_size * D, num_filters]
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = _seq_inputs(input, seq_lens)
    ins["Filter"] = [w]
    helper.append_op("sequence_conv", inputs=ins, outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -(filter_size - 1) // 2,
                            "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, dim_start=2)
    return helper.append_activation(pre_act, act)


def sequence_expand(x, y, seq_lens=None, ref_level=-1):
    helper = LayerHelper("sequence_expand")
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if seq_lens is not None:
        ins["SeqLens"] = [seq_lens]
    helper.append_op("sequence_expand", inputs=ins, outputs={"Out": [out]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, seq_lens=None):
    helper = LayerHelper("sequence_expand_as")
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y]}
    if seq_lens is not None:
        ins["SeqLens"] = [seq_lens]
    helper.append_op("sequence_expand_as", inputs=ins, outputs={"Out": [out]})
    return out


def sequence_concat(input, seq_lens=None, name=None):
    """input: list of [B,Ti,D]; seq_lens: matching list of [B] length
    tensors. Returns (Out [B, sum Ti, D], NewLens [B])."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    new_lens = helper.create_variable_for_type_inference("int32")
    ins = {"X": list(input)}
    if seq_lens is not None:
        ins["SeqLens"] = list(seq_lens)
    helper.append_op("sequence_concat", inputs=ins,
                     outputs={"Out": [out], "NewLens": [new_lens]})
    return out, new_lens


def sequence_reverse(x, seq_lens=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_reverse", inputs=_seq_inputs(x, seq_lens),
                     outputs={"Y": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    new_lens = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out], "NewLens": [new_lens]})
    return out


def sequence_erase(input, tokens, seq_lens=None, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    new_lens = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_erase", inputs=_seq_inputs(input, seq_lens),
                     outputs={"Out": [out], "NewLens": [new_lens]},
                     attrs={"tokens": list(tokens)})
    return out, new_lens


def sequence_enumerate(input, win_size, pad_value=0, seq_lens=None,
                       name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_enumerate",
                     inputs=_seq_inputs(input, seq_lens),
                     outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, seq_lens=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32")
    ins = _seq_inputs(x, seq_lens)
    attrs = {"padded_length": int(maxlen) if maxlen is not None else -1}
    if pad_value is not None and not hasattr(pad_value, "name"):
        attrs["pad_value"] = float(pad_value)
    elif pad_value is not None:
        ins["PadValue"] = [pad_value]
    helper.append_op("sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length]}, attrs=attrs)
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out], "Length": [out_len]})
    return out


def sequence_reshape(input, new_dim, seq_lens=None):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    new_lens = helper.create_variable_for_type_inference("int32")
    helper.append_op("sequence_reshape", inputs=_seq_inputs(input, seq_lens),
                     outputs={"Out": [out], "NewLens": [new_lens]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_mask(x, maxlen, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": maxlen, "out_dtype": dtype})
    return out


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """reference: nn.py edit_distance (operators/edit_distance_op.cc)."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int32")
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLens"] = [input_length]
    if label_length is not None:
        ins["RefsLens"] = [label_length]
    helper.append_op("edit_distance", inputs=ins,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def sequence_scatter(input, index, updates, seq_lens=None, name=None):
    """reference: nn.py sequence_scatter → sequence_scatter_op.cc (padded
    ids+updates per row with seq_lens replacing the updates LoD)."""
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "Ids": [index], "Updates": [updates]}
    if seq_lens is not None:
        inputs["SeqLens"] = [seq_lens]
    helper.append_op("sequence_scatter", inputs=inputs,
                     outputs={"Out": [out]})
    return out
