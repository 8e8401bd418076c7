"""Recurrent layers of the port (counterpart of ``paddle_tpu/fluid/
layers/rnn.py``; reference: python/paddle/fluid/layers/nn.py
dynamic_lstm / dynamic_gru): padded [B, T, ...] inputs and ``seq_lens``
in place of LoD. On the card the ``dynamic_lstm`` op trains through the
LSTM kernels (``ops/kernels/fused_rnn.py``) and ``dynamic_gru`` through
the GRU kernels. ``lstm_unit``, ``gru_unit`` and ``dynamic_lstmp`` are
ROADMAP A6.4b."""

from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def dynamic_lstm(input, size, h_0=None, c_0=None, seq_lens=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """reference: nn.py dynamic_lstm / lstm_op.cc. ``input`` is the
    projected [B, T, 4H] sequence; ``size`` is 4H. Returns (hidden,
    cell), both [B, T, H]."""
    helper = LayerHelper("dynamic_lstm", name=name)
    H = size // 4
    weight = helper.create_parameter(param_attr, shape=[H, 4 * H],
                                     dtype=dtype)
    bias_size = 7 * H if use_peepholes else 4 * H
    bias = helper.create_parameter(bias_attr, shape=[1, bias_size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if seq_lens is not None:
        inputs["SeqLens"] = [seq_lens]
    helper.append_op(
        "dynamic_lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "LastHidden": [last_h], "LastCell": [last_c]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    if input.shape is not None:
        B, T = input.shape[0], input.shape[1]
        for v in (hidden, cell):
            v.desc.shape = [B, T, H]
        for v in (last_h, last_c):
            v.desc.shape = [B, H]
    return hidden, cell


def dynamic_gru(input, size, h_0=None, seq_lens=None, param_attr=None,
                bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None):
    """reference: nn.py dynamic_gru / gru_op.cc. ``input`` is the
    projected [B, T, 3H]; ``size`` is H. Returns hidden [B, T, H]."""
    helper = LayerHelper("dynamic_gru", name=name)
    H = size
    weight = helper.create_parameter(param_attr, shape=[H, 3 * H],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, 3 * H], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if seq_lens is not None:
        inputs["SeqLens"] = [seq_lens]
    helper.append_op(
        "dynamic_gru", inputs=inputs,
        outputs={"Hidden": [hidden], "LastHidden": [last_h]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation})
    if input.shape is not None:
        hidden.desc.shape = [input.shape[0], input.shape[1], H]
        last_h.desc.shape = [input.shape[0], H]
    return hidden
