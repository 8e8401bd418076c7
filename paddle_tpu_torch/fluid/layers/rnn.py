"""Recurrent layers of the port (counterpart of ``paddle_tpu/fluid/
layers/rnn.py``; reference: python/paddle/fluid/layers/nn.py
dynamic_lstm / dynamic_gru): padded [B, T, ...] inputs and ``seq_lens``
in place of LoD. On the card the ``dynamic_lstm`` op trains through the
LSTM kernels (``ops/kernels/fused_rnn.py``) and ``dynamic_gru`` through
the GRU kernels. ``lstm_unit``, ``gru_unit`` (one step each) and
``dynamic_lstmp`` (the ``lstmp`` op, an LSTM with a recurrent
projection) are plain torch, as their JAX ops reach no Pallas kernel."""

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


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """reference: nn.py lstm_unit / lstm_unit_op.cc. Projects
    concat([x_t, h_prev]) to 4H then applies the fused cell. Returns (h, c)."""
    from paddle_tpu_torch.fluid.layers.nn import fc
    from paddle_tpu_torch.fluid.layers.tensor import concat
    helper = LayerHelper("lstm_unit", name=name)
    H = hidden_t_prev.shape[-1]
    gates = fc(concat([x_t, hidden_t_prev], axis=1), 4 * H,
               param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": float(forget_bias)})
    if cell_t_prev.shape is not None:
        c.desc.shape = list(cell_t_prev.shape)
        h.desc.shape = list(cell_t_prev.shape)
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """reference: nn.py gru_unit / gru_unit_op.cc. `input` pre-projected
    [B, 3H]; `size` = 3H to match the reference API. Returns (hidden, ...)."""
    helper = LayerHelper("gru_unit", name=name)
    H = size // 3
    weight = helper.create_parameter(param_attr, shape=[H, 3 * H],
                                     dtype=input.dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, 3 * H],
                                   dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [weight], "Bias": [bias]},
                     outputs={"Hidden": [out]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    if hidden.shape is not None:
        out.desc.shape = list(hidden.shape)
    return out, None, None


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """reference: nn.py:657 dynamic_lstmp → lstmp_op.cc. `input` is the
    pre-projected [B, T, 4H] sequence; returns (projection, cell)."""
    helper = LayerHelper("dynamic_lstmp", name=name)
    H = size // 4
    import copy

    from paddle_tpu_torch.fluid.param_attr import ParamAttr

    def slot_attr(suffix):
        # create_parameter stamps attr.name in place — sharing one attr
        # object would alias weight and proj_weight into one variable
        a = copy.copy(ParamAttr._to_attr(param_attr))
        if a.name is not None:
            a.name = a.name + suffix
        return a

    weight = helper.create_parameter(slot_attr(".weight"),
                                     shape=[proj_size, 4 * H], dtype=dtype)
    proj_weight = helper.create_parameter(slot_attr(".proj_weight"),
                                          shape=[H, proj_size], dtype=dtype)
    bias_size = 7 * H if use_peepholes else 4 * H
    bias = helper.create_parameter(bias_attr, shape=[1, bias_size],
                                   dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell
