"""Sequence layers of the port (counterpart of ``paddle_tpu/fluid/
layers/sequence.py``; reference: python/paddle/fluid/layers/nn.py
sequence_pool): padded [B, T, ...] inputs with an explicit ``seq_lens``.
Only ``sequence_pool`` and its FIRST / LAST forms are ported here; the
rest of the file is ROADMAP A6.4b."""

from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def _seq_inputs(x, seq_lens, slot="X"):
    ins = {slot: [x]}
    if seq_lens is not None:
        ins["SeqLens"] = [seq_lens]
    return ins


def sequence_pool(input, pool_type, seq_lens=None):
    """reference: nn.py sequence_pool — SUM / AVERAGE / SQRT / MAX / LAST
    / FIRST."""
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
