"""Carry decoder-LM weights from a JAX scope into :class:`DecoderLM`.

``paddle_tpu.models.transformer.build_decoder_lm_programs`` names every
parameter explicitly under the prefix ``lm``, and the attention
weights follow ``fluid/layers/nn.py`` ``_attention_projection_params``
(``lm_l{i}_attn.wq`` ... ``.wo``). The layouts already agree:
matrices are [in, out] on both sides.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_TOP = {"emb": "emb", "lnf_scale": "lnf_scale", "lnf_bias": "lnf_bias",
        "head_w": "head_w"}
_LAYER = re.compile(r"l(\d+)_(ln1_scale|ln1_bias|ln2_scale|ln2_bias|"
                    r"ffn1_w|ffn1_b|ffn2_w|ffn2_b|attn\.w[qkvo])$")


_PREFIX = "lm_"


def state_key(jax_name: str) -> str:
    """The :class:`DecoderLM` state-dict key of one JAX parameter name."""
    if not jax_name.startswith(_PREFIX):
        raise KeyError(f"{jax_name!r} is not a decoder-LM parameter")
    rest = jax_name[len(_PREFIX):]
    if rest in _TOP:
        return _TOP[rest]
    m = _LAYER.match(rest)
    if m is None:
        raise KeyError(f"{jax_name!r} is not a decoder-LM parameter")
    return f"layers.{int(m.group(1))}.{m.group(2).replace('attn.', '')}"


def params_from_jax(arrays: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays by parameter name -> a state dict for
    ``DecoderLM.load_state_dict`` (fp32 CPU tensors; ``load_state_dict``
    copies them to the model's device). Every name must be a decoder-LM
    parameter; pass parameters only, not pools or the position table."""
    return {state_key(name):
            torch.from_numpy(np.array(value, dtype=np.float32))
            for name, value in arrays.items()}
