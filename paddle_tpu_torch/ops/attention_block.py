"""Shared pieces of the attention block (counterpart of
``paddle_tpu/ops/attention_block.py``): the mask constant and the head
projection, with the JAX package's numerics (fp32 accumulation, the
result cast back to the input dtype)."""

from __future__ import annotations

import torch

# masked scores take this finite value, not -inf (attention_block.py:42):
# a row with every position masked still softmaxes to finite numbers
NEG = -2.0 ** 30


def dot(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` accumulated in fp32 -- the ``preferred_element_type=
    float32`` of the JAX dots. Products of bf16 values are exact in
    fp32, so casting the operands up first accumulates the same way."""
    return torch.einsum(equation, *(o.to(torch.float32) for o in operands))


def proj(x: torch.Tensor, w: torch.Tensor, h: int) -> torch.Tensor:
    """[B,T,M] @ [M,H,Dk] -> [B,T,H,Dk] (attention_block.py:64 ``_proj``);
    ``w`` is [M, M] in [in, out] layout."""
    b, t, m = x.shape
    return dot("btm,mn->btn", x, w).to(x.dtype).view(b, t, h, m // h)
