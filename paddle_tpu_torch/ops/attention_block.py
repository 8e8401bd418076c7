"""The attention block (counterpart of ``paddle_tpu/ops/attention_block.py``
and of the ``fused_attention_block`` op, ``paddle_tpu/ops/nn_ops.py:755``):
the mask constant and the head projection of the serving path, with the
JAX package's numerics (fp32 accumulation, the result cast back to the
input dtype), and :func:`fused_attention_block`, the training path's
whole attention block."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention

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


def fused_attention_block(x_q: torch.Tensor, x_kv: torch.Tensor,
                          wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, wo: torch.Tensor, n_head: int,
                          causal: bool = False, dropout_p: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """x_q [B,Tq,M], x_kv [B,Tk,M], w* [M,M] ([in, out]) -> [B,Tq,M]: the
    q/k/v projections, flash attention over [B,H,T,D] with scale D**-0.5
    (attention-weight dropout inside, keyed by ``seed``), and the output
    projection -- the flash branch of ``_fused_attention_block``
    (``nn_ops.py:819-843``), which the port takes for every shape.

    The projections are ``torch.matmul`` (the JAX op leaves them to XLA).
    Their [B,T,H,D] results are copied into the [B*H,T,D] layout the
    kernels take, and the attention output is copied back to [B,T,M]
    before ``Wo``; the backward pays the mirror copies. These relayouts
    are the cost of the kernels' layout, not hidden."""
    b, tq, m = x_q.shape
    tk = x_kv.shape[1]
    if m % n_head:
        raise ValueError(f"d_model {m} not divisible by n_head {n_head}")
    h, d = n_head, m // n_head

    def heads(x, w, t):                  # [B,T,M] -> [B,H,T,D]
        return torch.matmul(x, w).view(b, t, h, d).transpose(1, 2)
    o = flash_attention(heads(x_q, wq, tq), heads(x_kv, wk, tk),
                        heads(x_kv, wv, tk), causal, float(d) ** -0.5,
                        dropout_p, seed)
    return torch.matmul(o.transpose(1, 2).reshape(b, tq, m), wo)
