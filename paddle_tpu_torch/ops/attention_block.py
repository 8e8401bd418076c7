"""The attention block (counterpart of ``paddle_tpu/ops/attention_block.py``
and of the ``fused_attention_block`` op, ``paddle_tpu/ops/nn_ops.py:755``):
the mask constant and the head projection of the serving path, with the
JAX package's numerics (fp32 accumulation, the result cast back to the
input dtype), and :func:`fused_attention_block`, the training path's
whole attention block."""

from __future__ import annotations

import torch

from paddle_tpu_torch.contrib.mixed_precision import policy
from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
from paddle_tpu_torch.ops.nn_ops import amp_product

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
                          seed: int = 0, amp=None) -> torch.Tensor:
    """x_q [B,Tq,M], x_kv [B,Tk,M], w* [M,M] ([in, out]) -> [B,Tq,M]: the
    q/k/v projections, flash attention over [B,H,T,D] with scale D**-0.5
    (attention-weight dropout inside, keyed by ``seed``), and the output
    projection -- the flash branch of ``_fused_attention_block``
    (``nn_ops.py:819-843``), which the port takes for every shape.

    The projections are ``torch.matmul`` (the JAX op leaves them to XLA).
    Their [B,T,H,D] results are copied into the [B*H,T,D] layout the
    kernels take, and the attention output is copied back to [B,T,M]
    before ``Wo``; the backward pays the mirror copies. These relayouts
    are the cost of the kernels' layout, not hidden.

    Where ``amp`` tags ``fused_attention_block`` with ``bf16``
    (``nn_ops.py:826-841``), every projection takes bf16 operands and is
    rounded to bf16 after its fp32 sums (``nn_ops.amp_product``), so
    flash runs in bf16 (its bf16 kernels on the card); the ``Wo``
    product is rounded to bf16 too, then kept in pure mode and widened
    to fp32 otherwise. Either way the gradient reaching flash is bf16,
    the dtype of its output."""
    b, tq, m = x_q.shape
    tk = x_kv.shape[1]
    if m % n_head:
        raise ValueError(f"d_model {m} not divisible by n_head {n_head}")
    h, d = n_head, m // n_head
    tags = policy(amp, "fused_attention_block")

    def product(x, w):
        return amp_product(x, w, True) if tags.bf16 else torch.matmul(x, w)

    def heads(x, w, t):                  # [B,T,M] -> [B,H,T,D]
        return product(x, w).view(b, t, h, d).transpose(1, 2)
    o = flash_attention(heads(x_q, wq, tq), heads(x_kv, wk, tk),
                        heads(x_kv, wv, tk), causal, float(d) ** -0.5,
                        dropout_p, seed)
    out = product(o.transpose(1, 2).reshape(b, tq, m), wo)
    # _amp_out (nn_ops.py:42-48): fp32 at the edge in conservative mode
    return out.float() if tags.bf16 and not tags.keep_bf16 else out
