"""Mixed-precision training (counterpart of
``paddle_tpu/contrib/mixed_precision.py``): the bf16 compute rewrite and
the loss-scaling decorator.

The rewrite. The JAX :func:`rewrite_program_amp` (``:172-235``) tags the
ops of a program with attributes that their emitters read. The port has
no program: a trainer lists the op types of its forward, one entry a
site (``op_sites()``), and keeps one :class:`AmpPolicy` per op type in
its ``amp`` dict, which it hands to every op it calls. The ops read the
tags of their own JAX op type from it (:func:`policy`), as the emitters
read their attributes:

- ``bf16`` (``__amp_bf16__``): the op casts its float inputs to bf16 and
  its products accumulate in fp32 (``ops/nn_ops.py:33-50``
  ``_amp_cast``); the weights stay fp32 in the model, so the optimizer
  updates fp32 master weights from fp32 gradients.
- ``keep_bf16`` (``__amp_keep_bf16__``): the op's output stays bf16
  (pure mode); without it the output is fp32 at every op edge
  (conservative mode).
- ``match_dtype`` (``__amp_match_dtype__``): an elementwise binary casts
  an fp32 operand down to the other operand's bf16 instead of promoting
  it (``ops/basic.py:138-180``).

This is an explicit argument, not a context: there is no global autocast
state and no ``torch.autocast``, whose per-op casts differ from the
reference's. The JAX rewrite also tags the ``__vjp__`` snapshots of the
forward ops (``:220-231``), so that a backward re-traced after
``minimize`` stays in bf16. The port needs no counterpart: autograd
differentiates the same tagged forward that ran.

Loss scaling. :func:`decorate` (``:55-155``) scales the loss, takes one
all-finite flag over every gradient, multiplies the gradients by
``finite / scale`` (on overflow the update still runs, its gradient
multiplied by 0: an inf or NaN gradient stays NaN, as in the JAX
program) and, with dynamic scaling, grows the scale after
``incr_every_n_steps`` clean steps and shrinks it after
``decr_every_n_nan_or_inf`` consecutive bad ones. The scale and both
counters are fp32 [1] tensors on the parameters' device, updated by
selects there: a step reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

AMP_OP_TYPES = ("conv2d", "depthwise_conv2d", "conv2d_fusion", "conv3d",
                "mul", "matmul", "conv2d_transpose", "fc",
                "fused_linear_ce", "fused_attention_block")

RECURRENT_OPS = ("dynamic_lstm", "dynamic_gru", "dynamic_lstmp", "while",
                 "gru_unit", "lstm_unit")

# the float elementwise binaries (paddle_tpu/ops/basic.py:162-163)
ELEMENTWISE_OPS = ("elementwise_add", "elementwise_sub", "elementwise_mul",
                   "elementwise_div", "elementwise_max", "elementwise_min")

LOSS_SCALING = "loss_scaling@AMP"


@dataclass(frozen=True)
class AmpPolicy:
    """The three AMP tags of one op type (module docstring)."""
    bf16: bool = False
    keep_bf16: bool = False
    match_dtype: bool = False


FP32 = AmpPolicy()


def policy(amp: Optional[Mapping[str, AmpPolicy]], op_type: str
           ) -> AmpPolicy:
    """The tags of ``op_type`` in a model's ``amp`` dict (None: fp32)."""
    return FP32 if amp is None else amp.get(op_type, FP32)


def rewrite_program_amp(model, op_types=AMP_OP_TYPES,
                        pure: Optional[bool] = None) -> int:
    """Tag ``model``'s op sites for bf16 compute; returns the number of
    sites tagged, the count of the JAX rewrite over the forward ops.

    The ops of ``op_types`` get ``bf16``, and in pure mode ``keep_bf16``
    too; in pure mode the elementwise binaries get ``match_dtype`` and
    ``lookup_table`` gets ``keep_bf16`` (the embedding starts the
    residual stream in bf16; its gradient is cast back up before it
    reaches the fp32 table). ``pure=None`` chooses pure unless the model
    runs a recurrent op (``RECURRENT_OPS``): those scan steps are small
    and latency-bound, where bf16 edges add converts a step instead of
    saving bandwidth (``:199-202``). Apply it after ``build``, as the
    reference's ``bench.py:291-293`` applies it to the built program."""
    sites = list(model.op_sites())
    if pure is None:
        pure = not any(op in RECURRENT_OPS for op in sites)
    amp: Dict[str, AmpPolicy] = {}
    n = 0
    for op in sites:
        if op in op_types:
            amp[op] = AmpPolicy(bf16=True, keep_bf16=bool(pure))
            n += 1
        elif pure and op in ELEMENTWISE_OPS:
            amp[op] = AmpPolicy(match_dtype=True)
        elif pure and op == "lookup_table":
            amp[op] = AmpPolicy(keep_bf16=True)
            n += 1
    model.amp = amp
    return n


def decorate(optimizer, init_loss_scaling: float = 2.0 ** 15,
             use_dynamic_loss_scaling: bool = True,
             incr_every_n_steps: int = 1000,
             decr_every_n_nan_or_inf: int = 2, incr_ratio: float = 2.0,
             decr_ratio: float = 0.5) -> "OptimizerWithMixedPrecision":
    """-> ``optimizer`` training under loss scaling: call
    :meth:`OptimizerWithMixedPrecision.minimize` with the loss after the
    forward (its gradients zeroed before, as for any optimizer)."""
    return OptimizerWithMixedPrecision(
        optimizer, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, incr_ratio, decr_ratio, decr_every_n_nan_or_inf)


class OptimizerWithMixedPrecision:
    """A port optimizer under loss scaling (module docstring). The scale,
    ``good_steps@AMP`` and ``bad_steps@AMP`` are in :attr:`state`, fp32
    [1] tensors on the device of the first parameter."""

    def __init__(self, optimizer, init_scale: float, dynamic: bool,
                 incr_every: int, incr_ratio: float, decr_ratio: float,
                 decr_every: int = 2):
        self._opt = optimizer
        self._dynamic = bool(dynamic)
        self._incr_every = float(incr_every)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._decr_every = float(decr_every)
        dev = next(p.device for g in optimizer.param_groups
                   for p in g["params"])

        def var(value):
            return torch.full((1,), float(value), dtype=torch.float32,
                              device=dev)
        self.state = {LOSS_SCALING: var(init_scale),
                      "good_steps@AMP": var(0.0),
                      "bad_steps@AMP": var(0.0)}

    @property
    def loss_scaling(self) -> torch.Tensor:
        return self.state[LOSS_SCALING]

    def zero_grad(self, set_to_none: bool = True):
        self._opt.zero_grad(set_to_none=set_to_none)

    def backward(self, loss: torch.Tensor):
        """The gradients of ``loss * scale``."""
        (loss * self.loss_scaling).sum().backward()

    def _grads(self):
        return [p for g in self._opt.param_groups for p in g["params"]
                if p.grad is not None]

    @torch.no_grad()
    def step(self):
        """Unscale (gradients times ``finite / scale``), apply the inner
        optimizer, then update the scale and counters."""
        params = self._grads()
        scale = self.loss_scaling
        finite = torch.ones_like(scale)
        for p in params:
            g = p.grad._values() if p.grad.is_sparse else p.grad
            finite = finite * torch.isfinite(g).all().to(torch.float32)
        mult = finite / scale
        for p in params:
            g = p.grad
            if g.is_sparse:
                p.grad = torch.sparse_coo_tensor(
                    g._indices(), g._values() * mult.to(g.dtype), g.shape)
            else:
                g.mul_(mult.to(g.dtype))
        self._opt.step()
        if self._dynamic:
            self._update_scale(finite)

    def _update_scale(self, finite: torch.Tensor):
        """The JAX program's selects (``:118-147``), op for op in fp32."""
        st, scale = self.state, self.loss_scaling
        not_finite = 1.0 - finite
        inc = (st["good_steps@AMP"] + 1.0) * finite
        reached = (inc >= self._incr_every).to(torch.float32)
        grown = scale * (1.0 + reached * (self._incr_ratio - 1.0))
        bad_inc = (st["bad_steps@AMP"] + 1.0) * not_finite
        decr_reached = (bad_inc >= self._decr_every).to(torch.float32)
        shrunk = (scale * self._decr_ratio * decr_reached
                  + scale * (1.0 - decr_reached))
        scale.copy_(grown * finite + shrunk * not_finite)
        st["good_steps@AMP"].copy_(inc * (1.0 - reached))
        st["bad_steps@AMP"].copy_(bad_inc * (1.0 - decr_reached))

    def minimize(self, loss: torch.Tensor):
        """:meth:`backward` then :meth:`step` (``minimize``, ``:97``)."""
        self.backward(loss)
        self.step()
