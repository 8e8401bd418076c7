"""Mixed-precision training (counterpart of
``paddle_tpu/contrib/mixed_precision.py``): the bf16 compute rewrite and
the loss-scaling decorator, each over a program of the port's builder
and over an nn.Module trainer.

The rewrite over a program. :func:`rewrite_program_amp` (``:172-235``)
tags the ops of a ``fluid.Program`` with attributes that their emitters
read, the JAX rewrite's tags on the same ops, in the forward ops, their
``__vjp__`` snapshots and every sub-block (so a rewrite after
``minimize`` reaches the backward), and bumps the desc's version:

- ``__amp_bf16__``: the op casts its float inputs to bf16 and its
  products accumulate in fp32 (``ops/nn_ops.py:33-50`` ``_amp_cast``);
  the weights stay fp32 in the scope, so the optimizer updates fp32
  master weights from fp32 gradients.
- ``__amp_keep_bf16__``: the op's output stays bf16 (pure mode); without
  it the output is fp32 at every op edge (conservative mode).
- ``__amp_match_dtype__``: an elementwise binary casts an fp32 operand
  down to the other operand's bf16 instead of promoting it
  (``ops/basic.py:138-180``).

Each emitter turns its op's tags into the :class:`AmpPolicy` of the
function it calls (:func:`policy_of`); ``ops/nn_ops.py`` lists which
emitter reads which tag.

The rewrite over a Module. A trainer lists the op types of its forward,
one entry a site (``op_sites()``), and keeps one :class:`AmpPolicy` per
op type in its ``amp`` dict, which it hands to every op it calls; the
ops read the tags of their own JAX op type from it (:func:`policy`), as
the emitters read their attributes. This is an explicit argument, not a
context: there is no global autocast state and no ``torch.autocast``,
whose per-op casts differ from the reference's. Autograd differentiates
the same tagged forward that ran, so no snapshot needs tagging.

Loss scaling. :func:`decorate` (``:55-155``) scales the loss, takes one
all-finite flag over every gradient, multiplies the gradients by
``finite / scale`` (on overflow the update still runs, its gradient
multiplied by 0: an inf or NaN gradient stays NaN, as in the JAX
program) and, with dynamic scaling, grows the scale after
``incr_every_n_steps`` clean steps and shrinks it after
``decr_every_n_nan_or_inf`` consecutive bad ones. Over a ``fluid``
optimizer it writes the JAX decorator's ops into the program
(:class:`ProgramOptimizerWithMixedPrecision`: ``isfinite``, ``cast``,
the elementwise ops, ``greater_equal`` and ``assign`` on the persistable
``loss_scaling@AMP``, ``good_steps@AMP`` and ``bad_steps@AMP``); over a
Module optimizer (:class:`OptimizerWithMixedPrecision`) the scale and
both counters are fp32 [1] tensors on the parameters' device, updated by
selects there. Neither reads anything back to the host in a step.
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
# every tag combination, made once: policy_of runs for each op of a step
_POLICIES = {(b, k, m): AmpPolicy(b, k, m) for b in (False, True)
             for k in (False, True) for m in (False, True)}


def policy(amp: Optional[Mapping[str, AmpPolicy]], op_type: str
           ) -> AmpPolicy:
    """The tags of ``op_type`` in a model's ``amp`` dict (None: fp32)."""
    return FP32 if amp is None else amp.get(op_type, FP32)


def policy_of(op_type: str, attrs: Mapping) -> Optional[Dict[str,
                                                             AmpPolicy]]:
    """An op's AMP tags (its attributes) as the one-entry ``amp`` dict
    that the functions of ``ops/`` take, or None when it has none (an
    untagged op pays three dict lookups)."""
    tags = (bool(attrs.get("__amp_bf16__")),
            bool(attrs.get("__amp_keep_bf16__")),
            bool(attrs.get("__amp_match_dtype__")))
    return {op_type: _POLICIES[tags]} if any(tags) else None


def rewrite_program_amp(program=None, op_types=AMP_OP_TYPES,
                        pure: Optional[bool] = None) -> int:
    """Tag ``program`` (a ``fluid.Program``; None: the default main
    program) for bf16 compute and return the number of ops tagged, as
    the JAX rewrite (``:172-235``) tags and counts them. An object with
    ``op_sites()`` (an nn.Module trainer) takes the Module branch,
    :func:`_rewrite_module`.

    The ops of ``op_types`` get ``__amp_bf16__``, and in pure mode
    ``__amp_keep_bf16__`` too; in pure mode the elementwise binaries get
    ``__amp_match_dtype__`` and ``lookup_table`` gets ``__amp_keep_bf16__``
    (the embedding starts the residual stream in bf16; its gradient is
    cast back up before it reaches the fp32 table). The ``__vjp__`` ops'
    forward snapshots are tagged alike, so a rewrite after ``minimize``
    keeps the backward in bf16. ``pure=None`` chooses pure unless the
    program runs a recurrent op (``RECURRENT_OPS``): those scan steps are
    small and latency-bound, where bf16 edges add converts a step instead
    of saving bandwidth (``:199-202``). ``bench.py:291-293`` applies it
    after the build and its passes."""
    if hasattr(program, "op_sites"):
        return _rewrite_module(program, op_types, pure)
    if program is None:
        from paddle_tpu_torch.fluid import framework
        program = framework.default_main_program()
    if pure is None:
        pure = not any(op.type in RECURRENT_OPS
                       for block in program.desc.blocks
                       for op in block.ops)
    n = 0
    for block in program.desc.blocks:
        for op in block.ops:
            if op.type in op_types:
                op.attrs["__amp_bf16__"] = True
                if pure:
                    op.attrs["__amp_keep_bf16__"] = True
                n += 1
            elif pure and op.type in ELEMENTWISE_OPS:
                op.attrs["__amp_match_dtype__"] = True
            elif pure and op.type == "lookup_table":
                op.attrs["__amp_keep_bf16__"] = True
                n += 1
            elif op.type == "__vjp__":
                fwd = op.attrs.get("fwd_op", {})
                if fwd.get("type") in op_types:
                    fwd.setdefault("attrs", {})["__amp_bf16__"] = True
                    if pure:
                        fwd["attrs"]["__amp_keep_bf16__"] = True
                    n += 1
                elif pure and fwd.get("type") in ELEMENTWISE_OPS:
                    fwd.setdefault("attrs", {})["__amp_match_dtype__"] = True
                elif pure and fwd.get("type") == "lookup_table":
                    fwd.setdefault("attrs", {})["__amp_keep_bf16__"] = True
    program.desc.bump_version()
    return n


def _rewrite_module(model, op_types, pure: Optional[bool]) -> int:
    """Tag ``model``'s op sites (its ``amp`` dict) as the program branch
    tags a program's forward ops; returns the number of sites tagged.
    Apply it after ``build``."""
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
             decr_ratio: float = 0.5):
    """-> ``optimizer`` training under loss scaling. A ``fluid`` optimizer
    gives a :class:`ProgramOptimizerWithMixedPrecision`, whose
    ``minimize(loss)`` writes the scaling into the program; a Module
    optimizer (``param_groups``) an :class:`OptimizerWithMixedPrecision`:
    call its ``minimize`` with the loss after the forward (its gradients
    zeroed before, as for any optimizer)."""
    cls = (OptimizerWithMixedPrecision if hasattr(optimizer, "param_groups")
           else ProgramOptimizerWithMixedPrecision)
    return cls(optimizer, init_loss_scaling, use_dynamic_loss_scaling,
               incr_every_n_steps, incr_ratio, decr_ratio,
               decr_every_n_nan_or_inf)


def _emit(op_type, inputs, dtype="float32"):
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def _const(value):
    from paddle_tpu_torch.fluid import layers
    return layers.fill_constant([1], "float32", float(value))


def _finite_flag(grads):
    """all(isfinite(g)) over every gradient, as a float32 [1] variable
    (``:40-50``)."""
    from paddle_tpu_torch.fluid import layers
    flags = [layers.cast(_emit("isfinite", {"X": [g]}, dtype="bool"),
                         "float32") for g in grads]
    prod = flags[0]
    for f in flags[1:]:
        prod = layers.elementwise_mul(prod, f)
    return layers.reshape(prod, shape=[1])


class ProgramOptimizerWithMixedPrecision:
    """A ``fluid`` optimizer under loss scaling: the JAX package's
    ``OptimizerWithMixedPrecision`` (``:64-147``), op for op. The scale
    and the counters are persistable fp32 [1] variables that the startup
    program fills."""

    def __init__(self, optimizer, init_scale: float, dynamic: bool,
                 incr_every: int, incr_ratio: float, decr_ratio: float,
                 decr_every: int = 2):
        self._opt = optimizer
        self._init_scale = float(init_scale)
        self._dynamic = dynamic
        self._incr_every = float(incr_every)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._decr_every = float(decr_every)

    @property
    def loss_scaling_name(self) -> str:
        return LOSS_SCALING

    def backward(self, *a, **kw):
        return self._opt.backward(*a, **kw)

    def apply_gradients(self, params_grads):
        return self._opt.apply_gradients(params_grads)

    def _persistable(self, name, value):
        from paddle_tpu_torch.fluid import framework
        from paddle_tpu_torch.fluid.initializer import ConstantInitializer
        main = framework.default_main_program()
        startup = framework.default_startup_program()
        v = main.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True,
            stop_gradient=True)
        sv = startup.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        ConstantInitializer(float(value))(sv, startup.global_block())
        return v

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """-> (the optimizer ops, the (param, scaled-back grad) pairs)."""
        from paddle_tpu_torch.fluid import layers
        scale_var = self._persistable(LOSS_SCALING, self._init_scale)
        good_steps = self._persistable("good_steps@AMP", 0.0)
        scaled_loss = layers.elementwise_mul(loss, scale_var)
        params_grads = self._opt.backward(scaled_loss, startup_program,
                                          parameter_list, no_grad_set)
        finite = _finite_flag([g for _, g in params_grads])
        mult = layers.elementwise_div(finite, scale_var)
        safe = [(p, layers.elementwise_mul(g, mult))
                for p, g in params_grads]
        opt_ops = self._opt.apply_gradients(safe)
        if self._dynamic:
            self._update_scale(scale_var, good_steps, finite)
        return opt_ops, params_grads

    def _update_scale(self, scale_var, good_steps, finite):
        """The JAX program's selects (``:118-147``)."""
        from paddle_tpu_torch.fluid import layers
        L = layers
        bad_steps = self._persistable("bad_steps@AMP", 0.0)
        one = _const(1.0)
        not_finite = L.elementwise_sub(one, finite)
        inc = L.elementwise_mul(L.elementwise_add(good_steps, one), finite)
        reached = L.cast(L.greater_equal(inc, _const(self._incr_every)),
                         "float32")
        grown = L.elementwise_mul(scale_var, L.elementwise_add(
            one, L.elementwise_mul(reached,
                                   _const(self._incr_ratio - 1.0))))
        bad_inc = L.elementwise_mul(L.elementwise_add(bad_steps, one),
                                    not_finite)
        decr_reached = L.cast(
            L.greater_equal(bad_inc, _const(self._decr_every)), "float32")
        shrunk_overflow = L.elementwise_add(
            L.elementwise_mul(L.elementwise_mul(
                scale_var, _const(self._decr_ratio)), decr_reached),
            L.elementwise_mul(scale_var, L.elementwise_sub(one,
                                                           decr_reached)))
        new_scale = L.elementwise_add(
            L.elementwise_mul(grown, finite),
            L.elementwise_mul(shrunk_overflow, not_finite))
        L.assign(new_scale, scale_var)
        L.assign(L.elementwise_mul(inc, L.elementwise_sub(one, reached)),
                 good_steps)
        L.assign(L.elementwise_mul(bad_inc, L.elementwise_sub(
            one, decr_reached)), bad_steps)


class OptimizerWithMixedPrecision:
    """A Module optimizer under loss scaling (module docstring). The scale,
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
