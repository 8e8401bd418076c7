"""Emitters of the creation ops, the elementwise binaries and the
activations (counterpart of ``paddle_tpu/ops/basic.py``):

- the creation ops of the startup programs (``basic.py:34-100``):
  ``fill_constant``, ``fill_zeros_like``, ``gaussian_random``,
  ``uniform_random``, ``truncated_gaussian_random`` and ``assign_value``.
  The random ops draw from a ``torch.Generator`` on the executor's device
  seeded by :meth:`EmitContext.key` (the program's ``random_seed`` and the
  op's index, ``core/registry.py`` ``draw_seed``): a non-zero seed repeats
  its draws. The bits cannot be ``jax.random``'s, so parity runs carry the
  JAX startup scope across;
- ``assign`` (``basic.py:90``), ``sign`` (``:104``) and ``increment``
  (``:109``, the learning-rate schedules' step counter);
- the elementwise binaries ``elementwise_add``, ``_sub``, ``_mul``,
  ``_div``, ``_max``, ``_min``, ``_pow`` (``basic.py:158-186``) over
  ``nn_ops._elementwise``: Y broadcast into X from the ``axis`` attr
  (``nn_ops._broadcast_y``; -1: from the right), the float operands
  matched under ``__amp_match_dtype__``;
- the activations ``relu``, ``sigmoid``, ``tanh``, ``square``, ``exp``,
  ``sqrt``, ``floor``, ``ceil``, ``cos``, ``reciprocal``
  (``basic.py:196-213``), ``pow`` (``:247``) and ``clip`` (``:269``);
- the comparisons of ``_register_compare`` (``:279-292``: ``equal``,
  ``not_equal``, ``less_than``, ``less_equal``, ``greater_than``,
  ``greater_equal``; Y broadcast from ``axis`` as in the binaries),
  ``select`` (``:315``) and ``isfinite`` (``:324``), with which the
  piecewise schedule chooses and the AMP decorator
  (``contrib/mixed_precision.py``) tests and moves its loss scale.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.contrib.mixed_precision import policy_of
from paddle_tpu_torch.core.registry import (TORCH_DTYPES, first, register_op,
                                            single)
from paddle_tpu_torch.ops import nn_ops


def _device(ctx) -> torch.device:
    return ctx.device if ctx.device is not None else torch.device("cpu")


def _generator(ctx) -> torch.Generator:
    """The op's own generator on the executor's device, seeded by its
    program-level key (the reference's initializers draw ``ctx.key()``)."""
    g = torch.Generator(device=_device(ctx))
    g.manual_seed(ctx.key())
    return g


@register_op("fill_constant", no_grad=True,
             ref="operators/fill_constant_op.cc")
def _fill_constant(ctx, ins, attrs):
    return single(torch.full(tuple(attrs.get("shape", ())),
                             attrs.get("value", 0.0),
                             dtype=TORCH_DTYPES[attrs.get("dtype", "float32")],
                             device=_device(ctx)))


@register_op("fill_zeros_like", no_grad=True,
             ref="operators/fill_zeros_like_op.cc")
def _fill_zeros_like(ctx, ins, attrs):
    return single(torch.zeros_like(first(ins, "X")))


def _random(ctx, attrs, draw):
    """``draw(t, generator)`` fills a float32 tensor of the op's shape in
    place; the result is cast to the op's dtype."""
    t = torch.empty(tuple(attrs.get("shape", ())), dtype=torch.float32,
                    device=_device(ctx))
    if not t.is_meta:           # shape inference draws nothing
        t = draw(t, _generator(ctx))
    return single(t.to(TORCH_DTYPES[attrs.get("dtype", "float32")]))


@register_op("gaussian_random", no_grad=True,
             ref="operators/gaussian_random_op.cc")
def _gaussian_random(ctx, ins, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(ctx, attrs,
                   lambda t, g: t.normal_(generator=g) * std + mean)


@register_op("uniform_random", no_grad=True,
             ref="operators/uniform_random_op.cc")
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return _random(ctx, attrs, lambda t, g: t.uniform_(lo, hi, generator=g))


@register_op("truncated_gaussian_random", no_grad=True,
             ref="operators/truncated_gaussian_random_op.cc")
def _truncated_gaussian_random(ctx, ins, attrs):
    """A standard normal truncated to [-2, 2], then ``* std + mean``."""
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(ctx, attrs, lambda t, g: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=g) * std + mean)


@register_op("assign_value", no_grad=True,
             ref="operators/assign_value_op.cc")
def _assign_value(ctx, ins, attrs):
    dtype = attrs.get("dtype", "float32")
    vals = np.asarray(attrs.get("values", []), dtype=dtype).reshape(
        tuple(attrs.get("shape", ())))
    return single(torch.from_numpy(vals).to(_device(ctx)))


@register_op("assign", ref="operators/assign_op.cc")
def _assign(ctx, ins, attrs):
    return single(first(ins, "X"))


@register_op("sign", ref="operators/sign_op.cc")
def _sign(ctx, ins, attrs):
    return single(torch.sign(first(ins, "X")))


@register_op("increment", no_grad=True, ref="operators/increment_op.cc")
def _increment(ctx, ins, attrs):
    x = first(ins, "X")
    return single(x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                   device=x.device))


_ELEMENTWISE = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
                "elementwise_mul": torch.mul, "elementwise_div": torch.div,
                "elementwise_max": torch.maximum,
                "elementwise_min": torch.minimum,
                "elementwise_pow": torch.pow}
_ACTIVATIONS = {"relu": nn_ops.relu, "sigmoid": nn_ops.sigmoid,
                "tanh": torch.tanh, "square": nn_ops.square,
                "exp": torch.exp, "sqrt": torch.sqrt, "floor": torch.floor,
                "ceil": torch.ceil, "cos": torch.cos,
                "reciprocal": torch.reciprocal}
_COMPARE = {"equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
            "less_equal": torch.le, "greater_than": torch.gt,
            "greater_equal": torch.ge}


def _register_elementwise(name, fn):
    @register_op(name, ref="operators/elementwise/" + name + "_op.cc")
    def _emit(ctx, ins, attrs):
        """``__amp_match_dtype__`` matches the float operands
        (``nn_ops.match_low_precision``). ``__nhwc_bcast__`` ([C] at axis
        1) and ``__nhwc_bcast_bc__`` ([B, C] at axis 0) over an NHWC-resident
        X: the JAX op re-aims Y at the physical channel axis
        (``basic.py:163-172``); a channels-last X keeps its NCHW shape, so
        the ``axis`` broadcast is already the channel one."""
        return single(nn_ops._elementwise(fn, name, first(ins, "X"),
                                          first(ins, "Y"),
                                          policy_of(name, attrs),
                                          attrs.get("axis", -1)))


def _register_activation(name, fn):
    @register_op(name, ref="operators/activation_op.cc")
    def _emit(ctx, ins, attrs):
        return single(fn(first(ins, "X")))


for _name, _fn in _ELEMENTWISE.items():
    _register_elementwise(_name, _fn)
for _name, _fn in _ACTIVATIONS.items():
    _register_activation(_name, _fn)


@register_op("pow", ref="operators/activation_op.cc")
def _pow(ctx, ins, attrs):
    return single(torch.pow(first(ins, "X"), attrs.get("factor", 1.0)))


@register_op("clip", ref="operators/clip_op.cc")
def _clip(ctx, ins, attrs):
    return single(torch.clamp(first(ins, "X"), attrs.get("min"),
                              attrs.get("max")))


def _register_compare(name, fn):
    @register_op(name, no_grad=True,
                 ref="operators/controlflow/compare_op.cc")
    def _emit(ctx, ins, attrs):
        x = first(ins, "X")
        return single(fn(x, nn_ops._broadcast_y(x, first(ins, "Y"),
                                                attrs.get("axis", -1))))


for _name, _fn in _COMPARE.items():
    _register_compare(_name, _fn)


@register_op("isfinite", no_grad=True, ref="operators/isfinite_op.cc")
def _isfinite(ctx, ins, attrs):
    """[1] bool: every element of X finite (``basic.py:324``)."""
    return single(torch.isfinite(first(ins, "X")).all().reshape(1))


@register_op("select", ref="lax.select; elementwise choice")
def _select(ctx, ins, attrs):
    return single(torch.where(first(ins, "Condition"), first(ins, "X"),
                              first(ins, "Y")))
