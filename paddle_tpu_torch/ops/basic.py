"""Emitters of the elementwise binaries and activations (counterpart of
``paddle_tpu/ops/basic.py``) over the functions of ``ops/nn_ops.py``:

- ``elementwise_add``, ``elementwise_sub``, ``elementwise_mul``
  (``basic.py:181-183``): Y broadcast into X from the ``axis`` attr
  (``nn_ops._broadcast_y``; -1: from the right);
- ``relu``, ``sigmoid``, ``square`` (``basic.py:196-203``).
"""

from __future__ import annotations

from paddle_tpu_torch.core.registry import first, register_op, single
from paddle_tpu_torch.ops import nn_ops

_ELEMENTWISE = {"elementwise_add": nn_ops.elementwise_add,
                "elementwise_sub": nn_ops.elementwise_sub,
                "elementwise_mul": nn_ops.elementwise_mul}
_ACTIVATIONS = {"relu": nn_ops.relu, "sigmoid": nn_ops.sigmoid,
                "square": nn_ops.square}


def _register_elementwise(name, fn):
    @register_op(name, ref="operators/elementwise/" + name + "_op.cc")
    def _emit(ctx, ins, attrs):
        return single(fn(first(ins, "X"), first(ins, "Y"),
                         axis=attrs.get("axis", -1)))


def _register_activation(name, fn):
    @register_op(name, ref="operators/activation_op.cc")
    def _emit(ctx, ins, attrs):
        return single(fn(first(ins, "X")))


for _name, _fn in _ELEMENTWISE.items():
    _register_elementwise(_name, _fn)
for _name, _fn in _ACTIVATIONS.items():
    _register_activation(_name, _fn)
