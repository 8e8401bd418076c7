"""Generated layers of the unary activations, the elementwise binaries
and the comparisons (counterpart of ``paddle_tpu/fluid/layers/ops.py``;
reference: python/paddle/fluid/layers/ops.py and
layer_function_generator.py), for the op types the port's registry runs.
The others (``logsigmoid``, ``gelu``, ``elementwise_mod``, ...) come
with their emitters (ROADMAP A6.4b)."""

from __future__ import annotations

import sys

from paddle_tpu_torch.fluid.layer_helper import LayerHelper

_UNARY = ["sigmoid", "exp", "tanh", "sqrt", "ceil", "floor", "cos",
          "reciprocal", "square", "relu"]

_BINARY = ["elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow"]

_COMPARE = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal"]

_mod = sys.modules[__name__]


def _make_unary(op):
    def layer(x, name=None):
        helper = LayerHelper(op, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op, inputs={"X": [x]}, outputs={"Out": [out]})
        return out
    layer.__name__ = op
    return layer


def _make_binary(op):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)
    layer.__name__ = op
    return layer


def _make_compare(op):
    def layer(x, y, cond=None, force_cpu=None):
        helper = LayerHelper(op)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
        helper.append_op(op, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        cond.stop_gradient = True
        cond.desc.dtype = "bool"
        return cond
    layer.__name__ = op
    return layer


for _op in _UNARY:
    setattr(_mod, _op, _make_unary(_op))
for _op in _BINARY:
    setattr(_mod, _op, _make_binary(_op))
for _op in _COMPARE:
    setattr(_mod, _op, _make_compare(_op))


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out
