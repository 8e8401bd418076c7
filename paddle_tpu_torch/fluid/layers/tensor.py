"""Tensor layers of the port (counterpart of ``paddle_tpu/fluid/layers/
tensor.py``; reference: python/paddle/fluid/layers/tensor.py):
``fill_constant``, ``concat``, ``sums``, ``assign``, ``cast``, ``zeros``,
``ones``, ``zeros_like``, ``create_tensor``, ``create_parameter`` and
``create_global_var``, ``isfinite``. The layers whose ops the port lacks
(``has_inf``, ``has_nan``, ``argmax``, ``shape``, ``reverse``, ...) are
ROADMAP A6.4b."""

from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def isfinite(x):
    """[1] bool: every element of ``x`` finite (``tensor.py:165``)."""
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def create_tensor(dtype, name=None, persistable=False):
    """``tensor.py:104`` (reference tensor.py:35)."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(shape=[1], dtype=dtype,
                                         name=name, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``tensor.py:111`` (reference tensor.py:59)."""
    from paddle_tpu_torch.fluid.param_attr import ParamAttr
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape=list(shape), dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """``tensor.py:122`` (reference tensor.py:97) — a global variable that
    the startup program fills with ``value``."""
    from paddle_tpu_torch.fluid.initializer import ConstantInitializer
    helper = LayerHelper("global_var")
    var = helper.create_global_variable(shape=list(shape), dtype=dtype,
                                        name=name, persistable=persistable)
    startup_block = helper.startup_program.global_block()
    if not startup_block.has_var(var.name):
        sp = startup_block.create_var(name=var.name, shape=list(shape),
                                      dtype=dtype, persistable=persistable)
        ConstantInitializer(float(value))(sp, startup_block)
    return var
