"""Tensor layers of the port (counterpart of ``paddle_tpu/fluid/layers/
tensor.py``; reference: python/paddle/fluid/layers/tensor.py):
``fill_constant``, ``concat``, ``sums``, ``assign``, ``cast``, ``zeros``,
``ones`` and ``zeros_like``. The rest of the file is ROADMAP A6.4b."""

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
