"""``LayerHelper`` of the port: the plumbing every layer shares
(counterpart of ``paddle_tpu/fluid/layer_helper.py:17-137``; reference:
python/paddle/fluid/layer_helper.py:32 class, :55 append_op). It creates
parameters (their init ops go to the startup program: the two-program
convention), temporaries and the ops of the current block of the main
program. The weight-norm reparameterisation is not ported (ROADMAP
A6.4b)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.fluid import framework, initializer as init_mod
from paddle_tpu_torch.fluid import unique_name
from paddle_tpu_torch.fluid.param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self) -> framework.Program:
        return framework.default_main_program()

    @property
    def startup_program(self) -> framework.Program:
        return framework.default_startup_program()

    @property
    def block(self) -> framework.Block:
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    # -- parameters --------------------------------------------------------
    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None) -> framework.Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = (init_mod._global_bias_initializer() if is_bias
                    else init_mod._global_weight_initializer())
        # parameters live in the global block, also when a layer runs in
        # a sub-block
        param = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average,
        )
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(attr.name):
            sp = startup_block.create_var(
                name=attr.name, shape=shape, dtype=dtype, persistable=True)
            init(sp, startup_block)
        return param

    # -- temporaries -------------------------------------------------------
    def create_variable_for_type_inference(self, dtype="float32"
                                           ) -> framework.Variable:
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype)

    def create_global_variable(self, shape, dtype="float32",
                               persistable=False, name=None
                               ) -> framework.Variable:
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(
                ".".join([self.name, "global"])),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=True)

    # -- activation sugar (reference: layer_helper.py append_activation) ---
    def append_activation(self, out: framework.Variable,
                          act: Optional[str]) -> framework.Variable:
        if act is None:
            return out
        act_out = self.create_variable_for_type_inference(out.dtype)
        self.append_op(act, inputs={"X": [out]}, outputs={"Out": [act_out]})
        return act_out

    def append_bias_op(self, x: framework.Variable, bias_attr, size,
                       dim_start: int = 1) -> framework.Variable:
        if bias_attr is False:
            return x
        b = self.create_parameter(bias_attr, shape=[size], dtype=x.dtype,
                                  is_bias=True)
        out = self.create_variable_for_type_inference(x.dtype)
        self.append_op("elementwise_add", inputs={"X": [x], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out
