"""``ParamAttr`` of the port (counterpart of ``paddle_tpu/fluid/
param_attr.py``; reference: python/paddle/fluid/param_attr.py)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.fluid import initializer as init_mod


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None,
                 do_model_average: bool = False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            # fluid convention: bias_attr=False means "no bias"
            raise ValueError("use None/False checks before _to_attr")
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class WeightNormParamAttr(ParamAttr):
    """reference: param_attr.py WeightNormParamAttr (w = g * v / ||v||).
    The weight-norm reparameterisation is not ported yet (ROADMAP
    A6.4b)."""

    def __init__(self, dim=None, **kwargs):
        raise NotImplementedError(
            "WeightNormParamAttr is not ported yet (ROADMAP A6.4b)")
