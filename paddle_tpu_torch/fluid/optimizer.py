"""Optimizers of the program builder (counterpart of
``paddle_tpu/fluid/optimizer.py``; reference:
python/paddle/fluid/optimizer.py — base Optimizer :44, minimize :357 =
backward + apply_gradients :286, :318).

``minimize`` appends the backward (``fluid/backward.py``), the
regularizer and clip ops, and one update op per (param, grad) pair; the
accumulators (velocity, moments, beta powers) are persistable variables
that the startup program fills. The port's executor runs the update ops
(``ops/optimizer_ops.py``): SGD, Momentum, LarsMomentum, Adam, Adamax,
Adagrad, DecayedAdagrad, Adadelta, RMSProp, Ftrl and ``ModelAverage``'s
``ema_accumulate``. The nn.Module trainers' optimizers are
``paddle_tpu_torch/optimizer.py``.
"""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.fluid import clip as clip_mod
from paddle_tpu_torch.fluid import framework, unique_name
from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.initializer import ConstantInitializer
from paddle_tpu_torch.fluid.layer_helper import LayerHelper
from paddle_tpu_torch.fluid.regularizer import append_regularization_ops


class Optimizer:
    """reference: optimizer.py:44."""

    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._lr_var = None
        self._accumulators: Dict[str, Dict[str, framework.Variable]] = {}
        self.helper_type = type(self).__name__

    # -- learning rate -----------------------------------------------------
    def _param_lr(self, param):
        """reference: optimizer.py _create_param_lr — per-param learning
        rate. append_LARS stores a decayed-lr VARIABLE (which already
        folds in the global lr) in param.optimize_attr; a float scales
        the global lr; 1.0 is the global lr unchanged."""
        plr = getattr(param, "optimize_attr", None)
        plr = (plr or {}).get("learning_rate", 1.0)
        if isinstance(plr, framework.Variable):
            return plr
        if isinstance(plr, (int, float)) and float(plr) == 1.0:
            return self._lr_var
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("scale", inputs={"X": [self._lr_var]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(plr)})
        return out

    def _create_lr_var(self):
        if self._lr_var is not None:
            return self._lr_var
        if isinstance(self._learning_rate, framework.Variable):
            self._lr_var = self._learning_rate
            return self._lr_var
        main = framework.default_main_program()
        startup = framework.default_startup_program()
        name = unique_name.generate("learning_rate")
        self._lr_var = main.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True,
            stop_gradient=True)
        sv = startup.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True)
        ConstantInitializer(float(self._learning_rate))(
            sv, startup.global_block())
        return self._lr_var

    def _global_learning_rate(self):
        return self._create_lr_var()

    # -- accumulators (reference: optimizer.py _add_accumulator) ----------
    def _add_accumulator(self, name: str, param: framework.Variable,
                         fill_value: float = 0.0, shape=None,
                         dtype=None) -> framework.Variable:
        acc_map = self._accumulators.setdefault(name, {})
        if param.name in acc_map:
            return acc_map[param.name]
        main = framework.default_main_program()
        startup = framework.default_startup_program()
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(f"{param.name}_{name}")
        v = main.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sv = startup.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        ConstantInitializer(fill_value)(sv, startup.global_block())
        acc_map[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- to be overridden --------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def apply_gradients(self, params_grads):
        """reference: optimizer.py:318."""
        main = framework.default_main_program()
        block = main.global_block()
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        params_grads = clip_mod.append_gradient_clip_ops(params_grads)
        self._create_lr_var()
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for pg in params_grads:
            ops.append(self._append_optimize_op(block, pg))
        return ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """reference: optimizer.py:357."""
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        if not params_grads:
            raise RuntimeError("no trainable parameters reach the loss")
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    """reference: optimizer.py SGDOptimizer → sgd_op.cc."""

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    """reference: optimizer.py MomentumOptimizer → momentum_op.cc."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    """reference: optimizer.py LarsMomentumOptimizer → lars_momentum_op.cc."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdamOptimizer(Optimizer):
    """reference: optimizer.py AdamOptimizer → adam_op.h."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # lazy_mode rides to the adam op: with a row-sparse gradient
        # (core/selected_rows.py) only touched rows update their moments/
        # param (adam_op.h lazy_mode semantics — untouched rows' moments
        # don't decay); with a dense gradient it is a no-op, like the
        # reference
        self._lazy_mode = bool(lazy_mode)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})


class AdamaxOptimizer(Optimizer):
    """reference: optimizer.py AdamaxOptimizer → adamax_op.cc."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class AdagradOptimizer(Optimizer):
    """reference: optimizer.py AdagradOptimizer → adagrad_op.cc."""

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    """reference: optimizer.py DecayedAdagradOptimizer."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """reference: optimizer.py AdadeltaOptimizer → adadelta_op.cc."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """reference: optimizer.py RMSPropOptimizer → rmsprop_op.cc."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum", p)
        ins = {"Param": [p], "Grad": [g], "MeanSquare": [ms], "Moment": [mom],
               "LearningRate": [self._param_lr(p)]}
        outs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        return block.append_op(
            "rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    """reference: optimizer.py FtrlOptimizer → ftrl_op.cc."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """reference: optimizer.py ModelAverage — keeps an EMA copy of params;
    one ema_accumulate op per param, applied as
    a post-step program."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(learning_rate=0.0, **kw)
        decay = 1.0 - average_window_rate
        self._decay = min(max(decay, 0.0), 0.9999)

    def apply_ema(self, params):
        main = framework.default_main_program()
        block = main.global_block()
        ops = []
        for p in params:
            ema = self._add_accumulator("ema", p)
            ops.append(block.append_op(
                "ema_accumulate", inputs={"Param": [p], "Ema": [ema]},
                outputs={"EmaOut": [ema]}, attrs={"decay": self._decay}))
        return ops


# fluid-style aliases (reference: optimizer.py bottom-of-file aliases)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
