"""Learning-rate schedules of the program builder (counterpart of
``paddle_tpu/fluid/learning_rate_scheduler.py``; reference:
python/paddle/fluid/learning_rate_scheduler.py): ``noam_decay``,
``exponential_decay``, ``natural_exp_decay``, ``inverse_time_decay``,
``polynomial_decay``, ``piecewise_decay``, ``cosine_decay`` and
``append_LARS``, each ops over a global step counter.

The counter is a persistable [1] variable that an ``increment`` op of the
training program advances once a step, so the rate a step fetches is
that of its own step (1 on the first run). The nn.Module trainers'
schedules are ``paddle_tpu_torch/learning_rate_scheduler.py``.
"""

from __future__ import annotations

import math

from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid.initializer import ConstantInitializer
from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def _global_step_var():
    """Create (once) the auto-incremented global step counter
    (reference: _decay_step_counter in learning_rate_scheduler.py)."""
    main = framework.default_main_program()
    startup = framework.default_startup_program()
    name = "@lr_decay_counter@"
    gblock = main.global_block()
    if gblock.has_var(name):
        return gblock.var(name)
    step = gblock.create_var(name=name, shape=[1], dtype="float32",
                             persistable=True, stop_gradient=True)
    sv = startup.global_block().create_var(name=name, shape=[1],
                                           dtype="float32", persistable=True)
    ConstantInitializer(0.0)(sv, startup.global_block())
    gblock.append_op("increment", inputs={"X": [step]},
                     outputs={"Out": [step]}, attrs={"step": 1.0})
    return step


def _tmp(helper, dtype="float32"):
    return helper.create_variable_for_type_inference(dtype)


def _op(helper, op_type, ins, attrs=None):
    out = _tmp(helper)
    helper.append_op(op_type, inputs=ins, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def _const(helper, value):
    out = _tmp(helper)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [1], "dtype": "float32",
                            "value": float(value)})
    return out


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """reference: learning_rate_scheduler.py noam_decay —
    lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    helper = LayerHelper("noam_decay")
    step = _global_step_var()
    a = _op(helper, "pow", {"X": [step]}, {"factor": -0.5})
    b = _op(helper, "scale", {"X": [step]},
            {"scale": warmup_steps ** -1.5})
    m = _op(helper, "elementwise_min", {"X": [a], "Y": [b]})
    return _op(helper, "scale", {"X": [m]},
               {"scale": learning_rate * d_model ** -0.5})


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate^(step/decay_steps)."""
    helper = LayerHelper("exponential_decay")
    step = _global_step_var()
    div = _op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _op(helper, "floor", {"X": [div]})
    rate = _const(helper, decay_rate)
    powed = _op(helper, "elementwise_pow", {"X": [rate], "Y": [div]})
    return _op(helper, "scale", {"X": [powed]}, {"scale": learning_rate})


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step/decay_steps)."""
    helper = LayerHelper("natural_exp_decay")
    step = _global_step_var()
    div = _op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _op(helper, "floor", {"X": [div]})
    e = _op(helper, "scale", {"X": [div]}, {"scale": -decay_rate})
    powed = _op(helper, "exp", {"X": [e]})
    return _op(helper, "scale", {"X": [powed]}, {"scale": learning_rate})


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step/decay_steps)."""
    helper = LayerHelper("inverse_time_decay")
    step = _global_step_var()
    div = _op(helper, "scale", {"X": [step]}, {"scale": 1.0 / decay_steps})
    if staircase:
        div = _op(helper, "floor", {"X": [div]})
    denom = _op(helper, "scale", {"X": [div]},
                {"scale": decay_rate, "bias": 1.0})
    recip = _op(helper, "reciprocal", {"X": [denom]})
    return _op(helper, "scale", {"X": [recip]}, {"scale": learning_rate})


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    helper = LayerHelper("polynomial_decay")
    step = _global_step_var()
    if cycle:
        div = _op(helper, "scale", {"X": [step]},
                  {"scale": 1.0 / decay_steps})
        ceiled = _op(helper, "ceil", {"X": [div]})
        one = _const(helper, 1.0)
        mult = _op(helper, "elementwise_max", {"X": [ceiled], "Y": [one]})
        total = _op(helper, "scale", {"X": [mult]}, {"scale": decay_steps})
    else:
        total = _const(helper, decay_steps)
        step = _op(helper, "elementwise_min", {"X": [step], "Y": [total]})
    frac = _op(helper, "elementwise_div", {"X": [step], "Y": [total]})
    one = _const(helper, 1.0)
    rem = _op(helper, "elementwise_sub", {"X": [one], "Y": [frac]})
    powed = _op(helper, "pow", {"X": [rem]}, {"factor": power})
    scaled = _op(helper, "scale", {"X": [powed]},
                 {"scale": learning_rate - end_learning_rate})
    return _op(helper, "scale", {"X": [scaled]},
               {"scale": 1.0, "bias": end_learning_rate})


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i] (reference builds this with
    control-flow ops; here a select chain)."""
    assert len(values) == len(boundaries) + 1
    helper = LayerHelper("piecewise_decay")
    step = _global_step_var()
    lr = _const(helper, values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        bound = _const(helper, float(b))
        cond = _op(helper, "less_than", {"X": [step], "Y": [bound]})
        val = _const(helper, v)
        lr = _op(helper, "select",
                 {"Condition": [cond], "X": [val], "Y": [lr]})
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr/2 * (cos(pi * epoch/epochs) + 1)."""
    helper = LayerHelper("cosine_decay")
    step = _global_step_var()
    epoch = _op(helper, "scale", {"X": [step]},
                {"scale": 1.0 / step_each_epoch})
    epoch = _op(helper, "floor", {"X": [epoch]})
    ang = _op(helper, "scale", {"X": [epoch]}, {"scale": math.pi / epochs})
    c = _op(helper, "cos", {"X": [ang]})
    half = _op(helper, "scale", {"X": [c]},
               {"scale": 0.5, "bias": 0.5})
    return _op(helper, "scale", {"X": [half]}, {"scale": learning_rate})


def append_LARS(params_grads, learning_rate, weight_decay):
    """reference: layers/learning_rate_scheduler.py:310 — layer-wise
    adaptive rate scaling: per-param decayed lr =
    lr * ||w|| / (||g|| + wd * ||w||), written into the param's
    optimize_attr; the optimizer's _param_lr feeds that Variable to the
    update op in place of the global lr (reference _create_param_lr).
    The LARS-momentum optimizer (ops/optimizer_ops.py lars_momentum) is
    the fused form."""
    helper = LayerHelper("lars")

    def _norm(v):
        sq = _op(helper, "square", {"X": [v]})
        s = _op(helper, "reduce_sum", {"X": [sq]}, {"reduce_all": True})
        return _op(helper, "sqrt", {"X": [s]})

    for param, grad in params_grads:
        param_norm = _norm(param)
        grad_norm = _norm(grad)
        if weight_decay == 1.0:
            denom = _op(helper, "elementwise_add",
                        {"X": [grad_norm], "Y": [param_norm]})
        else:
            scaled = _op(helper, "scale", {"X": [param_norm]},
                         {"scale": float(weight_decay)})
            denom = _op(helper, "elementwise_add",
                        {"X": [grad_norm], "Y": [scaled]})
        num = _op(helper, "elementwise_mul",
                  {"X": [learning_rate], "Y": [param_norm]})
        decayed = _op(helper, "elementwise_div",
                      {"X": [num], "Y": [denom]})
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        if not (isinstance(param_lr, float) and param_lr == 1.0):
            decayed = _op(helper, "scale", {"X": [decayed]},
                          {"scale": float(param_lr)})
        param.optimize_attr["learning_rate"] = decayed
