"""Optimizer update, clip and EMA ops of the program executor (counterpart
of ``paddle_tpu/ops/optimizer_ops.py``).

Each is a ``no_grad`` state-transition op that returns its ``*Out``
tensors, as the JAX emitter does; the block runner writes them back to
the scope under the same names (``core/lowering.py``). The arithmetic is
the JAX emitter's, term for term and in its order, so one fp32 pass
agrees to rounding. Elementwise math: the JAX package computes it outside
any Pallas kernel, and so does the port.

- dense rules: ``sgd``, ``momentum`` (and Nesterov), ``lars_momentum``,
  ``adam``, ``adamax``, ``adagrad``, ``decayed_adagrad``, ``adadelta``,
  ``rmsprop`` (centered and not), ``ftrl``, ``proximal_gd``,
  ``proximal_adagrad`` (``:23-287``);
- the sparse branches of ``sgd``, ``momentum`` and ``adam`` (lazy and
  not; ``:27-35``, ``:45-57``, ``:102-139``) take a row-sparse gradient
  (``core/selected_rows.py``) intact; Adam merges duplicate rows before
  the squared moment;
- ``clip_by_norm``, ``global_norm_clip_apply`` and ``ema_accumulate``
  (``:290-316``).

The Module optimizers of ``paddle_tpu_torch/optimizer.py`` apply the same
rules in place over all of a group's parameters at once (``_foreach``);
both are held against the JAX emitters (``tests/test_torch_optimizer_ops.py``
and the trainers' tests).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core import selected_rows as sr
from paddle_tpu_torch.core.registry import first, register_op


def _scalar(ins, slot):
    return first(ins, slot).reshape(())


def _scatter_add(t, rows, vals):
    """``t`` with ``vals`` added at ``rows`` (duplicates sum), out of
    place: the reference's ``.at[rows].add``. (``index_put`` rather than
    ``index_add``, whose CPU kernel costs ~80 ms even at a few rows.)"""
    return t.index_put((rows,), vals, accumulate=True)


@register_op("sgd", no_grad=True, ref="operators/optimizers/sgd_op.cc")
def _sgd(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    lr = first(ins, "LearningRate")
    if sr.is_sparse(g):
        # scatter-add the scaled rows into the table; duplicates sum
        sr.record_sparse_apply(ctx, g)
        rows, vals = sr.rows_values(g)
        upd = (lr.reshape(()) * vals).to(p.dtype)
        return {"ParamOut": [_scatter_add(p, rows, -upd)]}
    return {"ParamOut": [p - lr.reshape(()) * g]}


@register_op("momentum", no_grad=True,
             ref="operators/optimizers/momentum_op.cc")
def _momentum(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    v = first(ins, "Velocity")
    lr = _scalar(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    nesterov = attrs.get("use_nesterov", False)
    if sr.is_sparse(g):
        # exact dense parity: untouched rows still decay their velocity
        sr.record_sparse_apply(ctx, g)
        rows, vals = sr.rows_values(g)
        vals = vals.to(v.dtype)
        v_out = _scatter_add(mu * v, rows, vals)
        if nesterov:
            p_out = _scatter_add(p - lr * mu * v_out, rows,
                                 -(lr * vals).to(p.dtype))
        else:
            p_out = p - lr * v_out
        return {"ParamOut": [p_out], "VelocityOut": [v_out]}
    v_out = mu * v + g
    if nesterov:
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


@register_op("lars_momentum", no_grad=True,
             ref="operators/optimizers/lars_momentum_op.cc")
def _lars_momentum(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    v = first(ins, "Velocity")
    lr = _scalar(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + decay * p_norm + 1e-12), lr)
    v_out = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


def _adam_sparse(p, g, m1, m2, b1, b2, eps, lr_t, lazy):
    """Adam over a row-sparse gradient, its duplicate rows merged first:
    ``(p, m1, m2)`` out. Lazy: only the touched rows move and decay."""
    gs = g.coalesce()
    rows = gs.indices()[0]
    vals = gs.values().to(p.dtype)
    if lazy:
        m1_r = b1 * m1[rows] + (1.0 - b1) * vals
        m2_r = b2 * m2[rows] + (1.0 - b2) * torch.square(vals)
        p_r = p[rows] - lr_t * m1_r / (torch.sqrt(m2_r) + eps)
        return (p.index_copy(0, rows, p_r), m1.index_copy(0, rows, m1_r),
                m2.index_copy(0, rows, m2_r))
    m1_out = _scatter_add(b1 * m1, rows, (1.0 - b1) * vals)
    m2_out = _scatter_add(b2 * m2, rows, (1.0 - b2) * torch.square(vals))
    return (p - lr_t * m1_out / (torch.sqrt(m2_out) + eps), m1_out, m2_out)


@register_op("adam", no_grad=True, ref="operators/optimizers/adam_op.h")
def _adam(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    m1 = first(ins, "Moment1")
    m2 = first(ins, "Moment2")
    b1p = _scalar(ins, "Beta1Pow")
    b2p = _scalar(ins, "Beta2Pow")
    lr = _scalar(ins, "LearningRate")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    if sr.is_sparse(g):
        sr.record_sparse_apply(ctx, g)
        p_out, m1_out, m2_out = _adam_sparse(
            p, g, m1, m2, b1, b2, eps, lr_t, attrs.get("lazy_mode", False))
    else:
        m1_out = b1 * m1 + (1.0 - b1) * g
        m2_out = b2 * m2 + (1.0 - b2) * torch.square(g)
        p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1_out],
            "Moment2Out": [m2_out],
            "Beta1PowOut": [b1p.reshape(1) * b1],
            "Beta2PowOut": [b2p.reshape(1) * b2]}


@register_op("adamax", no_grad=True, ref="operators/optimizers/adamax_op.cc")
def _adamax(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    m = first(ins, "Moment")
    inf_norm = first(ins, "InfNorm")
    b1p = _scalar(ins, "Beta1Pow")
    lr = _scalar(ins, "LearningRate")
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1.0 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    lr_t = lr / (1.0 - b1p)
    return {"ParamOut": [p - lr_t * m_out / inf_out],
            "MomentOut": [m_out], "InfNormOut": [inf_out]}


@register_op("adagrad", no_grad=True,
             ref="operators/optimizers/adagrad_op.cc")
def _adagrad(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    mom = first(ins, "Moment")
    lr = _scalar(ins, "LearningRate")
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + torch.square(g)
    return {"ParamOut": [p - lr * g / (torch.sqrt(mom_out) + eps)],
            "MomentOut": [mom_out]}


@register_op("decayed_adagrad", no_grad=True,
             ref="operators/optimizers/decayed_adagrad_op.cc")
def _decayed_adagrad(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    mom = first(ins, "Moment")
    lr = _scalar(ins, "LearningRate")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1.0 - decay) * torch.square(g)
    return {"ParamOut": [p - lr * g / (torch.sqrt(mom_out) + eps)],
            "MomentOut": [mom_out]}


@register_op("adadelta", no_grad=True,
             ref="operators/optimizers/adadelta_op.cc")
def _adadelta(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    avg_sq_grad = first(ins, "AvgSquaredGrad")
    avg_sq_upd = first(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * avg_sq_grad + (1.0 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_upd + (1.0 - rho) * torch.square(update)
    return {"ParamOut": [p + update], "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("rmsprop", no_grad=True,
             ref="operators/optimizers/rmsprop_op.cc")
def _rmsprop(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    ms = first(ins, "MeanSquare")
    mom = first(ins, "Moment")
    lr = _scalar(ins, "LearningRate")
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    outs = {}
    ms_out = rho * ms + (1.0 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_out = rho * first(ins, "MeanGrad") + (1.0 - rho) * g
        mom_out = momentum * mom + lr * g / torch.sqrt(
            ms_out - torch.square(mg_out) + eps)
        outs["MeanGradOut"] = [mg_out]
    else:
        mom_out = momentum * mom + lr * g / torch.sqrt(ms_out + eps)
    outs.update({"ParamOut": [p - mom_out], "MomentOut": [mom_out],
                 "MeanSquareOut": [ms_out]})
    return outs


@register_op("ftrl", no_grad=True, ref="operators/optimizers/ftrl_op.cc")
def _ftrl(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    sq_accum = first(ins, "SquaredAccumulator")
    lin_accum = first(ins, "LinearAccumulator")
    lr = _scalar(ins, "LearningRate")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_accum = sq_accum + torch.square(g)
    lin_out = lin_accum + g - (
        (torch.pow(new_accum, -power) - torch.pow(sq_accum, -power))
        / lr) * p
    x = l1 * torch.sign(lin_out) - lin_out
    y = torch.pow(new_accum, -power) / lr + 2.0 * l2
    p_out = torch.where(torch.abs(lin_out) > l1, x / y,
                        torch.zeros_like(p))
    return {"ParamOut": [p_out], "SquaredAccumOut": [new_accum],
            "LinearAccumOut": [lin_out]}


def _proximal(prox, eff_lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - eff_lr * l1,
                                           min=0.0)
            / (1.0 + eff_lr * l2))


@register_op("proximal_gd", no_grad=True,
             ref="operators/optimizers/proximal_gd_op.cc")
def _proximal_gd(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    lr = _scalar(ins, "LearningRate")
    return {"ParamOut": [_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))]}


@register_op("proximal_adagrad", no_grad=True,
             ref="operators/optimizers/proximal_adagrad_op.cc")
def _proximal_adagrad(ctx, ins, attrs):
    p = first(ins, "Param")
    g = first(ins, "Grad")
    mom = first(ins, "Moment")
    lr = _scalar(ins, "LearningRate")
    mom_out = mom + torch.square(g)
    eff_lr = lr / torch.sqrt(mom_out)
    return {"ParamOut": [_proximal(p - eff_lr * g, eff_lr,
                                   attrs.get("l1", 0.0),
                                   attrs.get("l2", 0.0))],
            "MomentOut": [mom_out]}


# -- gradient clipping (the reference's clip.py lowers to these) -----------

@register_op("clip_by_norm", no_grad=True,
             ref="operators/clip_by_norm_op.cc")
def _clip_by_norm(ctx, ins, attrs):
    x = first(ins, "X")
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > max_norm,
                                x * (max_norm / (norm + 1e-12)), x)]}


@register_op("global_norm_clip_apply", no_grad=True,
             ref="python clip.py GradientClipByGlobalNorm (scale step)")
def _global_norm_clip_apply(ctx, ins, attrs):
    x = first(ins, "X")
    gnorm = _scalar(ins, "GlobalNorm")
    clip_norm = attrs.get("clip_norm", 1.0)
    scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
    return {"Out": [x * scale]}


# -- EMA over parameters (the reference's optimizer.py ModelAverage) -------

@register_op("ema_accumulate", no_grad=True,
             ref="python optimizer.py ModelAverage capability, EMA form")
def _ema_accumulate(ctx, ins, attrs):
    p = first(ins, "Param")
    ema = first(ins, "Ema")
    decay = attrs.get("decay", 0.999)
    return {"EmaOut": [decay * ema + (1.0 - decay) * p]}
