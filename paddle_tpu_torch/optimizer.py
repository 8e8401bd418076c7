"""Optimizers of the nn.Module trainers (counterpart of
``paddle_tpu/fluid/optimizer.py``). The program-building optimizers,
whose ``minimize`` appends the backward and the update ops to a
``Program``, are ``paddle_tpu_torch/fluid/optimizer.py``.

:class:`Adam` is the JAX package's Adam (``optimizer.py:197``
``AdamOptimizer``, update rule ``ops/optimizer_ops.py:89`` ``_adam``),
not ``torch.optim.Adam``: the bias correction folds into the step size
and epsilon is added to ``sqrt(m2)`` unscaled. A dense gradient takes the
dense branch (``:140-149``); a row-sparse one (``lookup_table(...,
sparse=True)``) the sparse branches (``:102-139``).

:class:`SGD` is ``SGDOptimizer`` (rule ``ops/optimizer_ops.py:23-36``
``_sgd``): ``p - lr * g``, dense gradients only.

:class:`Adagrad` is ``AdagradOptimizer`` (``optimizer.py:268-287``, rule
``ops/optimizer_ops.py:173-182``), not ``torch.optim.Adagrad``: no
learning-rate decay, no initial accumulator, epsilon outside the root.

:class:`Momentum` is ``MomentumOptimizer`` (``optimizer.py:148-167``,
rule ``ops/optimizer_ops.py:39-66`` ``_momentum``), dense gradients only.
It takes ``regularization=``, a decay of ``paddle_tpu_torch.regularizer``
added to every parameter's gradient before the rule
(``optimizer.py:106-112``); ``p.grad`` keeps the gradient before decay.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch


def _rate(learning_rate):
    """(schedule or None, the constant rate) of a float or a callable."""
    if callable(learning_rate):
        return learning_rate, 0.0
    return None, float(learning_rate)


class Adam(torch.optim.Optimizer):
    """Per parameter, with float32 accumulators ``beta1_pow`` and
    ``beta2_pow`` that START at ``beta1`` and ``beta2`` (the JAX
    accumulators' fill values, ``optimizer.py:215-218``)::

        lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
        m1   = beta1 * m1 + (1 - beta1) * g
        m2   = beta2 * m2 + (1 - beta2) * g * g
        p   -= lr_t * m1 / (sqrt(m2) + epsilon)
        beta1_pow *= beta1;  beta2_pow *= beta2

    ``learning_rate`` is a float or a schedule: a callable that returns
    the rate of the step about to run (``learning_rate_scheduler``), read
    once per :meth:`step`. The parameters, moments and beta powers are
    updated IN PLACE. The beta powers and ``lr_t`` are host float32
    scalars (one value per parameter, as in the JAX scope), so a step
    never waits on the device; the moments live beside their parameters.
    Parameters without a gradient are skipped, their beta powers
    included.

    A sparse gradient (a COO tensor of rows, as ``lookup_table(...,
    sparse=True)`` gives) is coalesced first: duplicate rows are summed
    before the squared-gradient moment, as the JAX op dedupes
    (``:107``). Then, with ``lazy_mode=True`` (``:110-126``), only those
    rows' ``m1``, ``m2`` and values are updated and the other rows'
    moments do not decay; with ``lazy_mode=False`` (``:127-139``) every
    row's moments decay and every row moves, the gradient being zero off
    those rows. The beta powers advance once a step either way. A dense
    gradient takes the dense rule whatever ``lazy_mode`` is, as in the
    JAX op."""

    def __init__(self, params, learning_rate: Union[float, Callable] = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, lazy_mode: bool = False):
        self.schedule, lr = _rate(learning_rate)
        self.lazy_mode = bool(lazy_mode)
        super().__init__(params, dict(lr=lr, beta1=float(beta1),
                                      beta2=float(beta2),
                                      epsilon=float(epsilon)))

    @torch.no_grad()
    def step(self):
        scheduled = self.schedule() if self.schedule is not None else None
        one = np.float32(1.0)
        for group in self.param_groups:
            b1, b2, eps = group["beta1"], group["beta2"], group["epsilon"]
            rate = np.float32(group["lr"] if scheduled is None
                              else scheduled)
            ps, gs, m1s, m2s, steps = [], [], [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["moment1"] = torch.zeros_like(p)
                    st["moment2"] = torch.zeros_like(p)
                    st["beta1_pow"] = np.float32(b1)
                    st["beta2_pow"] = np.float32(b2)
                lr_t = rate * np.sqrt(one - st["beta2_pow"]) \
                    / (one - st["beta1_pow"])
                st["beta1_pow"] = st["beta1_pow"] * np.float32(b1)
                st["beta2_pow"] = st["beta2_pow"] * np.float32(b2)
                if p.grad.is_sparse:
                    self._sparse_update(p, p.grad, st, b1, b2, eps,
                                        float(lr_t))
                    continue
                ps.append(p)
                gs.append(p.grad)
                m1s.append(st["moment1"])
                m2s.append(st["moment2"])
                steps.append(-float(lr_t))
            if not ps:
                continue
            torch._foreach_mul_(m1s, b1)
            torch._foreach_add_(m1s, gs, alpha=1.0 - b1)
            torch._foreach_mul_(m2s, b2)
            torch._foreach_addcmul_(m2s, gs, gs, value=1.0 - b2)
            denom = torch._foreach_sqrt(m2s)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(ps, m1s, denom, steps)

    def _sparse_update(self, p, grad, st, b1, b2, eps, lr_t):
        g = grad.coalesce()
        rows, vals = g.indices()[0], g.values().to(p.dtype)
        m1, m2 = st["moment1"], st["moment2"]
        if self.lazy_mode:
            m1_r = b1 * m1[rows] + (1.0 - b1) * vals
            m2_r = b2 * m2[rows] + (1.0 - b2) * vals * vals
            p_r = p[rows] - lr_t * m1_r / (torch.sqrt(m2_r) + eps)
            m1[rows] = m1_r
            m2[rows] = m2_r
            p[rows] = p_r
            return
        m1.mul_(b1).index_add_(0, rows, (1.0 - b1) * vals)
        m2.mul_(b2).index_add_(0, rows, (1.0 - b2) * vals * vals)
        p.sub_(lr_t * m1 / (torch.sqrt(m2) + eps))


class SGD(torch.optim.Optimizer):
    """``p -= lr * g`` in place, the product rounded before the
    subtraction as in the JAX op, ``lr`` a float32 value (or a schedule,
    read once per :meth:`step`). Parameters without a gradient are
    skipped; a row-sparse gradient raises (the port's trainers give SGD
    none)."""

    def __init__(self, params,
                 learning_rate: Union[float, Callable] = 1e-3):
        self.schedule, lr = _rate(learning_rate)
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self):
        scheduled = self.schedule() if self.schedule is not None else None
        for group in self.param_groups:
            rate = float(np.float32(group["lr"] if scheduled is None
                                    else scheduled))
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise ValueError("SGD takes dense gradients only")
                p.sub_(p.grad * rate)


class Adagrad(torch.optim.Optimizer):
    """Per parameter, with a ``moment`` accumulator that starts at 0::

        moment += g * g
        p      -= lr * g / (sqrt(moment) + epsilon)

    in place, ``lr`` a float32 value (or a schedule, read once per
    :meth:`step`). The JAX package applies ``adagrad`` only to dense
    gradients (it is not in ``core/selected_rows.py:139``
    ``SPARSE_APPLY_OPS``), so a row-sparse gradient is densified first,
    duplicate rows summed: every row's moment takes ``g * g``, zero off
    the looked-up rows. Parameters without a gradient are skipped."""

    def __init__(self, params, learning_rate: Union[float, Callable] = 1e-2,
                 epsilon: float = 1e-6):
        self.schedule, lr = _rate(learning_rate)
        super().__init__(params, dict(lr=lr, epsilon=float(epsilon)))

    @torch.no_grad()
    def step(self):
        scheduled = self.schedule() if self.schedule is not None else None
        for group in self.param_groups:
            rate = float(np.float32(group["lr"] if scheduled is None
                                    else scheduled))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.to_dense() if p.grad.is_sparse else p.grad
                st = self.state[p]
                if not st:
                    st["moment"] = torch.zeros_like(p)
                moment = st["moment"]
                moment.add_(g * g)
                p.sub_(rate * g / (torch.sqrt(moment) + group["epsilon"]))


class Momentum(torch.optim.Optimizer):
    """Per parameter, with a ``velocity`` that starts at 0::

        v  = mu * v + g
        p -= lr * v                    # use_nesterov=False
        p -= (g + mu * v) * lr         # use_nesterov=True

    in place, ``lr`` a float32 value (or a schedule, read once per
    :meth:`step`), ``g`` the gradient after ``regularization``'s decay.
    Parameters without a gradient are skipped; a row-sparse gradient
    raises (no trainer of the port gives Momentum one)."""

    def __init__(self, params, learning_rate: Union[float, Callable],
                 momentum: float, use_nesterov: bool = False,
                 regularization=None):
        self.schedule, lr = _rate(learning_rate)
        self.use_nesterov = bool(use_nesterov)
        self.regularization = regularization
        super().__init__(params, dict(lr=lr, momentum=float(momentum)))

    @torch.no_grad()
    def step(self):
        scheduled = self.schedule() if self.schedule is not None else None
        for group in self.param_groups:
            rate = float(np.float32(group["lr"] if scheduled is None
                                    else scheduled))
            mu = group["momentum"]
            ps, gs, vs = [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise ValueError("Momentum takes dense gradients only")
                st = self.state[p]
                if not st:
                    st["velocity"] = torch.zeros_like(p)
                ps.append(p)
                gs.append(p.grad if self.regularization is None
                          else self.regularization(p, p.grad))
                vs.append(st["velocity"])
            if not ps:
                continue
            torch._foreach_mul_(vs, mu)
            torch._foreach_add_(vs, gs)
            if self.use_nesterov:
                upd = torch._foreach_mul(vs, mu)
                torch._foreach_add_(upd, gs)
                torch._foreach_mul_(upd, rate)
            else:
                upd = torch._foreach_mul(vs, rate)
            torch._foreach_sub_(ps, upd)
