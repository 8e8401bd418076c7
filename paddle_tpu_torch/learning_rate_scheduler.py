"""Learning-rate schedules of the nn.Module trainers (counterpart of
``paddle_tpu/fluid/learning_rate_scheduler.py``; the program-building
schedules, ops over a step counter in the scope, are
``paddle_tpu_torch/fluid/learning_rate_scheduler.py``).

The JAX package keeps a float32 global step counter in the scope
(``_global_step_var``, ``:19``): it starts at 0 and the train step
increments it before the schedule reads it, so the first step sees
step 1. Here the counter lives on the schedule object, in float32 as
well, and :meth:`NoamDecay.__call__` advances it and returns the rate
of the step about to run.
"""

from __future__ import annotations

import numpy as np


class NoamDecay:
    """``noam_decay`` (``:57``): ``learning_rate * d_model**-0.5 *
    min(step**-0.5, step * warmup_steps**-1.5)``, in float32 as the JAX
    ops (``pow``, ``scale``, ``elementwise_min``) compute it."""

    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0):
        self.d_model = int(d_model)
        self.warmup_steps = int(warmup_steps)
        self.learning_rate = float(learning_rate)
        self.step_num = np.float32(0.0)

    def __call__(self) -> np.float32:
        """Advance the step counter and return this step's rate."""
        self.step_num = self.step_num + np.float32(1.0)
        a = np.power(self.step_num, np.float32(-0.5))
        b = self.step_num * np.float32(self.warmup_steps ** -1.5)
        return np.minimum(a, b) * np.float32(
            self.learning_rate * self.d_model ** -0.5)


def noam_decay(d_model: int, warmup_steps: int,
               learning_rate: float = 1.0) -> NoamDecay:
    return NoamDecay(d_model, warmup_steps, learning_rate)
