"""The ``fc`` op of the program executor (counterpart of ``_fc``,
``paddle_tpu/ops/misc_ops.py:484``): ``fc_fuse_pass``'s fused mul +
bias + relu, a thin adapter onto ``nn_ops.fc``. ``in_num_col_dims`` k
flattens the input at k (an [B, T, D] input at 2 gives [B, T, out]);
``activation_type`` is "" or "relu", the two the pass writes (any other
raises). AMP-tagged ops are refused before any op runs
(``core/lowering.py``).
"""

from __future__ import annotations

from paddle_tpu_torch.core.registry import first, register_op, single
from paddle_tpu_torch.ops import nn_ops

_FC_ACTS = {"": None, "relu": "relu"}


@register_op("fc", ref="operators/fc_op.cc")
def _fc_op(ctx, ins, attrs):
    act = attrs.get("activation_type", "") or ""
    if act not in _FC_ACTS:
        raise NotImplementedError(f"fc activation_type {act!r} is not "
                                  f"ported ('' or 'relu')")
    return single(nn_ops.fc(first(ins, "Input"), first(ins, "W"),
                            first(ins, "Bias"), _FC_ACTS[act],
                            num_flatten_dims=attrs.get("in_num_col_dims",
                                                       1)))
