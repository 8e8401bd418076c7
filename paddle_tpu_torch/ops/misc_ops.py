"""The ``fc`` op of the program executor (counterpart of ``_fc``,
``paddle_tpu/ops/misc_ops.py:484-500``): ``fc_fuse_pass``'s fused mul +
bias + relu over ``nn_ops.fc``. ``in_num_col_dims`` k flattens the input
at k (an [B, T, D] input at 2 gives [B, T, out]); ``activation_type`` is
"" or "relu", the two the pass writes (any other raises). Its AMP tags
make the product :func:`nn_ops.amp_product` (bf16 operands, fp32 sums,
bf16 with ``__amp_keep_bf16__``), and the bias is cast to the product's
dtype before the add, as the JAX op casts it.
"""

from __future__ import annotations

from paddle_tpu_torch.contrib.mixed_precision import policy_of
from paddle_tpu_torch.core.registry import first, register_op, single
from paddle_tpu_torch.ops import nn_ops

_FC_ACTS = {"": None, "relu": "relu"}


@register_op("fc", ref="operators/fc_op.cc")
def _fc_op(ctx, ins, attrs):
    act = attrs.get("activation_type", "") or ""
    if act not in _FC_ACTS:
        raise NotImplementedError(f"fc activation_type {act!r} is not "
                                  f"ported ('' or 'relu')")
    amp = policy_of("fc", attrs)
    out = nn_ops.fc(first(ins, "Input"), first(ins, "W"), None, None,
                    amp and {"mul": amp["fc"]},
                    num_flatten_dims=attrs.get("in_num_col_dims", 1))
    bias = first(ins, "Bias")
    if bias is not None:
        out = out + bias.reshape(-1).to(out.dtype)
    return single(out if _FC_ACTS[act] is None else nn_ops.relu(out))
