"""``fluid.layers`` of the port (counterpart of ``paddle_tpu/fluid/
layers/__init__.py``): the layers the mnist, stacked-LSTM and Transformer
builders call and their neighbours, in the JAX package's module split.
``control_flow``, ``detection``, ``parallel`` and the other layers are
ROADMAP A6.4b."""

from paddle_tpu_torch.fluid.layers.io import data  # noqa: F401
from paddle_tpu_torch.fluid.layers.tensor import (  # noqa: F401
    assign, cast, concat, fill_constant, ones, sums, zeros, zeros_like)
from paddle_tpu_torch.fluid.layers.nn import (  # noqa: F401
    accuracy, batch_norm, clip, conv2d, cross_entropy, dropout, embedding,
    fc, fused_linear_cross_entropy, fused_multi_head_attention, layer_norm,
    matmul, mean, mul, pool2d, reduce_sum, reshape, scale, slice, softmax,
    softmax_with_cross_entropy, squeeze, topk, transpose)
from paddle_tpu_torch.fluid.layers.rnn import (  # noqa: F401
    dynamic_gru, dynamic_lstm)
from paddle_tpu_torch.fluid.layers.sequence import (  # noqa: F401
    sequence_first_step, sequence_last_step, sequence_pool)
from paddle_tpu_torch.fluid.layers.ops import (  # noqa: F401
    ceil, cos, elementwise_add, elementwise_div, elementwise_max,
    elementwise_min, elementwise_mul, elementwise_pow, elementwise_sub, exp,
    floor, less_than, pow, reciprocal, relu, sigmoid, sqrt, square, tanh)
from paddle_tpu_torch.fluid.learning_rate_scheduler import (  # noqa: F401
    append_LARS, cosine_decay, exponential_decay, inverse_time_decay,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
