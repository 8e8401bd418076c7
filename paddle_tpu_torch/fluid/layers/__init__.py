"""``fluid.layers`` of the port (counterpart of ``paddle_tpu/fluid/
layers/__init__.py``): the layers the bench builders call (mnist, the
stacked LSTM, the Transformer, the six image classifiers, deepfm and
machine translation), the sequence, recurrent and beam layers, the
decoder LM's serving layers (``kv_attention_*``, ``token_sample``,
``gather``, ``expand``), and their neighbours whose ops the port's
registry runs, in the JAX package's module split. The layers that need
ops the port lacks, ``control_flow``, ``detection`` and ``parallel`` are
ROADMAP A6.4b's later parts."""

from paddle_tpu_torch.fluid.layers.io import data  # noqa: F401
from paddle_tpu_torch.fluid.layers.tensor import (  # noqa: F401
    assign, cast, concat, create_global_var, create_parameter,
    create_tensor, fill_constant, isfinite, ones, sums, zeros, zeros_like)
from paddle_tpu_torch.fluid.layers.nn import (  # noqa: F401
    accuracy, batch_norm, beam_search, beam_search_decode, clip,
    clip_by_norm, conv2d, cross_entropy, dropout, embedding, expand, fc,
    fused_linear_cross_entropy, fused_multi_head_attention, gather,
    kv_attention_decode, kv_attention_decode_paged, kv_attention_prefill,
    kv_attention_prefill_paged, kv_attention_prefill_slot,
    kv_attention_verify, kv_attention_verify_paged, layer_norm, matmul,
    mean, mul, pool2d, reduce_sum, reshape, scale, slice, softmax,
    sigmoid_cross_entropy_with_logits, softmax_with_cross_entropy, split,
    squeeze, sum, token_sample, topk, transpose)
from paddle_tpu_torch.fluid.layers.rnn import (  # noqa: F401
    dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit, lstm_unit)
from paddle_tpu_torch.fluid.layers.sequence import (  # noqa: F401
    edit_distance, sequence_concat, sequence_conv, sequence_enumerate,
    sequence_erase, sequence_expand, sequence_expand_as, sequence_first_step,
    sequence_last_step, sequence_mask, sequence_pad, sequence_pool,
    sequence_reshape, sequence_reverse, sequence_scatter, sequence_slice,
    sequence_softmax, sequence_unpad)
from paddle_tpu_torch.fluid.layers.ops import (  # noqa: F401
    ceil, cos, elementwise_add, elementwise_div, elementwise_max,
    elementwise_min, elementwise_mul, elementwise_pow, elementwise_sub, equal,
    exp, floor, greater_equal, greater_than, less_equal, less_than,
    not_equal, pow, reciprocal, relu, sigmoid, sqrt, square, tanh)
from paddle_tpu_torch.fluid.learning_rate_scheduler import (  # noqa: F401
    append_LARS, cosine_decay, exponential_decay, inverse_time_decay,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
