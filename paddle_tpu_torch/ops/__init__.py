"""Operators of the port: plain PyTorch functions with the JAX
package's numerics (``nn_ops``, ``rnn_ops``, ``sequence_ops``,
``attention_block``, ``kv_attention``, ``beam_ops``, ``lod_ops``,
``metric_ops``), the hot-rows cache of a sharded table (``embed_cache``),
and the kernels under ``ops/kernels``. The program executor's op emitters
(``core/registry.py``) sit beside the functions they adapt, and in
``basic``, ``math_ops`` and ``misc_ops``."""
