"""Hand-written CUDA kernels of the port, how they are built and
loaded (``build``), and their plain PyTorch versions:
``paged_attention``, ``flash_attention``, ``fused_ce``, ``fused_rnn``,
``seqpool``, ``embed_pool`` and ``embed_cache``."""
