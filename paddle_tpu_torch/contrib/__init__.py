"""Training extensions of the port (counterpart of ``paddle_tpu/contrib``):
``mixed_precision``, bf16 compute with fp32 master weights and loss
scaling."""
