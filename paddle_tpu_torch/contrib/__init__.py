"""Training and inference extensions of the port (counterpart of
``paddle_tpu/contrib``): ``mixed_precision`` (bf16 compute with fp32
master weights, and loss scaling), ``layout`` (the NHWC region rewrite)
and ``float16`` (the reduced-precision inference transpilers)."""
