"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Its layout mirrors the JAX package's module paths
(``ops/kv_attention.py``, ``models/transformer.py``,
``serving/engine.py``, ...), so each module's counterpart is found at
the same place. The TPU's Pallas kernels become CUDA kernels written by
hand for Hopper (``csrc/``), built with ``nvcc`` on first use
(``ops/kernels/build.py``); each keeps a plain PyTorch version beside it
that CPU tensors take (``device.uses_kernel``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve``).
"""

from paddle_tpu_torch import device  # noqa: F401
