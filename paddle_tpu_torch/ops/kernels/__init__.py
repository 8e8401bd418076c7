"""Hand-written CUDA kernels of the port, how they are built and
loaded, and their plain PyTorch versions."""
