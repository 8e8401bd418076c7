"""Operators of the port: plain PyTorch functions with the JAX
package's numerics, and the kernels under ``ops/kernels``."""
