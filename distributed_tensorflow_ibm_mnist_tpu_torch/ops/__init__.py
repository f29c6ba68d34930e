"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version (the JAX package's ``ops/`` held its Pallas TPU kernels)."""
