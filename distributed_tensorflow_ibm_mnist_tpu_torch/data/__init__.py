"""Data of the port: the JAX package's seeded synthetic datasets and its
cache-first loader, copied (numpy only)."""

from distributed_tensorflow_ibm_mnist_tpu_torch.data.loaders import load_dataset
from distributed_tensorflow_ibm_mnist_tpu_torch.data.synthetic import (
    synthetic_cifar10,
    synthetic_fashion_mnist,
    synthetic_mnist,
)

__all__ = [
    "load_dataset",
    "synthetic_mnist",
    "synthetic_fashion_mnist",
    "synthetic_cifar10",
]
