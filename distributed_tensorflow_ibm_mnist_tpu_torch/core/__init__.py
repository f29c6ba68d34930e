"""Core of the port: generation primitives (serving) and the training
loop (Trainer, steps, optimizer, state)."""

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    init_cache,
    make_decode_step,
    make_generator,
    make_prefill,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer

__all__ = ["TrainState", "Trainer", "init_cache", "make_decode_step",
           "make_generator", "make_prefill"]
