"""Generation primitives of the port: prefill, decode step, greedy generator."""

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    init_cache,
    make_decode_step,
    make_generator,
    make_prefill,
)

__all__ = ["init_cache", "make_decode_step", "make_generator", "make_prefill"]
