"""Model zoo of the port: ``get_model(name, **kw)`` builds by registry name.

Ported so far: the causal-LM family (serving and training), LeNet-5 and
the MLP (training), under the JAX package's registry names.  ResNet and
ViT come with later slices.
"""

from __future__ import annotations

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5
from distributed_tensorflow_ibm_mnist_tpu_torch.models.mlp import MLP

_REGISTRY = {
    "mlp": MLP,
    "lenet5": LeNet5,
    "causal_lm": CausalLM,
}


def get_model(name: str, **kwargs):
    """Build a model from the registry by name (on ``device``, the GPU by
    default)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


__all__ = ["CausalLM", "LeNet5", "MLP", "get_model"]
