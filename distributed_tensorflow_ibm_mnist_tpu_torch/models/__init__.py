"""Model zoo of the port: ``get_model(name, **kw)`` builds by registry name.

Ported: the causal-LM family (serving and training), LeNet-5, the MLP,
ResNet-20, ResNet-50 and the ViT (training), under the JAX package's
registry names.
"""

from __future__ import annotations

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5
from distributed_tensorflow_ibm_mnist_tpu_torch.models.mlp import MLP
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ResNet, ResNet20, ResNet50
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import VisionTransformer

_REGISTRY = {
    "mlp": MLP,
    "lenet5": LeNet5,
    "resnet20": ResNet20,
    "resnet50": ResNet50,
    "vit": VisionTransformer,
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


def model_accepts(name: str, param: str) -> bool:
    """Whether a registry builder takes the keyword ``param`` (the JAX
    package's ``model_accepts``)."""
    import inspect

    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return param in inspect.signature(builder).parameters


__all__ = ["CausalLM", "LeNet5", "MLP", "ResNet", "ResNet20", "ResNet50",
           "VisionTransformer", "get_model", "model_accepts"]
