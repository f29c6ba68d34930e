"""Model zoo of the port: ``get_model(name, **kw)`` builds by registry name.

This slice ports the causal-LM family only; the registry grows with the
training slices (LeNet-5, MLP, ResNet, ViT in the JAX package).
"""

from __future__ import annotations

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM

_REGISTRY = {
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


__all__ = ["CausalLM", "get_model"]
