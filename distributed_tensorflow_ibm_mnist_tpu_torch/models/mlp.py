"""MLP of the port — the CPU smoke-test model (BASELINE.md config 1).

The counterpart of the JAX package's ``models/mlp.py``: flatten ->
``dense_{i}`` + ReLU per hidden width -> ``logits``.  Compute runs in
``dtype`` (bf16 by default; inputs, weights and biases cast to it, as
flax's ``dtype=`` does); parameters stay float32 and the logits come back
float32.  flax infers the input width at first call; here it is
``in_features`` (784 for a (28, 28, 1) image, flattened in H, W, C order
like the JAX model's ``reshape``).  Weights come from ``generator`` with
flax's initialisers (see ``models/lenet.py``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import (
    _resolve_generator,
    init_lecun_,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    """Flatten -> Dense(hidden) x N -> Dense(num_classes)."""

    def __init__(self, hidden: Sequence[int] = (256,), num_classes: int = 10,
                 in_features: int = 784, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden, self.num_classes = tuple(hidden), num_classes
        self.in_features, self.dtype = in_features, dtype
        meta = torch.device("meta")
        widths = (in_features,) + self.hidden
        for i in range(len(self.hidden)):
            setattr(self, f"dense_{i}", nn.Linear(widths[i], widths[i + 1], device=meta))
        self.logits = nn.Linear(widths[-1], num_classes, device=meta)
        self.to_empty(device=device)
        self.generator = _resolve_generator(generator, device)
        init_lecun_(self, self.generator)

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """``fc`` in the compute dtype; a tensor-parallel split of it on the
        generic path (``parallel.tensor_parallel.linear``)."""
        return tp.linear(x, fc, self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, ...) inputs -> (B, num_classes) float32; ``train`` is unused
        (the MLP has no dropout)."""
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(len(self.hidden)):
            x = F.relu(self._dense(getattr(self, f"dense_{i}"), x))
        return self._dense(self.logits, x).float()
