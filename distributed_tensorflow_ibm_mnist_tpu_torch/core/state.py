"""Train state of the port.

The JAX package threads one immutable pytree (step, params, batch_stats,
opt_state, rng) through its compiled step.  PyTorch runs eagerly and
updates in place, so here the state is a small mutable record: the step
count, the model (its parameters, and its buffers: the BatchNorm running
statistics, JAX's ``batch_stats``), the optimizer (its count and moments)
and the explicit random generators (the model's own generator, which its
dropout draws from, and the generator of the epoch permutations).
``snapshot`` / ``restore`` copy all of it on the device, for a caller that
must leave training undisturbed.  Under the ZeRO-1 sharded update the
optimizer is this rank's sharded one: its count and its 1/N moments are
what the snapshot carries (its parameter shards are copied from the
model's parameters at every step, so they need no copy of their own).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import Optimizer


@dataclass
class TrainState:
    """Everything needed to continue training."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    data_generator: torch.Generator

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def generators(self) -> list[torch.Generator]:
        gens = [self.data_generator]
        model_gen = getattr(self.model, "generator", None)
        if model_gen is not None:
            gens.append(model_gen)
        return gens

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    @torch.no_grad()
    def snapshot(self) -> dict:
        """Device copies of the parameters, the model's buffers and the
        optimizer state, with the step and every generator's state."""
        return {"step": self.step,
                "params": [p.clone() for p in self.params],
                "buffers": [b.clone() for b in self.model.buffers()],
                "optimizer": self.optimizer.state(),
                "generators": [g.get_state() for g in self.generators]}

    @torch.no_grad()
    def restore(self, snap: dict) -> None:
        self.step = snap["step"]
        for p, saved in zip(self.params, snap["params"]):
            p.copy_(saved)
        for b, saved in zip(self.model.buffers(), snap["buffers"]):
            b.copy_(saved)
        self.optimizer.load_state(snap["optimizer"])
        for g, s in zip(self.generators, snap["generators"]):
            g.set_state(s)
