"""Divergence detection (the port's copy of the JAX package's
``TrainingDiverged`` and its leaf localizer)."""

from __future__ import annotations

import torch
from torch import nn


class TrainingDiverged(RuntimeError):
    """Raised when a guarded step/state stops being finite."""

    def __init__(self, message: str, step: int | None = None, bad_leaves: list[str] | None = None):
        super().__init__(message)
        self.step = step
        self.bad_leaves = bad_leaves or []


def find_nonfinite(module: nn.Module) -> list[str]:
    """Names of the module's parameters holding NaN/Inf."""
    with torch.no_grad():
        return [name for name, p in module.named_parameters()
                if not bool(torch.isfinite(p).all())]
