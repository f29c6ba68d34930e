"""Device resolution for the port's entry points.

The port runs on a CUDA card.  Its entry points (model construction, the
weight loader, the serving engine) take ``device=None`` to mean that card,
and raise when there is none: they never drop to the CPU on their own.
Callers that want the CPU, as the tests do, pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` when CUDA is absent.
    An explicit device is returned as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available: the PyTorch port runs on the GPU by "
            "default; pass device='cpu' to run its plain versions on the CPU")
    return torch.device("cuda")
