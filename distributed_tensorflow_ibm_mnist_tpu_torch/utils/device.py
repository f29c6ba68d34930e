"""Device resolution for the port's entry points.

The port runs on a CUDA card.  Its entry points (model construction, the
weight loader, the serving engine) take ``device=None`` to mean that card,
and raise when there is none: they never drop to the CPU on their own.
Callers that want the CPU, as the tests do, pass ``device="cpu"``.
A data-parallel rank's card is ``cuda:{LOCAL_RANK}`` (:func:`rank_device`).
"""

from __future__ import annotations

import os

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


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """A data-parallel rank's device: ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK``
    from the environment, 0 when unset) unless ``device`` names one.
    Raises without a GPU, as :func:`resolve_device` does, and when
    ``LOCAL_RANK`` names a card this host does not have: a rank is never
    moved to another card on its own."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)  # raises without a GPU
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise RuntimeError(
            f"LOCAL_RANK={local} but this host has {count} CUDA device(s): start "
            "at most one rank per card, or name each rank's device")
    return torch.device("cuda", local)
