"""Numeric-health checking and fault injection (the port's copy of the JAX
package's ``utils/debug.py``).

* :func:`all_finite` — one bool tensor: every floating tensor of a state is
  finite.  One fused multi-tensor reduction (``torch._foreach_norm`` with
  the infinity norm, which a NaN or an Inf survives) and one comparison,
  so the caller pays one scalar readback, not one sync per tensor;
* :func:`find_nonfinite` — the names of the parameters holding NaN/Inf
  (the localizer);
* :func:`check_state` — raise :class:`TrainingDiverged`, with those names,
  on a non-finite state;
* :func:`inject_nan` — set one element of one named parameter to NaN, in
  place (the port's state is mutable; JAX's returns a copy): fault
  injection for the recovery tests and the ``train-step`` chaos site.

A "state" here is a module, a ``core.state.TrainState`` (its model's
parameters and buffers and its optimizer's moments), a tensor, or a
mapping or sequence of those.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping
from typing import Any

import torch
from torch import nn


class TrainingDiverged(RuntimeError):
    """Raised when a guarded step/state stops being finite."""

    def __init__(self, message: str, step: int | None = None, bad_leaves: list[str] | None = None):
        super().__init__(message)
        self.step = step
        self.bad_leaves = bad_leaves or []


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "model") and hasattr(tree, "optimizer"):  # a TrainState
        yield from _tensors(tree.model)
        opt = tree.optimizer
        yield from _tensors([opt.mu, opt.nu, opt.trace])


@torch.no_grad()
def all_finite(tree: Any) -> torch.Tensor:
    """A 0-d bool tensor: every floating tensor of ``tree`` is finite."""
    floats = [t.detach() for t in _tensors(tree)
              if t.is_floating_point() and t.numel() > 0]
    if not floats:
        return torch.tensor(True)
    norms = torch._foreach_norm(floats, float("inf"))  # NaN and Inf survive a max
    return torch.isfinite(torch.stack([n.float().to(norms[0].device) for n in norms])).all()


def find_nonfinite(module: nn.Module) -> list[str]:
    """Names of the module's parameters holding NaN/Inf."""
    with torch.no_grad():
        return [name for name, p in module.named_parameters()
                if not bool(torch.isfinite(p).all())]


def _module(state: Any) -> nn.Module:
    return state if isinstance(state, nn.Module) else state.model


def check_state(state: Any, step: int | None = None) -> None:
    """Raise :class:`TrainingDiverged` (with parameter names) when
    ``state`` (a module or a TrainState) holds a non-finite value."""
    if bool(all_finite(state)):
        return
    bad = find_nonfinite(_module(state))
    raise TrainingDiverged(
        f"non-finite values at step {step}: {bad[:8]}{'...' if len(bad) > 8 else ''}",
        step=step, bad_leaves=bad,
    )


@torch.no_grad()
def inject_nan(state: Any, name: str) -> Any:
    """Set element 0 of the parameter ``name`` (as ``named_parameters``
    gives it) of ``state`` (a module or a TrainState) to NaN, in place;
    returns ``state``.  Fault injection for recovery tests only."""
    params = dict(_module(state).named_parameters())
    if name not in params:
        raise KeyError(f"no parameter named {name!r}")
    params[name].view(-1)[0] = float("nan")
    return state
