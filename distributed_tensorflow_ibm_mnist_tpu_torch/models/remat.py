"""Activation recomputation: the port's ``jax.checkpoint`` / ``nn.remat``.

:func:`remat` runs ``fn(*args)`` under ``torch.utils.checkpoint`` (the
non-reentrant form): the forward keeps only ``fn``'s inputs, and the
backward runs ``fn`` again to rebuild what it needs.  Two things of the
port's eager, in-place world are made to behave as flax's functional
remat does:

* BatchNorm's running statistics are updated in place by its forward
  (models/resnet.py), where flax returns ``batch_stats`` as a value that a
  remat region produces once.  The recompute runs inside
  :func:`recomputing`, and ``BatchNorm`` skips its running update there,
  so the statistics move once a step.  (The recompute still forms the
  batch moments, which the normalisation needs, and under cross-replica
  BatchNorm all-reduces them again: the same values, one more
  collective.)
* Dropout draws from explicit generators (the model's ``generator``),
  which ``torch.utils.checkpoint``'s RNG stash does not cover: the
  recompute is handed ``generators`` as they stood when the forward
  began, and they are put back afterwards, so its masks are the
  forward's.
"""

from __future__ import annotations

import contextlib
import threading
from collections.abc import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

_local = threading.local()


def recomputing() -> bool:
    """True while a :func:`remat` region's backward recompute runs (on this
    thread)."""
    return getattr(_local, "depth", 0) > 0


def remat(fn: Callable, *args, generators: Sequence[torch.Generator] = ()):
    """``fn(*args)``, its activations recomputed in the backward (module
    docstring).  Without autograd (``torch.no_grad``, eval) it is a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    gens = [g for g in generators if g is not None]
    at_forward: list = []

    @contextlib.contextmanager
    def forward_ctx():
        at_forward[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            yield
        finally:
            _local.depth -= 1
            for g, s in zip(gens, now):
                g.set_state(s)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (forward_ctx(), recompute_ctx()))
