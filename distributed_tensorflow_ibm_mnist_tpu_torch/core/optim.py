"""Optimizer + LR-schedule construction from a RunConfig, equal to optax's.

The counterpart of the JAX package's ``core/optim.py`` (``make_schedule``,
``make_optimizer``), written out in PyTorch so that every update is the
optax chain's, step for step:

* schedules, evaluated at the update's count starting from 0 as optax's
  ``scale_by_schedule`` does: ``constant``; ``cosine`` =
  ``cosine_decay_schedule(lr, max(total, 1))``; ``warmup_cosine`` = linear
  0 -> lr over ``warmup`` steps joined to a cosine decay to 0 at
  ``max(total, warmup + 1)``, with the JAX package's clamp
  ``warmup = min(warmup_steps, max(total - 1, 1))``;
* ``adam`` (``scale_by_adam``: b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias-corrected moments), ``adamw`` (Adam's direction plus
  ``weight_decay * p``, both scaled by the learning rate), ``sgd``, and
  ``momentum`` = nesterov ``trace``: ``t = g + m t``, update ``g + m t``;
* ``add_decayed_weights`` (``g + wd * p``) ahead of sgd, momentum and adam
  when ``weight_decay`` is set;
* the global-norm clip outermost, with optax's rule: scale by
  ``clip / norm`` only when ``norm >= clip`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``).

The step count and the learning rate live on the host as Python numbers,
so an update never waits for the device; the moments live on the device
beside the parameters and are updated in place with PyTorch's multi-tensor
(``_foreach``) ops, a handful of launches per step whatever the number of
parameter tensors.

The ZeRO-1 sharded update (``sharded_update=True``) runs the same
:class:`Optimizer` on this rank's 1-D bucket shards
(:func:`init_sharded_opt_state`), its clip lifted out of the chain
(:func:`make_sharded_update_optimizer`).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    bucket_shard,
    flatten_buckets,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

Schedule = Callable[[int], float]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam / adamw defaults


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _warmup_cosine(peak: float, warmup: int, decay_steps: int) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``:
    ``join_schedules`` of a linear ramp and a cosine decay at ``warmup``."""
    cosine = _cosine(peak, decay_steps - warmup)

    def schedule(count: int) -> float:
        if count >= warmup:
            return cosine(count - warmup)
        return (0.0 - peak) * (1 - count / warmup) + peak  # linear_schedule(0, peak)

    return schedule


def make_schedule(config: RunConfig, total_steps: int) -> Schedule:
    if config.schedule == "constant":
        lr = config.lr
        return lambda count: lr
    if config.schedule == "cosine":
        return _cosine(config.lr, max(total_steps, 1))
    if config.schedule == "warmup_cosine":
        warmup = min(config.warmup_steps, max(total_steps - 1, 1))
        return _warmup_cosine(config.lr, warmup, max(total_steps, warmup + 1))
    raise ValueError(f"unknown schedule {config.schedule!r}")


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: in float64 the
    second moment's correction at count 1 differs by 1.3e-5 relative."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The optax chain of :func:`make_optimizer`, over a fixed list of
    parameter tensors, updating them in place.

    ``state()`` / ``load_state(s)`` snapshot and restore the count and the
    moments (device copies), for a caller that must leave training
    undisturbed.
    """

    def __init__(self, config: RunConfig, total_steps: int,
                 params: Sequence[torch.Tensor]):
        if config.optimizer not in ("adam", "adamw", "sgd", "momentum"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        self.kind = config.optimizer
        self.schedule = make_schedule(config, total_steps)
        self.weight_decay = float(config.weight_decay or 0.0)
        self.momentum = float(config.momentum)
        self.grad_clip = float(config.grad_clip) if config.grad_clip else None
        self.params = list(params)
        self.count = 0  # updates applied; the schedule reads it before the update
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros() if self.kind in ("adam", "adamw") else []
        self.nu = zeros() if self.kind in ("adam", "adamw") else []
        self.trace = zeros() if self.kind == "momentum" else []

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))  # the global L2 norm
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm), self.grad_clip)
        keep = norm < self.grad_clip
        return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (one per parameter, same order)."""
        g = [x.detach() for x in grads]
        if self.grad_clip is not None:
            g = self._clip(g)
        lr = self.schedule(self.count)
        self.count += 1
        p = self.params
        wd = self.weight_decay
        if wd and self.kind != "adamw":
            g = torch._foreach_add(g, p, alpha=wd)  # add_decayed_weights
        if self.kind in ("adam", "adamw"):
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(self.mu, _B1)
            torch._foreach_add_(self.mu, g, alpha=1 - _B1)
            torch._foreach_mul_(self.nu, _B2)
            torch._foreach_addcmul_(self.nu, g, g, value=1 - _B2)
            mu_hat = torch._foreach_div(self.mu, _bias_correction(_B1, self.count))
            nu_hat = torch._foreach_div(self.nu, _bias_correction(_B2, self.count))
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), _EPS)
            u = torch._foreach_div(mu_hat, denom)
            if self.kind == "adamw" and wd:
                torch._foreach_add_(u, p, alpha=wd)
        elif self.kind == "momentum":
            # optax.trace(nesterov=True): t = g + m t; update = g + m t
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, g)
            u = torch._foreach_add(g, self.trace, alpha=self.momentum)
        else:
            u = g
        torch._foreach_add_(p, u, alpha=-lr)

    def state(self) -> dict:
        return {"count": self.count,
                "tensors": [[t.clone() for t in ts]
                            for ts in (self.mu, self.nu, self.trace)]}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        self.count = state["count"]
        for dst, src in zip((self.mu, self.nu, self.trace), state["tensors"]):
            for d, t in zip(dst, src):
                d.copy_(t)


def make_optimizer(config: RunConfig, total_steps: int,
                   params: Sequence[torch.Tensor]) -> Optimizer:
    """The optimizer chain of ``config`` over ``params`` (see module doc)."""
    return Optimizer(config, total_steps, params)


def make_sharded_update_optimizer(config: RunConfig, total_steps: int,
                                  shards: Sequence[torch.Tensor]
                                  ) -> tuple[Optimizer, float | None]:
    """``(optimizer, grad_clip)`` for the ZeRO-1 sharded update.

    The optimizer runs the config's chain on this rank's 1-D bucket
    ``shards`` as its parameter list, which is exact for every link of the
    zoo's chains (they are elementwise: Adam moments, momentum traces,
    decayed weights, the schedules, which advance in lockstep) except the
    global-norm clip, which on a shard would see only this rank's norm.  So
    the clip is lifted out of the chain and returned as a value: the step
    applies it against the true cross-rank norm before the update (the JAX
    package's ``make_sharded_update_optimizer``)."""
    clip = float(config.grad_clip) if config.grad_clip else None
    return Optimizer(config.replace(grad_clip=None), total_steps, shards), clip


def init_sharded_opt_state(config: RunConfig, total_steps: int,
                           params: Sequence[torch.Tensor], layout
                           ) -> tuple[Optimizer, float | None]:
    """The ZeRO-1 optimizer of this rank: its parameter list is this rank's
    block of each bucket of ``params`` flattened by ``layout`` (a
    ``parallel.collectives.BucketLayout``), copied into storage of its own,
    so its moments hold 1/N of the replicated optimizer's; returns
    ``(optimizer, grad_clip)`` as :func:`make_sharded_update_optimizer`."""
    shards = [s.clone() for s in bucket_shard(flatten_buckets(params, layout), layout)]
    return make_sharded_update_optimizer(config, total_steps, shards)
