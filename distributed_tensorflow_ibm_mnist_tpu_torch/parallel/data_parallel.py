"""Data parallelism of the port: one rank per process over the ``data`` mesh.

The counterpart of the JAX package's ``parallel/data_parallel.py``.  There,
one program holds the whole mesh and ``shard_map`` splits the batch; here
every rank is its own process that holds its own rows and runs the same
step (``core/steps.py`` with a ``mesh``), and the gradient all-reduce is
the only collective of a step (the bucketed ZeRO-1 reduce-scatter and
all-gather instead with ``sharded_update``):

* :func:`shard_dataset` gives rank ``r`` rows ``[r n/dp, (r+1) n/dp)`` of
  the training set, after dropping a remainder of fewer than ``dp`` rows,
  and puts only those rows on its device;
* :func:`shard_eval_set` zero-pads the eval set to a multiple of ``dp``
  (never drops a row) and returns the true count for the eval's mask;
* :func:`replicate` broadcasts rank 0's parameters and buffers, so a
  rank-dependent initialisation cannot leak in;
* :func:`make_dp_train_step` runs one step on a global batch (each rank
  takes its own contiguous block, as ``P("data")`` lays it out), with the
  loss and accuracy averaged across ranks; :func:`make_dp_epoch_runner`
  runs an epoch over each rank's shard at the per-rank batch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import (
    make_epoch_runner,
    make_train_step,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    broadcast,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh


def _rows(x: np.ndarray, mesh: Mesh, n: int, device) -> torch.Tensor:
    """This rank's block of the first ``n`` rows of ``x``, on ``device``."""
    per = n // mesh.size
    block = x[mesh.rank * per:(mesh.rank + 1) * per]
    return torch.from_numpy(np.ascontiguousarray(block)).to(device)


def shard_dataset(mesh: Mesh, images: np.ndarray, labels: np.ndarray, device=None):
    """This rank's rows of a training set, on ``device``: rank ``r`` keeps
    rows ``[r n/dp, (r+1) n/dp)`` of the first ``n = (len // dp) dp``
    (a remainder of at most ``dp - 1`` rows is dropped, so every rank holds
    an equal shard).  Returns ``(images, labels)``."""
    n = (images.shape[0] // mesh.size) * mesh.size
    return _rows(images, mesh, n, device), _rows(labels, mesh, n, device)


def shard_eval_set(mesh: Mesh, images: np.ndarray, labels: np.ndarray, device=None):
    """This rank's rows of an eval set zero-padded up to a multiple of
    ``dp`` (never dropped).  Returns ``(images, labels, n_valid)``, the
    true count for ``make_eval_fn(n_valid=...)``."""
    n = images.shape[0]
    pad = (-n) % mesh.size
    if pad:
        images = np.pad(images, ((0, pad),) + ((0, 0),) * (images.ndim - 1))
        labels = np.pad(labels, ((0, pad),) + ((0, 0),) * (labels.ndim - 1))
    return (_rows(images, mesh, n + pad, device), _rows(labels, mesh, n + pad, device), n)


@torch.no_grad()
def replicate(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Give every rank rank 0's parameters and buffers (in place)."""
    for t in [*model.parameters(), *model.buffers()]:
        t.copy_(broadcast(t.detach(), root=0))
    return model


def make_dp_train_step(model, optimizer, mesh: Mesh, label_smoothing: float = 0.0,
                       fused_xent: bool = False, remat: bool = False,
                       grad_accum: int = 1, sharded_update=None):
    """One data-parallel step on a global batch: ``step(state, batch)``
    where ``batch`` is the same global batch on every rank.  Rank ``r``
    trains on rows ``[r B/dp, (r+1) B/dp)``; the returned ``loss`` and
    ``accuracy`` are the means across ranks, as JAX's step returns them.
    The same update as the single-device step on the whole batch."""
    step = make_train_step(model, optimizer, label_smoothing=label_smoothing,
                           fused_xent=fused_xent, remat=remat, grad_accum=grad_accum,
                           mesh=mesh, sharded_update=sharded_update)

    def dp_step(state, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        n = batch["label"].shape[0]
        if n % mesh.size:
            raise ValueError(f"global batch {n} not divisible by dp={mesh.size}")
        per = n // mesh.size
        local = {k: v[mesh.rank * per:(mesh.rank + 1) * per] for k, v in batch.items()}
        m = step(state, local)
        loss, accuracy = all_reduce_mean(torch.stack([m["loss"], m["accuracy"]]))
        return {"loss": loss, "accuracy": accuracy}

    return dp_step


def make_dp_epoch_runner(model, optimizer, global_batch: int, mesh: Mesh,
                         label_smoothing: float = 0.0, fused_xent: bool = False,
                         remat: bool = False, grad_accum: int = 1, sharded_update=None):
    """An epoch over this rank's shard (:func:`shard_dataset`) at the
    per-rank batch ``global_batch / dp``; ``run_epoch(state, images,
    labels, perm=None)`` as ``core.steps.make_epoch_runner``'s, with this
    rank's metrics (the Trainer averages them across ranks at its fence)."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by dp={mesh.size}")
    return make_epoch_runner(model, optimizer, global_batch // mesh.size,
                             label_smoothing=label_smoothing, fused_xent=fused_xent,
                             remat=remat, grad_accum=grad_accum, mesh=mesh,
                             sharded_update=sharded_update)
