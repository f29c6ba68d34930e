"""Train/eval steps and the epoch runner of the port.

The counterparts of the JAX package's ``core/steps.py``:

* ``make_loss_fn`` routes the loss as ``steps.py:101-110`` does: label
  smoothing (train only) through a soft-target cross-entropy, else the
  fused K1/K2 kernels (``ops/xent.py``) under ``fused_xent``, else the plain
  integer-label cross-entropy; eval always reports the unsmoothed loss;
* ``make_train_step`` — forward, backward (autograd) and the optimizer
  update, in place; ``grad_accum > 1`` averages the gradients of that many
  microbatches before the one update;
* ``make_epoch_runner`` — one epoch over the device-resident dataset (uint8
  images or int32 tokens): a permutation drawn on the device, each
  minibatch gathered there with ``index_select``; per-step metrics stay on
  the device as tensors;
* ``make_eval_fn`` — batched full-test-set accuracy and unsmoothed loss,
  summed on the device, off the fused kernels as in JAX (``:355``, ``:393``).

Labels may carry extra dims: the causal LM's (B, S) per-position labels
against (B, S, V) logits.  Loss and accuracy are then means over every
scored position, as optax's mean is, and eval's denominator counts scored
positions, not sequences (JAX ``steps.py:368-400``).

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``; JAX's ``axis_name``):
each rank runs the same step on its own rows.  The gradients are flattened
into a few buckets (``parallel/collectives.py``) and each bucket is
all-reduced, summed and divided by the rank count: JAX's one fused
``pmean`` over the tree (``steps.py:240`` there).  With ``sharded_update``
the ZeRO-1 update replaces it (:func:`_apply_sharded_update`).  Loss and
accuracy stay per rank on the device; the Trainer averages them across
ranks once at its fence (a mean of means over equal shards, the same
numbers as JAX's per-step ``pmean``).  Eval masks padded rows and sums
``correct`` and the loss across ranks.

PyTorch runs eagerly, so nothing here is compiled: each step is a sequence
of kernel launches from the host, and nothing reads a value back to the
host inside an epoch.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.ops.xent import softmax_xent_mean
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    ShardedUpdate,
    all_gather,
    all_reduce_sum,
    bucket_shard,
    flatten_buckets,
    grad_norm_global,
    grouped_all_reduce_mean,
    grouped_reduce_scatter_mean,
    make_bucket_layout,
    unflatten_buckets,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh

Batch = dict[str, torch.Tensor]


def _as_input(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]; other dtypes pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Integer-label cross-entropy over the last axis, float32 of the
    labels' shape: the port's form of
    ``optax.softmax_cross_entropy_with_integer_labels``."""
    x = logits.float()
    return torch.logsumexp(x, -1) - x.gather(-1, labels.long()[..., None])[..., 0]


def _smoothed_cross_entropy(logits, labels, smoothing: float) -> torch.Tensor:
    """``optax.softmax_cross_entropy`` against ``optax.smooth_labels``."""
    n_cls = logits.shape[-1]
    targets = F.one_hot(labels.long(), n_cls).float() * (1.0 - smoothing) + smoothing / n_cls
    return -(targets * torch.log_softmax(logits.float(), -1)).sum(-1)


def make_loss_fn(model, label_smoothing: float = 0.0, fused_xent: bool = False,
                 remat: bool = False) -> Callable:
    """Cross-entropy loss closure over the port's model.

    Returns ``loss_fn(batch, train) -> (loss, logits)``; the batch's
    ``image`` is uint8 or float NHWC (or (B, S) int tokens for the causal
    LM), its ``label`` int, (B,) or (B, S).  ``label_smoothing`` applies to
    the training loss only.
    """
    if fused_xent and label_smoothing > 0.0:
        raise ValueError(
            "fused_xent and label_smoothing are mutually exclusive: the Pallas "
            "fused kernel computes the unsmoothed loss, so smoothing would "
            "silently bypass it"
        )
    if remat:
        raise NotImplementedError(
            "remat (activation recomputation) is not ported to the PyTorch "
            "package yet: ROADMAP.md queue 1, 'Training follow-ups'")

    def loss_fn(batch: Batch, train: bool = True):
        logits = model(_as_input(batch["image"]), train=train)
        labels = batch["label"]
        if train and label_smoothing > 0.0:
            loss = _smoothed_cross_entropy(logits, labels, label_smoothing).mean()
        elif fused_xent:  # the kernels take (N, C) rows
            loss = softmax_xent_mean(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1))
        else:
            loss = cross_entropy(logits, labels).mean()
        return loss, logits

    return loss_fn


@torch.no_grad()
def _apply_sharded_update(optimizer, grads, params, su: ShardedUpdate,
                          mesh: Mesh) -> None:
    """The ZeRO-1 weight update (JAX's ``_apply_sharded_update``,
    ``steps.py:120-160`` there), per bucket: mean-reduce-scatter the
    gradients (each rank keeps its contiguous 1/N block), clip them against
    the true global norm (this rank's sum of squares, all-reduced), update
    this rank's block of the parameters against its sharded optimizer
    state (``optimizer``, from ``core.optim.init_sharded_opt_state``),
    all-gather the updated blocks and write them into ``params`` in place."""
    lay = su.layout
    g_shards = grouped_reduce_scatter_mean(flatten_buckets(grads, lay))
    if su.clip is not None:
        gnorm = grad_norm_global(g_shards, mesh)
        scale = torch.where(gnorm < su.clip, 1.0, su.clip / gnorm.clamp_min(1e-38))
        g_shards = torch._foreach_mul(g_shards, scale)
    p_shards = bucket_shard(flatten_buckets(params, lay), lay)
    for dst, src in zip(optimizer.params, p_shards):
        dst.copy_(src)  # the sharded optimizer updates this rank's block
    optimizer.step(g_shards)
    full = [all_gather(shard) for shard in optimizer.params]
    for p, new in zip(params, unflatten_buckets(full, lay)):
        p.copy_(new)


def make_train_step(model, optimizer, label_smoothing: float = 0.0,
                    fused_xent: bool = False, remat: bool = False,
                    grad_accum: int = 1, mesh: Mesh | None = None,
                    sharded_update: ShardedUpdate | None = None):
    """Build ``train_step(state, batch) -> metrics``; it updates
    ``state`` (parameters, optimizer, step) in place.  Metrics are device
    scalars: ``loss`` and ``accuracy`` (this rank's, under a ``mesh``).
    Dropout masks come from the model's generator, which advances with
    every step.

    ``mesh``: average the gradients across its ranks before the update,
    one all-reduce a bucket of ``make_bucket_layout``'s default count.
    ``sharded_update`` (needs ``mesh``): the ZeRO-1 update instead,
    ``optimizer`` being the sharded one."""
    if sharded_update is not None and mesh is None:
        raise ValueError("sharded_update needs a mesh (it is a cross-replica scheme)")
    loss_fn = make_loss_fn(model, label_smoothing, fused_xent=fused_xent, remat=remat)
    params = optimizer.params if sharded_update is None else list(model.parameters())
    layout = (make_bucket_layout(params, 1)
              if mesh is not None and sharded_update is None else None)

    def grads_of(batch: Batch):
        loss, logits = loss_fn(batch, train=True)
        grads = torch.autograd.grad(loss, params)
        accuracy = (logits.argmax(-1) == batch["label"]).float().mean()
        return loss.detach(), accuracy, grads

    def train_step(state: TrainState, batch: Batch) -> dict[str, torch.Tensor]:
        if grad_accum == 1:
            loss, accuracy, grads = grads_of(batch)
        else:
            n = batch["label"].shape[0]
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            loss = accuracy = 0.0
            grads = None
            for i in range(grad_accum):
                l_i, a_i, g_i = grads_of({k: v[i] for k, v in micro.items()})
                loss, accuracy = loss + l_i, accuracy + a_i
                grads = list(g_i) if grads is None else torch._foreach_add(grads, g_i)
            grads = torch._foreach_div(grads, float(grad_accum))
            loss, accuracy = loss / grad_accum, accuracy / grad_accum
        if sharded_update is not None:
            _apply_sharded_update(optimizer, grads, params, sharded_update, mesh)
        else:
            if layout is not None:  # the gradient mean across ranks
                grads = unflatten_buckets(
                    grouped_all_reduce_mean(flatten_buckets(grads, layout)), layout)
            optimizer.step(grads)
        state.step += 1
        return {"loss": loss, "accuracy": accuracy}

    return train_step


def make_epoch_runner(model, optimizer, batch_size: int, label_smoothing: float = 0.0,
                      fused_xent: bool = False, remat: bool = False, grad_accum: int = 1,
                      mesh: Mesh | None = None, sharded_update: ShardedUpdate | None = None):
    """One full epoch over a device-resident dataset.

    ``run_epoch(state, images, labels, perm=None)`` runs ``n // batch_size``
    steps and returns per-step metrics stacked on the device, ``loss`` and
    ``accuracy`` of shape (steps,).  With ``perm=None`` it draws
    ``torch.randperm(n)`` from ``state.data_generator`` on the data's
    device; a given ``perm`` (indices, at least ``steps * batch_size``) is
    used as it is.

    Under a ``mesh`` the images are this rank's shard, ``batch_size`` the
    per-rank batch and the permutation this rank's own (the caller seeds
    ``state.data_generator`` per rank: JAX folds the axis index into the
    epoch key, ``steps.py:302`` there); the metrics are this rank's.
    """
    train_step = make_train_step(model, optimizer, label_smoothing=label_smoothing,
                                 fused_xent=fused_xent, remat=remat,
                                 grad_accum=grad_accum, mesh=mesh,
                                 sharded_update=sharded_update)

    def run_epoch(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                  perm: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        n = images.shape[0]
        steps = n // batch_size
        if perm is None:
            perm = torch.randperm(n, generator=state.data_generator,
                                  device=images.device)
        perm = perm.to(images.device)[: steps * batch_size].view(steps, batch_size)
        losses, accs = [], []
        for idx in perm:
            m = train_step(state, {"image": images.index_select(0, idx),
                                   "label": labels.index_select(0, idx)})
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        return {"loss": torch.stack(losses), "accuracy": torch.stack(accs)}

    return run_epoch


def make_eval_fn(model, batch_size: int = 2000, mesh: Mesh | None = None,
                 n_valid: int | None = None):
    """Full-dataset eval: ``eval_fn(images, labels)`` -> ``{"accuracy",
    "loss"}`` as device scalars (unsmoothed loss, plain cross-entropy),
    averaged over every scored label: examples, or token positions.

    ``n_valid``: the true number of examples when the set was zero-padded
    (``parallel.data_parallel.shard_eval_set``); rows at or past it are
    masked out of both sums.  ``mesh``: ``images`` is this rank's block of
    the padded set (rank ``r`` holds rows ``r * n_local`` on), and
    ``correct`` and the loss sum are added across ranks."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        n = images.shape[0]
        correct = torch.zeros((), device=images.device)
        loss_sum = torch.zeros((), device=images.device)
        first = 0 if mesh is None else mesh.rank * n  # this block's first global row
        for start in range(0, n, batch_size):
            imgs, labs = images[start:start + batch_size], labels[start:start + batch_size]
            logits = model(_as_input(imgs), train=False)
            hits = (logits.argmax(-1) == labs).float()
            losses = cross_entropy(logits, labs)
            if n_valid is not None:
                rows = first + start + torch.arange(labs.shape[0], device=labs.device)
                keep = (rows < n_valid).float().view(-1, *([1] * (labs.ndim - 1)))
                hits, losses = hits * keep, losses * keep
            correct += hits.sum()
            loss_sum += losses.sum()
        if mesh is not None:
            correct, loss_sum = all_reduce_sum(torch.stack([correct, loss_sum]))
        per_example = labels[0].numel() if labels.ndim > 1 else 1
        examples = n if n_valid is None else n_valid
        if mesh is not None and n_valid is None:
            examples = n * mesh.size
        denom = examples * per_example  # scored positions
        return {"accuracy": correct / denom, "loss": loss_sum / denom}

    return eval_fn
