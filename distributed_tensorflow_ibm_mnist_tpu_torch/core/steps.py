"""Train/eval steps and the epoch runner of the port.

The counterparts of the JAX package's ``core/steps.py``:

* ``make_loss_fn`` routes the loss as ``steps.py:101-110`` does: label
  smoothing (train only) through a soft-target cross-entropy, else the
  fused K1/K2 kernels (``ops/xent.py``) under ``fused_xent``, else the plain
  integer-label cross-entropy; eval always reports the unsmoothed loss;
* ``make_train_step`` — forward, backward (autograd) and the optimizer
  update, in place; ``grad_accum > 1`` averages the gradients of that many
  microbatches before the one update; a model with MoE blocks adds the
  ``moe_dropped_frac`` metric (the mean over its MoE blocks, averaged over
  the microbatches, ``steps.py:77-115`` there);
* ``make_epoch_runner`` — one epoch over the device-resident dataset (uint8
  images or int32 tokens): a permutation drawn on the device, each
  minibatch gathered there with ``index_select``; per-step metrics stay on
  the device as tensors;
* ``make_chunk_runner`` — ``k`` consecutive steps over one transferred
  chunk of stacked batches (stream mode's unit, ``steps.py:315`` there);
* ``make_eval_fn`` — batched full-test-set accuracy and unsmoothed loss,
  summed on the device, off the fused kernels as in JAX (``:355``, ``:393``).

``remat=True`` recomputes the whole forward's activations in the backward
(``models/remat.py``; JAX's ``jax.checkpoint`` over the forward,
``steps.py:94-95``); the loss, and so the K1/K2 kernels, sit outside the
recomputed region.  BatchNorm's running statistics move once a step.

Labels may carry extra dims: the causal LM's (B, S) per-position labels
against (B, S, V) logits.  Loss and accuracy are then means over every
scored position, as optax's mean is, and eval's denominator counts scored
positions, not sequences (JAX ``steps.py:368-400``).

Sequence parallelism (a model whose ``attn_fn`` is the ring or Ulysses,
``parallel/ring_attention.py``): the causal LM's logits cover this rank's
token slice only (``model.seq_span``), so the loss and accuracy take the
labels of those positions (:func:`local_labels`) and are means over the
local tokens.  Every rank of the ``dp * sp`` group holds as many tokens,
so the mean of the ranks' local means is the mean over every token of the
global batch, and averaging each rank's gradient of its local mean over
the whole group gives that global mean's gradient: each rank's gradient
holds the paths through its own activations, and the ring's (or the
all-to-all's) backward brings home its share of every other rank's loss.
The ViT's logits are whole on every seq rank (its pool sums across the
seq group), so its labels stay whole; eval then sums over the data axis
only, the LM's over every rank.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``; JAX's ``axis_name``):
each rank runs the same step on its own rows.  The gradients are flattened
into a few buckets (``parallel/collectives.py``) and each bucket is
all-reduced, summed and divided by the rank count: JAX's one fused
``pmean`` over the tree (``steps.py:240`` there).  With ``sharded_update``
the ZeRO-1 update replaces it (:func:`_apply_sharded_update`).  With a
``plan`` (``parallel.fsdp.ShardPlan``: ZeRO-3 and expert parallelism) the
step gathers the fsdp leaves whole before the forward, releases them after
the backward, and the plan reduces the gradients and updates this rank's
blocks (``ShardPlan.apply``).  Loss and
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
from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import remat as remat_fn
from distributed_tensorflow_ibm_mnist_tpu_torch.ops.xent import softmax_xent_mean
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    ShardedUpdate,
    all_reduce_sum,
    bucket_reduce_scatter_mean,
    flatten_buckets,
    gather_bucket_shards,
    grad_norm_global,
    grouped_all_reduce_mean,
    load_bucket_shards,
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


def local_labels(model, labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The labels of the positions ``logits`` scores: under sequence
    parallelism the causal LM's (B, S_local, V) logits score this rank's
    slice of the (B, S) labels (module docstring); otherwise all of them."""
    if labels.ndim > 1 and logits.ndim > labels.ndim and logits.shape[1] != labels.shape[1]:
        lo, hi = model.seq_span(labels.shape[1])
        return labels[:, lo:hi]
    return labels


def make_loss_fn(model, label_smoothing: float = 0.0, fused_xent: bool = False,
                 remat: bool = False, moe_aux_weight: float = 0.01,
                 with_drop: bool = False) -> Callable:
    """Cross-entropy loss closure over the port's model.

    Returns ``loss_fn(batch, train) -> (loss, logits)``; the batch's
    ``image`` is uint8 or float NHWC (or (B, S) int tokens for the causal
    LM), its ``label`` int, (B,) or (B, S).  ``label_smoothing`` applies to
    the training loss only.

    A model with MoE blocks (``model.has_moe``) adds, to the training
    loss only, ``moe_aux_weight`` x the sum of its blocks' load-balancing
    losses and the sum of their z-losses (pre-weighted by the blocks'
    ``moe_z_weight``), as JAX's ``steps.py:77-115`` does.  Those terms are
    outputs of the (recomputed) forward, so under ``remat`` they come from
    the first forward and carry their gradient once.  ``with_drop=True``
    returns ``(loss, logits, dropped)``: the mean capacity-dropped
    fraction over the MoE blocks, None for a model without them.
    """
    if fused_xent and label_smoothing > 0.0:
        raise ValueError(
            "fused_xent and label_smoothing are mutually exclusive: the Pallas "
            "fused kernel computes the unsmoothed loss, so smoothing would "
            "silently bypass it"
        )
    moe = bool(getattr(model, "has_moe", False))

    def forward(x: torch.Tensor, train: bool):
        if moe:
            return model(x, train=train, with_moe=True)
        return model(x, train=train), None

    def loss_fn(batch: Batch, train: bool = True):
        x = _as_input(batch["image"])
        if remat:
            logits, terms = remat_fn(forward, x, train,
                                     generators=[getattr(model, "generator", None)])
        else:
            logits, terms = forward(x, train)
        labels = local_labels(model, batch["label"], logits)
        if train and label_smoothing > 0.0:
            loss = _smoothed_cross_entropy(logits, labels, label_smoothing).mean()
        elif fused_xent:  # the kernels take (N, C) rows
            loss = softmax_xent_mean(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1))
        else:
            loss = cross_entropy(logits, labels).mean()
        if train and terms is not None:
            # z-losses are pre-weighted by the blocks, so they add at 1.0
            loss = loss + moe_aux_weight * terms["aux"] + terms["z"]
        if with_drop:
            return loss, logits, None if terms is None else terms["dropped"].detach()
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
    g_shards = bucket_reduce_scatter_mean(grads, lay)
    if su.clip is not None:
        gnorm = grad_norm_global(g_shards, mesh)
        scale = torch.where(gnorm < su.clip, 1.0, su.clip / gnorm.clamp_min(1e-38))
        g_shards = torch._foreach_mul(g_shards, scale)
    load_bucket_shards(optimizer.params, params, lay)  # the optimizer updates this block
    optimizer.step(g_shards)
    gather_bucket_shards(optimizer.params, params, lay)


def make_train_step(model, optimizer, label_smoothing: float = 0.0,
                    fused_xent: bool = False, remat: bool = False,
                    grad_accum: int = 1, mesh: Mesh | None = None,
                    sharded_update: ShardedUpdate | None = None, plan=None):
    """Build ``train_step(state, batch) -> metrics``; it updates
    ``state`` (parameters, optimizer, step) in place.  Metrics are device
    scalars: ``loss`` and ``accuracy`` (this rank's, under a ``mesh``).
    Dropout masks come from the model's generator, which advances with
    every step.

    ``mesh``: average the gradients across its ranks before the update,
    one all-reduce a bucket of ``make_bucket_layout``'s default count.
    ``sharded_update`` (needs ``mesh``): the ZeRO-1 update instead,
    ``optimizer`` being the sharded one.  ``plan`` (a
    ``parallel.fsdp.ShardPlan``): the sharded step of ZeRO-3 and expert
    parallelism, ``optimizer`` over the plan's masters."""
    if sharded_update is not None and mesh is None:
        raise ValueError("sharded_update needs a mesh (it is a cross-replica scheme)")
    loss_fn = make_loss_fn(model, label_smoothing, fused_xent=fused_xent, remat=remat,
                           with_drop=True)
    params = (optimizer.params if sharded_update is None and plan is None
              else list(model.parameters()))
    layout = (make_bucket_layout(params, 1)
              if mesh is not None and sharded_update is None and plan is None else None)

    def grads_of(batch: Batch):
        loss, logits, drop = loss_fn(batch, train=True)
        grads = torch.autograd.grad(loss, params)
        labels = local_labels(model, batch["label"], logits)
        accuracy = (logits.argmax(-1) == labels).float().mean()
        return loss.detach(), accuracy, drop, grads

    def grads_and_metrics(batch: Batch):
        if grad_accum == 1:
            loss, accuracy, drop, grads = grads_of(batch)
        else:
            n = batch["label"].shape[0]
            if n % grad_accum:
                raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            loss = accuracy = 0.0
            grads, drops = None, []
            for i in range(grad_accum):
                l_i, a_i, d_i, g_i = grads_of({k: v[i] for k, v in micro.items()})
                loss, accuracy = loss + l_i, accuracy + a_i
                drops.append(d_i)
                grads = list(g_i) if grads is None else torch._foreach_add(grads, g_i)
            grads = torch._foreach_div(grads, float(grad_accum))
            loss, accuracy = loss / grad_accum, accuracy / grad_accum
            # the micro-batches' mean (None for a model without MoE blocks)
            drop = None if drops[0] is None else torch.stack(drops).mean()
        return loss, accuracy, drop, grads

    def train_step(state: TrainState, batch: Batch) -> dict[str, torch.Tensor]:
        if plan is not None:
            plan.gather()  # the one transient whole copy of the fsdp leaves
        try:
            loss, accuracy, drop, grads = grads_and_metrics(batch)
        finally:
            if plan is not None:
                plan.release()
        if plan is not None:
            plan.apply(optimizer, grads)
        elif sharded_update is not None:
            _apply_sharded_update(optimizer, grads, params, sharded_update, mesh)
        else:
            if layout is not None:  # the gradient mean across ranks
                grads = unflatten_buckets(
                    grouped_all_reduce_mean(flatten_buckets(grads, layout)), layout)
            optimizer.step(grads)
        state.step += 1
        metrics = {"loss": loss, "accuracy": accuracy}
        if drop is not None:  # routing observability: MoE models only
            metrics["moe_dropped_frac"] = drop
        return metrics

    return train_step


def _stack(metrics: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Per-step metric dicts -> each metric stacked over the steps."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


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
        return _stack([train_step(state, {"image": images.index_select(0, idx),
                                          "label": labels.index_select(0, idx)})
                       for idx in perm])

    return run_epoch


def make_chunk_runner(model, optimizer, label_smoothing: float = 0.0,
                      fused_xent: bool = False, remat: bool = False, grad_accum: int = 1,
                      mesh: Mesh | None = None, sharded_update: ShardedUpdate | None = None):
    """``run_chunk(state, batches)``: ``k`` consecutive train steps over
    ``batches["image"]`` (k, B, ...) and ``batches["label"]`` (k, B, ...),
    one chunk already on the device (stream mode ships a chunk in one
    transfer); returns the per-step ``loss`` and ``accuracy`` stacked, (k,).
    Under a ``mesh`` the chunk holds this rank's rows of each batch and the
    step is the data-parallel one (``parallel.data_parallel``)."""
    train_step = make_train_step(model, optimizer, label_smoothing=label_smoothing,
                                 fused_xent=fused_xent, remat=remat,
                                 grad_accum=grad_accum, mesh=mesh,
                                 sharded_update=sharded_update)

    def run_chunk(state: TrainState, batches: Batch) -> dict[str, torch.Tensor]:
        return _stack([train_step(state, {"image": image, "label": label})
                       for image, label in zip(batches["image"], batches["label"])])

    return run_chunk


def make_eval_fn(model, batch_size: int = 2000, mesh: Mesh | None = None,
                 n_valid: int | None = None):
    """Full-dataset eval: ``eval_fn(images, labels)`` -> ``{"accuracy",
    "loss"}`` as device scalars (unsmoothed loss, plain cross-entropy),
    averaged over every scored label: examples, or token positions.

    ``n_valid``: the true number of examples when the set was zero-padded
    (``parallel.data_parallel.shard_eval_set``); rows at or past it are
    masked out of both sums.  ``mesh``: ``images`` is this data row's block
    of the padded set (data index ``d`` holds rows ``d * n_local`` on), and
    ``correct`` and the loss sum are added across ranks: the replica
    group's (every rank of this model index) when the logits cover this
    rank's token slice (sequence parallelism), the data axis's when they
    are whole on every seq and model rank."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        n = images.shape[0]
        correct = torch.zeros((), device=images.device)
        loss_sum = torch.zeros((), device=images.device)
        first = 0 if mesh is None else mesh.data_index * n  # this block's first global row
        group = None  # where the sums add up (below)
        for start in range(0, n, batch_size):
            imgs, labs = images[start:start + batch_size], labels[start:start + batch_size]
            logits = model(_as_input(imgs), train=False)
            local = local_labels(model, labs, logits)
            if mesh is not None:  # whole logits: the data axis; a token slice: its replicas
                group = mesh.data_group if local is labs else mesh.replica_group
            labs = local
            hits = (logits.argmax(-1) == labs).float()
            losses = cross_entropy(logits, labs)
            if n_valid is not None:
                rows = first + start + torch.arange(labs.shape[0], device=labs.device)
                keep = (rows < n_valid).float().view(-1, *([1] * (labs.ndim - 1)))
                hits, losses = hits * keep, losses * keep
            correct += hits.sum()
            loss_sum += losses.sum()
        if mesh is not None:
            correct, loss_sum = all_reduce_sum(torch.stack([correct, loss_sum]), group)
        per_example = labels[0].numel() if labels.ndim > 1 else 1
        examples = n if n_valid is None else n_valid
        if mesh is not None and n_valid is None:
            examples = n * mesh.size
        denom = examples * per_example  # scored positions
        return {"accuracy": correct / denom, "loss": loss_sum / denom}

    return eval_fn
