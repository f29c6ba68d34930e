"""Train/eval steps and the epoch runner of the port.

The counterparts of the JAX package's ``core/steps.py``:

* ``make_loss_fn`` routes the loss as ``steps.py:101-110`` does: label
  smoothing (train only) through a soft-target cross-entropy, else the
  fused K1/K2 kernels (``ops/xent.py``) under ``fused_xent``, else the plain
  integer-label cross-entropy; eval always reports the unsmoothed loss;
* ``make_train_step`` — forward, backward (autograd) and the optimizer
  update, in place; ``grad_accum > 1`` averages the gradients of that many
  microbatches before the one update;
* ``make_epoch_runner`` — one epoch over the device-resident uint8 dataset:
  a permutation drawn on the device, each minibatch gathered there with
  ``index_select``; per-step metrics stay on the device as tensors;
* ``make_eval_fn`` — batched full-test-set accuracy and unsmoothed loss,
  summed on the device, off the fused kernels as in JAX (``:355``, ``:393``).

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

Batch = dict[str, torch.Tensor]


def _as_input(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]; other dtypes pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example integer-label cross-entropy, (N,) float32: the port's
    form of ``optax.softmax_cross_entropy_with_integer_labels``."""
    x = logits.float()
    return torch.logsumexp(x, -1) - x.gather(1, labels.long()[:, None])[:, 0]


def _smoothed_cross_entropy(logits, labels, smoothing: float) -> torch.Tensor:
    """``optax.softmax_cross_entropy`` against ``optax.smooth_labels``."""
    n_cls = logits.shape[-1]
    targets = F.one_hot(labels.long(), n_cls).float() * (1.0 - smoothing) + smoothing / n_cls
    return -(targets * torch.log_softmax(logits.float(), -1)).sum(-1)


def make_loss_fn(model, label_smoothing: float = 0.0, fused_xent: bool = False,
                 remat: bool = False) -> Callable:
    """Cross-entropy loss closure over the port's model.

    Returns ``loss_fn(batch, train) -> (loss, logits)``; the batch's
    ``image`` is uint8 or float NHWC, its ``label`` int.  ``label_smoothing``
    applies to the training loss only.
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
        elif fused_xent:
            loss = softmax_xent_mean(logits, labels)
        else:
            loss = cross_entropy(logits, labels).mean()
        return loss, logits

    return loss_fn


def make_train_step(model, optimizer, label_smoothing: float = 0.0,
                    fused_xent: bool = False, remat: bool = False,
                    grad_accum: int = 1):
    """Build ``train_step(state, batch) -> metrics``; it updates
    ``state`` (parameters, optimizer, step) in place.  Metrics are device
    scalars: ``loss`` and ``accuracy``.  Dropout masks come from the model's
    generator, which advances with every step."""
    loss_fn = make_loss_fn(model, label_smoothing, fused_xent=fused_xent, remat=remat)
    params = optimizer.params

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
        optimizer.step(grads)
        state.step += 1
        return {"loss": loss, "accuracy": accuracy}

    return train_step


def make_epoch_runner(model, optimizer, batch_size: int, label_smoothing: float = 0.0,
                      fused_xent: bool = False, remat: bool = False, grad_accum: int = 1):
    """One full epoch over a device-resident dataset.

    ``run_epoch(state, images, labels, perm=None)`` runs ``n // batch_size``
    steps and returns per-step metrics stacked on the device, ``loss`` and
    ``accuracy`` of shape (steps,).  With ``perm=None`` it draws
    ``torch.randperm(n)`` from ``state.data_generator`` on the data's
    device; a given ``perm`` (indices, at least ``steps * batch_size``) is
    used as it is.
    """
    train_step = make_train_step(model, optimizer, label_smoothing=label_smoothing,
                                 fused_xent=fused_xent, remat=remat,
                                 grad_accum=grad_accum)

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


def make_eval_fn(model, batch_size: int = 2000):
    """Full-dataset eval: ``eval_fn(images, labels)`` -> ``{"accuracy",
    "loss"}`` as device scalars (unsmoothed loss, plain cross-entropy)."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        n = images.shape[0]
        correct = torch.zeros((), device=images.device)
        loss_sum = torch.zeros((), device=images.device)
        for start in range(0, n, batch_size):
            imgs, labs = images[start:start + batch_size], labels[start:start + batch_size]
            logits = model(_as_input(imgs), train=False)
            correct += (logits.argmax(-1) == labs).sum()
            loss_sum += cross_entropy(logits, labs).sum()
        return {"accuracy": correct / n, "loss": loss_sum / n}

    return eval_fn
