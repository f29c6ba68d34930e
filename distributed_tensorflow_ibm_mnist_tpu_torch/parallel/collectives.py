"""The port's collectives: ``torch.distributed`` over the ``data`` mesh.

The counterpart of the JAX package's ``parallel/collectives.py``.  JAX's
collectives run inside a ``shard_map`` body on a named axis and XLA fuses
them into the step; here each is a plain function on tensors, one
``torch.distributed`` call over the default process group (NCCL on
cards, gloo on the CPU: the ``data`` mesh is the whole group), and every
cross-rank exchange of the port goes through one of them:

* :func:`all_reduce_sum` / :func:`all_reduce_mean` / :func:`all_reduce_max`,
  :func:`all_gather` (tiled), :func:`reduce_scatter`,
  :func:`broadcast` (and :func:`broadcast_object` and
  :func:`all_gather_object`, for host values) and
  :func:`grad_norm_global`, on a tensor or a sequence
  of tensors (JAX's pytrees), returning new tensors;
* the gradient buckets of the data-parallel step and of the ZeRO-1 sharded
  weight update: :func:`make_bucket_layout` plans a few contiguous 1-D
  buckets over a list of tensors (largest first into the lightest bucket of
  each dtype group, whole tensors never split, each bucket zero-padded to a
  multiple of the shard count), :func:`flatten_buckets` /
  :func:`unflatten_buckets` move between the two forms,
  :func:`grouped_all_reduce_mean` and :func:`grouped_reduce_scatter_mean`
  reduce whole buckets (sum, then divide by the rank count, as
  ``psum_scatter / n`` does), :func:`bucket_shard` is this rank's block;
  the ZeRO-1 update's three moves over them,
  :func:`bucket_reduce_scatter_mean`, :func:`load_bucket_shards` and
  :func:`gather_bucket_shards`, serve plain dp's sharded update and the
  ZeRO-1 leaves of a ZeRO-3 run alike.

* the ZeRO-3 pair along a chosen dim of a leaf (``parallel/fsdp.py``):
  :func:`all_gather_dim` (every rank's block concatenated along ``dim``)
  and :func:`reduce_scatter_dim` (sum, then this rank's block along
  ``dim``), each the dim-0 collective on the leaf with that dim moved to
  the front;
* :func:`all_to_all` (JAX's tiled ``all_to_all(x, axis, split_axis,
  concat_axis)``, the expert-parallel dispatch's exchange) over
  ``all_to_all_single``, differentiable: its backward is the reverse
  all-to-all, as JAX transposes it.

A mean is a sum divided by the rank count: gloo has no ``AVG``.  gloo
takes CUDA tensors too (several ranks sharing one card).
:func:`all_reduce_mean` is differentiable on a tensor that requires grad
(the expert-parallel routing fractions): its backward is the mean of the
incoming gradients across ranks, the transpose under the port's
convention that every rank differentiates its own loss and the
gradients are averaged afterwards.  The ring's neighbour exchange is not
here yet (ROADMAP.md queue 1, item 7.2).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Callable

import torch
import torch.distributed as dist

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh

Tensors = torch.Tensor | Sequence[torch.Tensor]

# the single-tensor forms under their newer names where PyTorch has them
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
_all_gather_into = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _map(fn: Callable[[torch.Tensor], torch.Tensor], x: Tensors):
    return fn(x) if isinstance(x, torch.Tensor) else [fn(t) for t in x]


def axis_size() -> int:
    """Ranks along the data axis."""
    return dist.get_world_size()


def axis_index() -> int:
    """This rank's position along the data axis."""
    return dist.get_rank()


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op)
    return y


def all_reduce_sum(x: Tensors):
    """Sum across ranks: the NCCL all-reduce of the source system."""
    return _map(lambda t: _all_reduce(t, dist.ReduceOp.SUM), x)


def _mean(t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(t.detach(), dist.ReduceOp.SUM).div_(axis_size())


class _AllReduceMean(torch.autograd.Function):
    """The cross-rank mean, differentiable: the backward is the mean of
    the incoming gradients (module docstring)."""

    @staticmethod
    def forward(ctx, t):
        return _mean(t)

    @staticmethod
    def backward(ctx, g):
        return _mean(g)


def all_reduce_mean(x: Tensors):
    """Mean across ranks: the sum divided by the rank count
    (differentiable where the input requires grad)."""
    return _map(lambda t: _AllReduceMean.apply(t) if t.requires_grad else _mean(t), x)


def all_reduce_max(x: Tensors):
    """Elementwise max across ranks."""
    return _map(lambda t: _all_reduce(t, dist.ReduceOp.MAX), x)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (tiled: that dim grows
    by the rank count)."""
    x = x.contiguous()
    out = x.new_empty((axis_size() * x.shape[0], *x.shape[1:]))
    _all_gather_into(out, x)
    return out


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """Sum across ranks, then keep this rank's 1/N block of dim 0 (the
    ZeRO gradient primitive: ``psum`` then this shard's slice)."""
    n = axis_size()
    x = x.contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not divide over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _reduce_scatter_into(out, x)
    return out


def all_gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    whole leaf from its blocks (ZeRO-3's parameter gather)."""
    if dim == 0:
        return all_gather(x)
    return all_gather(x.movedim(dim, 0)).movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum across ranks, then this rank's 1/N block along ``dim``
    (ZeRO-3's gradient reduction)."""
    if dim == 0:
        return reduce_scatter(x)
    return reduce_scatter(x.movedim(dim, 0)).movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
    a = axis_size()
    moved = x.movedim(split_axis, 0).contiguous()
    s = moved.shape[0]
    if s % a:
        raise ValueError(f"split axis of size {s} does not divide over {a} ranks")
    out = torch.empty_like(moved)
    dist.all_to_all_single(out, moved)  # block j of dim 0 to rank j
    # (a, s/a, ...): the block from each source rank, in rank order, back
    # in x's axis order, then laid side by side along concat_axis
    out = out.view(a, s // a, *moved.shape[1:]).movedim(1, split_axis + 1)
    out = out.movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [a * shape[concat_axis + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis: int, concat_axis: int):
        ctx.axes = (split_axis, concat_axis)
        return _all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, concat_axis, split_axis), None, None


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into N blocks along
    ``split_axis``, block j sent to rank j, and the N blocks this rank
    receives concatenated along ``concat_axis`` in source-rank order (so
    ``split_axis`` shrinks N-fold and ``concat_axis`` grows N-fold).
    Differentiable; the backward is the reverse exchange."""
    return _AllToAll.apply(x, split_axis, concat_axis)


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every rank receives rank ``root``'s ``x``."""
    y = x.clone()
    dist.broadcast(y, src=root)
    return y


def broadcast_object(obj, root: int = 0):
    """Rank ``root``'s picklable ``obj``, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * axis_size()
    dist.all_gather_object(out, obj)
    return out


def grad_norm_global(grads: Sequence[torch.Tensor], mesh: Mesh | None = None) -> torch.Tensor:
    """L2 norm over a list of tensors in float32; with ``mesh`` (JAX's
    ``axis_name``), the true norm over every rank's tensors (sum of
    squares all-reduced before the square root), for gradients that are
    sharded across ranks."""
    sq = sum(g.float().square().sum() for g in grads)
    if mesh is None:
        return sq.sqrt()
    return all_reduce_sum(sq).sqrt()


# ---------------------------------------------------------------------------
# Gradient buckets (the data-parallel step's all-reduce and the ZeRO-1
# sharded weight update).  A list of tensors flattens into a few contiguous
# 1-D buckets, so a step pays each collective's latency a handful of times,
# not once per bias vector; each bucket is padded to a multiple of the
# shard count so every rank owns an equal contiguous block.  The layout is
# built once from the parameters.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    """Where one tensor lives: ``bucket[offset : offset + size]``."""

    bucket: int
    offset: int
    size: int
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Flatten plan: one slot per tensor, the padded bucket sizes (each a
    multiple of ``n_shards``).  Buckets are single-dtype (one bucket group
    per dtype) and size-balanced greedily."""

    slots: tuple[_LeafSlot, ...]
    bucket_sizes: tuple[int, ...]
    n_shards: int

    @property
    def shard_sizes(self) -> tuple[int, ...]:
        return tuple(s // self.n_shards for s in self.bucket_sizes)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)


@dataclasses.dataclass(frozen=True)
class ShardedUpdate:
    """What the ZeRO-1 step needs: the bucket ``layout`` over the
    parameters and the run's global-norm ``clip`` (or None), applied by the
    step against the true cross-rank norm (``core.optim``'s sharded
    optimizer carries no clip of its own)."""

    layout: BucketLayout
    clip: float | None = None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")  # numpy's names: JAX's group order


def make_bucket_layout(tensors: Sequence[torch.Tensor], n_shards: int,
                       n_buckets: int = 4) -> BucketLayout:
    """Plan a size-balanced bucketing of ``tensors`` (in their order).

    Per dtype group (groups in the order of their names), tensors largest
    first (ties in list order) each go to the currently lightest bucket of
    their group, at most ``n_buckets`` buckets a group; each bucket is
    zero-padded up to a multiple of ``n_shards``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    slots: dict[int, _LeafSlot] = {}
    bucket_sizes: list[int] = []
    for dtype in sorted(by_dtype, key=_dtype_name):
        idxs = by_dtype[dtype]
        k = min(n_buckets, len(idxs))
        base = len(bucket_sizes)
        fill = [0] * k
        for i in sorted(idxs, key=lambda i: (-tensors[i].numel(), i)):
            b = min(range(k), key=lambda j: fill[j])
            size = tensors[i].numel()
            slots[i] = _LeafSlot(bucket=base + b, offset=fill[b], size=size,
                                 shape=tuple(tensors[i].shape), dtype=dtype)
            fill[b] += size
        bucket_sizes += [-(-f // n_shards) * n_shards for f in fill]
    return BucketLayout(slots=tuple(slots[i] for i in range(len(tensors))),
                        bucket_sizes=tuple(bucket_sizes), n_shards=n_shards)


def flatten_buckets(tensors: Sequence[torch.Tensor],
                    layout: BucketLayout) -> tuple[torch.Tensor, ...]:
    """Tensors -> the padded 1-D buckets of ``layout`` (new storage)."""
    pieces: list[list[tuple[int, torch.Tensor]]] = [[] for _ in layout.bucket_sizes]
    for slot, t in zip(layout.slots, tensors, strict=True):
        pieces[slot.bucket].append((slot.offset, t.detach().reshape(-1).to(slot.dtype)))
    out = []
    for b, sized in enumerate(layout.bucket_sizes):
        parts = [p for _, p in sorted(pieces[b], key=lambda op: op[0])]
        used = sum(p.numel() for p in parts)
        if used < sized:
            parts.append(parts[0].new_zeros(sized - used))
        out.append(torch.cat(parts))
    return tuple(out)


def unflatten_buckets(buckets: Sequence[torch.Tensor],
                      layout: BucketLayout) -> list[torch.Tensor]:
    """The inverse of :func:`flatten_buckets` as views into ``buckets``
    (padding dropped)."""
    return [buckets[s.bucket][s.offset:s.offset + s.size].view(s.shape)
            for s in layout.slots]


def grouped_all_reduce_mean(buckets: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Mean every bucket across ranks, in place (sum, then divide by the
    rank count): the data-parallel step's gradient all-reduce, one
    collective a bucket."""
    n = axis_size()
    for b in buckets:
        dist.all_reduce(b)
        b.div_(n)
    return buckets


def grouped_reduce_scatter_mean(buckets: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """Mean-reduce-scatter every bucket: ``(B,)`` -> this rank's
    ``(B / N,)`` block of the mean."""
    n = axis_size()
    return tuple(reduce_scatter(b).div_(n) for b in buckets)


def bucket_shard(buckets: Sequence[torch.Tensor],
                 layout: BucketLayout) -> tuple[torch.Tensor, ...]:
    """This rank's contiguous block of each full bucket (views; no
    communication)."""
    idx = axis_index()
    return tuple(b[idx * sz:(idx + 1) * sz] for b, sz in zip(buckets, layout.shard_sizes))


# The ZeRO-1 update's bucket moves, shared by plain dp's sharded update
# (``core/steps.py``) and by the ZeRO-1 leaves of a ZeRO-3 run
# (``parallel/fsdp.py``): reduce-scatter the gradients bucket by bucket,
# load this rank's block of the parameters into the optimizer's shards,
# and after the update gather the buckets back into the parameters.


def bucket_reduce_scatter_mean(tensors: Sequence[torch.Tensor],
                               layout: BucketLayout) -> tuple[torch.Tensor, ...]:
    """``tensors`` -> this rank's block of each bucket of their mean across
    ranks (one reduce-scatter a bucket)."""
    return grouped_reduce_scatter_mean(flatten_buckets(tensors, layout))


@torch.no_grad()
def load_bucket_shards(shards: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
                       layout: BucketLayout) -> None:
    """Copy this rank's block of each bucket of ``tensors`` into ``shards``
    (no communication)."""
    for dst, src in zip(shards, bucket_shard(flatten_buckets(tensors, layout), layout),
                        strict=True):
        dst.copy_(src)


@torch.no_grad()
def gather_bucket_shards(shards: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
                         layout: BucketLayout) -> None:
    """All-gather each bucket from every rank's block in ``shards`` and write
    it back into ``tensors`` in place (one all-gather a bucket)."""
    full = [all_gather(s) for s in shards]
    for t, new in zip(tensors, unflatten_buckets(full, layout), strict=True):
        t.copy_(new)
