"""The port's collectives: ``torch.distributed`` over the mesh's axes.

The counterpart of the JAX package's ``parallel/collectives.py``.  JAX's
collectives run inside a ``shard_map`` body on a named axis and XLA fuses
them into the step; here each is a plain function on tensors, one
``torch.distributed`` call over a process group (NCCL on cards, gloo on
the CPU), and every cross-rank exchange of the port goes through one of
them.  JAX's ``axis_name`` is the ``group`` argument: None is the default
(whole) group, which is the ``data`` axis at sp = 1 and the ``dp * sp``
ranks whose gradients a step averages; ``mesh.seq_group`` /
``mesh.data_group`` (``parallel/mesh.py``) are the axes of a 2-D mesh:

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
* :func:`gather_tokens`, the seq group's tokens gathered along a dim,
  differentiable (its backward the reduce-scatter of the sum);
* :func:`all_to_all` (JAX's tiled ``all_to_all(x, axis, split_axis,
  concat_axis)``, the expert-parallel dispatch's exchange and Ulysses'
  two reshards over the seq group) over ``all_to_all_single``,
  differentiable: its backward is the reverse all-to-all, as JAX
  transposes it;
* :func:`ring_shift` (JAX's ``ring_shift``, ``lax.ppermute(x, axis, [(i,
  (i + shift) % n)])``): the ring attention's neighbour exchange, every
  rank sending to the rank ``shift`` places on and receiving from the one
  ``shift`` places back in one ``dist.batch_isend_irecv``, so no pair of
  blocking sends can deadlock.  gloo's point-to-point takes host memory
  only, so under gloo a CUDA tensor is staged through pinned host buffers
  (``ring_shift.host_staged`` counts those hops); NCCL sends device
  memory.  Differentiable: the backward shifts the gradient back.
* the pipeline's two exchanges over the mesh's ``pipe`` group
  (``parallel/pipeline.py``): :func:`stage_hop`, one point-to-point
  hand-off between neighbouring stages (a send, a receive, or both, in one
  ``batch_isend_irecv``, host-staged under gloo as the ring's hop is), and
  :func:`broadcast_from_root`, the last stage's output on every stage,
  whose backward hands the root its own cotangent once (not the sum over
  the group).

* Megatron's four mappings over the mesh's ``model`` group (tensor
  parallelism; each the identity at tp = 1, each a
  ``torch.autograd.Function``): :func:`copy_to_model` (forward identity,
  backward all-reduce: the entry of a column-parallel region, whose
  replicated input each rank uses with its own block of the weight),
  :func:`reduce_from_model` (forward all-reduce of the partial sums of a
  row-parallel product, backward identity), :func:`scatter_to_model`
  (forward this rank's slice of a dim, backward all-gather) and
  :func:`gather_from_model` (forward all-gather of a dim, backward this
  rank's slice).  The backward of a gather is a slice, not a
  reduce-scatter: every rank of a replicated region already holds the
  whole gradient, so a sum over the group would multiply it by tp.

A mean is a sum divided by the rank count: gloo has no ``AVG``.  gloo
takes CUDA tensors too (several ranks sharing one card).
:func:`all_reduce_mean` is differentiable on a tensor that requires grad
(the expert-parallel routing fractions): its backward is the mean of the
incoming gradients across ranks, the transpose under the port's
convention that every rank differentiates its own loss and the
gradients are averaged afterwards; :func:`all_reduce_sum` is likewise
differentiable, its backward the sum (the ViT's token pool across the
seq group).
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


def axis_size(group=None) -> int:
    """Ranks along the axis of ``group`` (the whole group when None)."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's position along the axis of ``group``."""
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _sum(t: torch.Tensor, group=None) -> torch.Tensor:
    return _all_reduce(t.detach(), dist.ReduceOp.SUM, group)


class _AllReduceSum(torch.autograd.Function):
    """The cross-rank sum, differentiable: the backward is the sum of the
    incoming gradients (every rank's loss reads every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce_sum(x: Tensors, group=None):
    """Sum across ranks: the NCCL all-reduce of the source system
    (differentiable where the input requires grad)."""
    return _map(lambda t: _AllReduceSum.apply(t, group) if t.requires_grad
                else _sum(t, group), x)


def _mean(t: torch.Tensor, group=None) -> torch.Tensor:
    return _sum(t, group).div_(axis_size(group))


class _AllReduceMean(torch.autograd.Function):
    """The cross-rank mean, differentiable: the backward is the mean of
    the incoming gradients (module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _mean(t, group)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group), None


def all_reduce_mean(x: Tensors, group=None):
    """Mean across ranks: the sum divided by the rank count
    (differentiable where the input requires grad)."""
    return _map(lambda t: _AllReduceMean.apply(t, group) if t.requires_grad
                else _mean(t, group), x)


def all_reduce_max(x: Tensors, group=None):
    """Elementwise max across ranks."""
    return _map(lambda t: _all_reduce(t, dist.ReduceOp.MAX, group), x)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (tiled: that dim grows
    by the rank count)."""
    x = x.contiguous()
    out = x.new_empty((axis_size(group) * x.shape[0], *x.shape[1:]))
    _all_gather_into(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum across ranks, then keep this rank's 1/N block of dim 0 (the
    ZeRO gradient primitive: ``psum`` then this shard's slice)."""
    n = axis_size(group)
    x = x.contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not divide over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _reduce_scatter_into(out, x, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    whole leaf from its blocks (ZeRO-3's parameter gather)."""
    if dim == 0:
        return all_gather(x, group)
    return all_gather(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Sum across ranks, then this rank's 1/N block along ``dim``
    (ZeRO-3's gradient reduction)."""
    if dim == 0:
        return reduce_scatter(x, group)
    return reduce_scatter(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def gather_tokens(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather_dim` over ``group``, differentiable, its backward
    the reduce-scatter of the sum: every rank then computes on every
    rank's slice (the MoE blocks' routing over a whole sequence whose
    tokens the seq group holds in slices), and each slice's gradient sums
    what every rank's loss sends it."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_gather_dim(x.contiguous(), dim, group)
    return _GatherTokens.apply(x, dim % x.ndim, group)


def _all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
                group=None) -> torch.Tensor:
    a = axis_size(group)
    moved = x.movedim(split_axis, 0).contiguous()
    s = moved.shape[0]
    if s % a:
        raise ValueError(f"split axis of size {s} does not divide over {a} ranks")
    out = torch.empty_like(moved)
    dist.all_to_all_single(out, moved, group=group)  # block j of dim 0 to rank j
    # (a, s/a, ...): the block from each source rank, in rank order, back
    # in x's axis order, then laid side by side along concat_axis
    out = out.view(a, s // a, *moved.shape[1:]).movedim(1, split_axis + 1)
    out = out.movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [a * shape[concat_axis + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis: int, concat_axis: int, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, concat_axis, split_axis, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group=None) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into N blocks along
    ``split_axis``, block j sent to rank j, and the N blocks this rank
    receives concatenated along ``concat_axis`` in source-rank order (so
    ``split_axis`` shrinks N-fold and ``concat_axis`` grows N-fold).
    Differentiable; the backward is the reverse exchange."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _global(group, place: int) -> int:
    """The global rank at ``place`` along ``group`` (None: the default group)."""
    return dist.get_global_rank(group, place) if group is not None else place


def _exchange(sends: Sequence[tuple[torch.Tensor, int]],
              recvs: Sequence[tuple[torch.Tensor, int]], group) -> tuple[list, bool]:
    """Point-to-point sends ``(tensor, global rank)`` and receives ``(tensor
    to mimic, global rank)`` in one ``batch_isend_irecv``: the received
    tensors (new, on the mimicked tensors' devices) and whether gloo staged
    CUDA tensors through pinned host buffers (its point-to-point reads host
    memory only)."""
    staged = (any(t.is_cuda for t, _ in (*sends, *recvs))
              and dist.get_backend(group) == "gloo")
    out_s, out_r = [], []
    for x, _ in sends:
        x = x.contiguous()
        out_s.append(x.to("cpu", non_blocking=False).pin_memory() if staged else x)
    for like, _ in recvs:
        out_r.append(torch.empty(like.shape, dtype=like.dtype,
                                 device="cpu" if staged else like.device, pin_memory=staged))
    ops = ([dist.P2POp(dist.isend, t, to, group) for t, (_, to) in zip(out_s, sends)]
           + [dist.P2POp(dist.irecv, t, frm, group) for t, (_, frm) in zip(out_r, recvs)])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        out_r = [r.to(like.device) for r, (like, _) in zip(out_r, recvs)]
    return out_r, staged


def _shift(xs: Sequence[torch.Tensor], shift: int, group) -> list[torch.Tensor]:
    """Each of ``xs`` from this rank to the rank ``shift`` places on along
    ``group``, and from the rank ``shift`` places back into new tensors:
    every send and receive of the call in one ``batch_isend_irecv``."""
    n, me = axis_size(group), axis_index(group)
    if n == 1 or shift % n == 0:
        return [x.clone() for x in xs]
    to, frm = _global(group, (me + shift) % n), _global(group, (me - shift) % n)
    out, staged = _exchange([(x, to) for x in xs], [(x, frm) for x in xs], group)
    if staged:
        ring_shift.host_staged += 1
    return out


def stage_hop(send: torch.Tensor | None, to: int | None, like: torch.Tensor | None,
              frm: int | None, group) -> torch.Tensor | None:
    """One hand-off between pipeline stages (the pipeline's point-to-point
    hop, ``parallel/pipeline.py``): ``send`` to the rank at place ``to``
    along ``group`` and, from the rank at place ``frm``, a new tensor shaped
    as ``like``, in one ``batch_isend_irecv``; a None half is not made, and
    the call returns the received tensor or None.  Under gloo a CUDA tensor
    goes through pinned host memory (``stage_hop.host_staged`` counts such
    calls, ``stage_hop.bytes`` the bytes sent)."""
    sends = [] if send is None else [(send, _global(group, to))]
    recvs = [] if like is None else [(like, _global(group, frm))]
    if not sends and not recvs:
        return None
    out, staged = _exchange(sends, recvs, group)
    stage_hop.host_staged += int(staged)
    stage_hop.bytes += 0 if send is None else send.numel() * send.element_size()
    return out[0] if out else None


stage_hop.host_staged = 0  # hops staged through pinned host buffers (gloo, CUDA)
stage_hop.bytes = 0  # bytes the hops sent


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shift: int, group, *xs):
        ctx.shift, ctx.group = shift, group
        return tuple(_shift(xs, shift, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_shift([g.contiguous() for g in gs], -ctx.shift, ctx.group))


def ring_shift(x: Tensors, group=None, shift: int = 1):
    """Pass ``x`` (a tensor or a sequence of them) to the neighbour
    ``shift`` places up the ring of ``group``: rank i's value lands on rank
    ``(i + shift) % n`` and rank i receives rank ``(i - shift) % n``'s
    (JAX's ``ring_shift``).  Differentiable where an input requires grad:
    the gradient rides back ``-shift`` places."""
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = list(_RingShift.apply(shift, group, *xs))
    else:
        out = _shift(xs, shift, group)
    return out[0] if isinstance(x, torch.Tensor) else out


ring_shift.host_staged = 0  # hops staged through pinned host buffers (gloo, CUDA)


# ---------------------------------------------------------------------------
# Megatron's mappings over the model axis (tensor parallelism).  A model
# rank holds its block of every split leaf and the whole of every other
# activation; these four move activations between the two forms.  Each
# takes the mesh (None, or a model axis of one rank: the identity).
# ---------------------------------------------------------------------------


def _model_axis(mesh: Mesh | None):
    """``(group, size, index)`` of the mesh's model axis, or None when it has
    one rank (or there is no mesh)."""
    if mesh is None or mesh.model_size == 1:
        return None
    return mesh.model_group, mesh.model_size, mesh.model_index


def _slice(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {n} model ranks")
    return x.chunk(n, dim)[i].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, n, i)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim % g.ndim, ctx.group), None, None, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.n, ctx.i = dim, n, i
        return all_gather_dim(x.contiguous(), dim % x.ndim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.n, ctx.i), None, None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Forward the identity, backward the sum of the gradients over the
    model group: where a replicated activation enters a column-parallel
    region (each rank's gradient holds only its block's share)."""
    axis = _model_axis(mesh)
    return x if axis is None else _CopyToModel.apply(x, axis[0])


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Forward the sum over the model group (a row-parallel product's
    partial sums made whole), backward the identity."""
    axis = _model_axis(mesh)
    if axis is None:
        return x
    return _ReduceFromModel.apply(x, axis[0]) if x.requires_grad else _sum(x, axis[0])


def scatter_to_model(x: torch.Tensor, dim: int, mesh: Mesh | None) -> torch.Tensor:
    """Forward this model rank's 1/tp slice of ``dim`` (the input of a
    row-parallel product), backward the all-gather of the gradients."""
    axis = _model_axis(mesh)
    return x if axis is None else _ScatterToModel.apply(x, dim, *axis)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh | None) -> torch.Tensor:
    """Forward every model rank's block concatenated along ``dim`` (the
    output of a column-parallel product made whole), backward this rank's
    slice of the gradient."""
    axis = _model_axis(mesh)
    return x if axis is None else _GatherFromModel.apply(x, dim, *axis)


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """Every rank receives the ``x`` of rank ``root`` of ``group``."""
    y = x.clone()
    dist.broadcast(y, src=root if group is None else dist.get_global_rank(group, root),
                   group=group)
    return y


class _BroadcastFromRoot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, root, group):
        ctx.root, ctx.group = root, group
        return broadcast(x, root, group)

    @staticmethod
    def backward(ctx, g):
        return (g if axis_index(ctx.group) == ctx.root else torch.zeros_like(g)), None, None


def broadcast_from_root(x: torch.Tensor, root: int, group) -> torch.Tensor:
    """:func:`broadcast` (``x`` of the rank at place ``root`` of ``group``
    on every rank), differentiable: every rank's loss reads the same value,
    so every rank's cotangent is the same, and the backward hands the root
    its own copy, once (zeros elsewhere): a sum over the group would count
    it ``n`` times.  The pipeline's output leaves its last stage this way
    (JAX's ``broadcast``, a psum of the root-masked value, whose transpose
    the port would otherwise inherit as that sum)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return broadcast(x, root, group)
    return _BroadcastFromRoot.apply(x, root, group)


def broadcast_object(obj, root: int = 0):
    """Rank ``root``'s picklable ``obj``, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out = [None] * axis_size(group)
    dist.all_gather_object(out, obj, group=group)
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


def grouped_all_reduce_mean(buckets: Sequence[torch.Tensor],
                            group=None) -> Sequence[torch.Tensor]:
    """Mean every bucket across the ranks of ``group`` (every rank when
    None), in place (sum, then divide by the rank count): the
    data-parallel step's gradient all-reduce, one collective a bucket."""
    n = axis_size(group)
    for b in buckets:
        dist.all_reduce(b, group=group)
        b.div_(n)
    return buckets


def grouped_reduce_scatter_mean(buckets: Sequence[torch.Tensor],
                                group=None) -> tuple[torch.Tensor, ...]:
    """Mean-reduce-scatter every bucket over ``group``: ``(B,)`` -> this
    rank's ``(B / N,)`` block of the mean."""
    n = axis_size(group)
    return tuple(reduce_scatter(b, group).div_(n) for b in buckets)


def bucket_shard(buckets: Sequence[torch.Tensor], layout: BucketLayout,
                 group=None) -> tuple[torch.Tensor, ...]:
    """This rank's contiguous block (its place along ``group``) of each
    full bucket (views; no communication)."""
    idx = axis_index(group)
    return tuple(b[idx * sz:(idx + 1) * sz] for b, sz in zip(buckets, layout.shard_sizes))


# The ZeRO-1 update's bucket moves, shared by plain dp's sharded update
# (``core/steps.py``) and by the ZeRO-1 leaves of a ZeRO-3 run
# (``parallel/fsdp.py``): reduce-scatter the gradients bucket by bucket,
# load this rank's block of the parameters into the optimizer's shards,
# and after the update gather the buckets back into the parameters.


def bucket_reduce_scatter_mean(tensors: Sequence[torch.Tensor], layout: BucketLayout,
                               group=None) -> tuple[torch.Tensor, ...]:
    """``tensors`` -> this rank's block of each bucket of their mean across
    the ranks of ``group`` (one reduce-scatter a bucket)."""
    return grouped_reduce_scatter_mean(flatten_buckets(tensors, layout), group)


@torch.no_grad()
def load_bucket_shards(shards: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
                       layout: BucketLayout, group=None) -> None:
    """Copy this rank's block of each bucket of ``tensors`` into ``shards``
    (no communication)."""
    for dst, src in zip(shards, bucket_shard(flatten_buckets(tensors, layout), layout, group),
                        strict=True):
        dst.copy_(src)


@torch.no_grad()
def gather_bucket_shards(shards: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor],
                         layout: BucketLayout, group=None) -> None:
    """All-gather each bucket over ``group`` from every rank's block in
    ``shards`` and write it back into ``tensors`` in place (one all-gather
    a bucket)."""
    full = [all_gather(s, group) for s in shards]
    for t, new in zip(tensors, unflatten_buckets(full, layout), strict=True):
        t.copy_(new)
