"""Fully-sharded data parallelism (ZeRO-3) of the port over the ``data`` mesh.

The counterpart of the JAX package's ``parallel/fsdp.py``: each parameter,
and so each optimizer moment, is split along its largest divisible dim
over the same ``data`` axis that splits the batch, so the memory for
weights, gradients and moments drops from 4P words a device to 4P/N (plus
one transient gathered copy).  :func:`fsdp_rule`, :func:`make_fsdp_specs`
and :func:`make_fsdp_opt_specs` decide the layout as JAX's do, on the
flax paths and shapes (``parallel/tensor_parallel.py``), so each leaf is
split along the dim JAX picks for it, not always dim 0.

JAX jits the unchanged step under these shardings and lets XLA derive the
gathers and reduce-scatters.  The port runs eagerly, one rank a process,
so the choreography is written out in :class:`ShardPlan`, over the
port's own collectives:

* each rank keeps its block of every sharded leaf (the ``master``); the
  module's parameter of such a leaf is released between steps;
* a step gathers the whole parameter set once into the module's
  parameters (one transient copy), runs the unchanged loss and backward
  (``core.steps.make_train_step``), releases the gathered copy, then
  mean-reduce-scatters each sharded leaf's gradient along its dim and
  all-reduces the mean of the replicated leaves' (``min_size`` keeps
  small leaves whole), one bucketed collective;
* the global-norm clip counts each sharded leaf once, as the sum of its
  blocks' squares across ranks, and each replicated leaf once;
* the optimizer (``core.optim``, elementwise) updates this rank's blocks.

With ``sharded_update`` (:func:`make_fsdp_opt_specs`) the moments of the
leaves ``min_size`` keeps replicated are held at 1/N too.  JAX's opt-spec
upgrade picks these leaves (those ``fsdp_rule(min_size=1)`` splits); the
port updates them as plain dp's ZeRO-1 updates its leaves, with the same
bucket moves (``collectives.bucket_reduce_scatter_mean``,
``load_bucket_shards``, ``gather_bucket_shards``): their gradients are
reduce-scattered a few buckets at a time, this rank's block of each
bucket updated, and the buckets all-gathered back into the whole
parameters.  The save form is whole, so JAX's per-leaf layout of these
moments and the port's buckets read each other's checkpoints.
Expert parallelism (``parallel/expert_parallel.py``) puts its expert
leaves in the same plan: each rank owns E/N expert rows for good, their
gradients already sum every rank's tokens through the all-to-all's
backward, so they take the mean's 1/N and no collective.

The whole-leaf form (:meth:`ShardPlan.whole`, :meth:`ShardPlan.load_whole`)
is what checkpoints, eval of other layouts and decode read: every leaf
and moment gathered whole, the replicated form, which resumes at any dp.

Beside tp and sp the plan splits over each rank's data group (the ranks
that differ from it in the data index only), every collective above
over that group: under tp its leaves are the model rank's
``TPPlan`` blocks (``make_fsdp_specs(base_rule=megatron_rule(tp))``'s
``P("data", "model")`` leaf is the model block cut again along its data
dim), the whole form gathers over the data group and then over the model
group (so an fsdp x tp checkpoint resumes at tp alone or at fsdp alone),
and the clip counts every element once across both; under sp the seq
ranks of a data row hold the same blocks and average their gradients
over the seq group first (:class:`ShardPlan`).
"""

from __future__ import annotations

import contextlib
import copy
from collections.abc import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import make_train_step
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_gather,
    all_gather_dim,
    all_reduce_mean,
    all_reduce_sum,
    bucket_reduce_scatter_mean,
    bucket_shard,
    flatten_buckets,
    gather_bucket_shards,
    grouped_all_reduce_mean,
    load_bucket_shards,
    make_bucket_layout,
    reduce_scatter_dim,
    unflatten_buckets,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import (
    P,
    SpecRule,
    make_param_specs,
    model_param_specs,
    shard_dim,
)

REPLICATED, FSDP, ZERO1, EXPERT = "replicated", "fsdp", "zero1", "expert"


def fsdp_rule(n_shards: int, axis: str = "data", min_size: int = 1024,
              base_rule: SpecRule | None = None) -> SpecRule:
    """Spec rule splitting each leaf's largest divisible dim over ``axis``
    (ties to the earliest dim); leaves under ``min_size`` elements stay
    replicated.  With ``base_rule`` its non-replicated answer is kept and
    the largest remaining free divisible dim is split as well."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")

    def rule(path: tuple[str, ...], leaf) -> P:
        spec = None
        if base_rule is not None:
            base = base_rule(path, leaf)
            if base != P():
                spec = list(base) + [None] * (getattr(leaf, "ndim", 0) - len(base))
        ndim = getattr(leaf, "ndim", 0)
        shape = getattr(leaf, "shape", ())
        if ndim == 0 or int(getattr(leaf, "size", 0)) < min_size:
            return P(*spec) if spec else P()
        if spec is None:
            spec = [None] * ndim
        free = [i for i in range(ndim) if spec[i] is None]
        if not free:
            return P(*spec)
        best = max(free, key=lambda i: (shape[i] % n_shards == 0, shape[i]))
        if shape[best] % n_shards == 0:
            spec[best] = axis
        if all(s is None for s in spec):
            return P()
        return P(*spec)

    return rule


def _specs(params, rule: SpecRule):
    """A port model -> ``{name: spec}`` in its layout; a flax-shaped tree ->
    the spec tree."""
    if isinstance(params, nn.Module):
        return model_param_specs(params, rule)
    return make_param_specs(params, rule)


def make_fsdp_specs(params, mesh: Mesh, axis: str = "data", min_size: int = 1024,
                    base_rule: SpecRule | None = None):
    """The ZeRO-3 specs of ``params`` over ``mesh``'s ``axis``: a port model
    gives ``{parameter name: spec}`` in the port's layout, a flax-shaped
    tree the congruent spec tree (JAX's form)."""
    return _specs(params, fsdp_rule(mesh.shape[axis], axis=axis, min_size=min_size,
                                    base_rule=base_rule))


def make_fsdp_opt_specs(state, mesh: Mesh, param_specs, axis: str = "data"):
    """The moments' specs for ``sharded_update`` under fsdp: a sharded
    leaf's moments keep its spec, a replicated leaf's are upgraded to
    ``fsdp_rule(min_size=1)``'s (JAX's opt-spec upgrade).  ``state`` is a
    port ``TrainState`` or model (-> ``{name: spec}``) or a flax-shaped
    parameter tree (-> spec tree); the port keeps no optimizer tree, so the
    result is one spec per parameter, which each moment takes."""
    model = getattr(state, "model", state)
    upgraded = _specs(model, fsdp_rule(mesh.shape[axis], axis=axis, min_size=1))
    if isinstance(param_specs, Mapping) and not isinstance(model, nn.Module):
        def merge(spec_tree, up_tree):
            if isinstance(spec_tree, Mapping):
                return {k: merge(spec_tree[k], up_tree[k]) for k in spec_tree}
            return spec_tree if spec_tree != P() else up_tree
        return merge(param_specs, upgraded)
    return {n: spec if spec != P() else upgraded[n] for n, spec in param_specs.items()}


def _released(p: torch.Tensor) -> torch.Tensor:
    return torch.empty(0, dtype=p.dtype, device=p.device)


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ShardPlan:
    """How each parameter of a sharded run lives on this rank.

    The plan splits over the mesh's data axis: this rank's place along it
    (``mesh.data_index``) among the ``dp`` ranks of its data group
    (``mesh.data_group``, the ranks that differ from it in ``d`` only; the
    whole group at tp = sp = 1).  Under tp (``tp``, the run's
    :class:`~.tensor_parallel.TPPlan`) the module's parameters are this
    model rank's blocks, and this plan splits those blocks again over the
    data group (a ``P("data", "model")`` leaf is the model block cut along
    its data dim): the shapes and names here are the blocks', the whole
    forms gather over the data group and then over the model group, and
    the clip's norm counts every element once across both.  Under sp the
    seq ranks of a data row hold the same blocks: their gradients are
    averaged over the seq group before the data group's reduce-scatter.

    Per leaf ``i`` (``names[i]``, this rank's shape ``shapes[i]``): its ``kind``
    (``replicated``, ``fsdp``, ``zero1`` or ``expert``), ``split[i]``, the
    dim its master and moments are blocks of (None: whole), and
    ``masters[i]``, this rank's block of an fsdp or expert leaf, else the
    whole parameter itself (``local_names``, the names beside ``masters``
    on every plan, are ``names``).  The ``zero1`` leaves stay whole in the module
    and are updated as plain dp's ZeRO-1 updates its leaves: packed into
    a few buckets (``collectives.make_bucket_layout``), of which the
    optimizer holds this rank's 1/N block.  So the optimizer's tensors,
    ``opt_params`` (named by ``opt_names``), are the masters of the other
    leaves in order, then those bucket blocks.  ``clip`` is the run's
    global-norm clip, applied against the true cross-rank norm."""

    def __init__(self, mesh: Mesh, params: Sequence[nn.Parameter], names: Sequence[str],
                 kinds: Sequence[str], split: Sequence[int | None], n_buckets: int = 4,
                 tp=None):
        self.mesh, self.n, self.rank = mesh, mesh.size, mesh.data_index
        self.group = mesh.data_group  # the data axis of this rank
        self.tp = tp
        self.params, self.names = list(params), list(names)
        self.local_names = self.names
        self.kinds, self.split = list(kinds), list(split)
        self.shapes = [tuple(p.shape) for p in self.params]
        self.clip: float | None = None
        self.masters: list[torch.Tensor] = [
            p if s is None or k == EXPERT else self._block(p.detach(), s).clone()
            for p, k, s in zip(self.params, self.kinds, self.split)]
        for i, (p, k) in enumerate(zip(self.params, self.kinds)):
            if k == EXPERT:  # the module keeps this rank's expert rows for good
                p.data = self._block(p.detach(), self.split[i]).clone()
                self.masters[i] = p
        self._repl = [i for i, k in enumerate(self.kinds) if k == REPLICATED]
        self._repl_layout = (make_bucket_layout([self.params[i] for i in self._repl], 1)
                             if self._repl else None)
        self._seq_layout = None  # the split leaves' gradients' seq mean, at first use
        self._units = [i for i, k in enumerate(self.kinds) if k != ZERO1]
        self._z1 = [i for i, k in enumerate(self.kinds) if k == ZERO1]
        self.z1_layout = (make_bucket_layout(self._z1_params(), self.n, n_buckets)
                           if self._z1 else None)
        self.z1_shards = [s.clone() for s in self._z1_blocks(self._z1_params())]
        self.opt_params = [self.masters[i] for i in self._units] + self.z1_shards
        self.opt_names = ([self.names[i] for i in self._units]
                          + [f"zero1.bucket_{b}" for b in range(len(self.z1_shards))])
        # per optimizer tensor: split across the data group (its squares
        # summed over it in the norm) or whole and the same on every data
        # rank; and split across the model group (a tp block) or not
        self._opt_split = ([self.kinds[i] != REPLICATED for i in self._units]
                           + [True] * len(self.z1_shards))
        self._opt_model = ([tp is not None and tp.split[i] is not None for i in self._units]
                           + [False] * len(self.z1_shards))
        self.release()

    @classmethod
    def build(cls, mesh: Mesh, model: nn.Module, param_specs: Mapping[str, P] | None = None,
              opt_specs: Mapping[str, P] | None = None,
              expert_specs: Mapping[str, P] | None = None, n_buckets: int = 4,
              tp=None) -> "ShardPlan":
        """The plan of ``model`` (replicated on every rank of a data group:
        whole, or under ``tp``, a ``TPPlan`` already cut, this model
        rank's blocks): a leaf ``expert_specs`` splits over ``data`` is an
        expert leaf, else one ``param_specs`` splits over ``data`` is an
        fsdp leaf, else one ``opt_specs`` splits has ZeRO-1 moments (in
        ``n_buckets`` buckets), else it is replicated over the data group
        (specs in the port's layout; their ``model`` dims are ``tp``'s)."""
        if tp is not None and list(tp.names) != [n for n, _ in model.named_parameters()]:
            raise ValueError("tp's plan does not name the model's parameters in order")
        names, params, kinds, split = [], [], [], []
        for name, p in model.named_parameters():
            kind, dim = REPLICATED, None
            for k, specs in ((EXPERT, expert_specs), (FSDP, param_specs), (ZERO1, opt_specs)):
                d = shard_dim(specs.get(name, P())) if specs else None
                if d is not None:
                    kind, dim = k, None if k == ZERO1 else d  # a ZeRO-1 leaf stays whole
                    break
            if dim is not None and p.shape[dim] % mesh.size:
                raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does not divide "
                                 f"over dp={mesh.size}")
            names.append(name)
            params.append(p)
            kinds.append(kind)
            split.append(dim)
        return cls(mesh, params, names, kinds, split, n_buckets, tp=tp)

    # ---------------------------------------------------------------- layout

    def _block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.chunk(self.n, dim)[self.rank]

    def _z1_params(self) -> list[torch.Tensor]:
        return [self.params[i] for i in self._z1]

    def _z1_blocks(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's block of each ZeRO-1 bucket of ``tensors`` (views)."""
        if not self._z1:
            return []
        return list(bucket_shard(flatten_buckets(tensors, self.z1_layout), self.z1_layout,
                                 self.group))

    def _model_block(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s whole tensor -> this model rank's block (itself
        without tp)."""
        return whole if self.tp is None else self.tp.block_of(i, whole)

    def _model_whole(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Model blocks, one a leaf -> whole over the model group."""
        return tensors if self.tp is None else self.tp.whole(tensors)

    @property
    def whole_shapes(self) -> list[tuple]:
        """Each leaf's whole shape (across the model group too)."""
        return self.shapes if self.tp is None else list(self.tp.shapes)

    def block_of(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf ``i``'s whole tensor (itself if whole)."""
        whole, s = self._model_block(i, whole), self.split[i]
        return whole if s is None else self._block(whole, s)

    def _data_whole(self, t: torch.Tensor, i: int) -> torch.Tensor:
        s = self.split[i]
        return t if s is None else all_gather_dim(t.detach(), s, self.group)

    def whole(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tensors laid out as the masters, one a leaf, gathered whole (a
        collective)."""
        return self._model_whole([self._data_whole(t, i) for i, t in enumerate(tensors)])

    def opt_blocks(self, whole: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Whole tensors, one a leaf -> the optimizer's layout: each other
        leaf's block, then this rank's block of each ZeRO-1 bucket (views
        where they can be)."""
        return ([self.block_of(i, whole[i]) for i in self._units]
                + self._z1_blocks([self._model_block(i, whole[i]) for i in self._z1]))

    def opt_whole(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The inverse of :meth:`opt_blocks`: tensors in the optimizer's
        layout (a moment list) -> one whole tensor a leaf (a collective)."""
        out: list[torch.Tensor | None] = [None] * len(self.names)
        for i, t in zip(self._units, tensors):
            out[i] = self._data_whole(t, i)
        if self._z1:
            full = [all_gather(b.detach(), self.group) for b in tensors[len(self._units):]]
            for i, t in zip(self._z1, unflatten_buckets(full, self.z1_layout)):
                out[i] = t
        return self._model_whole(out)

    def resident_bytes(self) -> int:
        """Bytes this rank holds for the parameters at rest: the masters
        (an fsdp or expert leaf's block, any other leaf whole) and the
        ZeRO-1 bucket blocks the optimizer updates."""
        return _nbytes(self.masters) + _nbytes(self.z1_shards)

    def gathered_bytes(self) -> int:
        """Bytes of the module's parameters while a step holds them
        gathered: each leaf whole, but an expert leaf's rows this rank's."""
        return sum(int(np.prod(s)) * p.element_size() if k != EXPERT
                   else m.numel() * m.element_size()
                   for s, p, k, m in zip(self.shapes, self.params, self.kinds, self.masters))

    def numel(self) -> int:
        """Elements of the whole parameter set (every expert counted)."""
        return sum(int(np.prod(s)) for s in self.whole_shapes)

    # ---------------------------------------------------------------- step

    def gather(self) -> None:
        """Gather every fsdp leaf whole (this model rank's block under tp)
        into the module's parameter, over the data group."""
        for i, k in enumerate(self.kinds):
            if k == FSDP:
                self.params[i].data = all_gather_dim(self.masters[i], self.split[i],
                                                     self.group)

    def release(self) -> None:
        """Drop the gathered copies of the fsdp leaves."""
        for i, k in enumerate(self.kinds):
            if k == FSDP:
                self.params[i].data = _released(self.params[i])

    @contextlib.contextmanager
    def gathered_per_call(self, model: nn.Module, units: Sequence[nn.Module] = ()):
        """Inside the block, each of the ``units`` (submodules of ``model``,
        a transformer's blocks) gathers the fsdp leaves under it whole as
        its call begins and releases them as it ends, and ``model`` does so
        for the rest of its leaves around its own call (a collective per
        call: every rank must make the same calls in the same order).  So
        at most one unit's leaves, beside the others', are whole at a
        time."""
        index = {id(p): i for i, (p, k) in enumerate(zip(self.params, self.kinds))
                 if k == FSDP}
        owned: dict = {}
        for unit in units:
            owned[unit] = [index.pop(id(p)) for p in unit.parameters() if id(p) in index]
        owned[model] = [index.pop(id(p)) for p in model.parameters() if id(p) in index]

        def gather(ids):
            for i in ids:
                self.params[i].data = all_gather_dim(self.masters[i], self.split[i],
                                                     self.group)

        def release(ids):
            for i in ids:
                self.params[i].data = _released(self.params[i])

        hooks = []
        for mod, ids in owned.items():
            hooks.append(mod.register_forward_pre_hook(lambda m, a, ids=ids: gather(ids)))
            hooks.append(mod.register_forward_hook(lambda m, a, o, ids=ids: release(ids)))
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()
            self.release()

    @contextlib.contextmanager
    def gathered(self):
        """The fsdp leaves whole for the block (a collective on entry)."""
        self.gather()
        try:
            yield self
        finally:
            self.release()

    def _seq_mean(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Under sp, the split leaves' gradients averaged over the seq group
        (one bucketed all-reduce): the seq ranks of a data row hold the same
        blocks, each differentiating its own tokens' loss."""
        grads = list(grads)
        if self.mesh.seq_size == 1:
            return grads
        ids = [i for i, k in enumerate(self.kinds) if k != REPLICATED]
        if not ids:
            return grads
        if self._seq_layout is None:
            self._seq_layout = make_bucket_layout([grads[i] for i in ids], 1)
        lay = self._seq_layout
        mean = unflatten_buckets(grouped_all_reduce_mean(
            flatten_buckets([grads[i] for i in ids], lay), self.mesh.seq_group), lay)
        for i, g in zip(ids, mean):
            grads[i] = g
        return grads

    @torch.no_grad()
    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Whole per-rank gradients, one a leaf (this model rank's blocks
        under tp) -> the gradients of the optimizer's tensors: the mean
        across ranks, reduce-scattered over the data group to this rank's
        block for fsdp leaves, all-reduced (bucketed) over the replica
        group (the data x seq ranks of this model index) for replicated
        ones, scaled by 1/N for expert leaves (their all-to-all backward has
        already summed the data group's tokens), and reduce-scattered bucket
        by bucket for the ZeRO-1 leaves; under sp the split leaves are first
        averaged over the seq group."""
        grads = self._seq_mean(grads)
        repl = {}
        if self._repl:
            lay = self._repl_layout
            repl = dict(zip(self._repl, unflatten_buckets(grouped_all_reduce_mean(
                flatten_buckets([grads[i] for i in self._repl], lay),
                self.mesh.replica_group), lay)))
        out = []
        for i in self._units:
            k = self.kinds[i]
            if k == FSDP:
                out.append(reduce_scatter_dim(grads[i], self.split[i], self.group).div_(self.n))
            elif k == EXPERT:
                out.append(grads[i] / self.n)
            else:
                out.append(repl[i])
        if self._z1:
            out += bucket_reduce_scatter_mean([grads[i] for i in self._z1], self.z1_layout,
                                              self.group)
        return out

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the optimizer's gradients, every element
        counted once: each one split over the data group (an fsdp or expert
        block, a ZeRO-1 bucket block) as the sum of its blocks' squares
        across the data group, each tp block's across the model group (both,
        for a block split over both), and each leaf whole on every rank
        once."""
        zero = torch.zeros((), device=grads[0].device)

        def squares(data: bool, model: bool) -> torch.Tensor:
            return sum((g.float().square().sum() for g, d, m
                        in zip(grads, self._opt_split, self._opt_model, strict=True)
                        if d == data and m == model), zero)

        by_data = all_reduce_sum(torch.stack([squares(True, False), squares(True, True)]),
                                 self.group)
        total = by_data[0] + squares(False, False)
        if self.tp is not None:  # the model blocks' squares across the model group
            total = total + all_reduce_sum(by_data[1] + squares(False, True),
                                           self.mesh.model_group)
        return total.sqrt()

    @torch.no_grad()
    def apply(self, optimizer, grads: Sequence[torch.Tensor]) -> None:
        """One update from whole per-rank gradients: reduce, clip against
        the global norm, step the optimizer's tensors, gather the ZeRO-1
        buckets back into their parameters."""
        g = self.reduce_grads(grads)
        if self.clip is not None:
            norm = self.grad_norm(g)
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm.clamp_min(1e-38))
            g = torch._foreach_mul(g, scale)
        if self._z1:  # the parameters are the truth; the blocks are loaded from them
            load_bucket_shards(self.z1_shards, self._z1_params(), self.z1_layout, self.group)
        optimizer.step(g)
        if self._z1:
            gather_bucket_shards(self.z1_shards, self._z1_params(), self.z1_layout,
                                 self.group)

    # ---------------------------------------------------------------- state

    def adopt(self, state) -> None:
        """Make ``state`` (a ``core.state.TrainState`` whose optimizer runs
        over the model's whole parameters) this plan's: its optimizer now
        updates ``opt_params``, each moment cut to match, with the clip
        lifted out (:meth:`apply` applies it)."""
        old = state.optimizer
        opt = copy.copy(old)
        opt.params = self.opt_params
        for key in ("mu", "nu", "trace"):
            ts = getattr(old, key)
            setattr(opt, key, [t.clone() for t in self.opt_blocks(ts)] if ts else [])
        self.clip, opt.grad_clip = old.grad_clip, None
        state.optimizer = opt
        state.plan = self

    def whole_moments(self, optimizer) -> dict[str, dict[str, torch.Tensor]]:
        """``optimizer``'s moments as ``{key: {leaf name: whole tensor}}``
        (``{}`` for a moment the chain does not keep): a collective."""
        return {key: dict(zip(self.names, self.opt_whole(getattr(optimizer, key))))
                if getattr(optimizer, key) else {} for key in ("mu", "nu", "trace")}

    @torch.no_grad()
    def load_moments(self, optimizer, saved: Mapping) -> None:
        """Load the save form's whole moments (``count`` and ``{key: {leaf
        name: tensor}}``) into ``optimizer``, each cut to this rank's part;
        strict, as ``Optimizer.load_state_dict`` (every name, every shape,
        all checked before anything is copied)."""
        form = {"count": saved["count"]}
        for key in ("mu", "nu", "trace"):
            ts = saved[key]
            if ts:
                if set(ts) != set(self.names):
                    raise ValueError(
                        f"optimizer {key}: the saved state does not match this model "
                        f"(missing {sorted(set(self.names) - set(ts))[:4]}, unexpected "
                        f"{sorted(set(ts) - set(self.names))[:4]})")
                for n, shape in zip(self.names, self.whole_shapes):
                    if tuple(ts[n].shape) != shape:
                        raise ValueError(f"optimizer {key}/{n}: saved shape "
                                         f"{tuple(ts[n].shape)}, expected {shape}")
                ts = dict(zip(self.opt_names, self.opt_blocks([ts[n] for n in self.names])))
            form[key] = ts
        optimizer.load_state_dict(form, self.opt_names)

    @torch.no_grad()
    def load_whole(self, params: Mapping[str, torch.Tensor]) -> None:
        """Load whole parameters (by name): each master takes its block, a
        parameter kept whole takes all of it."""
        for i, name in enumerate(self.names):
            src = params[name]
            if tuple(src.shape) != self.whole_shapes[i]:
                raise ValueError(f"params/{name}: saved shape {tuple(src.shape)}, "
                                 f"expected {self.whole_shapes[i]}")
            src = src.to(self.params[i].device)
            if self.kinds[i] in (REPLICATED, ZERO1):
                self.params[i].copy_(self._model_block(i, src))
            if self.masters[i] is not self.params[i]:
                self.masters[i].copy_(self.block_of(i, src))
            elif self.kinds[i] == EXPERT:
                self.params[i].copy_(self.block_of(i, src))

    def whole_state_dict(self, model: nn.Module) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` with every leaf whole (a collective)."""
        whole = dict(zip(self.names, self.whole(self.masters)))
        return {k: whole.get(k, v) for k, v in model.state_dict().items()}


def shard_train_state(mesh: Mesh, state, param_specs: Mapping[str, P], opt_specs=None):
    """The ZeRO-3 form of a replicated ``core.state.TrainState`` (JAX's
    ``tensor_parallel.shard_train_state``, which ``fsdp.py`` re-exports
    there): this rank keeps its block of each leaf ``param_specs`` (port
    layout, by parameter name; ``tensor_parallel.model_param_specs``)
    splits over ``data``, and of its optimizer moments; ``opt_specs``
    (:func:`make_fsdp_opt_specs`) shards the moments of replicated leaves
    too.  Returns the state, now carrying its :class:`ShardPlan` (the
    module's parameters of sharded leaves are released until a step
    gathers them).  Specs over ``model`` are tensor parallelism's
    (``tensor_parallel.shard_train_state``)."""
    if any(ax == "model" for spec in param_specs.values() for ax in spec):
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel

        return tensor_parallel.shard_train_state(mesh, state, param_specs, opt_specs)
    plan = ShardPlan.build(mesh, state.model, param_specs, opt_specs=opt_specs)
    plan.adopt(state)
    return state


def _global_block(batch: dict, mesh: Mesh) -> dict:
    n = batch["label"].shape[0]
    if n % mesh.size:
        raise ValueError(f"global batch {n} not divisible by dp={mesh.size}")
    per = n // mesh.size
    return {k: v[mesh.rank * per:(mesh.rank + 1) * per] for k, v in batch.items()}


def make_fsdp_train_step(model, tx, mesh: Mesh, param_specs, state, data_axis: str = "data",
                         label_smoothing: float = 0.0, fused_xent: bool = False,
                         opt_specs=None, remat: bool = False, grad_accum: int = 1):
    """One ZeRO-3 step on a global batch: ``step(state, batch) -> metrics``
    with ``batch`` the same global batch on every rank; rank ``r`` trains on
    its contiguous block of rows, and ``loss``/``accuracy`` are the means
    across ranks, as JAX's step returns them.  ``state`` is sharded by
    :func:`shard_train_state` (here, when it is not yet:
    with ``param_specs`` and ``opt_specs``); ``tx`` is kept for JAX's
    signature: the update is ``state.optimizer``'s."""
    del tx, data_axis
    if getattr(state, "plan", None) is None:
        shard_train_state(mesh, state, param_specs, opt_specs=opt_specs)
    step = make_train_step(model, state.optimizer, label_smoothing=label_smoothing,
                           fused_xent=fused_xent, remat=remat, grad_accum=grad_accum,
                           plan=state.plan)

    def fsdp_step(st, batch: dict) -> dict:
        m = step(st, _global_block(batch, mesh))
        loss, accuracy = all_reduce_mean(torch.stack([m["loss"], m["accuracy"]]))
        return {"loss": loss, "accuracy": accuracy}

    return fsdp_step


__all__ = ["ShardPlan", "fsdp_rule", "make_fsdp_opt_specs",
           "make_fsdp_specs", "make_fsdp_train_step", "shard_train_state"]
