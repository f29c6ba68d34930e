"""Parameter spec rules of the port: which dims of each leaf are split over
which mesh axis.

The counterpart of the spec-rule half of the JAX package's
``parallel/tensor_parallel.py`` (``SpecRule``, ``megatron_dense_rule``,
``megatron_rule``, ``chain_rules``, ``make_param_specs``, ``specs_like``;
its ``shard_train_state`` is ``parallel/fsdp.py``'s here, beside the
``ShardPlan`` it builds).  The port has no ``PartitionSpec``; :class:`P` is
its own: a tuple holding an axis name or ``None`` per dim, ``P()`` the
replicated spec.  A rule sees what JAX's rules see, the flax path of a
leaf (``("block_0", "qkv", "kernel")``) and its flax shape, so the same
rule gives the same spec on both sides; :func:`model_param_specs` runs a
rule over a port model (the paths and shapes come from
``convert.flax_layout``, the mapping ``convert.py`` loads weights by) and
returns each spec in the PORT's layout, keyed by parameter name: a flax
``(in, out)`` kernel's ``P("data", None)`` is the ``(out, in)``
``nn.Linear`` weight's ``P(None, "data")``, a conv's HWIO spec is
permuted to OIHW.

Placement is explicit here, not GSPMD's: ``fsdp.shard_train_state`` makes
a state whose ranks each keep their block of every sharded leaf, and
``parallel/fsdp.py`` has the step that runs on it; specs over both
``data`` and ``model`` (fsdp beside tp) give a ``fsdp.ShardPlan`` over
each model rank's :class:`TPPlan` blocks (:func:`shard_train_state`).

The ``model`` axis (tensor parallelism in training).  JAX jits the
unchanged single-device step under ``megatron_rule(tp)``'s shardings and
GSPMD inserts every collective.  A port rank is a process, so the port
places them itself, and its numbers are still the single-device step's:

* :class:`TPPlan` (``shard_train_state`` over ``model``) keeps, on each
  model rank, its block of every leaf the rule splits, in the module's
  own parameter, and the optimizer's moments of those blocks; a leaf
  whose dim does not divide stays whole, as JAX degrades it.  Each split
  layer carries ``tp_dim`` (the dim of its weight that is split) and
  ``tp_mesh``.
* The forward places Megatron's four mappings
  (``collectives.copy_to_model`` / ``reduce_from_model`` /
  ``scatter_to_model`` / ``gather_from_model``).  Where tp divides a
  block's ``heads`` and ``heads_kv``, the attention and the MLP are the
  Megatron pairs: the column ``qkv`` (or ``q_proj`` + ``kv_proj``) on
  this rank's H/tp heads, attention on those heads, the row ``proj`` and
  one all-reduce; ``dense_0`` -> ``dense_1`` likewise.  JAX's fused
  ``qkv`` output is laid ``[3][H][D]``, so a contiguous 1/tp block of it
  is not this rank's heads: such a block holds rows ``{c * dim + r *
  dim / tp + j}`` of each of q, k and v (:func:`head_major_order`;
  ``kv_proj`` within its ``[2][H_kv][D]``), the values JAX's spec puts on
  the rank, in head-major order.  Everywhere else the generic path holds
  (:func:`linear`, :func:`conv2d`, :func:`embedding`, :func:`tied_head`):
  a column-split layer's output is gathered, a row-split layer's input is
  scattered and its output reduced; the ViT at tp=4 with 2 heads runs its
  attention whole on every model rank, the convs' output channels are
  gathered before their BatchNorm or ReLU.
* Gradients: a block's gradient is this rank's share of the whole leaf's,
  a replicated leaf's is the same on every model rank (each rank's
  ``copy_to_model`` sums the partial gradients of a replicated activation),
  so nothing reduces over ``model``; every gradient is averaged over the
  ``dp * sp`` ranks of the replica group, and the clip's global norm
  counts each block once across the model group and each replicated leaf
  once.
* The save form is whole: :meth:`TPPlan.whole` gathers each block over
  the model group (its head-major rows put back in order), so a tp
  checkpoint resumes at any tp.

The serving half (JAX's ``tensor_parallel.py:296-457``): the same rule
splits a serving model's weights (``TPPlan.shard``: int8 kernels as their
full-precision ancestors, a column layer's per-output scales with its
output features, a row layer's whole, as JAX's ``megatron_rule`` places
them), :func:`kv_cache_rule` splits the decode cache over its head axis,
:func:`serving_mesh` builds an engine's groups over given ranks (JAX's
devices), :func:`tp_device_groups` partitions ranks among a router's
replicas and :func:`per_chip_bytes` counts what a rank holds.  JAX's
``mesh_shardings`` (a spec tree to ``NamedSharding`` s) has no
counterpart: a port rank holds its blocks itself, nothing places them.
Context parallelism (``cp > 1``, JAX's ``tensor_parallel.py:313-434``):
the serving mesh is a ``(cp, tp)`` grid, and :func:`kv_cache_rule` also
splits the paged pool's page axis over its ``cp`` rows (cp row ``r`` holds
pages ``r * n / cp .. (r + 1) * n / cp - 1``).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import re
from collections.abc import Mapping, Sequence
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_reduce_sum,
    copy_to_model,
    flatten_buckets,
    gather_from_model,
    grouped_all_reduce_mean,
    make_bucket_layout,
    reduce_from_model,
    scatter_to_model,
    unflatten_buckets,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh, no_group_error

class P(tuple):
    """A partition spec: one mesh-axis name (or ``None``) per leading dim
    of a leaf; ``P()`` is replicated.  Equal to the tuple of its axes."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


SpecRule = Callable[[tuple[str, ...], Any], P]


class Leaf:
    """A shape standing in for an array: what a rule reads of a leaf
    (``ndim``, ``shape``, ``size``)."""

    __slots__ = ("shape",)

    def __init__(self, shape: Sequence[int]):
        self.shape = tuple(int(n) for n in shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def megatron_dense_rule(axis: str = "model") -> SpecRule:
    """Alternating column/row-parallel specs for ``dense_{i}`` stacks: even
    ``dense_i`` kernel ``P(None, axis)``, bias ``P(axis)``; odd kernel
    ``P(axis, None)``, bias replicated; anything else replicated."""

    def rule(path: tuple[str, ...], leaf) -> P:
        if len(path) >= 2:
            m = re.fullmatch(r"dense_(\d+)", path[-2])
            if m and getattr(leaf, "ndim", 0) >= 1:
                col = int(m.group(1)) % 2 == 0
                if path[-1] == "kernel":
                    return P(None, axis) if col else P(axis, None)
                if path[-1] == "bias":
                    return P(axis) if col else P()
        return P()

    return rule


def megatron_rule(n_shards: int, axis: str = "model") -> SpecRule:
    """Full-model Megatron sharding, as JAX's: the ``dense_{i}`` pair, the
    column-parallel ``qkv``/``q_proj``/``kv_proj`` and ``fc{i}``, the
    row-parallel attention ``proj`` and ``logits``, conv output channels,
    the embedding's feature dim, the matching biases and int8 scales;
    indivisible leaves degrade to replicated."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dense = megatron_dense_rule(axis)

    def rule(path: tuple[str, ...], leaf) -> P:
        ndim = getattr(leaf, "ndim", 0)
        shape = getattr(leaf, "shape", ())
        base = dense(path, leaf)
        if base != P():
            divisible = all(
                ax is None or shape[i] % n_shards == 0 for i, ax in enumerate(base))
            return base if divisible else P()
        if len(path) < 2:
            return P()
        name, kind = path[-2], path[-1]
        if kind == "kernel" and ndim == 4 and shape[3] % n_shards == 0:
            return P(None, None, None, axis)  # conv output channels
        if kind == "kernel" and ndim == 2:
            d_in, d_out = shape
            if name in ("qkv", "q_proj", "kv_proj") and d_out % n_shards == 0:
                return P(None, axis)
            if name == "proj" and d_in % n_shards == 0:
                return P(axis, None)
            if re.fullmatch(r"fc\d*", name) and d_out % n_shards == 0:
                return P(None, axis)
            if name == "logits" and d_in % n_shards == 0:
                return P(axis, None)
        if kind == "embedding" and ndim == 2 and shape[1] % n_shards == 0:
            return P(None, axis)
        if kind == "bias" and ndim == 1 and shape[0] % n_shards == 0:
            if name in ("qkv", "q_proj", "kv_proj") or re.fullmatch(r"fc\d*", name):
                return P(axis)
        if kind == "scale" and ndim == 1:
            m = re.fullmatch(r"dense_(\d+)", name)
            col = ((m is not None and int(m.group(1)) % 2 == 0)
                   or name in ("qkv", "q_proj", "kv_proj")
                   or re.fullmatch(r"fc\d*", name) is not None)
            if col and shape[0] % n_shards == 0:
                return P(axis)
            return P()
        return P()

    return rule


def chain_rules(*rules: SpecRule) -> SpecRule:
    """Compose spec rules: the first non-replicated answer wins."""

    def rule(path: tuple[str, ...], leaf) -> P:
        for r in rules:
            spec = r(path, leaf)
            if spec != P():
                return spec
        return P()

    return rule


def _tree_map(fn, tree, path: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested mapping / sequence (the leaves are
    whatever is not one), keeping the containers."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def _tree_leaves(tree, path: tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _tree_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, path + (str(i),))
    else:
        yield path, tree


def make_param_specs(params, rule: SpecRule):
    """Apply a spec rule over a flax-shaped parameter tree (nested
    mappings of leaves with a ``shape``) -> the congruent spec tree."""
    return _tree_map(rule, params)


def specs_like(target, params, param_specs, default: P = P()):
    """Spec tree congruent to ``target``, reusing the parameter specs by
    path suffix: a leaf whose path ends with a parameter's path (an
    optimizer moment mirroring the parameter tree) and has its ndim gets
    that parameter's spec; everything else gets ``default``.  ``params``
    is kept for JAX's signature (the suffixes come from ``param_specs``)."""
    del params
    param_paths = dict(_tree_leaves(param_specs))

    def leaf_spec(path, leaf) -> P:
        for start in range(len(path)):
            spec = param_paths.get(path[start:])
            if spec is not None and getattr(leaf, "ndim", None) == len(spec):
                return spec
        return default

    return _tree_map(leaf_spec, target)


def _port_spec(spec: P, layout: str) -> P:
    """A spec over a flax leaf's dims -> the same spec over the port
    tensor's dims (``convert.py``'s layout change)."""
    if spec == P():
        return spec
    if layout == "transpose":
        return P(*reversed(spec))
    if layout == "hwio":  # OIHW dim j is HWIO dim (3, 2, 0, 1)[j]
        return P(*(spec[d] for d in (3, 2, 0, 1)))
    return spec


def flax_shape_tree(model) -> dict:
    """The port model's parameters as a flax-shaped tree: the nested flax
    paths (``convert.flax_layout``), each leaf a :class:`Leaf` of the flax
    shape."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.convert import flax_layout

    tree: dict = {}
    for name, (path, layout, shape) in flax_layout(model).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = Leaf(shape)
    return tree


def model_param_specs(model, rule: SpecRule) -> dict[str, P]:
    """``rule`` over the port model's parameters: ``{parameter name: spec
    in the port tensor's layout}``, each decided on the leaf's flax path
    and flax shape as the JAX package decides it."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.convert import flax_layout

    return {name: _port_spec(rule(path, Leaf(shape)), layout)
            for name, (path, layout, shape) in flax_layout(model).items()}


def shard_dim(spec: P, axis: str = "data") -> int | None:
    """The one dim ``spec`` splits over ``axis`` (None when it splits none).
    The plans read ``data`` (``fsdp.ShardPlan``) and ``model``
    (:class:`TPPlan`); a pipe rank holds its stage by
    ``parallel.pipeline.stage_param_specs``'s stage split, so a spec's
    ``pipe`` dim (JAX's ``pipeline_block_rule``) is read by no plan."""
    dims = [i for i, ax in enumerate(spec) if ax == axis]
    return dims[0] if dims else None


# ---------------------------------------------------------------------------
# The model axis in the forward: the generic path of each split layer (module
# docstring).  ``layer.tp_mesh`` is None (or absent) on an unsplit layer,
# which then runs its plain product, the tp = 1 launches exactly.
# ---------------------------------------------------------------------------


def layer_mesh(layer: nn.Module):
    """The mesh of a split layer, None for a whole one."""
    return getattr(layer, "tp_mesh", None)


def column(x: torch.Tensor, fn: Callable, mesh, bias: torch.Tensor | None = None,
           dim: int = -1, entered: bool = False, gather: bool = True) -> torch.Tensor:
    """A column-parallel product ``fn(x)`` (this rank's block of the
    output features along ``dim``).  ``entered``: ``x`` already passed
    ``copy_to_model``; ``gather=False`` keeps the block (a Megatron pair's
    first half).  ``bias``, whole, is added after the gather; a block's
    own bias belongs in ``fn``."""
    y = fn(x if entered else copy_to_model(x, mesh))
    if not gather:
        return y
    y = gather_from_model(y, dim, mesh)
    if bias is None:
        return y
    return y + (bias if dim in (-1, y.ndim - 1) else bias.view(-1, *[1] * (y.ndim - dim - 1)))


def row(x: torch.Tensor, fn: Callable, mesh, bias: torch.Tensor | None = None,
        local: bool = False) -> torch.Tensor:
    """A row-parallel product: ``fn`` on this rank's slice of the last dim
    of ``x`` (already sliced when ``local``), the partial sums reduced over
    the model group, then the whole ``bias``."""
    y = reduce_from_model(fn(x if local else scatter_to_model(x, -1, mesh)), mesh)
    return y if bias is None else y + bias


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, entered: bool = False,
           local: bool = False) -> torch.Tensor:
    """``layer`` in ``dtype`` on ``x``: the plain product when it is whole,
    else its column (``tp_dim`` 0) or row (``tp_dim`` 1) split on the
    generic path, or, with ``local``, as one half of a Megatron pair (a
    column keeps its output block, a row takes ``x`` as this rank's
    slice)."""
    w = layer.weight.to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    mesh = layer_mesh(layer)
    if mesh is None:
        return F.linear(x, w, b)
    if layer.tp_dim == 0:
        own = b is not None and b.shape[0] == w.shape[0]  # the bias block
        return column(x, lambda h: F.linear(h, w, b if own else None), mesh,
                      None if own else b, entered=entered, gather=not local)
    return row(x, lambda h: F.linear(h, w), mesh, b, local=local)


def conv2d(x: torch.Tensor, layer: nn.Conv2d, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride=1, padding=0) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` with ``weight`` (the layer's, cast); a
    layer split on its output channels runs this rank's channels and
    gathers them (dim 1), the whole ``bias`` added after."""
    mesh = layer_mesh(layer)
    if mesh is None:
        return F.conv2d(x, weight, bias, stride, padding)
    return column(x, lambda h: F.conv2d(h, weight, None, stride, padding), mesh, bias, dim=1)


def embedding(tokens: torch.Tensor, layer: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    """The embedding lookup; split on its features, each rank looks its
    block up and the features are gathered."""
    w = layer.weight.to(dtype)
    mesh = layer_mesh(layer)
    if mesh is None:
        return F.embedding(tokens, w)
    return gather_from_model(F.embedding(tokens, w), -1, mesh)


def tied_head(x: torch.Tensor, layer: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    """``x @ embed^T`` (the tied vocab head); with the embedding split on
    its features, a row split over ``dim``."""
    w = layer.weight.to(dtype)
    mesh = layer_mesh(layer)
    if mesh is None:
        return x @ w.T
    return row(x, lambda h: h @ w.T, mesh)


# ---------------------------------------------------------------------------
# The model axis in the state: each rank's blocks, the whole form, the step.
# ---------------------------------------------------------------------------


def head_major_order(rows: int, parts: int, n: int) -> torch.Tensor:
    """The row order whose contiguous 1/n blocks are a model rank's heads of
    a fused projection laid ``[parts][width]`` (``qkv``: 3 parts of dim,
    ``kv_proj``: 2 of ``H_kv * D``): block r holds rows ``{c * width + r *
    width / n + j}`` for each part c, parts in order."""
    width = rows // parts
    blk = width // n
    return torch.tensor([c * width + r * blk + j for r in range(n) for c in range(parts)
                         for j in range(blk)], dtype=torch.long)


def _block_attention(block, specs: Mapping[str, P], prefix: str, n: int) -> dict:
    """The head-aligned layout of a transformer block, when tp divides its
    heads and heads_kv and the rule splits its projections as Megatron's
    pair: ``{parameter name: (parts)}`` of the fused leaves to lay out
    head-major (empty when the block takes the generic path, None)."""
    def dim(leaf):
        return shard_dim(specs.get(f"{prefix}{leaf}", P()), "model")

    if block.heads % n or block.heads_kv % n or dim("proj.weight") != 1:
        return None
    if block.heads_kv == block.heads:
        fused = {"qkv.weight": 3, "qkv.bias": 3}
    else:
        if dim("q_proj.weight") != 0:
            return None
        fused = {"kv_proj.weight": 2, "kv_proj.bias": 2}
    if any(dim(leaf) != 0 for leaf in fused):
        return None
    return fused


class TPPlan:
    """How each parameter of a tp run lives on this rank (the counterpart
    of ``fsdp.ShardPlan``'s interface, which ``core.state`` and the step
    use): per leaf ``i`` (``names[i]``, whole shape ``shapes[i]``),
    ``split[i]``, the dim its block is cut along (None: whole), and
    ``perm[i]``, the row order of a head-major leaf (None: in order).  The
    module's own parameters are the blocks (``masters``, named by
    ``local_names``, here ``names``: every plan has that pair), and the
    optimizer updates them.  ``clip`` is the run's global-norm clip, lifted
    out of the optimizer and applied against the norm over the model
    group."""

    def __init__(self, mesh, names: Sequence[str], params: Sequence[nn.Parameter],
                 shapes: Sequence[tuple], split: Sequence[int | None],
                 perm: Sequence[torch.Tensor | None]):
        self.mesh, self.n, self.index = mesh, mesh.model_size, mesh.model_index
        self.names, self.params = list(names), list(params)
        self.shapes, self.split, self.perm = list(shapes), list(split), list(perm)
        self.masters, self.local_names = self.params, self.names
        self.clip: float | None = None
        self._inverse = [None if q is None else torch.argsort(q) for q in self.perm]
        # split buffers (an int8 column's scales): name -> (dim, row order)
        self.buffers: dict[str, tuple[int, torch.Tensor | None]] = {}
        self._replicas = mesh.shape["data"] * mesh.shape["seq"]
        self._layout = None  # the gradient buckets, laid over the blocks at first use

    @classmethod
    def shard(cls, mesh, model: nn.Module, param_specs: Mapping[str, P] | None = None
              ) -> "TPPlan":
        """Cut ``model`` (whole, the same on every rank) to this model
        rank's blocks in place, by ``param_specs`` (port layout, by name;
        default ``megatron_rule(tp)``'s), mark the split layers and the
        head-aligned transformer blocks for the forward, and return the
        plan."""
        n = mesh.model_size
        if param_specs is None:
            param_specs = model_param_specs(model, megatron_rule(n))
        from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import Int8Linear
        from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
            TransformerBlock,
        )

        fused: dict[str, int] = {}
        for mod_name, mod in model.named_modules():
            if isinstance(mod, TransformerBlock):
                prefix = f"{mod_name}." if mod_name else ""
                layout = _block_attention(mod, param_specs, prefix, n)
                if layout and isinstance(mod.proj, Int8Linear):
                    # an int8 column's scales are laid out as its rows
                    layout.update({k.replace(".weight", ".scale"): v
                                   for k, v in layout.items() if k.endswith(".weight")})
                aligned = layout is not None
                mod.tp_mesh = mesh
                mod.tp_heads = mod.heads // n if aligned else mod.heads
                mod.tp_heads_kv = mod.heads_kv // n if aligned else mod.heads_kv
                mod.tp_attn_pair = aligned
                mod.tp_mlp_pair = (mod.moe is None and all(
                    shard_dim(param_specs.get(f"{prefix}{leaf}", P()), "model") == d
                    for leaf, d in (("dense_0.weight", 0), ("dense_1.weight", 1))))
                fused.update({prefix + k: v for k, v in (layout or {}).items()})
        names, params, shapes, split, perm = [], [], [], [], []
        with torch.no_grad():
            for mod_name, mod in model.named_modules():
                for leaf, p in mod.named_parameters(recurse=False):
                    name = f"{mod_name}.{leaf}" if mod_name else leaf
                    d = shard_dim(param_specs.get(name, P()), "model")
                    order = None
                    if d is not None:
                        if p.shape[d] % n:
                            raise ValueError(f"{name}: dim {d} of {tuple(p.shape)} does "
                                             f"not divide over tp={n}")
                        if name in fused:
                            order = head_major_order(p.shape[d], fused[name], n)
                        if leaf == "weight":
                            mod.tp_dim, mod.tp_mesh = d, mesh
                    names.append(name)
                    params.append(p)
                    shapes.append(tuple(p.shape))
                    split.append(d)
                    perm.append(order)
            plan = cls(mesh, names, params, shapes, split, perm)
            for i, p in enumerate(plan.params):
                if split[i] is not None:
                    p.data = plan.block_of(i, p.detach()).clone()
            for mod_name, mod in model.named_modules():
                if not isinstance(mod, Int8Linear):
                    continue
                name = f"{mod_name}.scale"
                d = shard_dim(param_specs.get(name, P()), "model")
                if d is not None:  # a column's scales: this rank's output features
                    order = (head_major_order(mod.scale.shape[0], fused[name], n)
                             if name in fused else None)
                    plan.buffers[name] = (d, order)
                    mod.scale = plan.cut(mod.scale, d, order).clone()
        model.tp_mesh = mesh
        return plan

    # ---------------------------------------------------------------- layout

    def cut(self, whole: torch.Tensor, d: int | None, order: torch.Tensor | None
            ) -> torch.Tensor:
        """This rank's block along dim ``d`` of ``whole`` taken in row order
        ``order`` (None: in order; ``d`` None: ``whole`` itself)."""
        if d is None:
            return whole
        if order is not None:
            whole = whole.index_select(d, order.to(whole.device))
        return whole.chunk(self.n, d)[self.index]

    def block_of(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i``'s whole tensor (itself if whole)."""
        return self.cut(whole, self.split[i], self.perm[i])

    def whole(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tensors laid out as the blocks, one a leaf, gathered whole over the
        model group in the leaves' own row order (a collective)."""
        out = []
        for t, d, inv in zip(tensors, self.split, self._inverse):
            if d is not None:
                t = all_gather_dim(t.detach().contiguous(), d, self.mesh.model_group)
                if inv is not None:
                    t = t.index_select(d, inv.to(t.device))
            out.append(t)
        return out

    def numel(self) -> int:
        """Elements of the whole parameter set."""
        return sum(int(np.prod(s)) for s in self.shapes)

    def resident_bytes(self) -> int:
        """Bytes this rank holds for the parameters: its blocks, and every
        leaf the rule leaves whole."""
        return sum(p.numel() * p.element_size() for p in self.params)

    # ---------------------------------------------------------------- step

    def gather(self) -> None:
        """Nothing to gather: the forward runs on the blocks."""

    def release(self) -> None:
        """Nothing to release."""

    @contextlib.contextmanager
    def gathered(self):
        """The eval runs the same forward on the blocks."""
        yield self

    @torch.no_grad()
    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Each rank's gradients of its blocks and whole leaves -> their mean
        over the replica group (the ``dp * sp`` ranks of this model index),
        one bucketed all-reduce; nothing crosses the model group."""
        if self._replicas == 1:
            return list(grads)
        if self._layout is None:
            self._layout = make_bucket_layout(self.params, 1)
        lay = self._layout
        return unflatten_buckets(grouped_all_reduce_mean(
            flatten_buckets(grads, lay), self.mesh.replica_group), lay)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's global L2 norm: each block's squares summed
        over the model group, each whole leaf (the same on every model
        rank) counted once."""
        zero = torch.zeros((), device=grads[0].device)
        split = sum((g.float().square().sum() for g, d in zip(grads, self.split, strict=True)
                     if d is not None), zero)
        whole = sum((g.float().square().sum() for g, d in zip(grads, self.split)
                     if d is None), zero)
        return (all_reduce_sum(split, self.mesh.model_group) + whole).sqrt()

    @torch.no_grad()
    def apply(self, optimizer, grads: Sequence[torch.Tensor]) -> None:
        """One update: the replica mean, the clip against the global norm,
        the optimizer's step on the blocks."""
        g = self.reduce_grads(grads)
        if self.clip is not None:
            norm = self.grad_norm(g)
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm.clamp_min(1e-38))
            g = torch._foreach_mul(g, scale)
        optimizer.step(g)

    # ---------------------------------------------------------------- state

    def adopt(self, state) -> None:
        """Make ``state`` (a ``core.state.TrainState`` whose optimizer was
        built over the whole parameters) this plan's: its moments cut to
        the blocks, the clip lifted out (:meth:`apply` applies it)."""
        old = state.optimizer
        opt = copy.copy(old)
        opt.params = self.params
        for key in ("mu", "nu", "trace"):
            ts = getattr(old, key)
            setattr(opt, key, [self.block_of(i, t).clone() for i, t in enumerate(ts)])
        self.clip, opt.grad_clip = old.grad_clip, None
        state.optimizer = opt
        state.plan = self

    def whole_moments(self, optimizer) -> dict[str, dict[str, torch.Tensor]]:
        """``optimizer``'s moments as ``{key: {leaf name: whole tensor}}``
        (a collective)."""
        return {key: dict(zip(self.names, self.whole(getattr(optimizer, key))))
                if getattr(optimizer, key) else {} for key in ("mu", "nu", "trace")}

    @torch.no_grad()
    def load_moments(self, optimizer, saved: Mapping) -> None:
        """Load whole moments (``count`` and ``{key: {leaf name: tensor}}``),
        each cut to this rank's block; strict, as
        ``Optimizer.load_state_dict``."""
        form = {"count": saved["count"]}
        for key in ("mu", "nu", "trace"):
            ts = saved[key]
            if ts and set(ts) == set(self.names):
                for n, shape in zip(self.names, self.shapes):
                    if tuple(ts[n].shape) != shape:
                        raise ValueError(f"optimizer {key}/{n}: saved shape "
                                         f"{tuple(ts[n].shape)}, expected {shape}")
                ts = {n: self.block_of(i, ts[n]) for i, n in enumerate(self.names)}
            form[key] = ts
        optimizer.load_state_dict(form, self.names)

    @torch.no_grad()
    def load_whole(self, params: Mapping[str, torch.Tensor]) -> None:
        """Load whole parameters (by name), each rank taking its block."""
        for i, name in enumerate(self.names):
            src = params[name]
            if tuple(src.shape) != self.shapes[i]:
                raise ValueError(f"params/{name}: saved shape {tuple(src.shape)}, "
                                 f"expected {self.shapes[i]}")
            self.params[i].copy_(self.block_of(i, src.to(self.params[i].device)))

    @torch.no_grad()
    def load_whole_state_dict(self, model: nn.Module, state: Mapping[str, torch.Tensor]
                              ) -> None:
        """Load a whole ``state_dict`` (every leaf as one card holds it) into
        the cut ``model``, strictly, each rank keeping its block of every
        split leaf and buffer (a serving engine's weight swap)."""
        own = model.state_dict()
        if set(own) != set(state):
            raise ValueError(
                f"state_dict keys differ: missing {sorted(set(own) - set(state))}, "
                f"unexpected {sorted(set(state) - set(own))}")
        index = {name: i for i, name in enumerate(self.names)}
        for key, dst in own.items():
            src = state[key].to(dst.device)
            if key in index:
                src = self.block_of(index[key], src)
            elif key in self.buffers:
                src = self.cut(src, *self.buffers[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: this rank's block is {tuple(src.shape)}, "
                                 f"the model holds {tuple(dst.shape)}")
            dst.copy_(src)

    def whole_state_dict(self, model: nn.Module) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` with every leaf whole (a collective)."""
        whole = dict(zip(self.names, self.whole(self.masters)))
        return {k: whole.get(k, v) for k, v in model.state_dict().items()}


def shard_train_state(mesh, state, param_specs: Mapping[str, P], opt_specs=None):
    """Place a replicated ``core.state.TrainState`` on the mesh by
    ``param_specs`` (port layout, by parameter name; JAX's
    ``shard_train_state``): specs over ``model`` give each model rank its
    blocks and their moments (:class:`TPPlan`); specs over ``data`` alone
    are ZeRO-3's (``fsdp.shard_train_state``).  Both at once (fsdp beside
    tp: ``make_fsdp_specs(base_rule=megatron_rule(tp))``'s
    ``P("data", "model")`` leaves), or ``opt_specs`` beside tp
    (``make_fsdp_opt_specs``), cut the model to its tp blocks and put a
    ``fsdp.ShardPlan`` over them on the data group."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import fsdp

    axes = {ax for spec in param_specs.values() for ax in spec if ax is not None}
    if "model" not in axes:
        return fsdp.shard_train_state(mesh, state, param_specs, opt_specs=opt_specs)
    blocks = TPPlan.shard(mesh, state.model, param_specs)
    if axes == {"model"} and opt_specs is None:
        blocks.adopt(state)
        return state
    fsdp.ShardPlan.build(mesh, state.model, param_specs, opt_specs=opt_specs,
                         tp=blocks).adopt(state)
    return state


def _tp_state(mesh, state, param_specs, opt_specs=None):
    if getattr(state, "plan", None) is None:
        shard_train_state(mesh, state, param_specs, opt_specs)
    return state.plan


def make_tp_train_step(model, tx, mesh, param_specs, state, data_axis: str = "data",
                       label_smoothing: float = 0.0, fused_xent: bool = False,
                       remat: bool = False, grad_accum: int = 1, opt_specs=None):
    """One step under dp x tp (x sp): ``step(state, batch) -> metrics`` with
    ``batch`` the same global batch on every rank; data row ``d`` trains on
    its block of rows, every model rank of the row on the same rows, and
    ``loss`` / ``accuracy`` are the means across ranks, as JAX's step
    returns them.  ``state`` is sharded here when it is not yet
    (:func:`shard_train_state`); ``tx`` and ``data_axis`` are kept for
    JAX's signature (the update is ``state.optimizer``'s)."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import make_train_step
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
        all_reduce_mean,
    )

    del tx, data_axis
    plan = _tp_state(mesh, state, param_specs, opt_specs)
    step = make_train_step(model, state.optimizer, label_smoothing=label_smoothing,
                           fused_xent=fused_xent, remat=remat, grad_accum=grad_accum,
                           plan=plan)
    dp = mesh.shape["data"]

    def tp_step(st, batch: dict) -> dict:
        n = batch["label"].shape[0]
        if n % dp:
            raise ValueError(f"global batch {n} not divisible by dp={dp}")
        per, d = n // dp, mesh.data_index
        m = step(st, {k: v[d * per:(d + 1) * per] for k, v in batch.items()})
        loss, accuracy = all_reduce_mean(torch.stack([m["loss"], m["accuracy"]]))
        return {"loss": loss, "accuracy": accuracy}

    return tp_step


def make_tp_epoch_runner(model, tx, mesh, param_specs, state, batch_size: int,
                         data_axis: str = "data", label_smoothing: float = 0.0,
                         fused_xent: bool = False, remat: bool = False, grad_accum: int = 1,
                         img_ndim: int = 4, opt_specs=None):
    """The Trainer's tp path: an epoch as JAX's GSPMD epoch runs it (one
    permutation of the whole set, data row ``d`` on its block of every
    global batch, ``data_parallel.make_global_epoch_runner``) on the
    state's :class:`TPPlan` (a ``fsdp.ShardPlan`` over it under fsdp or
    ``opt_specs``).  ``run_epoch(state, images, labels,
    perm=None)`` returns this rank's per-step metrics stacked."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
        make_global_epoch_runner,
    )

    del tx, data_axis, img_ndim
    plan = _tp_state(mesh, state, param_specs, opt_specs)
    return make_global_epoch_runner(model, state.optimizer, batch_size, mesh, plan=plan,
                                    label_smoothing=label_smoothing, fused_xent=fused_xent,
                                    remat=remat, grad_accum=grad_accum)


# ---------------------------------------------------------------------------
# The serving half (JAX's tensor_parallel.py:296-457).  Every cache slab,
# dense ``(slots, max_len, H_kv, D)`` rows and paged ``(n_pages, page_size,
# H_kv, D)`` pools alike, splits over its HEAD axis, the decode analog of
# splitting the kv projection's output features; cursors and block tables
# stay whole on every rank: the host's page allocator (serving/kv_pool.py)
# works in whole pages and never sees the head axis, so allocation is the
# same at any tp.
# ---------------------------------------------------------------------------

# cache leaves with a head axis (dim 2 of the 4-D slabs); an int8 cache's
# float32 scales carry it last
_KV_HEAD_LEAVES = ("k", "v", "pages_k", "pages_v")
_KV_SCALE_LEAVES = ("k_scale", "v_scale", "pages_k_scale", "pages_v_scale")
# the model group's timeout (seconds) by default: a follower that stops
# answering fails the leader's next collective no later than this
SERVING_TIMEOUT_S = 300.0


def kv_cache_rule(n_shards: int, axis: str = "tp", cp: int = 1, cp_axis: str = "cp"
                  ) -> SpecRule:
    """Spec rule for a decode cache (JAX's ``kv_cache_rule``,
    ``tensor_parallel.py:313-367``): the K/V slabs split over their head
    axis, dense ``k``/``v`` ``(B, max_len, H_kv, D)`` and paged
    ``pages_k``/``pages_v`` ``(n_pages, page_size, H_kv, D)`` alike, and
    their int8 ``*_scale`` companions over their last (head) axis;
    everything else (cursors, block tables) whole.  With ``cp > 1`` a
    ``pages_*`` leaf also splits its page dim 0 over ``cp_axis`` and a dense
    slab its position dim 1.  A dim that does not divide degrades to whole,
    as JAX's rule does (the engine refuses such a tp or cp first)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")

    def rule(path: tuple[str, ...], leaf) -> P:
        name = path[-1] if path else ""
        shape = getattr(leaf, "shape", ())
        if not ((name in _KV_HEAD_LEAVES and len(shape) == 4)
                or (name in _KV_SCALE_LEAVES and len(shape) == 3)):
            return P()
        head = axis if shape[2] % n_shards == 0 else None
        tail = (None,) if len(shape) == 4 else ()
        if cp > 1 and name.startswith("pages_"):
            spec = P(cp_axis if shape[0] % cp == 0 else None, None, head, *tail)
        elif cp > 1:
            spec = P(None, cp_axis if shape[1] % cp == 0 else None, head, *tail)
        else:
            spec = P(None, None, head, *tail)
        return spec if any(a is not None for a in spec) else P()

    return rule


def rank_cache_shape(model, leaf: str, shape: Sequence[int]) -> tuple[int, ...]:
    """The shape of decode-cache leaf ``leaf`` (whole ``shape``) on this
    rank: whole, or its :func:`kv_cache_rule` block for a model cut by
    ``TPPlan.shard`` (this rank's heads) or served over a cp mesh (a
    serving engine's ``model.cp_mesh``: this cp row's pages)."""
    tp_mesh, cp_mesh = getattr(model, "tp_mesh", None), getattr(model, "cp_mesh", None)
    n = 1 if tp_mesh is None else tp_mesh.model_size
    cp = 1 if cp_mesh is None else cp_mesh.seq_size
    if n == 1 and cp == 1:
        return tuple(shape)
    spec = kv_cache_rule(n, cp=cp)((leaf,), Leaf(shape))
    size = {"tp": n, "cp": cp}
    return tuple(d // size[spec[i]] if i < len(spec) and spec[i] is not None else d
                 for i, d in enumerate(shape))


def kv_whole_bytes(tree, n: int) -> int:
    """Bytes of a decode cache or prefill row ``tree`` of this rank's heads,
    counted whole (what JAX's ``nbytes`` reads of a global array): every
    head-split leaf ``n`` times, the rest once."""
    return sum(leaf.nbytes * (n if path[-1] in _KV_HEAD_LEAVES + _KV_SCALE_LEAVES else 1)
               for path, leaf in _tree_leaves(tree))


def serving_mesh(tp: int, devices: Sequence[int] | None = None, cp: int = 1,
                 timeout_s: float = SERVING_TIMEOUT_S) -> Mesh | None:
    """The serving mesh of one engine (JAX's ``serving_mesh``,
    ``tensor_parallel.py:370-399``, over ranks where JAX has devices): a
    ``(cp, tp)`` grid over ``devices``, the global ranks in JAX's row-major
    order (cp row ``r`` holds ``devices[r * tp:(r + 1) * tp]``; default the
    first ``cp * tp`` ranks), the first the engine's leader.  A collective
    over the whole process group: every rank calls it, in the same order,
    member or not (``dist.new_group``).  It builds gloo groups over the
    ranks: a model group per cp row, which Megatron's collectives run on,
    and a cp group per model index, which the ring prefill's hops and the
    decode's merge run on, each with a timeout of ``timeout_s`` (a follower
    that stops answering fails the leader's next collective within it), and
    the control group over all ``cp * tp`` ranks, which the leader sends
    its step records on (a timeout of days: an idle follower waits there).
    Returns this rank's mesh, or None on a rank outside ``devices``: its
    ``shape`` is ``{"model": tp, "seq": cp}`` (``model_index`` and
    ``seq_index`` are this rank's column and cp row; ``rank`` is the grid
    rank ``model_index * cp + seq_index``, 0 on the leader) and ``ranks``
    is ``devices``.  At ``tp = cp = 1`` it builds no group and needs
    none."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    shape = {"data": 1, "model": tp, "seq": cp, "pipe": 1}
    need = tp * cp
    if need == 1 and devices is None:
        return Mesh(shape=shape, rank=0)
    what = f"tp={tp}" if cp == 1 else f"tp={tp}, cp={cp}"
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"serving_mesh({what})")
    world = dist.get_world_size()
    ranks = list(range(need)) if devices is None else [int(r) for r in devices]
    if len(ranks) != need or len(set(ranks)) != need or not all(0 <= r < world for r in ranks):
        raise ValueError(
            f"serving_mesh({what}) needs exactly {need} distinct ranks of the process "
            f"group, got {ranks} (of {world} ranks) — start the ranks with "
            "launch.torchrun")
    timeout = datetime.timedelta(seconds=timeout_s)
    # every rank builds every group in this order: the model groups (one a
    # cp row), the cp groups (one a model index), then the control group
    rows = [dist.new_group(ranks[r * tp:(r + 1) * tp], timeout=timeout) if tp > 1 else None
            for r in range(cp)]
    cols = [dist.new_group(ranks[m::tp], timeout=timeout) if cp > 1 else None
            for m in range(tp)]
    control = (dist.new_group(ranks, timeout=datetime.timedelta(days=7)) if need > 1
               else None)
    me = dist.get_rank()
    if me not in ranks:
        return None
    row, col = divmod(ranks.index(me), tp)
    return Mesh(shape=shape, rank=col * cp + row, ranks=tuple(ranks),
                model_group=rows[row], seq_group=cols[col], control_group=control)


def tp_device_groups(n_groups: int, tp: int, devices: Sequence[int] | None = None,
                     cp: int = 1, leader: int | None = None) -> list[list[int]]:
    """Partition ``devices`` (ranks; default every rank of the process group)
    into ``n_groups`` groups of ``cp * tp`` (JAX's ``tp_device_groups``,
    ``tensor_parallel.py:402-426``): replica ``i`` of a router builds its
    engine on group ``i``, which :func:`serving_mesh` lays out row-major
    (the first ``tp`` ranks are cp row 0).  JAX's groups are disjoint
    slices; with ``leader=r`` each group is ``[r]`` followed by ``cp * tp -
    1`` followers disjoint from every other group's: the router's process
    holds every replica's leader (``[[0, 1], [0, 2]]`` for 2 groups of 2),
    since a port rank is a process and the router drives each replica's
    leader in its own."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise no_group_error(f"tp_device_groups({n_groups}, {tp})")
        devices = range(dist.get_world_size())
    ranks = [int(r) for r in devices]
    per = cp * tp
    what = (f"tp_device_groups({n_groups}, {tp})" if cp == 1
            else f"tp_device_groups({n_groups}, {tp}, cp={cp})")
    if leader is None:
        need = n_groups * per
        if len(ranks) < need:
            raise ValueError(
                f"{what} needs {need} devices (= groups x cp x tp), got {len(ranks)}")
        return [ranks[i * per:(i + 1) * per] for i in range(n_groups)]
    if leader not in ranks:
        raise ValueError(f"the leader rank {leader} is not among {ranks}")
    rest = [r for r in ranks if r != leader]
    per -= 1
    if len(rest) < n_groups * per:
        raise ValueError(
            f"{what[:-1]}, leader={leader}) needs {1 + n_groups * per} ranks (= one "
            f"leader + groups x (cp x tp - 1) followers), got {len(ranks)}")
    return [[leader] + rest[i * per:(i + 1) * per] for i in range(n_groups)]


def per_chip_bytes(tree, device=None) -> int:
    """Bytes of ``tree`` resident on this rank (JAX's ``per_chip_bytes``,
    ``tensor_parallel.py:437-456``): a rank holds its own blocks (its heads
    and, under cp, its cp row's page range of a pool), so every tensor leaf
    counts whole (with ``device``, only those on it); host
    (numpy) leaves count whole."""
    dev = None if device is None else torch.device(device)
    total = 0
    for _, leaf in _tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if dev is None or leaf.device == dev:
                total += leaf.nbytes
        else:
            total += int(getattr(leaf, "nbytes", 0))
    return total


__all__ = ["Leaf", "P", "SpecRule", "TPPlan", "chain_rules", "column", "conv2d",
           "embedding", "flax_shape_tree", "head_major_order",
           "kv_cache_rule", "kv_whole_bytes", "linear", "make_param_specs",
           "rank_cache_shape",
           "make_tp_epoch_runner", "make_tp_train_step", "megatron_dense_rule",
           "megatron_rule", "model_param_specs", "per_chip_bytes", "row", "serving_mesh",
           "shard_dim", "shard_train_state", "specs_like", "tied_head", "tp_device_groups"]
