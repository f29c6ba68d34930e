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
``parallel/fsdp.py`` has the step that runs on it.  The ``model`` axis
(tensor parallelism proper: ``make_tp_train_step``,
``make_tp_epoch_runner``) and the serving half (``kv_cache_rule``,
``serving_mesh``, ``tp_device_groups``, ``per_chip_bytes``) are not ported
yet: each raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import re
from collections.abc import Mapping, Sequence
from typing import Any, Callable

TENSOR_PARALLEL = ("ROADMAP.md queue 1, item 7.1 ('Remaining parallelism and "
                   "utilities': tensor parallelism over the model axis)")


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
    """The one dim ``spec`` splits over ``axis`` (None when it splits none);
    any other axis is tensor parallelism, not ported."""
    for ax in spec:
        if ax is not None and ax != axis:
            raise NotImplementedError(
                f"a spec over the {ax!r} axis ({spec}) needs tensor parallelism: "
                f"{TENSOR_PARALLEL}")
    dims = [i for i, ax in enumerate(spec) if ax == axis]
    return dims[0] if dims else None


def _tp_later(what: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not in the PyTorch port yet ({TENSOR_PARALLEL} ports it)")
    refuse.__name__ = what
    return refuse


make_tp_train_step = _tp_later("make_tp_train_step")
make_tp_epoch_runner = _tp_later("make_tp_epoch_runner")
kv_cache_rule = _tp_later("kv_cache_rule")
serving_mesh = _tp_later("serving_mesh")
tp_device_groups = _tp_later("tp_device_groups")
per_chip_bytes = _tp_later("per_chip_bytes")

__all__ = ["Leaf", "P", "SpecRule", "chain_rules", "flax_shape_tree", "kv_cache_rule",
           "make_param_specs", "make_tp_epoch_runner", "make_tp_train_step",
           "megatron_dense_rule", "megatron_rule", "model_param_specs", "per_chip_bytes",
           "serving_mesh", "shard_dim", "specs_like",
           "tp_device_groups"]
