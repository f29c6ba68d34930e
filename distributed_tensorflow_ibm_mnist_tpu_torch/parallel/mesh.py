"""The mesh of the port: one rank per process over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py`` ``make_mesh``.
JAX lays the visible devices out on a ``(data, model, seq, pipe)`` grid;
the port lays its ranks (each one process, one device) out on the same
grid in the same order, ``data`` outermost and ``pipe`` innermost, so rank
``r = ((d * tp + m) * sp + s) * pp + p`` sits at ``data_index = d``,
``model_index = m``, ``seq_index = s`` and ``pipe_index = p``, and ``dp *
tp * sp * pp`` is the world size (at pp = 1 every rank keeps the index
``(d * tp + m) * sp + s`` it had before the pipe axis).  Each axis of more
than one rank has its own process group: the ``seq`` group of a rank holds
the ranks that differ from it in ``s`` only (the ring's hops and Ulysses'
all-to-alls run there), the ``model`` group those that differ in ``m`` only
(Megatron's mappings, ``parallel/collectives.py``), the ``pipe`` group
those that differ in ``p`` only (the pipeline's stage hand-offs and its
output broadcast, ``parallel/pipeline.py``), the ``data`` group those that
differ in ``d`` only (cross-replica BatchNorm, eval's sums); the
``replica`` group holds the ``dp * sp`` ranks of one ``(model_index,
pipe_index)``, which hold the same blocks of the weights and average their
gradients.  Every rank builds every group, in the same order
(``dist.new_group`` is collective, and a group built out of order
deadlocks).

Multislice (``dcn_dp=N``, JAX's hybrid ICI x DCN mesh), beside any tp,
sp and pp: only the data axis spans nodes, so the group must span N nodes
with ``(dp/N) * tp * sp * pp`` ranks each (``data`` is outermost in the
rank order, so a node holds that many consecutive ranks).  A rank's node
is its host name, gathered from every rank (:func:`rank_records`; its
``slice_index`` is the node's place in rank order), or records a caller
passes, as JAX's tests pass mock devices.  :func:`hybrid_mesh_shapes` and
:func:`pick_multislice_devices` are JAX's, over those records; the mesh
records the node-major rank order and the ``(dp/N, tp, sp, pp)`` /
``(N, 1, 1, 1)`` ici/dcn factors; on node-major records no model, seq or
pipe group crosses a node (:func:`node_crossings` reads which do).
The data axis's collectives stay the flat ones over its group: NCCL
picks its own rings across nodes, as XLA does over JAX's hybrid mesh.

The models that take JAX's ``axis_name="data"`` (cross-replica
BatchNorm) resolve it when they are built (:func:`axis_mesh`) to the mesh
:func:`make_mesh` built last in this process (over the initialised default
group when none was built); with no group they raise.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any

import torch.distributed as dist

def no_group_error(what: str) -> ValueError:
    return ValueError(
        f"{what} needs an initialised torch.distributed process group: start "
        "the ranks with launch.torchrun (bootstrap(), spawn(), or the torchrun "
        "command) first")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model, seq, pipe)`` grid over the default process group
    and this process's rank in it.  ``data_group`` / ``model_group`` /
    ``seq_group`` / ``pipe_group`` / ``replica_group`` are the axes'
    process groups (module docstring).  None means the default group for
    ``data`` (tp = sp = pp = 1: the data axis is the whole group) and for
    ``replica`` (tp = pp = 1: every rank holds the same weights), and no
    group for ``model``, ``seq`` and ``pipe`` (an axis of one rank, which
    exchanges nothing)."""

    shape: dict[str, int]
    rank: int
    dcn_dp: int = 1  # nodes the data axis spans (multislice)
    ici_shape: tuple[int, ...] = ()  # (data, model, seq, pipe) within a node
    dcn_shape: tuple[int, ...] = ()  # the same factors across nodes
    order: tuple[int, ...] = ()  # ranks in node-major order
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    seq_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    replica_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    pipe_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    # a serving mesh (parallel/tensor_parallel.serving_mesh): the global ranks
    # of its model axis in order (``rank`` is this process's place among
    # them), the group the engine's leader sends its step records on, and
    # the model group's failures (a collective that timed out, a follower
    # that raised): once one is recorded, no engine is built on the mesh
    ranks: tuple[int, ...] = ()
    control_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    failed: list = dataclasses.field(default_factory=list, compare=False, repr=False)

    @property
    def size(self) -> int:
        """Ranks along the data axis (dp)."""
        return self.shape["data"]

    @property
    def seq_size(self) -> int:
        """Ranks along the seq axis (sp)."""
        return self.shape["seq"]

    @property
    def model_size(self) -> int:
        """Ranks along the model axis (tp)."""
        return self.shape["model"]

    @property
    def pipe_size(self) -> int:
        """Ranks along the pipe axis (pp)."""
        return self.shape["pipe"]

    @property
    def data_index(self) -> int:
        """This rank's place along the data axis: the rows it trains on."""
        return self.rank // (self.shape["model"] * self.shape["seq"] * self.shape["pipe"])

    @property
    def model_index(self) -> int:
        """This rank's place along the model axis: the block of each split
        leaf it holds."""
        return (self.rank // (self.shape["seq"] * self.shape["pipe"])) % self.shape["model"]

    @property
    def pipe_index(self) -> int:
        """This rank's place along the pipe axis: the pipeline stage whose
        blocks it holds and runs."""
        return self.rank % self.shape["pipe"]

    @property
    def replica_index(self) -> int:
        """This rank's place among the ``dp * sp`` ranks of its model index
        (``data_index * sp + seq_index``; the rank itself at tp = 1): what
        its random streams are keyed by, so the ranks of a model group draw
        the same ones."""
        return self.data_index * self.shape["seq"] + self.seq_index

    @property
    def seq_index(self) -> int:
        """This rank's place along the seq axis: the token slice it holds."""
        return (self.rank // self.shape["pipe"]) % self.shape["seq"]

    def group_ranks(self, group: str) -> list[list[int]]:
        """The ranks of every group of axis group ``group`` (``"model_group"``,
        ``"data_group"``, ...), in the order every rank builds them."""
        return _axis_members(self.shape["data"], self.shape["model"], self.shape["seq"],
                             self.shape["pipe"])[group]


def hybrid_mesh_shapes(dp: int, tp: int, sp: int, pp: int, dcn_dp: int
                       ) -> tuple[tuple[int, int, int, int], tuple[int, int, int, int]]:
    """Split a (data, model, seq, pipe) request into the within-node (ICI)
    and cross-node (DCN) factors: only the data axis spans nodes, so
    ``dcn_dp`` must divide ``dp``."""
    if dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {dcn_dp}")
    if dp % dcn_dp:
        raise ValueError(
            f"dcn_dp ({dcn_dp}) must divide dp ({dp}): the data axis factors "
            "as (cross-slice x within-slice)")
    return (dp // dcn_dp, tp, sp, pp), (dcn_dp, 1, 1, 1)


def pick_multislice_devices(devices: list, dcn_dp: int, per_slice: int) -> list:
    """``per_slice`` records from EACH of ``dcn_dp`` slices, slice-major:
    grouped by ``slice_index`` (None never counts), ``ValueError`` naming
    the slices found when fewer than ``dcn_dp`` hold ``per_slice`` each."""
    groups: dict = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", None), []).append(d)
    usable = sorted(s for s, g in groups.items() if s is not None and len(g) >= per_slice)
    if len(usable) < dcn_dp:
        found = sorted(s for s in groups if s is not None)
        raise ValueError(
            f"dcn_dp={dcn_dp} needs {dcn_dp} slices (nodes) with >= {per_slice} "
            f"ranks each (found slice indices {found or 'none'}); a multislice "
            "run spans that many nodes of the process group")
    return [d for s in usable[:dcn_dp] for d in groups[s][:per_slice]]


@dataclasses.dataclass(frozen=True)
class RankRecord:
    """One rank as the multislice selection sees it: its rank, host and
    ``slice_index`` (the node's place among the group's nodes)."""

    rank: int
    host: str
    slice_index: int | None


def rank_records() -> list[RankRecord]:
    """Every rank's record, in rank order (a collective): the slice is the
    rank's node, numbered by first appearance in rank order."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    index: dict[str, int] = {}
    return [RankRecord(r, h, index.setdefault(h, len(index))) for r, h in enumerate(hosts)]


def _axis_members(dp: int, tp: int, sp: int, pp: int = 1) -> dict:
    """The members of every group of each axis of a ``(dp, tp, sp, pp)``
    grid (``{"data_group": [[rank, ...], ...], ...}``), each axis's groups
    in the order every rank builds them."""
    def at(d, m, s, p):
        return ((d * tp + m) * sp + s) * pp + p

    pipes = range(pp)
    return {
        "seq_group": [[at(d, m, s, p) for s in range(sp)]
                      for d in range(dp) for m in range(tp) for p in pipes],
        "data_group": [[at(d, m, s, p) for d in range(dp)]
                       for m in range(tp) for s in range(sp) for p in pipes],
        "model_group": [[at(d, m, s, p) for m in range(tp)]
                        for d in range(dp) for s in range(sp) for p in pipes],
        "replica_group": [[at(d, m, s, p) for d in range(dp) for s in range(sp)]
                          for m in range(tp) for p in pipes],
        "pipe_group": [[at(d, m, s, p) for p in pipes]
                       for d in range(dp) for m in range(tp) for s in range(sp)],
    }


def node_crossings(records: list, dp: int, tp: int = 1, sp: int = 1, pp: int = 1
                   ) -> dict[str, list[list[int]]]:
    """The groups of each axis of a ``(dp, tp, sp, pp)`` grid whose ranks
    sit on more than one node, by ``records`` (one a rank, in rank order,
    each with a ``slice_index``): ``{"data_group": [...], ...}``.  On a
    multislice mesh's node-major records only the data groups (and the
    replica groups, which hold them) cross."""
    node = [getattr(r, "slice_index", None) for r in records]
    return {name: [g for g in groups if len({node[r] for r in g}) > 1]
            for name, groups in _axis_members(dp, tp, sp, pp).items()}


def _axis_groups(dp: int, tp: int, sp: int, rank: int, pp: int = 1) -> dict:
    """This rank's process group of each axis of a ``(dp, tp, sp, pp)`` grid
    (``{"data_group": ..., ...}``; an axis of one rank, or the whole world,
    gets none).  Every rank builds every group, in one fixed order: the
    seq groups, the data groups, the model groups, the replica groups, the
    pipe groups (at pp = 1 the order and the groups of a ``(dp, tp, sp)``
    grid)."""
    members = _axis_members(dp, tp, sp, pp)
    built = {"seq_group": sp > 1, "data_group": tp > 1 or sp > 1 or pp > 1,
             "model_group": tp > 1, "replica_group": tp > 1 or pp > 1,
             "pipe_group": pp > 1}
    mine: dict = {}
    for name, on in built.items():
        if not on:
            continue
        for group in members[name]:
            g = dist.new_group(group)
            if rank in group:
                mine[name] = g
    return mine


_CURRENT: list = [None]  # the mesh make_mesh built last in this process


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1,
              dcn_dp: int = 1, devices: list | None = None) -> Mesh:
    """The ``(data, model, seq, pipe)`` mesh over the initialised default
    process group.

    ``dp=None`` (or 0) is the world size over ``tp * sp * pp``, as JAX gives
    the data axis the devices the other axes leave; ``dp * tp * sp * pp``
    must equal the world size (one rank per process).  ``tp``, ``sp`` or
    ``pp`` above 1 builds the axes' process groups (module docstring).
    ``dcn_dp > 1`` is multislice (module docstring), beside any tp, sp
    and pp: ``devices`` are the group's rank records in rank order
    (default :func:`rank_records`); ``ValueError`` unless they span
    ``dcn_dp`` slices of ``(dp / dcn_dp) * tp * sp * pp`` ranks each, laid
    out node-major (ranks of a node contiguous, as torchrun numbers them).
    The mesh becomes the one :func:`axis_mesh` returns."""
    if dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {dcn_dp}")
    axes_in = (("tp", tp), ("sp", sp), ("pp", pp))
    for name, n in axes_in:
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if not (dist.is_available() and dist.is_initialized()):
        axes = "".join(f", {k}={v}" for k, v in axes_in if v > 1)
        raise no_group_error(f"make_mesh(dp={dp}{axes})")
    world = dist.get_world_size()
    inner = tp * sp * pp
    if dp is None or dp == 0:
        dp = world // inner
        if dp == 0:
            raise ValueError(
                f"tp*sp*pp={inner} exceeds device count {world}; no room for a data axis")
    if dp * inner != world:
        parts = [f"dp={dp}"] + [f"{k}={v}" for k, v in axes_in if v > 1]
        axes = " x ".join(p.split("=")[0] for p in parts)
        raise ValueError(
            f"{' x '.join(parts)} but the process group has {world} rank(s): the port "
            f"runs one rank per process, so {axes} must equal the world size")
    shape = {"data": dp, "model": tp, "seq": sp, "pipe": pp}
    rank = dist.get_rank()
    slices: dict = {}
    if dcn_dp > 1:
        ici, dcn = hybrid_mesh_shapes(dp, tp, sp, pp, dcn_dp)
        records = list(devices) if devices is not None else rank_records()
        if len(records) != world:
            raise ValueError(f"{len(records)} rank records for a group of {world}")
        chosen = pick_multislice_devices(records, dcn_dp, (dp // dcn_dp) * inner)
        order = tuple(r.rank for r in chosen)
        if order != tuple(range(world)):
            raise ValueError(
                f"dcn_dp={dcn_dp}: the ranks are not node-major (node-major order "
                f"{list(order)}); number each node's ranks contiguously, as torchrun does")
        slices = dict(dcn_dp=dcn_dp, ici_shape=ici, dcn_shape=dcn, order=order)
    groups = _axis_groups(dp, tp, sp, rank, pp) if inner > 1 else {}
    mesh = Mesh(shape=shape, rank=rank, **slices, **groups)
    _CURRENT[0] = mesh
    return mesh


def axis_mesh(axis_name: str) -> Mesh:
    """The mesh a model's ``axis_name`` names: the one :func:`make_mesh`
    built last (its ``data_group`` is the axis), or, when none was built,
    one over the default group; ``ValueError`` without a group."""
    if axis_name != "data":
        raise ValueError(f"unknown mesh axis {axis_name!r}: the port's mesh has 'data'")
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"axis_name={axis_name!r} (cross-replica reduction)")
    current = _CURRENT[0]
    if current is not None and current.rank == dist.get_rank() and (
            current.shape["data"] * current.shape["model"] * current.shape["seq"]
            * current.shape["pipe"] == dist.get_world_size()):
        return current
    return make_mesh()
