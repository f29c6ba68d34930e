"""The mesh of the port: one rank per process over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py`` ``make_mesh``.
JAX lays the visible devices out on a ``(data, model, seq, pipe)`` grid;
the port lays its ranks (each one process, one device) out on the same
grid with ``data`` outermost, so rank ``r`` sits at ``data_index = r //
sp`` and ``seq_index = r % sp``, and ``dp * sp`` is the world size.  Under
``sp > 1`` each axis has its own process group: the ``seq`` group of a
rank holds the ranks of its data row (the ring's hops and Ulysses'
all-to-alls run there), the ``data`` group the ranks at its seq index.
Every rank builds every group, in the same order (``dist.new_group`` is
collective).  ``model`` and ``pipe`` are refused by name until their
ROADMAP.md item ports them.

Multislice (``dcn_dp=N``, JAX's hybrid ICI x DCN mesh): the group must
span N nodes with dp/N ranks each.  A rank's node is its host name,
gathered from every rank (:func:`rank_records`; its ``slice_index`` is the
node's place in rank order), or records a caller passes, as JAX's tests
pass mock devices.  :func:`hybrid_mesh_shapes` and
:func:`pick_multislice_devices` are JAX's, over those records; the mesh
records the node-major rank order and the ``(dp/N, N)`` ici/dcn factors.
The data axis's collectives stay the flat ones over the whole group: NCCL
picks its own rings across nodes, as XLA does over JAX's hybrid mesh.

The models that take JAX's ``axis_name="data"`` (cross-replica
BatchNorm) resolve it when they are built (:func:`axis_mesh`) to the mesh
over the initialised default group; with no group they raise.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any

import torch.distributed as dist

_PARALLEL = "ROADMAP.md queue 1, 'Remaining parallelism and utilities'"


def no_group_error(what: str) -> ValueError:
    return ValueError(
        f"{what} needs an initialised torch.distributed process group: start "
        "the ranks with launch.torchrun (bootstrap(), spawn(), or the torchrun "
        "command) first")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, seq)`` grid over the default process group and this
    process's rank in it.  ``data_group`` / ``seq_group`` are the axes'
    process groups; None means the default group for ``data`` (sp = 1:
    the data axis is the whole group) and no group for ``seq`` (sp = 1:
    a seq axis of one rank, which exchanges nothing)."""

    shape: dict[str, int]
    rank: int
    dcn_dp: int = 1  # nodes the data axis spans (multislice)
    ici_shape: tuple[int, ...] = ()  # (data, model, seq, pipe) within a node
    dcn_shape: tuple[int, ...] = ()  # the same factors across nodes
    order: tuple[int, ...] = ()  # ranks in node-major order
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    seq_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        """Ranks along the data axis (dp)."""
        return self.shape["data"]

    @property
    def seq_size(self) -> int:
        """Ranks along the seq axis (sp)."""
        return self.shape["seq"]

    @property
    def data_index(self) -> int:
        """This rank's place along the data axis: the rows it trains on."""
        return self.rank // self.shape["seq"]

    @property
    def seq_index(self) -> int:
        """This rank's place along the seq axis: the token slice it holds."""
        return self.rank % self.shape["seq"]


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


def _axis_groups(dp: int, sp: int, rank: int) -> tuple:
    """``(data_group, seq_group)`` of ``rank`` on a ``(dp, sp)`` grid: one
    new group per data row (its sp ranks) and per seq column (its dp
    ranks), built on every rank in the same order."""
    data_group = seq_group = None
    for d in range(dp):
        g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
        if rank // sp == d:
            seq_group = g
    for s in range(sp):
        g = dist.new_group(list(range(s, dp * sp, sp)))
        if rank % sp == s:
            data_group = g
    return data_group, seq_group


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1,
              dcn_dp: int = 1, devices: list | None = None) -> Mesh:
    """The ``(data, seq)`` mesh over the initialised default process group.

    ``dp=None`` (or 0) is the world size over ``sp``, as JAX gives the
    data axis the devices the other axes leave; ``dp * sp`` must equal the
    world size (one rank per process).  ``sp > 1`` builds the two axes'
    process groups (module docstring).  ``tp`` and ``pp`` above 1 raise
    ``NotImplementedError``.  ``dcn_dp > 1`` is multislice (module
    docstring), at ``sp = 1`` only: ``devices`` are the group's rank
    records in rank order (default :func:`rank_records`); ``ValueError``
    unless they span ``dcn_dp`` slices of ``dp / dcn_dp`` ranks each, laid
    out node-major (ranks of a node contiguous, as torchrun numbers them)."""
    if dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {dcn_dp}")
    for name, n in (("tp", tp), ("pp", pp)):
        if n > 1:
            raise NotImplementedError(
                f"{name}={n} is not ported to the PyTorch package yet: {_PARALLEL}")
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if dcn_dp > 1 and sp > 1:
        raise NotImplementedError(
            f"dcn_dp={dcn_dp} with sp={sp} (a multislice data axis beside a seq "
            f"axis) is not ported to the PyTorch package yet: {_PARALLEL}")
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"make_mesh(dp={dp}, sp={sp})" if sp > 1
                             else f"make_mesh(dp={dp})")
    world = dist.get_world_size()
    if dp is None or dp == 0:
        dp = world // sp
        if dp == 0:
            raise ValueError(
                f"tp*sp*pp={sp} exceeds device count {world}; no room for a data axis")
    if dp * sp != world:
        what, axes = (f"dp={dp}", "dp") if sp == 1 else (f"dp={dp} x sp={sp}", "dp x sp")
        raise ValueError(
            f"{what} but the process group has {world} rank(s): the port runs "
            f"one rank per process, so {axes} must equal the world size")
    shape = {"data": dp, "model": 1, "seq": sp, "pipe": 1}
    rank = dist.get_rank()
    if sp > 1:
        data_group, seq_group = _axis_groups(dp, sp, rank)
        return Mesh(shape=shape, rank=rank, data_group=data_group, seq_group=seq_group)
    if dcn_dp == 1:
        return Mesh(shape=shape, rank=rank)
    ici, dcn = hybrid_mesh_shapes(dp, tp, sp, pp, dcn_dp)
    records = list(devices) if devices is not None else rank_records()
    if len(records) != world:
        raise ValueError(f"{len(records)} rank records for a group of {world}")
    chosen = pick_multislice_devices(records, dcn_dp, dp // dcn_dp)
    order = tuple(r.rank for r in chosen)
    if order != tuple(range(world)):
        raise ValueError(
            f"dcn_dp={dcn_dp}: the ranks are not node-major (node-major order "
            f"{list(order)}); number each node's ranks contiguously, as torchrun does")
    return Mesh(shape=shape, rank=rank, dcn_dp=dcn_dp, ici_shape=ici,
                dcn_shape=dcn, order=order)


def axis_mesh(axis_name: str) -> Mesh:
    """The mesh a model's ``axis_name`` names: the one over the default
    group; ``ValueError`` without a group."""
    if axis_name != "data":
        raise ValueError(f"unknown mesh axis {axis_name!r}: the port's mesh has 'data'")
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"axis_name={axis_name!r} (cross-replica reduction)")
    return make_mesh()
