"""The data mesh of the port: one rank per process over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py`` ``make_mesh``.
JAX lays the visible devices out on a ``(data, model, seq, pipe)`` grid;
the port has one axis, ``data``, whose size is the process group's world
size (each rank one process, one device).  The other axes and multislice
(``dcn_dp``) are refused by name until their ROADMAP.md items port them.

The models that take JAX's ``axis_name="data"`` (cross-replica
BatchNorm) resolve it when they are built (:func:`axis_mesh`) to the mesh
over the initialised default group; with no group they raise.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

_DP = "ROADMAP.md queue 1, 'Data-parallel training with torch.distributed'"
_PARALLEL = "ROADMAP.md queue 1, 'Remaining parallelism and utilities'"


def no_group_error(what: str) -> ValueError:
    return ValueError(
        f"{what} needs an initialised torch.distributed process group: start "
        "the ranks with launch.torchrun (bootstrap(), spawn(), or the torchrun "
        "command) first")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``data`` axis over the default process group and this
    process's rank in it."""

    shape: dict[str, int]
    rank: int

    @property
    def size(self) -> int:
        return self.shape["data"]


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1,
              dcn_dp: int = 1) -> Mesh:
    """The ``data`` mesh over the initialised default process group.

    ``dp=None`` (or 0) is the group's world size; any other ``dp`` must
    equal it (one rank per process).  ``tp``, ``sp``, ``pp`` and
    ``dcn_dp`` above 1 raise ``NotImplementedError``."""
    if dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {dcn_dp}")
    if dcn_dp > 1:
        raise NotImplementedError(
            f"dcn_dp={dcn_dp} (multislice) is not ported to the PyTorch package yet: {_DP}")
    for name, n in (("tp", tp), ("sp", sp), ("pp", pp)):
        if n > 1:
            raise NotImplementedError(
                f"{name}={n} is not ported to the PyTorch package yet: {_PARALLEL}")
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"make_mesh(dp={dp})")
    world = dist.get_world_size()
    if dp is None or dp == 0:
        dp = world
    if dp != world:
        raise ValueError(
            f"dp={dp} but the process group has {world} rank(s): the port runs "
            "one rank per process, so dp must equal the world size")
    return Mesh(shape={"data": dp, "model": 1, "seq": 1, "pipe": 1},
                rank=dist.get_rank())


def axis_mesh(axis_name: str) -> Mesh:
    """The mesh a model's ``axis_name`` names: the one over the default
    group; ``ValueError`` without a group."""
    if axis_name != "data":
        raise ValueError(f"unknown mesh axis {axis_name!r}: the port's mesh has 'data'")
    if not (dist.is_available() and dist.is_initialized()):
        raise no_group_error(f"axis_name={axis_name!r} (cross-replica reduction)")
    return make_mesh()
