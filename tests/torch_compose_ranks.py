"""Rank bodies of the port's composed-parallelism tests: fsdp beside tp and
sp (``parallel/fsdp.py``'s ``ShardPlan`` over a data group, under tp over
the model blocks), MoE blocks beside tp and sp (expert parallelism over
the data group, routing over whole sequences), multislice beside tp, sp
and pp (``parallel/mesh.py``), and dropout under sp.

Like ``torch_tp_ranks.py``, this module imports neither JAX nor the JAX
package: ``launch.torchrun.spawn`` imports it in every spawned rank, which
runs the port alone on numpy inputs the tests made (converted JAX states,
JAX's epoch permutations) and returns numpy results for the tests to hold
against JAX's Trainers.  Every rank runs every job of its world in order.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.models import transformer
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import expert_parallel as ep
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import RankRecord, make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from torch_dp_ranks import _error, forbidden_modules


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _whole_params(t: Trainer) -> dict:
    """The run's parameters whole (a collective under a plan)."""
    sd = (t._plan.whole_state_dict(t.model) if t._plan is not None
          else t.model.state_dict())
    return {k: _np(v) for k, v in sd.items()}


def _layout(t: Trainer) -> dict:
    """What this rank holds: each leaf's kind, the fraction of its whole
    elements in this rank's master and the bytes of its module parameter
    while gathered (the model block under tp), and the plan's resident
    bytes."""
    plan = t._plan
    whole = getattr(plan, "whole_shapes", plan.shapes)
    return {"kinds": dict(zip(plan.names, getattr(plan, "kinds", ["tp"] * len(plan.names)))),
            "fraction": {n: m.numel() / float(np.prod(s))
                         for n, m, s in zip(plan.names, plan.masters, whole)},
            "resident_bytes": plan.resident_bytes(),
            "block_bytes": {n: int(np.prod(s)) * p.element_size()
                            for n, s, p in zip(plan.names, plan.shapes, plan.params)}}


@contextlib.contextmanager
def _moe_inputs(log: list):
    """Each MoE block's input, as this rank's block receives it, appended to
    ``log`` (the first call of every block)."""
    real = ep.MoEBlock.forward

    def forward(self, x, seq_group=None):
        log.append(_np(x))
        return real(self, x, seq_group=seq_group)

    ep.MoEBlock.forward = forward
    try:
        yield
    finally:
        ep.MoEBlock.forward = real


@contextlib.contextmanager
def _local_routing():
    """A planted fault: a sequence-parallel MoE block routes its own slice
    only (rank-local capacity and slot offsets), never the whole sequence."""
    real = ep.MoEBlock.forward

    def forward(self, x, seq_group=None):
        return real(self, x, seq_group=None)

    ep.MoEBlock.forward = forward
    try:
        yield
    finally:
        ep.MoEBlock.forward = real


def _epochs(job: dict, mesh=None) -> dict:
    """A Trainer on ``job["config"]`` (the JAX state's form loaded when
    given) running one epoch a permutation of ``job["perms"]`` (JAX's epoch
    permutations): the per-step losses averaged over every rank (JAX's
    step loss), the dropped fractions, the whole parameters and the
    layout."""
    cfg = RunConfig(**job["config"])
    log: list = []
    fault = _local_routing() if job.get("fault") == "local_routing" else (
        _moe_inputs(log) if job.get("moe_inputs") else contextlib.nullcontext())
    with Trainer(cfg, device="cpu", mesh=mesh) as t, fault:
        if job.get("form") is not None:
            t.state.load_state_dict(job["form"])
        out = {"layout": _layout(t) if t._plan is not None else None}
        losses, drops = [], []
        for perm in job["perms"]:
            m = t._run_epoch(t.state, t.train_images, t.train_labels,
                             perm=torch.as_tensor(perm))
            losses += C.all_reduce_mean(m["loss"]).tolist()
            if "moe_dropped_frac" in m:
                drops += C.all_reduce_mean(m["moe_dropped_frac"]).tolist()
        out.update(losses=losses, drops=drops, params=_whole_params(t),
                   path_label=t._path_label, chips=t.n_chips, moe_inputs=log[:2])
        return out


def _bytes(job: dict) -> dict:
    """A Trainer's resident parameter bytes on this rank, built and not run."""
    with Trainer(RunConfig(**job["config"]), device="cpu") as t:
        return {"resident_bytes": t._plan.resident_bytes()}


def _checkpoint(job: dict) -> dict:
    """Save: one epoch at ``job["config"]`` with a checkpoint; then the
    uninterrupted two-epoch run's second epoch.  Resume (``resume``): the
    checkpoint resumed at this config's layout for one more epoch."""
    cfg = RunConfig(**job["config"])
    if job.get("resume"):
        with Trainer(cfg.replace(resume=True), device="cpu") as t:
            t.fit()
            return {"step": t.state.step, "loss": t.history[-1]["train_loss"],
                    "params": _whole_params(t)}
    with Trainer(cfg, device="cpu") as t:
        t.fit()
    with Trainer(cfg.replace(epochs=2, checkpoint_dir=None), device="cpu") as t:
        t.fit()
        return {"loss": t.history[-1]["train_loss"], "params": _whole_params(t),
                "layout": _layout(t)}


def _records(hosts: list[str]) -> list[RankRecord]:
    index: dict = {}
    return [RankRecord(r, h, index.setdefault(h, len(index))) for r, h in enumerate(hosts)]


def _mesh_record(mesh) -> dict:
    tag = torch.tensor([float(mesh.rank)])

    def total(group):
        return float(C.all_reduce_sum(tag, group))

    return {"dcn_dp": mesh.dcn_dp, "ici": mesh.ici_shape, "dcn": mesh.dcn_shape,
            "order": mesh.order, "shape": dict(mesh.shape),
            "data_sum": total(mesh.data_group),
            "model_sum": total(mesh.model_group) if mesh.model_group is not None else None,
            "seq_sum": total(mesh.seq_group) if mesh.seq_group is not None else None,
            "pipe_sum": total(mesh.pipe_group) if mesh.pipe_group is not None else None}


def _multislice(job: dict) -> dict:
    """Meshes at ``dcn_dp=2`` beside tp, sp and pp on mock rank records
    (two nodes of two ranks each), their refusals on records that are not
    node-major and on this one node's own, and a dp=2 x tp=2 run on the
    multislice mesh against the same run on the flat mesh."""
    world = torch.distributed.get_world_size()
    two_nodes = _records(["node-a"] * (world // 2) + ["node-b"] * (world // 2))
    out = {"meshes": {}}
    for name, kw in job["meshes"].items():
        out["meshes"][name] = _mesh_record(make_mesh(devices=two_nodes, dcn_dp=2, **kw))
    interleaved = _records(["node-a", "node-b"] * (world // 2))
    out["interleaved"] = _error(lambda: make_mesh(2, tp=world // 2, dcn_dp=2,
                                                  devices=interleaved))
    out["one_node"] = _error(lambda: make_mesh(2, tp=world // 2, dcn_dp=2))
    fits = {}
    for name, mesh in (("dcn1", make_mesh(2, tp=world // 2)),
                       ("dcn2", make_mesh(2, tp=world // 2, dcn_dp=2, devices=two_nodes))):
        fits[name] = _epochs(job["fit"], mesh=mesh)
    out["fits"] = fits
    return out


@contextlib.contextmanager
def _kept(log: list):
    """Each dropout call's kept count and size, appended to ``log``."""
    real = transformer.dropout

    def counting(x, rate, generator):
        y = real(x, rate, generator)
        log.append((int((y != 0).sum()), int((x != 0).sum())))
        return y

    transformer.dropout = counting
    try:
        yield
    finally:
        transformer.dropout = real


def _dropout(job: dict) -> dict:
    """One epoch of the LM with dropout under ``job["config"]`` at each of
    ``job["seeds"]``: this rank's kept share over every dropout call, and
    the step losses averaged over the ranks."""
    out = {}
    for seed in job["seeds"]:
        log: list = []
        cfg = RunConfig(**dict(job["config"], seed=seed))
        with Trainer(cfg, device="cpu") as t, _kept(log):
            m = t._run_epoch(t.state, t.train_images, t.train_labels,
                             perm=torch.as_tensor(job["perm"]))
            kept, seen = map(sum, zip(*log))
            out[seed] = {"kept": kept, "seen": seen,
                         "losses": C.all_reduce_mean(m["loss"]).tolist()}
    return out


def run(rank: int, world: int, jobs: dict) -> dict:
    """Every job of one world, in order; ``kind`` picks the body
    (``epochs``, ``bytes``, ``checkpoint``, ``multislice``, ``dropout``)."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    bodies = {"epochs": _epochs, "bytes": _bytes, "checkpoint": _checkpoint,
              "multislice": _multislice, "dropout": _dropout}
    for name, job in jobs.items():
        try:
            out[name] = bodies[job["kind"]](job)
        except Exception as e:
            raise RuntimeError(f"job {name!r} failed on rank {rank}") from e
    return out
