"""Rank bodies of the port's tensor-parallel tests: Megatron's mappings
(``parallel/collectives.py``), the blocks of ``parallel/tensor_parallel.py``
and the Trainer at ``tp > 1``, alone and beside dp and sp.

Like ``torch_sp_ranks.py``, this module imports neither JAX nor the JAX
package: ``launch.torchrun.spawn`` imports it in every spawned rank, which
runs the port alone on numpy inputs the tests made and returns numpy
results for the tests to hold against JAX and against the port's tp=1
runs.  A JAX ``TrainState`` reaches a rank as :func:`plain_state`'s form
(dicts, tuples and :class:`Record` nodes of numpy leaves), which
``convert.load_train_state`` reads as it reads the JAX tree.  Each test
file spawns one group a world size and runs every job of that world in it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch import convert
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from torch_dp_ranks import _error, forbidden_modules


class Record:
    """A node of an optimizer state that pickles without optax: its
    ``_fields`` and their values, as ``convert`` reads a namedtuple."""

    def __init__(self, name: str, fields: dict):
        self.name, self._fields = name, tuple(fields)
        for k, v in fields.items():
            setattr(self, k, v)


def plain_state(tree):
    """A numpy JAX ``TrainState`` as plain containers: mappings as dicts,
    namedtuples as :class:`Record`, dataclasses as dicts of their fields."""
    if hasattr(tree, "_fields"):
        return Record(type(tree).__name__, {k: plain_state(getattr(tree, k))
                                            for k in tree._fields})
    if isinstance(tree, Mapping):
        return {k: plain_state(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(plain_state(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return {k: plain_state(getattr(tree, k)) for k in ("step", "params", "batch_stats",
                                                          "opt_state") if hasattr(tree, k)}
    return np.asarray(tree) if tree is not None else None


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------- mappings


class _TimesTpGather(torch.autograd.Function):
    """A planted fault: the gather's backward summed over the model group
    (a reduce-scatter), which multiplies the replicated gradient by tp."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return C.all_gather_dim(x.contiguous(), x.ndim - 1, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        n, i = ctx.mesh.model_size, ctx.mesh.model_index
        return C.all_reduce_sum(g, ctx.mesh.model_group).chunk(n, -1)[i].contiguous(), None


def _mappings(job: dict, mesh) -> dict:
    """A column-parallel product whose output is gathered, scattered into a
    row-parallel one whose output is reduced (the generic path), and the
    same two as a Megatron pair (no gather, no scatter), each with its
    gradients of ``sum(z * c)``; plus the generic path with the planted
    gather."""
    n, i = mesh.model_size, mesh.model_index
    x0 = torch.from_numpy(job["x"])
    wc, wr = (torch.from_numpy(job[k]).chunk(n, d)[i].contiguous()
              for k, d in (("wc", 0), ("wr", 1)))
    c = torch.from_numpy(job["c"])
    out = {}
    for label in ("generic", "pair", "fault"):
        x = x0.clone().requires_grad_(True)
        a, b = wc.clone().requires_grad_(True), wr.clone().requires_grad_(True)
        if label == "pair":
            z = C.reduce_from_model(C.copy_to_model(x, mesh) @ a.T @ b.T, mesh)
        else:
            y = C.copy_to_model(x, mesh) @ a.T
            y = (C.gather_from_model(y, -1, mesh) if label == "generic"
                 else _TimesTpGather.apply(y, mesh))
            z = C.reduce_from_model(C.scatter_to_model(y, -1, mesh) @ b.T, mesh)
        (z * c).sum().backward()
        out[label] = {"z": _np(z), "dx": _np(x.grad), "dwc": _np(a.grad), "dwr": _np(b.grad)}
    return out


# ---------------------------------------------------------------- blocks


def _lm(kw: dict, seed: int):
    return get_model("causal_lm", device="cpu", dtype=torch.float32,
                     generator=torch.Generator().manual_seed(seed), **kw)


def _blocks(job: dict, mesh) -> dict:
    """The fused projections of an LM cut over the model axis: each rank's
    block, the whole leaf the rank started from, the plan's whole form
    gathered back, and the logits and loss of the sharded model against
    the whole one; with ``contiguous``, the fused leaves cut as contiguous
    blocks of their output (JAX's spec taken literally), a planted fault."""
    whole = _lm(job["kw"], job["seed"])
    tokens = torch.from_numpy(job["tokens"])
    with torch.no_grad():
        want = whole(tokens)
    model = _lm(job["kw"], job["seed"])
    saved = tp.head_major_order
    if job.get("contiguous"):
        tp.head_major_order = lambda rows, parts, n: torch.arange(rows)
    try:
        plan = tp.TPPlan.shard(mesh, model)
    finally:
        tp.head_major_order = saved
    fused = [n for n in ("blocks.0.qkv.weight", "blocks.0.qkv.bias",
                         "blocks.0.kv_proj.weight", "blocks.0.q_proj.weight")
             if n in plan.names]
    params = dict(model.named_parameters())
    wparams = dict(whole.named_parameters())
    regathered = dict(zip(plan.names, plan.whole(plan.masters)))
    with torch.no_grad():
        got = model(tokens)
    labels = tokens.roll(-1, 1).long()
    loss = lambda lg: float(torch.nn.functional.cross_entropy(  # noqa: E731
        lg.reshape(-1, lg.shape[-1]), labels.reshape(-1)))
    return {"blocks": {n: _np(params[n]) for n in fused},
            "whole": {n: _np(wparams[n]) for n in fused},
            "regathered_equal": all(torch.equal(regathered[n], wparams[n])
                                    for n in plan.names),
            "split": {n: d for n, d in zip(plan.names, plan.split)},
            "pair": [b.tp_attn_pair for b in model.blocks],
            "heads": [(b.tp_heads, b.tp_heads_kv) for b in model.blocks],
            "logits": _np(got), "want": _np(want), "loss": loss(got), "want_loss": loss(want)}


# ---------------------------------------------------------------- trainers


def _whole_params(t: Trainer) -> dict:
    """The run's parameters whole (a collective under a plan)."""
    sd = (t._plan.whole_state_dict(t.model) if t._plan is not None
          else t.model.state_dict())
    return {k: _np(v) for k, v in sd.items()}


def _fit(job: dict) -> dict:
    """A Trainer on ``job["config"]`` (the JAX state's form loaded when
    given), fit(); its epochs' records, the whole parameters and the
    layout."""
    cfg = RunConfig(**job["config"])
    with Trainer(cfg, device="cpu") as t:
        if job.get("form") is not None:
            t.state.load_state_dict(job["form"])
        summary = t.fit()
        out = {"losses": [h["train_loss"] for h in t.history],
               "test_loss": t.history[-1].get("test_loss"),
               "test_accuracy": t.history[-1].get("test_accuracy"),
               "step": t.state.step, "chips": t.n_chips, "path_label": t._path_label,
               "mesh": None if t.mesh is None else dict(t.mesh.shape),
               "params": _whole_params(t),
               "buffers": {k: _np(v) for k, v in t.model.named_buffers()},
               "summary_chips": summary.get("images_per_sec_per_chip") is not None}
        if job.get("generate") is not None:
            out["generated"] = t.generate(np.asarray(job["generate"]), max_new=6).tolist()
        return out


def _steps(job: dict, mesh) -> dict:
    """``make_tp_train_step`` on a state converted from JAX's
    (``convert.load_train_state`` with the mesh): each step's loss and the
    whole parameters after, and each rank's block shapes."""
    cfg = RunConfig(**job["config"])
    state = convert.load_train_state(job["state"], cfg, device="cpu", total_steps=10,
                                     mesh=None if job.get("specs") else mesh, **job["model_kw"])
    model = state.model
    if job.get("attn_fn") == "ring":  # the ViT of JAX's combined test
        ring = make_ring_attention(mesh)
        for m in (model, *model.blocks):
            m.attn_fn = ring
    if job.get("specs") == "dense":  # megatron_dense_rule: the MLPs alone
        tp.shard_train_state(mesh, state, tp.model_param_specs(model, tp.megatron_dense_rule()))
    step = tp.make_tp_train_step(model, None, mesh, None, state)
    losses = []
    for img, lab in job["batches"]:
        m = step(state, {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})
        losses.append(float(m["loss"]))
    plan = state.plan
    return {"losses": losses, "step": state.step,
            "params": {k: _np(v) for k, v in plan.whole_state_dict(model).items()},
            "shapes": {n: tuple(p.shape) for n, p in zip(plan.names, plan.params)},
            "split": {n: d for n, d in zip(plan.names, plan.split)},
            "pair": [getattr(b, "tp_attn_pair", None) for b in getattr(model, "blocks", [])]}


def _bn_fault(job: dict) -> dict:
    """The ResNet's cross-replica BatchNorm with its reductions over every
    rank (dp x tp) instead of the data group: a planted fault."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import resnet

    saved = resnet.BatchNorm.forward

    def world_forward(self, x, train):
        if self.mesh is not None and self.mesh.data_group is not None:
            self.mesh = dataclasses.replace(self.mesh, data_group=None)
        return saved(self, x, train)

    resnet.BatchNorm.forward = world_forward
    try:
        return _fit(job)
    finally:
        resnet.BatchNorm.forward = saved


def _resume(job: dict) -> dict:
    """A checkpointed tp run resumed at its own layout: one epoch saved, a
    resumed Trainer running the next, against the uninterrupted run."""
    cfg = RunConfig(**job["config"])
    with Trainer(cfg, device="cpu") as t1:
        t1.fit()
    with Trainer(cfg.replace(resume=True), device="cpu") as t2:
        t2.fit()
        out = {"step": t2.state.step, "spe": t2.steps_per_epoch,
               "losses": [h["train_loss"] for h in t2.history], "params": _whole_params(t2)}
    with Trainer(cfg.replace(epochs=2, checkpoint_dir=None), device="cpu") as t3:
        t3.fit()
        out["uninterrupted"] = [h["train_loss"] for h in t3.history]
        out["uninterrupted_params"] = _whole_params(t3)
    return out


def _refusals(refusals: dict) -> dict:
    return {name: _error(lambda c=c: Trainer(RunConfig(**c), device="cpu"))
            for name, c in refusals.items()}


def _mesh_record(mesh) -> dict:
    tag = torch.tensor([float(mesh.rank)])
    return {"data_index": mesh.data_index, "model_index": mesh.model_index,
            "seq_index": mesh.seq_index, "replica_index": mesh.replica_index,
            "model_sum": float(C.all_reduce_sum(tag, mesh.model_group)),
            "data_sum": float(C.all_reduce_sum(tag, mesh.data_group)),
            "replica_sum": float(C.all_reduce_sum(tag, mesh.replica_group)),
            "seq_sum": float(C.all_reduce_sum(tag, mesh.seq_group))
            if mesh.seq_group is not None else None}


def run(rank: int, world: int, jobs: dict) -> dict:
    """Every job of one world, in order; ``kind`` picks the body
    (``mesh``, ``mappings``, ``blocks``, ``fit``, ``steps``, ``bn_fault``,
    ``resume``, ``refusals``, ``cli``)."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    meshes: dict = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_mesh(shape[0], tp=shape[1], sp=shape[2])
        return meshes[shape]

    for name, job in jobs.items():
        try:
            out[name] = _job(name, job, world, rank, mesh_of)
        except Exception as e:
            raise RuntimeError(f"job {name!r} failed on rank {rank}") from e
    return out


def _job(name: str, job: dict, world: int, rank: int, mesh_of):
    kind = job["kind"]
    if kind == "mesh":
        return _mesh_record(mesh_of(job["shape"]))
    if kind in ("mappings", "blocks", "steps"):
        body = {"mappings": _mappings, "blocks": _blocks, "steps": _steps}[kind]
        return body(job, mesh_of(job["shape"]))
    if kind in ("fit", "bn_fault", "resume"):
        return {"fit": _fit, "bn_fault": _bn_fault, "resume": _resume}[kind](job)
    if kind == "refusals":
        return _refusals(job["configs"])
    if kind == "cli":  # the CLI's rank body: dp from the world, tp and sp
        cfg = cli.build_config(job["argv"])
        return {"tp": cfg.tp, "dp": cli.world_config(cfg, world).dp,
                "rc": cli._run(cfg, "cpu", None, world, rank)}
    raise ValueError(f"unknown job kind {kind!r} ({name})")
