"""Rank bodies of the port's pipeline-parallel tests: the schedule of
``parallel/pipeline.py`` (``make_pipeline_apply``, the pp x tp helpers),
the mesh's ``pipe`` axis and the Trainer at ``pp > 1``, alone and beside
dp and tp.

Like ``torch_tp_ranks.py``, this module imports neither JAX nor the JAX
package: ``launch.torchrun.spawn`` imports it in every spawned rank, which
runs the port alone on numpy inputs the tests made and returns numpy
results for the tests to hold against JAX and against the port's pp=1
runs.  Each test file spawns one group a world size and runs every job of
that world in it.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import pipeline as PL
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import vanilla_attention
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from torch_dp_ranks import _error, forbidden_modules


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def mlp_stage(p: dict, x: torch.Tensor) -> torch.Tensor:
    """JAX's test stage: ``x + tanh(x @ w1 + b1) @ w2``."""
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


# ---------------------------------------------------------------- planted faults


class _SumOverPipe:
    """A planted fault: the output broadcast's backward sums the cotangents
    over the pipe group (the transpose of JAX's root-masked psum taken
    literally), so the last stage gets pp copies of it."""

    def __enter__(self):
        self.saved = C._BroadcastFromRoot.backward
        C._BroadcastFromRoot.backward = staticmethod(
            lambda ctx, g: (C._sum(g, ctx.group), None, None))

    def __exit__(self, *exc):
        C._BroadcastFromRoot.backward = self.saved


class _HopOneOff:
    """A planted fault: each stage hand-off delivers the activation (or
    gradient) of the previous microbatch, the first one its own."""

    def __enter__(self):
        self.saved = PL.stage_hop
        prev: list = [None]

        def off(send, to, like, frm, group):
            got = self.saved(send, to, like, frm, group)
            if got is None:
                return None
            out, prev[0] = (prev[0] if prev[0] is not None else got), got
            return out

        PL.stage_hop = off

    def __exit__(self, *exc):
        PL.stage_hop = self.saved


def _slow_stage(mesh):
    """An unequal workload: stage 0 sleeps before each microbatch, so every
    other rank waits at its hops."""
    def fn(p, x):
        if mesh.pipe_index == 0:
            time.sleep(0.05)
        return mlp_stage(p, x)
    return fn


# ---------------------------------------------------------------- functional


def _apply(job: dict, mesh) -> dict:
    """``make_pipeline_apply`` over the stacked numpy stages: the output
    and the gradients of ``sum(y ** 2)`` for the stacked leaves (nonzero on
    this rank's stage only), under a planted fault when ``fault`` says;
    with ``no_grad`` the output of a forward under ``torch.no_grad`` (as
    eval runs it) and whether any stage call built a graph."""
    stacked = {k: v.requires_grad_(True) for k, v in PL.stack_stage_params(
                   [{k: torch.from_numpy(v) for k, v in s.items()} for s in job["stages"]]
               ).items()}
    fault = job.get("fault")
    stage = _slow_stage(mesh) if fault == "slow" else mlp_stage
    calls, graphs = [0], [0]

    def fn(p, h):
        calls[0] += 1
        graphs[0] += torch.is_grad_enabled()
        return stage(p, h)
    apply = PL.make_pipeline_apply(fn, mesh, job["m"], remat=job.get("remat", False),
                                   batch_axis=job.get("batch_axis"))
    x = torch.from_numpy(job["x"])
    if job.get("no_grad"):
        with torch.no_grad():
            y = apply(stacked, x)
        return {"y": _np(y), "grad_fn": y.grad_fn is not None, "stage_calls": calls[0],
                "graph_calls": graphs[0], "data_index": mesh.data_index}
    ctx = {"sum_over_pipe": _SumOverPipe, "hop_one_off": _HopOneOff}.get(fault)
    sent0 = C.stage_hop.bytes
    t0 = time.perf_counter()
    if ctx is not None:
        with ctx():
            y = apply(stacked, x)
            (y ** 2).sum().backward()
    else:
        y = apply(stacked, x)
        (y ** 2).sum().backward()
    return {"y": _np(y), "grads": {k: _np(v.grad) for k, v in stacked.items()},
            "data_index": mesh.data_index, "pipe_index": mesh.pipe_index,
            "seconds": time.perf_counter() - t0, "stage_calls": calls[0],
            "bytes_sent": C.stage_hop.bytes - sent0}


def _tp_apply(job: dict, mesh) -> dict:
    """The pp x tp island: JAX's permuted stacked block tree through
    ``make_tp_block_stage_fn`` under ``tp_stage_specs``; the output and
    each leaf's gradient of ``sum(y ** 2)``, this rank's (stage, model)
    block of it."""
    tree = _tensor_tree(job["stacked"])
    heads, hd, hkv = job["heads"], job["head_dim"], job["heads_kv"]
    tp = mesh.model_size
    permuted = (PL.permute_kv_shard_major(tree, hkv, hd, tp) if hkv
                else PL.permute_qkv_head_major(tree, heads, hd))
    permuted = _map(lambda t: t.detach().clone().requires_grad_(True), permuted)
    specs = PL.tp_stage_specs(permuted)
    attn = lambda q, k, v: vanilla_attention(q, k, v, causal=True)  # noqa: E731
    stage_fn = PL.make_tp_block_stage_fn(heads, hd, tp, attn, rope=True, dtype=torch.float32,
                                         heads_kv=hkv, mesh=mesh)
    apply = PL.make_pipeline_apply(stage_fn, mesh, job["m"], param_specs=specs)
    y = apply(permuted, torch.from_numpy(job["x"]))
    (y ** 2).sum().backward()
    return {"y": _np(y), "permuted": _map(_np, permuted), "grads": _map(lambda t: _np(t.grad),
                                                                        permuted),
            "specs": _map(tuple, specs), "pipe_index": mesh.pipe_index,
            "model_index": mesh.model_index}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensor_tree(tree):
    return _map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree)


# ---------------------------------------------------------------- trainers


def _whole_params(t: Trainer) -> dict:
    """The run's parameters whole (a collective under a plan)."""
    sd = t._plan.whole_state_dict(t.model) if t._plan is not None else t.model.state_dict()
    return {k: _np(v) for k, v in sd.items()}


def _fit(job: dict) -> dict:
    """A Trainer on ``job["config"]`` (a converted JAX state loaded when
    ``form`` is given), fit(); its records, whole parameters and layout,
    the warnings its construction raised, and a greedy decode when asked."""
    cfg = RunConfig(**job["config"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = Trainer(cfg, device="cpu")
    with t:
        if job.get("form") is not None:
            t.state.load_state_dict(job["form"])
        t.fit()
        plan = t._plan
        out = {"losses": [h["train_loss"] for h in t.history],
               "test_loss": t.history[-1].get("test_loss"),
               "test_accuracy": t.history[-1].get("test_accuracy"),
               "step": t.state.step, "chips": t.n_chips, "path_label": t._path_label,
               "mesh": None if t.mesh is None else dict(t.mesh.shape),
               "pipe_index": None if t.mesh is None else t.mesh.pipe_index,
               "params": _whole_params(t),
               "held": sorted({n.split(".")[2] for n in (plan.local_names if plan is not None else ())
                               if PL.is_stage_leaf(n)}),
               "local_shapes": {n: tuple(p.shape) for n, p in t.model.named_parameters()},
               "in_stages": t._pp_tp_in_stages, "param_count": t.state.param_count(),
               "warnings": [str(w.message) for w in caught]}
        if job.get("generate") is not None:
            out["generated"] = t.generate(np.asarray(job["generate"]), max_new=6).tolist()
            eng = InferenceEngine.from_trainer(t, slots=1, max_len=16, device="cpu")
            eng.submit(list(job["generate"]), max_new=6)
            out["served"] = [list(r.generated) for r in eng.run()]
            out["on_mesh"] = _error(lambda: t.generate(np.asarray(job["generate"]), max_new=2,
                                                       on_mesh=True))
        return out


def _resume(job: dict) -> dict:
    """A checkpointed pp run resumed at its own layout: one epoch saved, a
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

    def total(group):
        return None if group is None else float(C.all_reduce_sum(tag, group))

    return {"data_index": mesh.data_index, "model_index": mesh.model_index,
            "seq_index": mesh.seq_index, "pipe_index": mesh.pipe_index,
            "pipe_sum": total(mesh.pipe_group), "data_sum": total(mesh.data_group),
            "replica_sum": total(mesh.replica_group), "model_sum": total(mesh.model_group)}


def run(rank: int, world: int, jobs: dict) -> dict:
    """Every job of one world, in order; ``kind`` picks the body (``mesh``,
    ``apply``, ``tp_apply``, ``fit``, ``resume``, ``refusals``, ``cli``)."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    meshes: dict = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_mesh(shape[0], tp=shape[1], sp=shape[2], pp=shape[3])
        return meshes[shape]

    for name, job in jobs.items():
        try:
            out[name] = _job(job, world, rank, mesh_of)
        except Exception as e:
            raise RuntimeError(f"job {name!r} failed on rank {rank}") from e
    return out


def _job(job: dict, world: int, rank: int, mesh_of):
    kind = job["kind"]
    if kind == "mesh":
        return _mesh_record(mesh_of(job["shape"]))
    if kind in ("apply", "tp_apply"):
        return {"apply": _apply, "tp_apply": _tp_apply}[kind](job, mesh_of(job["shape"]))
    if kind in ("fit", "resume"):
        return {"fit": _fit, "resume": _resume}[kind](job)
    if kind == "refusals":
        return _refusals(job["configs"])
    if kind == "cli":  # the CLI's rank body: dp from the world, pp and its microbatches
        cfg = cli.build_config(job["argv"])
        return {"pp": cfg.pp, "dp": cli.world_config(cfg, world).dp,
                "rc": cli._run(cfg, "cpu", None, world, rank)}
    raise ValueError(f"unknown job kind {kind!r}")
