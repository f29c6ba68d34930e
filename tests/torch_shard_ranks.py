"""Rank bodies of the port's sharded-training tests: ZeRO-3 (fsdp),
expert parallelism and the multislice mesh.

Like ``torch_dp_ranks.py`` (whose helpers it shares), this module imports
neither JAX nor the JAX package: ``launch.torchrun.spawn`` imports it in
every spawned rank, which runs the port alone on numpy inputs the tests
made and returns numpy results for the tests to hold against JAX.  Each
function runs every case of one test file in one spawn of two gloo ranks.
"""

from __future__ import annotations

import copy
from collections import namedtuple

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_mlp, load_train_state
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import expert_parallel as EP
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.fsdp import (
    make_fsdp_opt_specs,
    make_fsdp_specs,
    make_fsdp_train_step,
    shard_train_state,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import RankRecord, make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from torch_dp_ranks import _error, forbidden_modules

# optax's state records, rebuilt here so a JAX TrainState crosses into a
# rank without optax (convert.py reads the records by their fields)
ScaleByAdamState = namedtuple("ScaleByAdamState", "count mu nu")
EmptyState = namedtuple("EmptyState", "")
ScaleByScheduleState = namedtuple("ScaleByScheduleState", "count")


def _np_tree(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _whole(state) -> dict:
    """The state's whole (replicated) form as numpy: params and moments."""
    form = state.state_dict()
    return {"params": _np_tree(form["params"]),
            **{k: _np_tree(form["optimizer"][k]) for k in ("mu", "nu", "trace")
               if form["optimizer"][k]}}


def _blocks(state) -> dict:
    """This rank's masters and first moments, with each leaf's kind and
    split dim (a ZeRO-1 leaf's moments live in its buckets: :func:`_zero1`)."""
    plan, opt = state.plan, state.optimizer
    mu = dict(zip(plan.opt_names, opt.mu))  # empty without Adam
    return {n: {"kind": k, "split": s, "master": m.detach().numpy().copy(),
                "mu": mu[n].numpy().copy() if n in mu else None}
            for n, k, s, m in zip(plan.names, plan.kinds, plan.split, plan.masters)}


def _zero1(state) -> dict:
    """The ZeRO-1 leaves' elements, their padded bucket sizes, and the
    elements of this rank's bucket blocks and of their first moments."""
    plan, opt = state.plan, state.optimizer
    lay = plan.z1_layout
    mu = dict(zip(plan.opt_names, opt.mu))
    return {"leaves": sum(p.numel() for p, k in zip(plan.params, plan.kinds) if k == "zero1"),
            "buckets": list(lay.bucket_sizes) if lay is not None else [],
            "shards": [t.numel() for t in plan.z1_shards],
            "mu": [mu[n].numel() for n in plan.opt_names if n.startswith("zero1.")]}


def _record_norms(plan) -> list:
    """Record every global gradient norm the plan's clip reads."""
    norms, grad_norm = [], plan.grad_norm

    def recorded(grads):
        norm = grad_norm(grads)
        norms.append(float(norm))
        return norm

    plan.grad_norm = recorded
    return norms


def _fsdp_steps(mesh, case: dict) -> dict:
    """``make_fsdp_train_step`` of the MLP on converted weights, over the
    case's global batches: losses, the whole state, this rank's blocks."""
    model = load_mlp(case["params"], device="cpu", dtype=torch.float32, hidden=case["hidden"])
    opt = make_optimizer(RunConfig(**case["opt"]), 10, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=opt, data_generator=torch.Generator())
    specs = make_fsdp_specs(model, mesh, min_size=case["min_size"])
    opt_specs = make_fsdp_opt_specs(model, mesh, specs) if case.get("sharded_update") else None
    fs_step = make_fsdp_train_step(model, opt, mesh, specs, state, opt_specs=opt_specs)
    norms = _record_norms(state.plan)
    losses = [float(fs_step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
                    ["loss"]) for x, y in case["batches"]]
    return {"losses": losses, "whole": _whole(state), "blocks": _blocks(state),
            "specs": {n: tuple(s) for n, s in specs.items()}, "norms": norms,
            "kinds": dict(zip(state.plan.names, state.plan.kinds))}


# ---------------------------------------------------------------- ZeRO-3


def fsdp(rank: int, steps: dict, trainer_cfgs: dict, jax_state: dict, tmp: str) -> dict:
    """The ZeRO-3 cases at dp=2: ``make_fsdp_train_step`` steps of the MLP
    on converted weights, one run a case of ``steps`` (with and without
    the clip and sharded_update); ``Trainer(fsdp=True)`` on the MLP,
    resnet20 and the causal LM; fsdp + sharded_update; checkpoints (save,
    restore, resume without fsdp); a JAX TrainState through
    ``load_train_state``."""
    torch.set_num_threads(1)
    mesh = make_mesh(2)
    out: dict = {"forbidden": forbidden_modules()}
    out["steps"] = {name: _fsdp_steps(mesh, case) for name, case in steps.items()}

    for name, kw in trainer_cfgs.items():
        with Trainer(RunConfig(**kw), device="cpu") as t:
            norms = _record_norms(t._plan) if kw.get("grad_clip") else None
            summary = t.fit()
            rec = {"losses": [h["train_loss"] for h in t.history],
                   "epochs_run": summary["epochs_run"], "blocks": _blocks(t.state),
                   "cross_replica_bn": getattr(getattr(t.model, "stem_bn", None), "mesh",
                                               None) is not None,
                   "buffers": _np_tree(dict(t.model.named_buffers())),
                   "param_count": summary["param_count"]}
            if kw.get("checkpoint_dir") or norms is not None:
                rec["whole"] = _whole(t.state)
            if norms is not None:
                rec["norms"], rec["zero1"] = norms, _zero1(t.state)
                # the whole save form reads back into the ZeRO-1 buckets
                saved = copy.deepcopy(t.state.state_dict())
                for m in t.state.optimizer.mu + t.state.optimizer.nu:
                    m.zero_()
                t.state.load_state_dict(saved)
                rec["reloaded"] = _whole(t.state)
            if kw["model"] == "causal_lm":  # decode gathers every leaf (a collective)
                rec["decode_params"] = _np_tree(t._decode_params())
                rec["generated"] = t.generate(np.array([1, 2, 3]), 5).cpu().numpy()
            out[name] = rec

    # the fsdp checkpoint restores bit-equal into a fresh fsdp run, and
    # resumes at dp=2 without fsdp (the replicated form)
    ck = RunConfig(**trainer_cfgs["ckpt"])
    with Trainer(ck, device="cpu") as t:
        out["ckpt_restored_step"] = t.restore_checkpoint()
        out["ckpt_restored"] = _whole(t.state)
        out["ckpt_blocks"] = _blocks(t.state)
    with Trainer(ck.replace(fsdp=False), device="cpu") as t:
        t.restore_checkpoint()
        out["ckpt_dp2"] = _whole(t.state)
        t.fit()  # continues at dp=2, replicated
        out["ckpt_dp2_step"] = t.state.step

    # a JAX TrainState: load_train_state, then this rank's blocks
    cfg = RunConfig(**jax_state["config"])
    st = load_train_state(jax_state["tree"], cfg, device="cpu", total_steps=10,
                          **jax_state["model_kw"])
    shard_train_state(mesh, st, make_fsdp_specs(st.model, mesh))
    out["jax_state"] = {"whole": _whole(st), "blocks": _blocks(st), "step": st.step}
    return out


# ---------------------------------------------------------------- experts


def expert_parallel(rank: int, cases: dict, trainer: dict) -> dict:
    """The expert-parallel cases at dp=2: ``make_moe_dispatch`` forward and
    gradients per case (this rank's tokens and expert rows); the Trainer's
    automatic EP on a MoE ViT (expert rows, a JAX TrainState loaded, one
    step, the drop metric); the refusals that need a group."""
    torch.set_num_threads(1)
    mesh = make_mesh(2)
    out: dict = {"forbidden": forbidden_modules()}
    for name, case in cases.items():
        e = case["params"]["w1"].shape[0]
        p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
        for k in ("w1", "b1", "w2", "b2"):
            p[k] = p[k].chunk(2, 0)[rank].clone()
        for v in p.values():
            v.requires_grad_(True)
        x = torch.from_numpy(case["x"]).chunk(2, 0)[rank].clone().requires_grad_(True)
        moe = EP.make_moe_dispatch(mesh, e, case["capacity"], top_k=case["top_k"])
        y, aux, stats = moe(p, x)
        # each rank's share of JAX's global loss sum(out^2) + 0.01 aux: the
        # port averages the ranks' gradients (ShardPlan), so rank r
        # differentiates N * sum(out_r^2) + 0.01 aux
        loss = 2 * (y ** 2).sum() + 0.01 * aux
        grads = torch.autograd.grad(loss, [x, *p.values()])
        out[name] = {"out": y.detach().numpy(), "aux": float(aux.detach()),
                     "stats": {k: float(v.detach()) for k, v in stats.items()},
                     "grads": dict(zip(["x", *p], (g.numpy() for g in grads)))}

    cfg = RunConfig(**trainer["config"])
    with Trainer(cfg, device="cpu") as t:
        norms = _record_norms(t._plan)
        out["kinds"] = dict(zip(t._plan.names, t._plan.kinds))
        out["rows"] = {n: tuple(m.shape) for n, m in zip(t._plan.names, t._plan.masters)}
        opt = t.state.optimizer
        out["moment_rows"] = {n: tuple(m.shape) for n, m in zip(t._plan.names,
                                                                opt.mu or opt.trace)}
        t.state.load_state_dict(trainer["form"])
        out["loaded"] = _whole(t.state)
        summary = t.fit()
        out["fit"] = {"history": t.history, "summary": summary, "whole": _whole(t.state),
                      "norms": norms}
        out["decode_shapes"] = {k: tuple(v.shape) for k, v in t._decode_params().items()}
    out["indivisible"] = _error(lambda: Trainer(cfg.replace(model_kwargs={
        **cfg.model_kwargs, "n_experts": 3}), device="cpu"))
    out["su_with_ep"] = _error(lambda: Trainer(cfg.replace(sharded_update=True),
                                               device="cpu"))
    return out


# ---------------------------------------------------------------- multislice


def multislice(rank: int) -> dict:
    """``make_mesh(dcn_dp=2)`` on two ranks: records naming two slices
    build the hybrid mesh; records on one slice, this one node's own
    records, and a Trainer asking for two nodes here are refused."""
    torch.set_num_threads(1)
    two = [RankRecord(0, "node-a", 0), RankRecord(1, "node-b", 1)]
    one = [RankRecord(0, "node-a", 0), RankRecord(1, "node-a", 0)]
    swapped = [RankRecord(0, "node-b", 1), RankRecord(1, "node-a", 0)]
    mesh = make_mesh(2, dcn_dp=2, devices=two)
    return {
        "forbidden": forbidden_modules(),
        "mesh": (mesh.shape, mesh.rank, mesh.dcn_dp, mesh.ici_shape, mesh.dcn_shape,
                 mesh.order),
        "one_slice": _error(lambda: make_mesh(2, dcn_dp=2, devices=one)),
        "not_node_major": _error(lambda: make_mesh(2, dcn_dp=2, devices=swapped)),
        "this_node": _error(lambda: make_mesh(2, dcn_dp=2)),
        "trainer": _error(lambda: Trainer(RunConfig(
            model="mlp", synthetic=True, n_train=64, n_test=32, batch_size=32, quiet=True,
            dp=2, dcn_dp=2), device="cpu")),
        "explicit_mesh": _error(lambda: Trainer(RunConfig(
            model="mlp", synthetic=True, n_train=64, n_test=32, batch_size=32, quiet=True,
            dp=2, dcn_dp=2), mesh=make_mesh(2), device="cpu")),
    }
