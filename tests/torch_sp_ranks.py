"""Rank bodies of the port's sequence-parallel tests: the ring
(``parallel/ring_attention.py``), Ulysses (``parallel/sequence_parallel.py``)
and the Trainer at ``sp > 1``.

Like ``torch_shard_ranks.py``, this module imports neither JAX nor the
JAX package: ``launch.torchrun.spawn`` imports it in every spawned rank,
which runs the port alone on numpy inputs the tests made and returns
numpy results for the tests to hold against JAX.  Each test file spawns
one group a world size and runs every case of that world in it.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import make_loss_fn
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli
from distributed_tensorflow_ibm_mnist_tpu_torch.models import transformer
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import ring_attention as RA
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.sequence_parallel import (
    make_ulysses_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from torch_dp_ranks import _error, forbidden_modules


class _Spy:
    """Count the K7 block calls (the plain versions on the CPU: the
    wrappers count only CUDA launches) and record every hop's tensor
    shapes and every attention input's shape, while active."""

    def __init__(self):
        self.fwd = self.bwd = 0
        self.hops: list[list[tuple]] = []
        self.saved = (fa.flash_block_fwd, fa.flash_block_bwd, RA.ring_shift)

    def __enter__(self):
        blk_f, blk_b, shift = self.saved

        def fwd(*a, **kw):
            self.fwd += 1
            return blk_f(*a, **kw)

        def bwd(*a, **kw):
            self.bwd += 1
            return blk_b(*a, **kw)

        def hop(xs, *a, **kw):
            self.hops.append([tuple(x.shape) for x in xs])
            return shift(xs, *a, **kw)

        fa.flash_block_fwd, fa.flash_block_bwd, RA.ring_shift = fwd, bwd, hop
        return self

    def __exit__(self, *exc):
        fa.flash_block_fwd, fa.flash_block_bwd, RA.ring_shift = self.saved
        return False


def _block(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's (B/dp, S/sp, ...) block of a global (B, S, ...) array."""
    b, s = x.shape[0] // mesh.size, x.shape[1] // mesh.seq_size
    d, i = mesh.data_index, mesh.seq_index
    return torch.from_numpy(np.ascontiguousarray(x[d * b:(d + 1) * b, i * s:(i + 1) * s]))


def _attention(case: dict, mesh):
    """One attention case on this rank's blocks: the output and the
    gradients of ``sum(out * w)`` with respect to q, k and v (each rank
    differentiates its share of the global sum), plus the spy's counts."""
    q, k, v = (_block(case[n], mesh).requires_grad_(True) for n in "qkv")
    if case["impl"] == "ring":
        attn = make_ring_attention(mesh, causal=case["causal"], inner=case["inner"])
    else:
        inner = {"vanilla": RA.vanilla_attention, "flash": fa.flash_attention}[case["inner"]]
        seen = []

        def probe(q_h, k_h, v_h, **kw):
            seen.append(tuple(q_h.shape))
            return inner(q_h, k_h, v_h, **kw)

        attn = make_ulysses_attention(mesh, causal=case["causal"], inner_attn=probe,
                                      window=case.get("window", 0))
    with _Spy() as spy:
        out = attn(q, k, v)
        (out * _block(case["w"], mesh)).sum().backward()
    rec = {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
           "dv": v.grad.numpy(), "block_fwd": spy.fwd, "block_bwd": spy.bwd,
           "hops": spy.hops, "local": tuple(q.shape)}
    if case["impl"] != "ring":
        rec["inner_shapes"] = seen
    return rec


def _attn_inputs(trainer) -> list:
    """Record the (q, k, v) shapes every block's attention is called with."""
    shapes = []
    for block in trainer.model.blocks:
        fn = block.attn_fn

        def spy(q, k, v, _fn=fn):
            shapes.append((tuple(q.shape), tuple(k.shape)))
            return _fn(q, k, v)

        block.attn_fn = spy
    return shapes


def _fit(job: dict) -> dict:
    """A Trainer on ``job["config"]``: the JAX state loaded when given,
    fit(); its epochs' train losses, the test loss and step."""
    cfg = RunConfig(**job["config"])
    with Trainer(cfg, device="cpu") as t:
        if job.get("form") is not None:
            t.state.load_state_dict(job["form"])
        shapes = _attn_inputs(t) if job.get("spy_inputs") else None
        summary = t.fit()
        return {"losses": [h["train_loss"] for h in t.history],
                "test_loss": t.history[-1].get("test_loss"),
                "test_accuracy": t.history[-1].get("test_accuracy"),
                "step": t.state.step, "chips": t.n_chips,
                "tokens_per_sec_per_chip": summary.get("tokens_per_sec_per_chip"),
                "attn_inputs": sorted(set(shapes)) if shapes is not None else None,
                "path_label": t._path_label}


class _FaultPool:
    """A planted fault in the ViT's pool across the seq group: its backward
    scaled by ``scale`` (1/sp: a mean's backward; sp: twice summed)."""

    def __init__(self, scale: float):
        self.scale, self.saved = scale, transformer.all_reduce_sum

    def __enter__(self):
        real, scale = self.saved, self.scale

        class Scaled(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, group):
                ctx.group = group
                return real(x.detach(), group=group)

            @staticmethod
            def backward(ctx, g):
                return real(g, group=ctx.group) * scale, None

        transformer.all_reduce_sum = lambda x, group=None: Scaled.apply(x, group)
        return self

    def __exit__(self, *exc):
        transformer.all_reduce_sum = self.saved
        return False


def _grads(job: dict, fault: float | None = None) -> dict:
    """One step's gradient of the run's model at the loaded JAX state on
    the given global batch: each rank's gradient of its loss, averaged over
    every rank, as the step averages it."""
    cfg = RunConfig(**job["config"])
    with Trainer(cfg, device="cpu") as t:
        t.state.load_state_dict(job["form"])
        loss_fn = make_loss_fn(t.model)
        batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
        d, per = t.mesh.data_index, batch["label"].shape[0] // t.mesh.size
        batch = {k: v[d * per:(d + 1) * per] for k, v in batch.items()}
        names, params = zip(*t.model.named_parameters())
        if fault is None:
            loss, _ = loss_fn(batch, train=True)
        else:
            with _FaultPool(fault):
                loss, _ = loss_fn(batch, train=True)
        grads = torch.autograd.grad(loss, params)
        grads = C.all_reduce_mean(list(grads))
        return {n: g.numpy() for n, g in zip(names, grads)}


def _resume(job: dict) -> dict:
    """Checkpoint and resume at the job's sp: one epoch saved, a resumed
    Trainer running the next; against the uninterrupted two epochs."""
    cfg = RunConfig(**job["config"])
    with Trainer(cfg, device="cpu") as t1:
        t1.fit()
    with Trainer(cfg.replace(resume=True), device="cpu") as t2:
        t2.fit()
        resumed = {"step": t2.state.step, "spe": t2.steps_per_epoch,
                   "loss": t2.history[-1]["train_loss"],
                   # decode from the sp run: whole weights on one device
                   "generated": t2.generate(np.asarray([1, 2, 3]), max_new=3).tolist()}
    whole = cfg.replace(epochs=2, checkpoint_dir=None)
    with Trainer(whole, device="cpu") as t3:
        t3.fit()
        resumed["uninterrupted"] = [h["train_loss"] for h in t3.history]
    return resumed


def _dense_path(job: dict, mesh) -> dict:
    """A causal LM whose heads do not divide the seq axis, with Ulysses as
    its ``attn_fn``: the whole sequence on every rank through the island's
    unsharded inner, against the same weights without the island."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

    kw = dict(job["model_kw"], device="cpu", dtype=torch.float32)
    island = make_ulysses_attention(mesh, causal=True)
    plain = get_model("causal_lm", **kw, generator=torch.Generator().manual_seed(5))
    sp = get_model("causal_lm", **kw, attn_fn=island,
                   generator=torch.Generator().manual_seed(5))
    tokens = torch.from_numpy(job["tokens"])
    with torch.no_grad():
        return {"span": island.local_span(tokens.shape[1], kw["heads"]),
                "sp": sp(tokens).numpy(), "plain": plain(tokens).numpy()}


def _refusals(refusals: dict) -> dict:
    """Each refused config's error, as ``type: message``."""
    return {name: _error(lambda c=c: Trainer(RunConfig(**c), device="cpu"))
            for name, c in refusals.items()}


def run(rank: int, world: int, attention: dict, meshes: dict, jobs: dict) -> dict:
    """Every case of one world: ``attention`` cases (each on its own
    ``(dp, sp)`` mesh of the world), Trainer ``jobs`` (kind ``fit``,
    ``grads``, ``grads_fault``, ``resume``, ``refusals``, ``cli``), and
    ``meshes``: the ``(dp, sp)`` layouts whose coordinates and groups to
    report."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    cache = {}

    def mesh_of(dp, sp):
        if (dp, sp) not in cache:
            cache[(dp, sp)] = make_mesh(dp, sp=sp)
        return cache[(dp, sp)]

    for name, (dp, sp) in meshes.items():
        m = mesh_of(dp, sp)
        tag = torch.tensor([float(rank)])
        out[name] = {"data_index": m.data_index, "seq_index": m.seq_index,
                     "seq_sum": float(C.all_reduce_sum(tag, m.seq_group)),
                     "data_sum": float(C.all_reduce_sum(tag, m.data_group)),
                     "right": float(C.ring_shift(tag, m.seq_group)),
                     "left": float(C.ring_shift(tag, m.seq_group, shift=-1))}
        x = torch.full((2,), float(rank), requires_grad=True)
        (C.ring_shift(x, m.seq_group) * (rank + 1)).sum().backward()
        out[name]["shift_grad"] = x.grad.tolist()
    for name, case in attention.items():
        out[name] = _attention(case, mesh_of(case["dp"], case["sp"]))
    for name, job in jobs.items():
        kind = job["kind"]
        if kind == "fit":
            out[name] = _fit(job)
        elif kind == "grads":
            out[name] = {"grads": _grads(job),
                         **{f"fault_{k}": _grads(job, s) for k, s in job["faults"].items()}}
        elif kind == "resume":
            out[name] = _resume(job)
        elif kind == "refusals":
            out[name] = _refusals(job["configs"])
        elif kind == "cli":  # the CLI's rank body: dp from the world and sp
            cfg = cli.build_config(job["argv"])
            ran = cli.world_config(cfg, world)
            out[name] = {"sp": ran.sp, "sp_impl": ran.sp_impl, "dp": ran.dp,
                         "rc": cli._run(cfg, "cpu", None, world, rank)}
        elif kind == "dense_path":  # a sequence the mesh cannot split
            out[name] = _dense_path(job, mesh_of(1, world))
    return out
