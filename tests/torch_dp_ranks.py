"""Rank bodies of the port's data-parallel tests.

``launch.torchrun.spawn`` imports this module in every spawned rank, so it
imports neither JAX nor the JAX package (nor the test files, whose
``conftest.py`` does): the ranks run the port alone, on numpy inputs the
tests made, and return numpy results that the tests hold against JAX and
against the port's single-process runs.  Each function runs every case of
one test file in one spawn of two gloo ranks on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_lenet5, load_mlp, load_resnet
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    replicate,
    shard_dataset,
    shard_eval_set,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

JAX_PKG = "distributed_tensorflow_ibm_mnist_tpu"


def forbidden_modules() -> list[str]:
    """Modules of JAX, flax, optax or the JAX package this process loaded."""
    roots = {"jax", "jaxlib", "flax", "optax", "orbax"}
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in roots or m == JAX_PKG or m.startswith(JAX_PKG + "."))


def _np(tensors) -> list[np.ndarray]:
    return [t.detach().cpu().numpy().copy() for t in tensors]


def _state_np(model) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


# ---------------------------------------------------------------- collectives


def collectives(rank: int, xs: np.ndarray, grads: list[np.ndarray]) -> dict:
    """Every collective on this rank's ``xs[rank]`` (and ``grads[rank]``)."""
    torch.set_num_threads(1)
    mesh = make_mesh(2)
    x = torch.from_numpy(xs[rank])
    g = [torch.from_numpy(a) for a in grads[rank]]
    out = {
        "sum": C.all_reduce_sum(x), "mean": C.all_reduce_mean(x),
        "max": C.all_reduce_max(x), "all_gather": C.all_gather(x),
        "all_gather_flat": C.all_gather(x.reshape(-1)),
        "reduce_scatter": C.reduce_scatter(x),
        "reduce_scatter_flat": C.reduce_scatter(x.reshape(-1)),
        "broadcast": C.broadcast(x, root=1), "broadcast_root0": C.broadcast(x),
        "grad_norm_global": C.grad_norm_global(g, mesh)[None],
    }
    tree = C.all_reduce_sum([x, 2 * x])
    return {**{k: v.numpy() for k, v in out.items()},
            "tree_sum": _np(tree), "size_index": (C.axis_size(), C.axis_index()),
            "object": C.broadcast_object({"from": rank}),
            "mesh": (mesh.shape, mesh.rank), "mesh_dp3": _error(lambda: make_mesh(3)),
            "forbidden": forbidden_modules()}


def raise_on_rank_1(rank: int) -> int:
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def torn_result_on_rank_0(rank: int, store: str) -> int:
    """Rank 0 leaves the torn result file of a rank killed while writing
    it (the first bytes of a pickle) and dies without a result of its own."""
    if rank == 0:
        import os

        with open(f"{store}.rank0.out", "wb") as fh:
            fh.write(b"\x80\x05\x95")
        os._exit(9)
    return rank


def sleep_past_the_limit(rank: int, seconds: float) -> int:
    import time

    time.sleep(seconds)
    return rank


# ---------------------------------------------------------------- data parallel


def _dp_steps(mesh, model, opt_kw: dict, batches, sharded_update=None, optimizer=None) -> dict:
    """``len(batches)`` data-parallel steps on global batches: per-step
    mean loss and the final parameters."""
    replicate(mesh, model)
    opt = optimizer or make_optimizer(RunConfig(**opt_kw), 10, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=opt, data_generator=torch.Generator())
    step = make_dp_train_step(model, opt, mesh, sharded_update=sharded_update)
    losses = [float(step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
                    ["loss"]) for x, y in batches]
    return {"losses": losses, "state": _state_np(model), "opt": opt}


def _mini_cfg(**kw) -> RunConfig:
    base = dict(name="dp", model="mlp", model_kwargs={"hidden": (32,), "dtype": torch.float32},
                dataset="mnist", synthetic=True, n_train=256, n_test=101, batch_size=32,
                epochs=2, lr=2e-3, quiet=True, seed=7, eval_batch_size=48,
                target_accuracy=None)
    return RunConfig(**{**base, **kw})


def data_parallel(rank: int, steps: dict, rows: tuple, bn: dict, tmp: str) -> dict:
    """The data-parallel cases: dp=2 steps of the MLP and LeNet on
    converted weights; the data and eval layouts; a Trainer's eval and
    fit; one step of a toy ResNet with cross-replica BatchNorm."""
    torch.set_num_threads(1)
    mesh = make_mesh(2)
    out: dict = {"forbidden": forbidden_modules()}
    loaders = {"mlp": lambda p: load_mlp(p, device="cpu", dtype=torch.float32, hidden=(64,)),
               "lenet5": lambda p: load_lenet5(p, device="cpu", dtype=torch.float32,
                                               dropout_rate=0.0)}
    for name, case in steps.items():
        run = _dp_steps(mesh, loaders[case["model"]](case["params"]), case["opt"],
                        case["batches"])
        out[name] = {"losses": run["losses"], "state": run["state"]}

    images, labels = rows
    out["shard"] = [t.numpy() for t in shard_dataset(mesh, images, labels, "cpu")]
    *ev, n_valid = shard_eval_set(mesh, images, labels, "cpu")
    out["eval_shard"] = ([t.numpy() for t in ev], n_valid)

    trainer = Trainer(_mini_cfg(dp=2), device="cpu")
    out["evaluate"] = trainer.evaluate()
    out["test_rows"] = int(trainer.test_images.shape[0])
    fit_cfg = _mini_cfg(dp=2, metrics_path=f"{tmp}/metrics.jsonl")
    with Trainer(fit_cfg, device="cpu") as trainer:
        out["fit"] = trainer.fit()
        out["n_chips"], out["steps_per_epoch"] = trainer.n_chips, trainer.steps_per_epoch
        out["params"] = _np(trainer.model.parameters())
        out["writes_file"] = trainer.writer._file is not None

    # cross-replica BatchNorm, float64: a train-mode forward, then one step
    def resnet():
        return load_resnet(bn["params"], bn["stats"], "resnet20", device="cpu",
                           dtype=torch.float64, in_channels=3, axis_name="data",
                           **bn["arch"]).double()

    per = bn["x"].shape[0] // 2
    local = slice(rank * per, (rank + 1) * per)
    model = resnet()
    out["bn_logits"] = model(torch.from_numpy(bn["x"][local]), train=True).detach().numpy()
    out["bn_forward_state"] = _state_np(model)
    run = _dp_steps(mesh, resnet(), bn["opt"], [(bn["x"], bn["labels"])])
    out["bn_step"] = {"losses": run["losses"], "state": run["state"]}
    return out


# ---------------------------------------------------------------- ZeRO-1


def sharded_update(rank: int, params: dict, cases: dict, batches: list) -> dict:
    """ZeRO-1 against the replicated update at dp=2 on the same weights and
    batches, with and without the clip; the config-driven Trainer; its
    throughput leaving the state as it was; the validation."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import init_sharded_opt_state

    torch.set_num_threads(1)
    mesh = make_mesh(2)
    out: dict = {"forbidden": forbidden_modules()}
    model_of = lambda: load_mlp(params, device="cpu", dtype=torch.float32, hidden=(64,))  # noqa: E731
    for name, opt_kw in cases.items():
        rep = _dp_steps(mesh, model_of(), opt_kw, batches)
        model = model_of()
        plist = list(model.parameters())
        layout = C.make_bucket_layout(plist, 2, n_buckets=3)
        sharded_opt, clip = init_sharded_opt_state(RunConfig(**opt_kw), 10, plist, layout)
        sh = _dp_steps(mesh, model, opt_kw, batches, C.ShardedUpdate(layout, clip),
                       sharded_opt)
        out[name] = {"replicated": rep["state"], "sharded": sh["state"],
                     "losses": (rep["losses"], sh["losses"]),
                     "moment_sizes": [t.numel() for t in sh["opt"].mu + sh["opt"].trace],
                     "bucket_sizes": layout.bucket_sizes}

    cfg = _mini_cfg(dp=2, grad_clip=1.0, epochs=1)
    runs = {}
    for key, flag in (("replicated", False), ("sharded", True)):
        trainer = Trainer(cfg.replace(sharded_update=flag), device="cpu")
        trainer.fit()
        runs[key] = _np(trainer.model.parameters())
    out["trainer"] = runs
    snap = trainer.state.snapshot()
    tp = trainer.measure_throughput(epochs=1)
    after = trainer.state.snapshot()
    out["throughput_chips"] = tp["chips"]
    out["throughput_kept_state"] = (
        after["step"] == snap["step"]
        and after["optimizer"]["count"] == snap["optimizer"]["count"]
        and all(torch.equal(a, b) for a, b in zip(after["params"], snap["params"]))
        and all(torch.equal(a, b) for xs, ys in zip(after["optimizer"]["tensors"],
                                                    snap["optimizer"]["tensors"])
                for a, b in zip(xs, ys))
        and all(torch.equal(a, b) for a, b in zip(after["generators"], snap["generators"])))
    out["moments"] = [t.numel() for t in trainer.state.optimizer.mu]
    out["buckets0"] = _error(lambda: Trainer(cfg.replace(sharded_update=True,
                                                         sharded_update_buckets=0),
                                             device="cpu"))
    return out


# ---------------------------------------------------------------- checkpoints


def _params_of(trainer) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in trainer.model.named_parameters()}


def checkpoint_dp(rank: int, tmp: str) -> dict:
    """Checkpoints at dp=2: a replicated run saves (rank 0 writes); a dp=1
    checkpoint (``tmp/dp1``, made by the test) resumes here at dp=2; a
    ZeRO-1 run saves and a fresh ZeRO-1 trainer restores it bit-equal."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules()}
    with Trainer(_mini_cfg(dp=2, epochs=1, checkpoint_dir=f"{tmp}/dp2"), device="cpu") as t:
        t.fit()
        out["dp2"] = {"step": t.state.step, "params": _params_of(t)}
    with Trainer(_mini_cfg(dp=2, epochs=1, checkpoint_dir=f"{tmp}/dp1"), device="cpu") as t:
        out["dp1_restored_step"] = t.restore_checkpoint()
        out["dp1_restored"] = _params_of(t)
        t.fit()  # continues, at dp=2
        out["dp1_resumed_step"] = t.state.step
    zero = _mini_cfg(dp=2, epochs=1, sharded_update=True, optimizer="adam",
                     checkpoint_dir=f"{tmp}/zero1")
    with Trainer(zero, device="cpu") as t:
        t.fit()
        live = [[s.detach().clone() for s in ts] for ts in (t.state.optimizer.mu,
                                                            t.state.optimizer.nu)]
        out["zero1_step"] = t.state.step
    with Trainer(zero, device="cpu") as t:
        t.restore_checkpoint()
        got = [t.state.optimizer.mu, t.state.optimizer.nu]
        out["zero1_shards_equal"] = all(torch.equal(a, b) for ls, gs in zip(live, got)
                                        for a, b in zip(ls, gs))
        out["zero1_count"] = t.state.optimizer.count
    return out


def stream_dp(rank: int, tmp: str) -> dict:
    """One stream-mode epoch at dp=2 (the data-parallel chunk runner over
    this rank's rows of each global batch): per-step losses averaged
    across ranks, and the final parameters."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules()}
    for chunk in (3, 1):
        cfg = _mini_cfg(dp=2, epochs=1, input_mode="stream", stream_chunk=chunk)
        with Trainer(cfg, device="cpu") as t:
            m = t._epoch(t._epoch_seed(0))
            out[chunk] = {"loss": C.all_reduce_mean(m["loss"]).numpy(),
                          "params": _params_of(t), "step": t.state.step}
    return out
