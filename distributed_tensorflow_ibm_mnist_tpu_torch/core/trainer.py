"""The port's Trainer: one run's model, optimizer, data and loop.

The counterpart of the JAX package's ``core/trainer.py`` for the paths
ported so far: one device per rank, the dataset resident on it (uint8
images, or int32 token sequences), LeNet-5, the MLP, ResNet-20, ResNet-50 and the
ViT on images and the causal LM on ``dataset="retrieval"``, any
optimizer/schedule of ``core/optim.py``, the loss routed as
``core/steps.py`` routes it (``fused_xent=True`` runs the K1/K2 CUDA
kernels).  ``attn="flash"`` (the causal LM, the ViT) trains through the
flash kernels (K3 forward, K4/K5/K6 backward).  Semantics follow the JAX
Trainer:

* ``fit()`` (``trainer.py:1493-1772``): per-epoch metrics stay on the
  device and are read back once per eval interval; eval every
  ``eval_every`` epochs and at the end; early stop once the test accuracy
  reaches ``target_accuracy`` (``time_to_target_s`` measured from the start
  of ``fit``); ``TrainingDiverged`` on a non-finite epoch loss; ``epoch``
  and ``summary`` records under the JAX key names.
* ``measure_throughput(epochs)`` (``:1207-1278``): one warm-up epoch off
  the clock, then ``epochs`` epochs with one readback at the end; the
  state (parameters, BatchNorm statistics, optimizer, step, generators)
  is snapshotted first and restored after.
* The epoch's data order is a pure function of ``(seed, epoch)``, as JAX's
  ``fold_in(data_rng, epoch)`` makes it.
* The attention's causal flag is derived as JAX derives it
  (``trainer.py:305-381``): ``model_kwargs["causal"]``, else
  ``config.causal``, else the family's default (True for causal_lm).  A
  family without a causal knob of its own (the ViT) gets a causal
  ``attn_fn`` (flash or vanilla, by its ``attn``) when the flag is set.
* The image models take their input size from the data: ResNets their
  ``in_channels``, the ViT its ``image_size`` and ``in_channels``.
* Token data adds ``tokens_per_sec_per_chip`` to the ``summary`` and
  throughput records.

Data parallelism (``dp > 1``, or a ``mesh``): one process per rank over
``torch.distributed`` (``launch/torchrun.py``); with no mesh given the
Trainer builds one over the initialised process group, and without a group
it raises ``ValueError``.  As the JAX Trainer: each rank holds its own rows
of the training set (``parallel.data_parallel.shard_dataset``) and draws
its own permutation of them from a seed that folds in its rank (at dp=1
the seed is unchanged); the eval set is sharded, zero-padded and masked;
the gradients are averaged across ranks each step (or the ZeRO-1 update
runs, ``sharded_update=True``); models that take ``axis_name`` (the
ResNets: cross-replica BatchNorm) get ``"data"``; rank 0's weights are
broadcast at start and each rank's dropout generator folds in its rank.
Metrics are averaged across ranks at each fence, so early stop and
``TrainingDiverged`` take the same branch on every rank; only rank 0
writes records, and ``fit()`` returns rank 0's summary on every rank.
``n_chips`` is dp.

Left out, because they describe XLA and there is nothing honest to put in
them: ``n_compiled_programs``, ``compile_time_s`` and ``compile_by_site``.
``compile_overhead_s`` (summary) and ``compile_and_first_epoch_s``
(throughput) keep their JAX names and meaning, the first interval's excess
over the steady pace: in the port that is the kernel build at first
launch, the library's algorithm choices and allocator growth, not XLA.
FLOPs are counted analytically (``utils/flops.py``).

Refused with ``NotImplementedError`` naming the ROADMAP.md item that will
port them: tp/sp/pp > 1, ``fsdp``, ``dcn_dp`` > 1,
``input_mode="stream"``, ``remat``, ``checkpoint_dir``/``resume``,
``profile_dir``, the chaos, tracer and telemetry hooks, and the causal
LM's dropout, MoE blocks and ``pos="learned"``.  The models' constructors
refuse the rest of what they cannot build yet the same way (the ViT's
dropout, MoE blocks and pipeline stages, ``block_remat``).
"""

from __future__ import annotations

import functools
import inspect
import math
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import (
    init_sharded_opt_state,
    make_optimizer,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import (
    make_epoch_runner,
    make_eval_fn,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.data import load_dataset
from distributed_tensorflow_ibm_mnist_tpu_torch.models import (
    CausalLM,
    VisionTransformer,
    get_model,
    model_accepts,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import _resolve_attn
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    ShardedUpdate,
    all_reduce_mean,
    broadcast_object,
    make_bucket_layout,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
    make_dp_epoch_runner,
    replicate,
    shard_dataset,
    shard_eval_set,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh, make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.debug import (
    TrainingDiverged,
    find_nonfinite,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import rank_device, resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import mfu as _mfu
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import model_flops_per_image
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter

TRAINABLE = ("lenet5", "mlp", "resnet20", "resnet50", "vit", "causal_lm")
_DP = "'Data-parallel training with torch.distributed'"
_PARALLEL = "'Remaining parallelism and utilities'"
_FOLLOW_UPS = "'Training follow-ups'"
_LM_FOLLOW_UPS = "'Causal-LM and ViT training follow-ups'"


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: ROADMAP.md queue 1, {item}")


def _refuse_unported(config: RunConfig, hooks: dict[str, Any]) -> None:
    """Raise for every knob this slice does not port."""
    for name, hook in hooks.items():
        if hook is not None:
            raise _later(f"the {name} hook", _FOLLOW_UPS)
    for axis in ("tp", "sp", "pp"):
        if getattr(config, axis) > 1:
            raise _later(f"{axis}={getattr(config, axis)}", _PARALLEL)
    if config.fsdp:
        raise _later("fsdp (ZeRO-3)", _DP)
    if config.dcn_dp != 1:
        raise _later(f"dcn_dp={config.dcn_dp}", _DP)
    if config.input_mode != "device":
        if config.input_mode != "stream":
            raise ValueError(
                f"input_mode must be 'device' or 'stream', got {config.input_mode!r}")
        raise _later("input_mode='stream'", _FOLLOW_UPS)
    if config.remat:
        raise _later(f"remat={config.remat!r}", _FOLLOW_UPS)
    if config.checkpoint_dir or config.resume:
        raise _later("checkpointing (checkpoint_dir / resume)", _FOLLOW_UPS)
    if config.profile_dir:
        raise _later("profile_dir", _FOLLOW_UPS)
    if config.model not in TRAINABLE:
        raise ValueError(
            f"unknown model {config.model!r}; the port trains: {list(TRAINABLE)}")
    if config.model == "causal_lm":
        kw = config.model_kwargs
        if kw.get("dropout", 0.0) > 0.0:
            raise _later("dropout in the causal LM's blocks", _LM_FOLLOW_UPS)
        if kw.get("moe_every", 0):
            raise _later("MoE blocks (moe_every)", _LM_FOLLOW_UPS)
        if kw.get("pos", "rope") == "learned":
            raise _later("pos='learned'", _LM_FOLLOW_UPS)
    if (config.model == "causal_lm") != (config.dataset == "retrieval"):
        raise ValueError(
            "causal_lm trains on token sequences (dataset='retrieval') and the "
            f"image models on images; got model={config.model!r}, "
            f"dataset={config.dataset!r}")


def _seed_words(*key: int) -> int:
    """A 63-bit generator seed that is a pure function of ``key``."""
    return int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> 1)


def _data_mesh(config: RunConfig, mesh: Mesh | None) -> tuple[int, Mesh | None]:
    """``(dp, mesh)`` of a run: ``config.dp`` (0: the process group's world
    size, 1 without a group); dp > 1 builds a mesh over the initialised
    group unless one is given (``ValueError`` naming launch.torchrun
    without a group); a given mesh must have dp ranks."""
    dp = config.dp
    if dp == 0:
        dp = mesh.size if mesh is not None else (
            dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1)
    if dp < 1:
        raise ValueError(f"dp must be >= 0, got {config.dp}")
    if mesh is None and dp > 1:
        mesh = make_mesh(dp)
    if mesh is not None and mesh.size != dp:
        raise ValueError(f"dp={dp} but the mesh's data axis has {mesh.size} rank(s)")
    return dp, mesh


class Trainer:
    """Owns the model, optimizer, device-resident data and loop of one run.

    ``device=None`` means the GPU (and raises without one): the rank's card
    ``cuda:{LOCAL_RANK}`` under a mesh; pass ``device="cpu"`` to run the
    plain PyTorch versions on the CPU.  ``mesh``: this rank's data mesh
    (``parallel.mesh.make_mesh``); built from the process group when
    ``config.dp > 1`` and none is given."""

    def __init__(self, config: RunConfig, mesh: Mesh | None = None,
                 writer: MetricWriter | None = None, device=None, chaos=None,
                 tracer=None, telemetry=None):
        _refuse_unported(config, {"chaos": chaos, "tracer": tracer,
                                  "telemetry": telemetry})
        self.config = config
        self.dp, self.mesh = _data_mesh(config, mesh)
        if config.sharded_update:
            if self.dp <= 1:
                raise ValueError(
                    "sharded_update shards the weight update over the 'data' "
                    f"axis; needs dp>1, got dp={self.dp}")
            if config.sharded_update_buckets < 1:
                raise ValueError(
                    f"sharded_update_buckets must be >= 1, got "
                    f"{config.sharded_update_buckets}")
        if config.batch_size % self.dp:
            raise ValueError(f"batch_size {config.batch_size} not divisible by dp={self.dp}")
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.device = resolve_device(device) if self.mesh is None else rank_device(device)
        data = load_dataset(
            config.dataset, n_train=config.n_train, n_test=config.n_test,
            seed=config.seed, synthetic=config.synthetic, **config.dataset_kwargs,
        )
        self.num_classes = data["num_classes"]
        self.data_synthetic: bool = bool(data.get("synthetic", True))
        image_shape = tuple(data["train_images"].shape[1:])
        tokens = data["train_images"].ndim == 2  # (N, S) token sequences
        if config.model == "lenet5" and image_shape != (28, 28, 1):
            raise ValueError(f"lenet5 takes (28, 28, 1) images, not {image_shape}")
        if not tokens and len(image_shape) != 3:
            raise ValueError(f"{config.model} takes (H, W, C) images, not {image_shape}")

        n_train = data["train_images"].shape[0]
        # under a mesh each rank steps through its own n/dp rows, B/dp at a time
        self.steps_per_epoch = (n_train // self.dp) // (config.batch_size // self.dp)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds training-set size {n_train}")
        total_steps = self.steps_per_epoch * config.epochs

        model_kwargs = dict(config.model_kwargs)
        in_features = int(np.prod(image_shape))
        if config.model == "mlp":
            model_kwargs.setdefault("in_features", in_features)
        if config.model in ("resnet20", "resnet50", "vit"):  # sized by the data
            model_kwargs.setdefault("in_channels", image_shape[2])
        if config.model == "vit":
            model_kwargs.setdefault("image_size", image_shape[:2])
        # the attention's causal flag: model_kwargs, then config, then the
        # family's default; a family with its own causal knob receives it
        family_causal = config.model == "causal_lm"
        self.causal = bool(model_kwargs["causal"] if "causal" in model_kwargs
                           else config.causal if config.causal is not None
                           else family_causal)
        if family_causal and config.causal is not None:
            model_kwargs.setdefault("causal", self.causal)
        elif (self.causal and model_accepts(config.model, "attn_fn")
              and not model_accepts(config.model, "causal")):
            # causal attention for a family with no causal knob of its own
            # (the ViT): the masked kernel by the model's attn
            model_kwargs.setdefault("attn_fn", functools.partial(
                _resolve_attn(None, model_kwargs.get("attn", "vanilla")), causal=True))
        if self.dp > 1 and model_accepts(config.model, "axis_name"):
            model_kwargs.setdefault("axis_name", "data")  # cross-replica BatchNorm
        self._data_seed = _seed_words(config.seed, 1)
        self.model = get_model(
            config.model, num_classes=self.num_classes, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                _seed_words(config.seed, 0)),
            **model_kwargs)
        if self.mesh is not None:
            replicate(self.mesh, self.model)
            model_gen = getattr(self.model, "generator", None)
            if self.dp > 1 and model_gen is not None:  # decorrelated dropout masks
                model_gen.manual_seed(_seed_words(config.seed, 0, self.rank))
        params = list(self.model.parameters())
        self._sharded = None
        if config.sharded_update:
            layout = make_bucket_layout(params, self.dp, config.sharded_update_buckets)
            optimizer, clip = init_sharded_opt_state(config, total_steps, params, layout)
            self._sharded = ShardedUpdate(layout=layout, clip=clip)
        else:
            optimizer = make_optimizer(config, total_steps, params)
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer,
                                data_generator=torch.Generator(device=self.device))
        step_kw = dict(label_smoothing=config.label_smoothing, fused_xent=config.fused_xent,
                       grad_accum=config.grad_accum)
        if self.mesh is None:
            self._run_epoch = make_epoch_runner(self.model, optimizer, config.batch_size,
                                                **step_kw)
        else:  # this rank's shard at the per-rank batch
            self._run_epoch = make_dp_epoch_runner(self.model, optimizer, config.batch_size,
                                                   self.mesh, sharded_update=self._sharded,
                                                   **step_kw)
        flops_kw = model_kwargs
        family = {"causal_lm": CausalLM, "vit": VisionTransformer}.get(config.model)
        if family is not None:  # the architecture, defaults filled in
            flops_kw = {name: par.default for name, par
                        in inspect.signature(family).parameters.items()}
            flops_kw.update(model_kwargs)
        self._flops_per_image = model_flops_per_image(
            config.model, flops_kw, self.num_classes, in_features,
            seq_len=self._hot_seq_len(data), causal=self.causal,
            image_shape=image_shape)

        def put(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(data[key])).to(
                self.device, dtype)

        inputs = torch.int32 if tokens else torch.uint8
        if self.mesh is None:
            self.train_images = put("train_images", inputs)
            self.train_labels = put("train_labels", torch.int32)
            self.test_images = put("test_images", inputs)
            self.test_labels = put("test_labels", torch.int32)
            self._eval = make_eval_fn(self.model, config.eval_batch_size)
        else:  # this rank's rows only
            train = shard_dataset(self.mesh, data["train_images"], data["train_labels"],
                                  self.device)
            *test, n_valid = shard_eval_set(self.mesh, data["test_images"],
                                            data["test_labels"], self.device)
            self.train_images, self.test_images = (x.to(inputs) for x in (train[0], test[0]))
            self.train_labels, self.test_labels = (
                x.to(torch.int32) for x in (train[1], test[1]))
            self._eval = make_eval_fn(self.model, max(1, config.eval_batch_size // self.dp),
                                      mesh=self.mesh, n_valid=n_valid)
        self.history: list[dict[str, Any]] = []
        # records come from rank 0 alone; the other ranks write to no sink
        self._owns_writer = writer is None or self.rank != 0
        self.writer = (writer if writer is not None and self.rank == 0 else MetricWriter(
            path=config.metrics_path if self.rank == 0 else None,
            stdout=not config.quiet and self.rank == 0))

    @property
    def n_chips(self) -> int:
        """Devices the run occupies: the images/sec/chip denominator."""
        return self.dp

    def _epoch_seed(self, *key: int) -> int:
        """An epoch's data-order seed; under dp > 1 it folds in the rank,
        as JAX folds the axis index into the epoch key."""
        if self.dp > 1:
            key = (*key, self.rank)
        return _seed_words(self._data_seed, *key)

    def _rank_mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged across the ranks (itself without a mesh)."""
        return x if self.mesh is None else all_reduce_mean(x)

    def _hot_seq_len(self, data: dict) -> int | None:
        """Sequence length the attention sees on the training path: the
        token length of rank-2 (LM) data, the patch-grid size of images
        through a patchifying model (the ViT's ``seq_len``); None
        otherwise."""
        shape = data["train_images"].shape
        if len(shape) == 2:
            return int(shape[1])
        return getattr(self.model, "seq_len", None)

    def _tokens_per_sec(self, sequences_per_sec: float) -> float | None:
        """sequences/sec -> tokens/sec for token data; None for images."""
        if self.train_images.ndim != 2:
            return None
        return round(sequences_per_sec * self.train_images.shape[1], 1)

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _mfu_fields(self, images_per_sec_per_chip: float) -> dict[str, Any]:
        """Analytic model TFLOP/s per chip and MFU; None off the GPU (a CPU
        rate is no device metric)."""
        if self.device.type != "cuda":
            return {"model_tflops_per_sec_per_chip": None, "mfu": None}
        fps_chip = self._flops_per_image * images_per_sec_per_chip
        m = _mfu(fps_chip, self._device_name())
        return {"model_tflops_per_sec_per_chip": round(fps_chip / 1e12, 6),
                "mfu": round(m, 6) if m is not None else None}

    def _epoch(self, epoch_seed: int) -> dict[str, torch.Tensor]:
        self.state.data_generator.manual_seed(epoch_seed)
        return self._run_epoch(self.state, self.train_images, self.train_labels)

    def close(self) -> None:
        """Release a metric writer the trainer built itself.  Idempotent."""
        if self._owns_writer:
            self.writer.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def evaluate(self) -> dict[str, float]:
        """Test accuracy and loss over the whole test set (under a mesh a
        collective: every rank calls it, and every rank gets the same)."""
        out = self._eval(self.test_images, self.test_labels)
        acc, loss = torch.stack([out["accuracy"], out["loss"]]).tolist()
        return {"accuracy": acc, "loss": loss}

    def measure_throughput(self, epochs: int = 10) -> dict[str, Any]:
        """Steady-state training throughput + MFU: ``epochs`` epochs back
        to back with one readback at the end, after one warm-up epoch off
        the clock; training state is restored afterwards."""
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        cfg = self.config
        snap = self.state.snapshot()
        try:
            t0 = time.perf_counter()
            m = self._epoch(self._epoch_seed(123))
            m["loss"][-1].item()  # the fence
            first_epoch_s = time.perf_counter() - t0

            t1 = time.perf_counter()
            for i in range(epochs):
                m = self._epoch(self._epoch_seed(123, i))
            last_loss = self._rank_mean(m["loss"].mean()).item()
            wall = time.perf_counter() - t1
            if not math.isfinite(last_loss):
                raise RuntimeError(
                    f"non-finite loss during throughput measurement: {last_loss}")
            images = self.steps_per_epoch * cfg.batch_size * epochs
            ips_chip = images / wall / self.n_chips
            result = {
                "images_per_sec": round(images / wall, 1),
                "images_per_sec_per_chip": round(ips_chip, 1),
                "epochs": epochs,
                "steps_per_epoch": self.steps_per_epoch,
                "batch_size": cfg.batch_size,
                "chips": self.n_chips,
                "compile_and_first_epoch_s": round(first_epoch_s, 3),
                **self._mfu_fields(ips_chip),
                "last_loss": last_loss,
                "device": self._device_name(),
            }
            tokens = self._tokens_per_sec(ips_chip)
            if tokens is not None:
                result["tokens_per_sec_per_chip"] = tokens
            return result
        finally:
            self.state.restore(snap)

    def fit(self) -> dict[str, Any]:
        """Run the configured number of epochs (early-stop on target acc)."""
        cfg = self.config
        if cfg.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {cfg.epochs}")
        chips = self.n_chips
        step0 = self.state.step
        abs_epoch0 = step0 // self.steps_per_epoch
        t0 = time.perf_counter()
        epoch_times: list[float] = []
        time_to_target = None
        best_acc = 0.0
        # epoch metrics stay on the device until an eval boundary, then
        # come back in one transfer for the whole interval
        pending: list[tuple[int, dict[str, torch.Tensor]]] = []
        interval_t0 = t0
        first_interval_len = 0
        images = self.steps_per_epoch * cfg.batch_size
        for epoch in range(cfg.epochs):
            metrics = self._epoch(self._epoch_seed(abs_epoch0 + epoch))
            pending.append((epoch, metrics))
            eval_now = (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1
            if not eval_now:
                continue  # keep the device queue full; no host sync this epoch

            means = self._rank_mean(torch.stack(
                [torch.stack([m["loss"].mean(), m["accuracy"].mean()])
                 for _, m in pending])).tolist()  # the fence
            interval = time.perf_counter() - interval_t0
            epoch_time = interval / len(pending)  # amortized over the interval
            if first_interval_len == 0:
                first_interval_len = len(pending)
            for (ep, _), (loss, acc) in zip(pending, means):
                if not math.isfinite(loss):
                    raise TrainingDiverged(
                        f"non-finite train loss in epoch {ep} (leaves localized "
                        f"from end-of-interval state, epoch {epoch})",
                        step=step0 + self.steps_per_epoch * (ep + 1),
                        bad_leaves=find_nonfinite(self.model),
                    )
                epoch_times.append(epoch_time)
                record = {
                    "epoch": ep,
                    "train_loss": loss,
                    "train_accuracy": acc,
                    "epoch_time_s": round(epoch_time, 4),
                    "interval_epochs": len(pending),
                    "images_per_sec": round(images / epoch_time, 1),
                    "images_per_sec_per_chip": round(images / epoch_time / chips, 1),
                }
                if ep == epoch:
                    ev = self.evaluate()
                    record["test_accuracy"] = ev["accuracy"]
                    record["test_loss"] = ev["loss"]
                    best_acc = max(best_acc, ev["accuracy"])
                    if (time_to_target is None and cfg.target_accuracy
                            and ev["accuracy"] >= cfg.target_accuracy):
                        time_to_target = time.perf_counter() - t0
                self.history.append(record)
                self.writer.write("epoch", step=step0 + self.steps_per_epoch * (ep + 1),
                                  **record)
            pending.clear()
            if time_to_target is not None and cfg.target_accuracy:
                break
            interval_t0 = time.perf_counter()

        total_time = time.perf_counter() - t0
        # the first interval carries the one-time start-up cost; the steady
        # rate excludes it and the overhead is its excess over steady pace
        steady = epoch_times[first_interval_len:] or epoch_times
        steady_mean = sum(steady) / len(steady)
        overhead = max(0.0, (epoch_times[0] - steady_mean) * first_interval_len)
        ips_chip = images / steady_mean / chips
        summary = {
            "name": cfg.name,
            "epochs_run": len(epoch_times),
            "total_time_s": round(total_time, 3),
            "compile_overhead_s": round(overhead, 3),
            "best_test_accuracy": best_acc,
            "time_to_target_s": round(time_to_target, 3) if time_to_target else None,
            "target_accuracy": cfg.target_accuracy,
            "images_per_sec": round(images / steady_mean, 1),
            "images_per_sec_per_chip": round(ips_chip, 1),
            "param_count": self.state.param_count(),
            **self._mfu_fields(ips_chip),
        }
        tokens = self._tokens_per_sec(ips_chip)
        if tokens is not None:
            summary["tokens_per_sec_per_chip"] = tokens
        if self.dp > 1:  # every rank returns rank 0's summary
            summary = broadcast_object(summary)
        self.writer.write("summary", **summary)
        return summary
