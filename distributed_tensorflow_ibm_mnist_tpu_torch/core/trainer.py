"""The port's Trainer: one run's model, optimizer, data and loop.

The counterpart of the JAX package's ``core/trainer.py`` for the paths
ported so far: one device, the dataset resident on it (uint8 images, or
int32 token sequences), LeNet-5 or the MLP on images and the causal LM on
``dataset="retrieval"``, any optimizer/schedule of ``core/optim.py``, the
loss routed as ``core/steps.py`` routes it (``fused_xent=True`` runs the
K1/K2 CUDA kernels).  The causal LM's ``attn="flash"`` trains through the
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
  state (parameters, optimizer, step, generators) is snapshotted first and
  restored after.
* The epoch's data order is a pure function of ``(seed, epoch)``, as JAX's
  ``fold_in(data_rng, epoch)`` makes it.
* The attention's causal flag is derived as JAX derives it
  (``trainer.py:305-348``): ``model_kwargs["causal"]``, else
  ``config.causal``, else the family's default (True for causal_lm).
* Token data adds ``tokens_per_sec_per_chip`` to the ``summary`` and
  throughput records.

Left out, because they describe XLA and there is nothing honest to put in
them: ``n_compiled_programs``, ``compile_time_s`` and ``compile_by_site``.
``compile_overhead_s`` (summary) and ``compile_and_first_epoch_s``
(throughput) keep their JAX names and meaning, the first interval's excess
over the steady pace: in the port that is the kernel build at first
launch, the library's algorithm choices and allocator growth, not XLA.
FLOPs are counted analytically (``utils/flops.py``).

Refused with ``NotImplementedError`` naming the ROADMAP.md item that will
port them: dp/tp/sp/pp > 1, ``fsdp``, ``sharded_update``, ``dcn_dp`` > 1,
``input_mode="stream"``, ``remat``, ``checkpoint_dir``/``resume``,
``profile_dir``, the chaos, tracer and telemetry hooks, and the causal
LM's dropout, MoE blocks and ``pos="learned"``.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import (
    make_epoch_runner,
    make_eval_fn,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.data import load_dataset
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM, get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.debug import (
    TrainingDiverged,
    find_nonfinite,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import mfu as _mfu
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import model_flops_per_image
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter

TRAINABLE = ("lenet5", "mlp", "causal_lm")
_DP = "'Data-parallel training across GPUs with NCCL'"
_PARALLEL = "'Remaining parallelism and utilities'"
_FOLLOW_UPS = "'Training follow-ups'"
_LM_FOLLOW_UPS = "'Causal-LM training follow-ups'"


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
    if config.dp > 1:
        raise _later(f"dp={config.dp}", _DP)
    for flag in ("fsdp", "sharded_update"):
        if getattr(config, flag):
            raise _later(flag, _DP)
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
        if config.model in ("resnet20", "resnet50", "vit"):
            raise _later(f"training {config.model!r}", _FOLLOW_UPS)
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


class Trainer:
    """Owns the model, optimizer, device-resident data and loop of one run.

    ``device=None`` means the GPU (and raises without one); pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU."""

    def __init__(self, config: RunConfig, writer: MetricWriter | None = None,
                 device=None, chaos=None, tracer=None, telemetry=None):
        _refuse_unported(config, {"chaos": chaos, "tracer": tracer,
                                  "telemetry": telemetry})
        self.config = config
        self.device = resolve_device(device)
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

        n_train = data["train_images"].shape[0]
        self.steps_per_epoch = n_train // config.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds training-set size {n_train}")
        total_steps = self.steps_per_epoch * config.epochs

        model_kwargs = dict(config.model_kwargs)
        in_features = int(np.prod(image_shape))
        if config.model == "mlp":
            model_kwargs.setdefault("in_features", in_features)
        # the attention's causal flag: model_kwargs, then config, then the
        # family's default; a family with its own causal knob receives it
        family_causal = config.model == "causal_lm"
        self.causal = bool(model_kwargs["causal"] if "causal" in model_kwargs
                           else config.causal if config.causal is not None
                           else family_causal)
        if family_causal and config.causal is not None:
            model_kwargs.setdefault("causal", self.causal)
        self._data_seed = _seed_words(config.seed, 1)
        self.model = get_model(
            config.model, num_classes=self.num_classes, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                _seed_words(config.seed, 0)),
            **model_kwargs)
        optimizer = make_optimizer(config, total_steps, list(self.model.parameters()))
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer,
                                data_generator=torch.Generator(device=self.device))
        self._run_epoch = make_epoch_runner(
            self.model, optimizer, config.batch_size,
            label_smoothing=config.label_smoothing, fused_xent=config.fused_xent,
            grad_accum=config.grad_accum)
        self._eval = make_eval_fn(self.model, config.eval_batch_size)
        flops_kw = model_kwargs
        if config.model == "causal_lm":  # the architecture, defaults filled in
            flops_kw = {name: par.default for name, par
                        in inspect.signature(CausalLM).parameters.items()}
            flops_kw.update(model_kwargs)
        self._flops_per_image = model_flops_per_image(
            config.model, flops_kw, self.num_classes, in_features,
            seq_len=self._hot_seq_len(data), causal=self.causal)

        def put(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(data[key])).to(
                self.device, dtype)

        inputs = torch.int32 if tokens else torch.uint8
        self.train_images = put("train_images", inputs)
        self.train_labels = put("train_labels", torch.int32)
        self.test_images = put("test_images", inputs)
        self.test_labels = put("test_labels", torch.int32)
        self.history: list[dict[str, Any]] = []
        self._owns_writer = writer is None
        self.writer = writer or MetricWriter(path=config.metrics_path, stdout=not config.quiet)

    @property
    def n_chips(self) -> int:
        """Devices the run occupies: the images/sec/chip denominator."""
        return 1

    @staticmethod
    def _hot_seq_len(data: dict) -> int | None:
        """Sequence length the attention sees on the training path: the
        token length of rank-2 (LM) data; None for images (the port has no
        patchifying model yet)."""
        shape = data["train_images"].shape
        return int(shape[1]) if len(shape) == 2 else None

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
            m = self._epoch(_seed_words(self._data_seed, 123))
            m["loss"][-1].item()  # the fence
            first_epoch_s = time.perf_counter() - t0

            t1 = time.perf_counter()
            for i in range(epochs):
                m = self._epoch(_seed_words(self._data_seed, 123, i))
            last_loss = m["loss"].mean().item()
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
            metrics = self._epoch(_seed_words(self._data_seed, abs_epoch0 + epoch))
            pending.append((epoch, metrics))
            eval_now = (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1
            if not eval_now:
                continue  # keep the device queue full; no host sync this epoch

            means = torch.stack([torch.stack([m["loss"].mean(), m["accuracy"].mean()])
                                 for _, m in pending]).tolist()  # the fence
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
        self.writer.write("summary", **summary)
        return summary
