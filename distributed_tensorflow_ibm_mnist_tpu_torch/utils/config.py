"""Run configuration + the five benchmark presets (the port's copy).

The JAX package's ``utils/config.py``, copied so the port imports nothing
of that package: the same ``RunConfig`` fields with the same defaults, and
the same five ``PRESETS``.  The port's Trainer runs these knobs, the
parallel ones (``dp``, ``tp``, ``sp``, ``sp_impl``, ``pp``,
``pp_microbatches``, ``fsdp``, ``sharded_update``, ``dcn_dp``) as any
other field (``--set`` on the command line), and refuses by name what it
does not compose (``core/trainer.py``).  One field keeps its JAX meaning only for
configuration compatibility: ``compile_cache_dir`` (eager PyTorch compiles
no programs at run time, so there is nothing to cache; the field is
accepted and has no effect).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class RunConfig:
    """Complete description of a training run (fields and defaults as the
    JAX package's; comments say what the port does with each)."""

    name: str = "run"
    # model
    model: str = "lenet5"
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    # data
    dataset: str = "mnist"
    dataset_kwargs: dict[str, Any] = field(default_factory=dict)  # generator extras
    synthetic: bool | None = None  # None = real cache if present, else synthetic
    n_train: int | None = None
    n_test: int | None = None
    # optimization
    batch_size: int = 128  # global batch
    epochs: int = 10
    optimizer: str = "adam"  # adam | adamw | sgd | momentum (nesterov)
    lr: float = 1e-3
    schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float | None = None  # clip gradients to this global L2 norm
    label_smoothing: float = 0.0
    fused_xent: bool = False  # fused softmax-xent kernels (ops/xent.py) for the train loss
    grad_accum: int = 1  # microbatches per step (gradient accumulation)
    remat: bool | str = False  # False | True (the whole forward) | "blocks" (each block)
    # input pipeline
    input_mode: str = "device"  # device: dataset resident on the GPU; stream: host-
    #                             resident, batches from the native prefetcher
    prefetch_depth: int = 3  # stream mode: batches assembled ahead of the consumer
    stream_chunk: int = 8  # stream mode: batches per host->device transfer
    # parallelism (one rank a process: dp * tp * sp * pp ranks)
    dp: int = 1  # data-parallel degree; 0 => all visible devices
    tp: int = 1  # tensor-parallel degree
    sp: int = 1  # sequence-parallel degree
    sp_impl: str = "ring"  # 'ring' | 'ulysses' (sequence parallelism only)
    causal: bool | None = None  # causal attention mask (sequence models only)
    pp: int = 1  # pipeline-parallel degree
    pp_microbatches: int = 0  # pipeline microbatches; 0 = pp
    fsdp: bool = False  # ZeRO-3 sharding (needs dp > 1)
    sharded_update: bool = False  # ZeRO-1 sharded weight update (needs dp > 1)
    sharded_update_buckets: int = 4  # gradient buckets for sharded_update
    dcn_dp: int = 1  # multislice: nodes the data axis spans (parallel/mesh.py)
    # run control
    seed: int = 0
    target_accuracy: float | None = None  # stop early when test acc reaches this
    eval_every: int = 1  # epochs between evals
    eval_batch_size: int = 2000
    checkpoint_dir: str | None = None  # step checkpoints with integrity manifests
    checkpoint_every: int = 0  # epochs between saves; 0 = final save only
    resume: bool = False  # restore the newest intact checkpoint before training
    preempt_poll_every: int = 0  # stream mode: steps between preemption polls
    metrics_path: str | None = None  # JSONL file (always also stdout unless quiet)
    quiet: bool = False  # suppress stdout metric lines (tests/benchmarks)
    profile_dir: str | None = None  # torch.profiler Chrome trace of the steady epochs
    compile_cache_dir: str | None = "default"  # no effect in the port (see above)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# The five measurement configs of BASELINE.md, as the JAX package names them.
PRESETS: dict[str, RunConfig] = {
    # 1. "MNIST 2-layer MLP, single-process, batch=32 (CPU smoke test)"
    "mnist_mlp_smoke": RunConfig(
        name="mnist_mlp_smoke", model="mlp", model_kwargs={"hidden": (256,)},
        dataset="mnist", batch_size=32, epochs=3, lr=1e-3, dp=1,
        target_accuracy=0.97,
    ),
    # 2. "MNIST LeNet-5 CNN, single TPU core, batch=128"
    "mnist_lenet_1chip": RunConfig(
        name="mnist_lenet_1chip", model="lenet5", dataset="mnist",
        batch_size=128, epochs=12, lr=1e-3, schedule="cosine", dp=1,
        target_accuracy=0.99,
    ),
    # 3. "MNIST CNN, 8-core TPUStrategy-equivalent data-parallel, global batch=1024"
    "mnist_cnn_dp8": RunConfig(
        name="mnist_cnn_dp8", model="lenet5", dataset="mnist",
        batch_size=1024, epochs=20, lr=2e-3, schedule="warmup_cosine",
        warmup_steps=100, dp=8, target_accuracy=0.99,
    ),
    # 4. "Fashion-MNIST ResNet-20, v4-32 data-parallel"
    "fashion_resnet20_dp32": RunConfig(
        name="fashion_resnet20_dp32", model="resnet20", dataset="fashion_mnist",
        batch_size=4096, epochs=30, optimizer="momentum", lr=0.4,
        schedule="warmup_cosine", warmup_steps=200, weight_decay=1e-4, dp=32,
        target_accuracy=0.90,
    ),
    # 5. "CIFAR-10 ResNet-50, v4-32 (stretch beyond MNIST)"
    "cifar_resnet50_dp32": RunConfig(
        name="cifar_resnet50_dp32", model="resnet50", dataset="cifar10",
        batch_size=4096, epochs=40, optimizer="momentum", lr=0.4,
        schedule="warmup_cosine", warmup_steps=300, weight_decay=1e-4, dp=32,
        target_accuracy=0.90,
    ),
}


def get_preset(name: str) -> RunConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None
