"""Training CLI of the port: preset + overrides -> Trainer.

The counterpart of the JAX package's ``launch/cli.py``::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli \\
        --preset mnist_lenet_1chip --set fused_xent=True

``--set key=value`` overrides any RunConfig field (values parsed as Python
literals when possible, else kept as strings); ``--resume`` restores the
newest intact checkpoint of ``checkpoint_dir`` first; ``--profile DIR``
writes a Chrome trace of the steady-state epochs (of the measurement,
with ``--throughput``); ``--throughput N`` measures instead of training.
The run is on the GPU unless ``--device cpu``.

Data-parallel runs, one process per rank (``launch/torchrun.py``):

* ``torchrun --nproc-per-node N -m ...launch.cli --preset mnist_cnn_dp8``:
  each process joins from torchrun's environment (NCCL on the cards);
* ``--coordinator HOST:PORT --num-processes N --process-id R``: the JAX
  launcher's flags, one process started by hand per rank;
* ``--virtual-devices N --device cpu``: N local gloo ranks on the CPU,
  spawned by this command (the port's form of JAX's virtual CPU mesh).

Under a world of N ranks a config at ``dp`` 0 or 1 trains at ``dp=N /
(tp * sp * pp)``; any other ``dp`` times ``tp`` times ``sp`` times ``pp``
must equal N.
``--set tp=2`` splits every leaf Megatron's rule splits over each data
row's tp ranks (tensor parallelism)::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli --virtual-devices 4 \
        --device cpu --preset mnist_mlp_smoke --set tp=2 --set synthetic=True

``--set sp=2 --set
sp_impl=ulysses`` (or ``ring``, the default) shards the sequence of a
sequence model (the causal LM, the ViT) over each data row's sp ranks::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli --virtual-devices 4 \
        --device cpu --set model=causal_lm --set dataset=retrieval --set sp=2 \
        --set sp_impl=ulysses

``--set pp=4 --set pp_microbatches=8`` pipelines a block-stacked model
(the ViT, the causal LM) over each data row's pp ranks (GPipe,
``parallel/pipeline.py``), example 07(a)'s layout at dp=2::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli --virtual-devices 8 \
        --device cpu --set model=vit --set pp=4 --set pp_microbatches=8 \
        --set synthetic=True --set n_train=256 --set n_test=64 --set batch_size=32 \
        --set "model_kwargs={'patch_size': 7, 'dim': 32, 'depth': 4, 'heads': 2}"

Only rank 0 prints records and the
``final`` line.  The sharded runs take their knobs through ``--set`` as
any other field: ``--set fsdp=True`` (ZeRO-3), with ``--set
sharded_update=True`` (its small leaves' moments split too), ``--set
dcn_dp=2`` (the group must span two nodes), and a model with
``moe_every`` under N > 1 ranks trains expert-parallel::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli --virtual-devices 2 \
        --device cpu --preset mnist_mlp_smoke --set fsdp=True --set synthetic=True
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import tempfile
from pathlib import Path

from distributed_tensorflow_ibm_mnist_tpu_torch.launch.torchrun import bootstrap, spawn
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import (
    PRESETS,
    RunConfig,
    get_preset,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.profiling import trace


def _parse_override(kv: str) -> tuple[str, object]:
    if "=" not in kv:
        raise argparse.ArgumentTypeError(f"override {kv!r} must be key=value")
    key, raw = kv.split("=", 1)
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    return key, value


def build_config(argv: list[str] | None = None) -> RunConfig:
    return _build(argv)[0]


def _build(argv: list[str] | None = None) -> tuple[RunConfig, argparse.Namespace]:
    parser = argparse.ArgumentParser(
        prog="distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli",
        description="PyTorch/CUDA trainer (see BASELINE.md for the preset configs)",
    )
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="named benchmark config")
    parser.add_argument(
        "--set", dest="overrides", action="append", default=[], type=_parse_override,
        metavar="KEY=VALUE", help="override any RunConfig field (repeatable)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest intact checkpoint from checkpoint_dir "
                        "before training")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the steady-state epochs "
                        "into DIR/trace.json (a Chrome trace); shorthand for "
                        "--set profile_dir=DIR")
    parser.add_argument(
        "--throughput", type=int, default=None, metavar="EPOCHS",
        help="measure steady-state throughput/MFU over EPOCHS chained epochs "
        "(Trainer.measure_throughput) instead of training; prints one JSON line")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    parser.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                        help="spawn N local gloo ranks on the CPU and train data-parallel")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-process: the rendezvous address (tcp://HOST:PORT)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-process: the world size")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-process: this process's rank")
    args = parser.parse_args(argv)

    if args.virtual_devices is not None:
        if args.virtual_devices < 1:
            parser.error(f"--virtual-devices must be >= 1, got {args.virtual_devices}")
        if args.coordinator or args.num_processes or args.process_id is not None:
            parser.error("--virtual-devices spawns its own ranks: it takes no "
                         "--coordinator, --num-processes or --process-id")
        if args.device != "cpu":
            parser.error("--virtual-devices runs gloo ranks on the CPU: it needs "
                         f"--device cpu, got {args.device or 'the GPU (no --device)'}")
    config = get_preset(args.preset) if args.preset else RunConfig()
    overrides = dict(args.overrides)
    if args.resume:
        overrides["resume"] = True
    if args.profile:
        overrides["profile_dir"] = args.profile
    unknown = set(overrides) - set(config.to_dict())
    if unknown:
        parser.error(f"unknown config fields: {sorted(unknown)}")
    return config.replace(**overrides), args


def _join(args: argparse.Namespace) -> dict | None:
    """Join the process group the flags or torchrun's environment describe;
    None when the run is a single process."""
    if args.coordinator or (args.num_processes or 0) > 1:
        init = f"tcp://{args.coordinator}" if args.coordinator else None
        return bootstrap(init_method=init, world_size=args.num_processes,
                         rank=args.process_id, device=args.device)
    if "WORLD_SIZE" in os.environ:  # started by torchrun
        return bootstrap(device=args.device)
    return None


def world_config(config: RunConfig, world: int) -> RunConfig:
    """``config`` as a rank of ``world`` runs it: at ``dp`` 0 or 1 the data
    axis takes the ranks the model, seq and pipe axes leave (``world / (tp
    * sp * pp)``)."""
    if world > 1 and config.dp in (0, 1):
        inner = max(1, config.tp) * max(1, config.sp) * max(1, config.pp)
        return config.replace(dp=max(1, world // inner))
    return config


def _run(config: RunConfig, device, throughput: int | None, world: int, rank: int) -> int:
    """Train (or measure) as one rank of ``world``; rank 0 prints the result."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer

    config = world_config(config, world)
    with Trainer(config, device=device) as trainer:
        if throughput and config.profile_dir and rank == 0:
            # the measurement region, its warm-up epoch included (fit()
            # stages the first epoch out instead)
            with trace(config.profile_dir):
                out = {"kind": "throughput", **trainer.measure_throughput(epochs=throughput)}
        elif throughput:
            out = {"kind": "throughput", **trainer.measure_throughput(epochs=throughput)}
        else:
            out = {"kind": "final", **trainer.fit()}
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def _virtual_rank(rank: int, config: RunConfig, throughput: int | None, world: int) -> int:
    return _run(config, "cpu", throughput, world, rank)


def main(argv: list[str] | None = None) -> int:
    config, args = _build(argv)
    if args.virtual_devices:
        with tempfile.TemporaryDirectory() as tmp:
            spawn(_virtual_rank, args.virtual_devices, "gloo", "cpu",
                  Path(tmp) / "store", args=(config, args.throughput, args.virtual_devices),
                  timeout=None)
        return 0
    info = _join(args)
    if info is not None:
        print(json.dumps({"kind": "bootstrap", **info}), flush=True)
    world, rank = (1, 0) if info is None else (info["process_count"], info["process_index"])
    return _run(config, args.device, args.throughput, world, rank)


if __name__ == "__main__":
    sys.exit(main())
