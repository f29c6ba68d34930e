"""Training CLI of the port: preset + overrides -> Trainer.

The counterpart of the JAX package's ``launch/cli.py``::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli \\
        --preset mnist_lenet_1chip --set fused_xent=True

``--set key=value`` overrides any RunConfig field (values parsed as Python
literals when possible, else kept as strings); ``--throughput N`` measures
instead of training.  The run is on the GPU unless ``--device cpu``.

Data-parallel runs, one process per rank (``launch/torchrun.py``):

* ``torchrun --nproc-per-node N -m ...launch.cli --preset mnist_cnn_dp8``:
  each process joins from torchrun's environment (NCCL on the cards);
* ``--coordinator HOST:PORT --num-processes N --process-id R``: the JAX
  launcher's flags, one process started by hand per rank;
* ``--virtual-devices N --device cpu``: N local gloo ranks on the CPU,
  spawned by this command (the port's form of JAX's virtual CPU mesh).

Under a world of N ranks a config at ``dp`` 0 or 1 trains at ``dp=N``;
any other ``dp`` must equal N.  Only rank 0 prints records and the
``final`` line.
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
                        help="restore the latest checkpoint (not ported: refused)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="profile capture (not ported: refused)")
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


def _run(config: RunConfig, device, throughput: int | None, world: int, rank: int) -> int:
    """Train (or measure) as one rank of ``world``; rank 0 prints the result."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer

    if world > 1 and config.dp in (0, 1):
        config = config.replace(dp=world)
    with Trainer(config, device=device) as trainer:
        if throughput:
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
