"""Training CLI of the port: preset + overrides -> Trainer.

The counterpart of the JAX package's ``launch/cli.py``::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli \\
        --preset mnist_lenet_1chip --set fused_xent=True

``--set key=value`` overrides any RunConfig field (values parsed as Python
literals when possible, else kept as strings); ``--throughput N`` measures
instead of training.  The run is on the GPU unless ``--device cpu``.  The
multi-host flags (``--coordinator``, ``--num-processes``, ``--process-id``)
and ``--virtual-devices`` belong to the JAX package's TPU launcher and
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys

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
                        help="JAX virtual CPU mesh (not ported: refused)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host coordinator (not ported: refused)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)

    if (args.coordinator or (args.num_processes or 0) > 1
            or args.process_id is not None or args.virtual_devices):
        raise NotImplementedError(
            "multi-host and virtual-device launch are not ported to the PyTorch "
            "package yet: ROADMAP.md queue 1, 'Data-parallel training across "
            "GPUs with NCCL'")
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


def main(argv: list[str] | None = None) -> int:
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer

    config, args = _build(argv)
    with Trainer(config, device=args.device) as trainer:
        if args.throughput:
            out = trainer.measure_throughput(epochs=args.throughput)
            print(json.dumps({"kind": "throughput", **out}), flush=True)
            return 0
        summary = trainer.fit()
    print(json.dumps({"kind": "final", **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
