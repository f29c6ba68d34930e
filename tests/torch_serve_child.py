"""A serving process for the port's crash-recovery test: run as
``python tests/torch_serve_child.py DIR``.

It imports neither JAX nor the JAX package: it builds the tier that
``DIR/config.json`` describes (the port's CausalLM on the CPU with the
weights of ``DIR/weights.pt``), with a request journal in ``DIR/journal``
(fsync ``always``), the front door on 127.0.0.1 and fsync'd telemetry in
``DIR/telemetry.jsonl``; it publishes its port in ``DIR/port`` and serves
until it is killed.  ``step_sleep_s`` slows every engine step so that a
kill lands while clients are mid-stream.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    FrontDoor,
    InferenceEngine,
    RequestJournal,
    Router,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import Telemetry


def build_daemon(work: Path, cfg: dict, journal, step_sleep_s: float = 0.0):
    """The tier of ``cfg`` over ``journal`` (not started)."""
    torch.set_num_threads(1)
    sd = torch.load(work / "weights.pt")

    def make(tid):
        eng = InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **cfg["model"]), sd,
            scheduler=FIFOScheduler(max_len=cfg["max_len"], buckets=tuple(cfg["buckets"]),
                                    max_queue=64),
            trace_tid=tid, device="cpu", **cfg["engine"])
        if step_sleep_s:
            step = eng.step

            def slow():
                time.sleep(step_sleep_s)
                return step()

            eng.step = slow
        return eng

    return ServingDaemon(Router(make, cfg["replicas"]), max_queue=64, journal=journal,
                         watchdog_interval_s=0.01)


def main(directory: str) -> int:
    work = Path(directory)
    cfg = json.loads((work / "config.json").read_text())
    daemon = build_daemon(work, cfg, RequestJournal(str(work / "journal"),
                                                    fsync_policy="always"),
                          cfg["step_sleep_s"]).start()
    fd = FrontDoor(daemon, keepalive_s=5.0).start_in_thread()
    tele = Telemetry(interval_s=0.05, jsonl_path=str(work / "telemetry.jsonl"), fsync=True)
    tele.register_source("daemon", daemon.summary)
    tele.sample()

    def black_box():
        while True:
            time.sleep(0.05)
            tele.sample()

    threading.Thread(target=black_box, daemon=True).start()
    (work / "port.tmp").write_text(str(fd.port))
    os.replace(work / "port.tmp", work / "port")
    while True:  # the parent's SIGKILL is the only way out
        time.sleep(1.0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
