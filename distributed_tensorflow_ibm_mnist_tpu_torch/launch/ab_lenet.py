"""LeNet-5 training of two checkouts of the repo on one card, interleaved.

Host times on a shared machine drift by 2x between runs of the same code,
so a change to the LeNet path is judged only against its parent within one
call, in the order A B B A::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.ab_lenet \\
        PARENT_DIR CHANGE_DIR

Each run is a fresh interpreter started in its checkout, so it imports
that checkout's port and its kernels, which are built before the first
run.  It trains the
``mnist_lenet_1chip`` preset with ``fused_xent=True`` (synthetic MNIST, as
``chip_smoke.py``'s ``training`` phase) and then measures
``measure_throughput(epochs=2)``.  One JSON line per run: the tree's label,
time to 99% (data set-up excluded), ``fit()``'s and the steady
images/sec/chip; first a line with the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

_RUN = """
import json, torch
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset
cfg = get_preset("mnist_lenet_1chip").replace(fused_xent=True, synthetic=True, quiet=True)
trainer = Trainer(cfg, device="cuda")
summary = trainer.fit()
tp = trainer.measure_throughput(epochs=2)
trainer.close()
print(json.dumps({"time_to_target_s": summary["time_to_target_s"],
                  "best_test_accuracy": summary["best_test_accuracy"],
                  "fit_ips": summary["images_per_sec_per_chip"],
                  "steady_ips": tp["images_per_sec"]}))
"""


# every kernel of the checkout, built before the timed runs
_BUILD = """
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
_build.build_all()
print("{}")
"""


def run(tree: str, code: str = _RUN) -> dict:
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"the run in {tree} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"A": argv[0], "B": argv[1]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "A": trees["A"], "B": trees["B"]}), flush=True)
    for tree in trees.values():
        run(tree, _BUILD)
    for label in "ABBA":
        print(json.dumps({"tree": label, **run(trees[label])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
