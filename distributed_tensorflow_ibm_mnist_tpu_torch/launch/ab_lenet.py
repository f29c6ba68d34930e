"""LeNet-5 training and the serving run of two checkouts of the repo on
one card, interleaved.

Host times on a shared machine drift by 2x between runs of the same code,
so a change to the LeNet or serving path is judged only against its parent
within one call, in the order A B B A::

    python -m distributed_tensorflow_ibm_mnist_tpu_torch.launch.ab_lenet \\
        PARENT_DIR CHANGE_DIR [ROUNDS]

``ROUNDS`` (default 1) repeats A B B A, so each side runs first in half
of the pairs.

Each run is a fresh interpreter started in its checkout, so it imports
that checkout's port and its kernels, which are built before the first
run.  It trains the
``mnist_lenet_1chip`` preset with ``fused_xent=True`` (synthetic MNIST, as
``chip_smoke.py``'s ``training`` phase) and then measures
``measure_throughput(epochs=2)``.  One JSON line per run: the tree's label,
time to 99% (data set-up excluded), ``fit()``'s and the steady
images/sec/chip; first a line with the card's ``nvidia-smi`` name and
power limit.  Each run then serves through the checkout's own
``chip_smoke.py`` serving phase (16 requests x 32 tokens through
``InferenceEngine``) in a second fresh interpreter, and its line adds
that phase's wall time, TTFT p50 and decode tokens/s.  The last line
gives each metric's median and quartiles per tree.
"""

from __future__ import annotations

import json
import statistics
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


_SERVE = """
import json, torch, chip_smoke
from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import make_generator, make_prefill
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa, xent
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
rec = chip_smoke.phase_serving(torch, fa, xent,
                               (get_model, InferenceEngine, make_prefill, make_generator))
print(json.dumps({k: rec[k] for k in ("wall_s", "ttft_s_p50", "decode_tokens_per_s")}))
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
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(argv[2]) if len(argv) == 3 else 1
    trees = {"A": argv[0], "B": argv[1]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "A": trees["A"], "B": trees["B"]}), flush=True)
    for tree in trees.values():
        run(tree, _BUILD)
    runs = {"A": [], "B": []}
    for label in "ABBA" * rounds:
        rec = {**run(trees[label]), **run(trees[label], _SERVE)}
        runs[label].append(rec)
        print(json.dumps({"tree": label, **rec}), flush=True)
    summary = {}
    for label, recs in runs.items():
        summary[label] = {}
        for key in ("time_to_target_s", "steady_ips", "wall_s", "ttft_s_p50",
                    "decode_tokens_per_s"):
            vals = [r[key] for r in recs]
            q1, med, q3 = statistics.quantiles(vals, n=4)  # two runs a round at least
            summary[label][key] = {"median": med, "q1": q1, "q3": q3}
    print(json.dumps({"summary": summary, "runs_per_tree": 2 * rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
