"""The port stands alone: no JAX, no JAX package, no silent CPU.

* Importing the port and every submodule in a fresh interpreter loads no
  ``jax``, no ``flax`` and no module of the JAX package
  (``distributed_tensorflow_ibm_mnist_tpu`` or below it — mind the prefix:
  the port's own name starts with the JAX package's).
* No source of the port, nor chip_smoke.py, imports them.
* With no GPU and no ``device`` argument, the entry points raise instead
  of running on the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    load_causal_lm,
    load_lenet5,
    load_resnet,
    load_vit,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_tensorflow_ibm_mnist_tpu_torch"
JAX_PKG = "distributed_tensorflow_ibm_mnist_tpu"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax"}


def _forbidden(module: str) -> bool:
    return (module.split(".")[0] in FORBIDDEN_ROOTS or module == JAX_PKG
            or module.startswith(JAX_PKG + "."))


def test_forbidden_matches_the_jax_package_but_not_the_port():
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".ops.xent")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden(JAX_PKG + "_torch")
    assert not _forbidden(JAX_PKG + "_torch.ops.flash_attention")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT.name} as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert PORT.name + ".serving.engine" in loaded  # the walk reached the leaves
    assert PORT.name + ".core.trainer" in loaded and PORT.name + ".launch.cli" in loaded
    assert PORT.name + ".models.resnet" in loaded
    for name in ("launch.torchrun", "parallel.mesh", "parallel.collectives",
                 "parallel.data_parallel"):  # the data-parallel slice
        assert f"{PORT.name}.{name}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        get_model("causal_lm", num_classes=16, dim=32, depth=1, heads=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        load_causal_lm({}, num_classes=16, dim=32, depth=1, heads=2)
    for name in ("lenet5", "mlp", "resnet20", "resnet50", "vit"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            get_model(name)
    for load in (load_lenet5, load_vit, lambda p: load_resnet(p, {}, "resnet20")):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            load({})
    model = get_model("causal_lm", num_classes=16, dim=32, depth=1, heads=2,
                      device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        InferenceEngine(model, slots=1, max_len=16)
    assert resolve_device("cpu") == torch.device("cpu")
