"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists).  The hash covers the source, every shared
header ``csrc/*.cuh`` (which any source may include) and the compiler
flags, so an edited source or header rebuilds at its next use and an
unchanged one is reused.  Nothing here runs at import: a machine without
``nvcc`` imports the package and runs the plain PyTorch versions; only a
kernel launch needs the library.

No PyTorch header is included: a source with a C interface builds in
seconds, where one that includes ``torch/extension.h`` takes minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the .log
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` (or
    ``CUDA_PATH``, default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of the port build at first launch and need the CUDA toolkit")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the name carries the hash of the
    source, the shared headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built;
    returns ``(output path, temp path, process or None)``."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path | None, proc) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)  # ptxas registers/spills, for reading
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if needed and return the library's path."""
    return _finish(name, *_start(name))


def build_all() -> dict[str, Path]:
    """Build every source, one nvcc each, all started together."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, *job) for name, job in started.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build(name)))


def entry(name: str, fn: str, argtypes: dict):
    """The C entry ``fn`` of ``csrc/<name>.cu``, its argument types set from
    ``argtypes[fn]`` and its result a C int (a cudaError_t value)."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes[fn]
    f.restype = ctypes.c_int
    return f
