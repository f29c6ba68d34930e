"""ctypes bindings for the repo's native (C++) data runtime, ``native/dtm.cpp``.

The port's counterpart of the JAX package's ``data/native.py``, over the
same C source (the repo's file, not the JAX package's):

* :func:`gather` — parallel batch assembly, ``out[i] = src[idx[i]]``;
* :func:`render_affine` — the synthetic-dataset renderer, multithreaded and
  deterministic per (seed, sample) whatever the thread count;
* :class:`Prefetcher` — worker threads assemble the epoch's batches, in
  order, ``depth`` ahead of the consumer (stream mode's host side).

The library is built on first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``build/host/libdtm-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists; never ``native/build/``, which the JAX
package's loader owns).  The hash covers the source and the flags; a build
writes a temporary file and ``os.replace``s it into place, so concurrent
builds (test workers) never load half a file.  Unlike the JAX module
there is no numpy fallback: a failed build or load raises with the
compiler's output, so a run that asked for the native path never runs
another one.  :func:`available` says whether the library builds and loads.
The g++ run and the load are recorded in the process's
``utils.tracing.CompileTracker`` (library ``"dtm"``).

Each C entry's ctypes argument list is :data:`ARGTYPES` (held against the
C declarations by ``tests/test_torch_build.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import record_build

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dtm.cpp"
BUILD_DIR = _ROOT / "build" / "host"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32, _i64, _f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float

ARGTYPES = {
    "dtm_gather": [_u8p, _i32p, _u8p, _i64, _i64, _i32],
    "dtm_render_affine": [_f32p, _i32, _i32, _i32, _i32, _i32p, _i64, _i32, _i32,
                          _f32, _f32, _f32, _f32, _f32, ctypes.c_uint64, _u8p, _i32],
    "dtm_prefetch_create": [_u8p, _i32p, _i64, _i64, _i32p, _i64, _i32, _i32],
    "dtm_prefetch_next": [ctypes.c_void_p, _u8p, _i32p],
    "dtm_prefetch_destroy": [ctypes.c_void_p],
}
RESTYPES = {"dtm_prefetch_create": ctypes.c_void_p, "dtm_prefetch_next": ctypes.c_int32}


def library_path() -> Path:
    """Where the library builds to; the name carries the source's and the
    flags' hash."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libdtm-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is built; return its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building native/dtm.cpp failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/dtm.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    record_build("build", "dtm", time.perf_counter() - t0)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built at first use, its entries' argument and
    result types set."""
    path = build()
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    record_build("load", "dtm", time.perf_counter() - t0)
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name)
    return lib


def available() -> bool:
    """Whether the C++ library builds and loads on this machine."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _rows(a: np.ndarray) -> np.ndarray:
    """``a`` as (rows, bytes) uint8, a view of its contiguous buffer."""
    return a.view(np.uint8).reshape(a.shape[0], -1)


def gather(src: np.ndarray, idx: np.ndarray, threads: int = 0,
           out: np.ndarray | None = None) -> np.ndarray:
    """``out[i] = src[idx[i]]`` over the leading axis, in parallel.
    ``out`` (optional): a C-contiguous array of the result's shape and
    dtype to write into (a pinned buffer's view, say)."""
    lib = load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int32)
    shape = (idx.shape[0],) + src.shape[1:]
    if out is None:
        out = np.empty(shape, src.dtype)
    elif out.shape != shape or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous {src.dtype} {shape}")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.dtm_gather(_ptr(_rows(src), _u8p), _ptr(idx, _i32p), _ptr(_rows(out), _u8p),
                   idx.shape[0], row_bytes, threads)
    return out


def render_affine(templates: np.ndarray, labels: np.ndarray, out_hw: tuple[int, int],
                  scale_range: tuple[float, float], rot_range: float, shift_frac: float,
                  noise_std: float, seed: int, threads: int = 0) -> np.ndarray:
    """The C++ renderer (the JAX package's ``backend="native"``): templates
    (C, gh, gw[, ch]) float32 in [0, 1] -> uint8 (N, H, W, ch), one
    splitmix64 stream per sample."""
    lib = load()
    if templates.ndim == 3:
        templates = templates[..., None]
    templates = np.ascontiguousarray(templates, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    n_classes, gh, gw, ch = templates.shape
    h, w = out_hw
    out = np.empty((labels.shape[0], h, w, ch), np.uint8)
    lib.dtm_render_affine(
        _ptr(templates, _f32p), n_classes, gh, gw, ch,
        _ptr(labels, _i32p), labels.shape[0], h, w,
        scale_range[0], scale_range[1], rot_range, shift_frac, noise_std,
        np.uint64(seed), _ptr(out, _u8p), threads,
    )
    return out


class Prefetcher:
    """Iterate ``(images, labels)`` batches assembled by C++ worker threads.

    ``perm`` is the epoch's flat index order (``n_batches * batch``
    entries); batches come back in order, assembled ``depth`` ahead of the
    consumer.  Images are any fixed-size rows (uint8 pictures, int32 token
    sequences); one int32 label per sample rides in the C prefetcher, and
    labels of higher rank (the causal LM's per-position labels) are
    gathered with :func:`gather` as each batch is taken.
    :meth:`next_into` writes a batch into caller-owned arrays (pinned
    host buffers), iteration into new ones."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int,
                 perm: np.ndarray, depth: int = 3, threads: int = 2):
        self._lib = load()
        self._images = np.ascontiguousarray(images)
        self._labels = np.ascontiguousarray(labels, np.int32)
        self._perm = np.ascontiguousarray(perm, np.int32)
        self._batch = batch
        self._n_batches = len(self._perm) // batch
        self._img_shape = self._images.shape[1:]
        self._lab_shape = self._labels.shape[1:]
        self._row_labels = self._labels.ndim > 1
        c_labels = (np.zeros(self._images.shape[0], np.int32) if self._row_labels
                    else self._labels)
        self._c_labels = c_labels  # the C side holds raw pointers: keep them alive
        img_bytes = self._images.dtype.itemsize * int(np.prod(self._img_shape, dtype=np.int64))
        self._handle = self._lib.dtm_prefetch_create(
            _ptr(_rows(self._images), _u8p), _ptr(c_labels, _i32p),
            img_bytes, batch, _ptr(self._perm, _i32p), self._n_batches, depth, threads)
        self._next = 0
        self._scratch = np.empty((batch,), np.int32)

    @property
    def n_batches(self) -> int:
        return self._n_batches

    def next_into(self, img_out: np.ndarray, lab_out: np.ndarray) -> bool:
        """Write the next batch into ``img_out`` (batch, *image shape) and
        ``lab_out`` (batch, *label shape), C-contiguous; False when the
        permutation is exhausted."""
        if self._handle is None:
            raise ValueError("the prefetcher is closed")
        for name, out, shape, dtype in (
                ("img_out", img_out, self._img_shape, self._images.dtype),
                ("lab_out", lab_out, self._lab_shape, np.dtype(np.int32))):
            if (out.shape != (self._batch, *shape) or out.dtype != dtype
                    or not out.flags.c_contiguous):
                raise ValueError(f"{name} must be C-contiguous {dtype} "
                                 f"{(self._batch, *shape)}")
        lab = lab_out if not self._row_labels else self._scratch
        ok = self._lib.dtm_prefetch_next(self._handle, _ptr(_rows(img_out), _u8p),
                                         _ptr(lab, _i32p))
        if not ok:
            return False
        if self._row_labels:
            b = self._next
            gather(self._labels, self._perm[b * self._batch:(b + 1) * self._batch],
                   out=lab_out)
        self._next += 1
        return True

    def __iter__(self):
        return self

    def __next__(self):
        img = np.empty((self._batch, *self._img_shape), self._images.dtype)
        lab = np.empty((self._batch, *self._lab_shape), np.int32)
        if not self.next_into(img, lab):
            raise StopIteration
        return img, lab

    def close(self):
        if self._handle is not None:
            self._lib.dtm_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
