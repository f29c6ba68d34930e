"""Dataset resolution (the port's copy): real on-disk caches first, synthetic
fallback.

The JAX package's ``data/loaders.py``, copied so the port imports nothing of
that package.  Resolution order is the same:

1. real data from a local cache if present (MNIST/Fashion-MNIST IDX or the
   keras-style ``.npz``, CIFAR-10 pickle batches), searched in
   ``$DTM_DATA_DIR`` and then the per-user cache locations below;
2. the deterministic synthetic generator (``synthetic.py``).

The JAX package also searches one fixed absolute directory outside the
user's home; the port does not (name it in ``$DTM_DATA_DIR`` instead).
Either way the result is the same dict schema, with ``synthetic`` recording
which source was used.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tempfile
from pathlib import Path

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.data import synthetic as _syn

_MNIST_CACHE_DIRS = [
    "~/.keras/datasets",
    "~/.cache/mnist",
    "~/data/mnist",
]


def _cache_dirs() -> list[str]:
    """Search path for dataset caches; $DTM_DATA_DIR (if set) wins.  The
    JAX package's ``/tmp/mnist_data`` is looked for under the temporary
    directory ``$TMPDIR`` names."""
    env = os.environ.get("DTM_DATA_DIR")
    tmp = os.path.join(tempfile.gettempdir(), "mnist_data")
    return ([env] if env else []) + _MNIST_CACHE_DIRS + [tmp]


def _read_idx(path: Path) -> np.ndarray:
    """Parse an (optionally gzipped) IDX file (the MNIST wire format)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an IDX file")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32, 13: np.float32, 14: np.float64}[dtype_code]
        return np.frombuffer(f.read(), dtype=dtype).reshape(dims)


def _find_file(names: list[str]) -> Path | None:
    for d in _cache_dirs():
        for name in names:
            p = Path(os.path.expanduser(d)) / name
            if p.exists():
                return p
    return None


def _try_real_mnist(prefix: str = "") -> dict[str, np.ndarray] | None:
    """Load MNIST/Fashion-MNIST from IDX or keras .npz caches if present."""
    npz = _find_file([f"{prefix}mnist.npz"])
    if npz is not None:
        with np.load(npz) as d:
            return {
                "train_images": d["x_train"][..., None].astype(np.uint8),
                "train_labels": d["y_train"].astype(np.int32),
                "test_images": d["x_test"][..., None].astype(np.uint8),
                "test_labels": d["y_test"].astype(np.int32),
                "num_classes": 10,
            }
    parts = {}
    for key, names in {
        "train_images": ["train-images-idx3-ubyte.gz", "train-images-idx3-ubyte"],
        "train_labels": ["train-labels-idx1-ubyte.gz", "train-labels-idx1-ubyte"],
        "test_images": ["t10k-images-idx3-ubyte.gz", "t10k-images-idx3-ubyte"],
        "test_labels": ["t10k-labels-idx1-ubyte.gz", "t10k-labels-idx1-ubyte"],
    }.items():
        p = _find_file([f"{prefix}{n}" for n in names] if prefix else names)
        if p is None:
            return None
        parts[key] = _read_idx(p)
    return {
        "train_images": parts["train_images"][..., None].astype(np.uint8),
        "train_labels": parts["train_labels"].astype(np.int32),
        "test_images": parts["test_images"][..., None].astype(np.uint8),
        "test_labels": parts["test_labels"].astype(np.int32),
        "num_classes": 10,
    }


def _try_real_cifar10() -> dict[str, np.ndarray] | None:
    for d in _cache_dirs():
        root = Path(os.path.expanduser(d)) / "cifar-10-batches-py"
        if not root.exists():
            continue
        xs, ys = [], []
        for i in range(1, 6):
            with open(root / f"data_batch_{i}", "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(batch[b"data"])
            ys.append(batch[b"labels"])
        with open(root / "test_batch", "rb") as f:
            tb = pickle.load(f, encoding="bytes")

        def to_img(flat):
            return np.asarray(flat, np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

        return {
            "train_images": to_img(np.concatenate(xs)),
            "train_labels": np.concatenate(ys).astype(np.int32),
            "test_images": to_img(tb[b"data"]),
            "test_labels": np.asarray(tb[b"labels"], np.int32),
            "num_classes": 10,
        }
    return None


def load_dataset(
    name: str,
    n_train: int | None = None,
    n_test: int | None = None,
    seed: int = 0,
    synthetic: bool | None = None,
    **dataset_kwargs,
) -> dict[str, np.ndarray]:
    """Load ``mnist`` | ``fashion_mnist`` | ``cifar10`` | ``retrieval``.

    ``synthetic=None`` (default) tries real caches first then falls back;
    ``True`` forces synthetic; ``False`` requires real data (raises if absent).
    Returns uint8 images (N, H, W, C), int32 labels, ``num_classes`` — except
    ``retrieval`` (synthetic-only token sequences for the ``causal_lm``
    model: int32 (N, seq_len) tokens with per-position labels; extra
    ``dataset_kwargs`` like ``vocab``/``seq_len`` reach the generator).
    """
    if name not in ("mnist", "fashion_mnist", "cifar10", "retrieval"):
        raise ValueError(f"unknown dataset {name!r}")
    real = None
    if synthetic is not True and name != "retrieval":
        try:
            if name == "mnist":
                real = _try_real_mnist()
            elif name == "fashion_mnist":
                real = _try_real_mnist(prefix="fashion-")
            else:
                real = _try_real_cifar10()
        except Exception:
            # An incomplete/corrupt cache must not break the run unless real
            # data was explicitly required.
            if synthetic is False:
                raise
            real = None
        if real is None and synthetic is False:
            raise FileNotFoundError(f"real {name} requested but no local cache found")
    elif name == "retrieval" and synthetic is False:
        raise ValueError("retrieval is a synthetic-only dataset")

    if real is None:
        gen = {
            "mnist": _syn.synthetic_mnist,
            "fashion_mnist": _syn.synthetic_fashion_mnist,
            "cifar10": _syn.synthetic_cifar10,
            "retrieval": _syn.synthetic_retrieval,
        }[name]
        kwargs = {"seed": seed, **dataset_kwargs}
        if n_train is not None:
            kwargs["n_train"] = n_train
        if n_test is not None:
            kwargs["n_test"] = n_test
        out = gen(**kwargs)
        out["synthetic"] = True  # measurement provenance (synthetic=None resolves here)
        return out

    if n_train is not None:
        real["train_images"] = real["train_images"][:n_train]
        real["train_labels"] = real["train_labels"][:n_train]
    if n_test is not None:
        real["test_images"] = real["test_images"][:n_test]
        real["test_labels"] = real["test_labels"][:n_test]
    real["synthetic"] = False
    return real
