"""Deterministic synthetic image-classification datasets (the port's copy).

The JAX package's ``data/synthetic.py`` numpy renderer, copied so the port
imports nothing of that package: a seeded, class-conditional renderer of
MNIST-shaped problems (a fixed per-class template placed on the canvas under
a random affine transform plus brightness jitter and Gaussian noise).  A
split is a pure function of ``(seed, n)``, bit-identical to the JAX
package's for the same arguments (the tests check it).  Individual samples
are NOT independent of ``n``: the RNG stream is shared across the split.

All generation is on the host: vectorised numpy by default, or the repo's
multithreaded C++ renderer (``backend="native"``, ``data/native.py``;
bit-identical to the JAX package's native backend for the same
``(seed, n)``, and of the same difficulty class as numpy's, not its bits).
A failed native build raises; it never falls back to numpy.
"""

from __future__ import annotations

import os

import numpy as np

# Classic 5x7 dot-matrix digit glyphs. Each string row is one glyph row;
# '#' = ink. These are the class-conditional templates for synthetic MNIST.
_DIGIT_GLYPHS = [
    (" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "),  # 0
    ("  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),  # 1
    (" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"),  # 2
    ("#####", "   # ", "  #  ", "   # ", "    #", "#   #", " ### "),  # 3
    ("   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "),  # 4
    ("#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "),  # 5
    ("  ## ", " #   ", "#    ", "#### ", "#   #", "#   #", " ### "),  # 6
    ("#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "),  # 7
    (" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "),  # 8
    (" ### ", "#   #", "#   #", " ####", "    #", "   # ", " ##  "),  # 9
]


def _glyphs_to_array(glyphs) -> np.ndarray:
    """(10, H, W) float32 templates in [0, 1]."""
    arrs = []
    for g in glyphs:
        arrs.append(np.array([[1.0 if c == "#" else 0.0 for c in row] for row in g], np.float32))
    return np.stack(arrs)


def _procedural_templates(
    n_classes: int, height: int, width: int, channels: int, seed: int
) -> np.ndarray:
    """Fixed per-class low-frequency textured shapes, (C, H, W, ch) in [0,1].

    Used for synthetic Fashion-MNIST / CIFAR-10 stand-ins: each class gets a
    deterministic smooth random pattern (sum of a few random 2-D cosines)
    masked by a deterministic random blob, so classes are visually distinct
    and learnable but not trivially separable by mean intensity.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, height), np.linspace(-1, 1, width), indexing="ij"
    )
    templates = np.zeros((n_classes, height, width, channels), np.float32)
    for c in range(n_classes):
        img = np.zeros((height, width, channels), np.float32)
        for ch in range(channels):
            tex = np.zeros((height, width))
            for _ in range(4):
                fx, fy = rng.uniform(0.5, 3.0, 2)
                ph = rng.uniform(0, 2 * np.pi, 2)
                tex += rng.uniform(0.3, 1.0) * np.cos(fx * np.pi * xx + ph[0]) * np.cos(
                    fy * np.pi * yy + ph[1]
                )
            tex = (tex - tex.min()) / (np.ptp(tex) + 1e-8)
            img[..., ch] = tex
        # blob mask: union of a few random ellipses (same mask for all channels)
        mask = np.zeros((height, width))
        for _ in range(3):
            cy, cx = rng.uniform(-0.5, 0.5, 2)
            ry, rx = rng.uniform(0.25, 0.7, 2)
            th = rng.uniform(0, np.pi)
            ys, xs = yy - cy, xx - cx
            yr = ys * np.cos(th) + xs * np.sin(th)
            xr = -ys * np.sin(th) + xs * np.cos(th)
            mask = np.maximum(mask, ((yr / ry) ** 2 + (xr / rx) ** 2) < 1.0)
        templates[c] = (img * mask[..., None]).astype(np.float32)
    return templates


def _render_affine(
    templates: np.ndarray,
    labels: np.ndarray,
    out_hw: tuple[int, int],
    rng: np.random.Generator,
    scale_range: tuple[float, float],
    rot_range: float,
    shift_frac: float,
    noise_std: float,
) -> np.ndarray:
    """Render each sample's class template under a random inverse-affine map.

    templates: (C, gh, gw) or (C, gh, gw, ch) in [0,1].
    Returns float32 images (N, H, W, ch) in [0,1], bilinearly sampled.
    """
    if templates.ndim == 3:
        templates = templates[..., None]
    n = labels.shape[0]
    h, w = out_hw
    _, gh, gw, ch = templates.shape
    glyphs = templates[labels]  # (N, gh, gw, ch)

    # Per-sample transform params.
    scale = rng.uniform(scale_range[0], scale_range[1], n).astype(np.float32)
    theta = rng.uniform(-rot_range, rot_range, n).astype(np.float32)
    tx = rng.uniform(-shift_frac, shift_frac, n).astype(np.float32) * w
    ty = rng.uniform(-shift_frac, shift_frac, n).astype(np.float32) * h

    # Output pixel grid, centered.
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    ys = ys - (h - 1) / 2.0
    xs = xs - (w - 1) / 2.0

    cos_t, sin_t = np.cos(theta), np.sin(theta)  # (N,)
    # Inverse map: glyph coords = R(-theta) @ (p - t) / scale + glyph_center
    px = xs[None] - tx[:, None, None]  # (N, H, W)
    py = ys[None] - ty[:, None, None]
    inv_s = 1.0 / scale
    gx = (cos_t[:, None, None] * px + sin_t[:, None, None] * py) * inv_s[:, None, None] + (gw - 1) / 2.0
    gy = (-sin_t[:, None, None] * px + cos_t[:, None, None] * py) * inv_s[:, None, None] + (gh - 1) / 2.0

    # Bilinear sample with zero padding outside the glyph.
    x0 = np.floor(gx).astype(np.int32)
    y0 = np.floor(gy).astype(np.int32)
    fx = gx - x0
    fy = gy - y0

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < gh) & (xi >= 0) & (xi < gw)
        yc = np.clip(yi, 0, gh - 1)
        xc = np.clip(xi, 0, gw - 1)
        vals = glyphs[np.arange(n)[:, None, None], yc, xc]  # (N, H, W, ch)
        return vals * valid[..., None]

    img = (
        tap(y0, x0) * ((1 - fy) * (1 - fx))[..., None]
        + tap(y0, x0 + 1) * ((1 - fy) * fx)[..., None]
        + tap(y0 + 1, x0) * (fy * (1 - fx))[..., None]
        + tap(y0 + 1, x0 + 1) * (fy * fx)[..., None]
    )

    # Per-sample brightness jitter + additive Gaussian noise.
    gain = rng.uniform(0.75, 1.0, n).astype(np.float32)[:, None, None, None]
    img = img * gain + rng.normal(0.0, noise_std, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _make_split(
    templates: np.ndarray,
    n: int,
    seed: int,
    out_hw: tuple[int, int],
    scale_range: tuple[float, float],
    rot_range: float,
    shift_frac: float,
    noise_std: float,
    chunk: int = 16384,
    backend: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Balanced labels + rendered images, chunked to bound peak host memory.

    ``backend``: ``"numpy"`` (default) or ``"native"``, the multithreaded
    C++ renderer (``data/native.py``): the same algorithm on its own
    per-sample RNG streams.  The ``DTM_DATA_BACKEND`` env var sets the
    default.
    """
    if backend is None:
        backend = os.environ.get("DTM_DATA_BACKEND", "numpy")
    if backend not in ("numpy", "native"):
        raise ValueError(f"unknown data backend {backend!r}; use 'numpy' or 'native'")
    rng = np.random.default_rng(seed)
    n_classes = templates.shape[0]
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    if backend == "native":
        from distributed_tensorflow_ibm_mnist_tpu_torch.data import native

        images = native.render_affine(templates, labels, out_hw, scale_range, rot_range,
                                      shift_frac, noise_std, seed=seed)
        return images, labels
    imgs = []
    for start in range(0, n, chunk):
        imgs.append(
            _render_affine(
                templates,
                labels[start : start + chunk],
                out_hw,
                rng,
                scale_range,
                rot_range,
                shift_frac,
                noise_std,
            )
        )
    images = np.concatenate(imgs, axis=0)
    # Store as uint8: 4x less device memory for the resident dataset; the
    # train step converts each gathered batch to float32 / 255.
    return (images * 255.0 + 0.5).astype(np.uint8), labels


def synthetic_mnist(
    n_train: int = 60_000, n_test: int = 10_000, seed: int = 0
) -> dict[str, np.ndarray]:
    """MNIST-shaped synthetic digits: (N, 28, 28, 1) uint8 + int32 labels.

    Difficulty is tuned so an MLP lands ~97-98% and a LeNet-class CNN >=99%,
    mirroring the real-MNIST headroom the reference's metrics assume
    (SURVEY.md §2.1: "99%-capable MNIST CNN => LeNet-class, MLPs plateau ~98%").
    """
    templates = _glyphs_to_array(_DIGIT_GLYPHS)
    kw = dict(
        out_hw=(28, 28),
        scale_range=(2.2, 3.4),
        rot_range=0.30,
        shift_frac=0.12,
        noise_std=0.18,
    )
    train_x, train_y = _make_split(templates, n_train, seed * 2 + 1, **kw)
    test_x, test_y = _make_split(templates, n_test, seed * 2 + 2, **kw)
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
        "num_classes": 10,
    }


def synthetic_fashion_mnist(
    n_train: int = 60_000, n_test: int = 10_000, seed: int = 0
) -> dict[str, np.ndarray]:
    """Fashion-MNIST stand-in: 10 textured-shape classes, (N, 28, 28, 1)."""
    templates = _procedural_templates(10, 16, 16, 1, seed=7_001)[..., 0]
    kw = dict(
        out_hw=(28, 28),
        scale_range=(1.1, 1.6),
        rot_range=0.25,
        shift_frac=0.10,
        noise_std=0.15,
    )
    train_x, train_y = _make_split(templates, n_train, seed * 2 + 11, **kw)
    test_x, test_y = _make_split(templates, n_test, seed * 2 + 12, **kw)
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
        "num_classes": 10,
    }


def synthetic_cifar10(
    n_train: int = 50_000, n_test: int = 10_000, seed: int = 0
) -> dict[str, np.ndarray]:
    """CIFAR-10 stand-in: 10 colored textured-shape classes, (N, 32, 32, 3)."""
    templates = _procedural_templates(10, 20, 20, 3, seed=7_002)
    kw = dict(
        out_hw=(32, 32),
        scale_range=(1.0, 1.5),
        rot_range=0.25,
        shift_frac=0.10,
        noise_std=0.12,
    )
    train_x, train_y = _make_split(templates, n_train, seed * 2 + 21, **kw)
    test_x, test_y = _make_split(templates, n_test, seed * 2 + 22, **kw)
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
        "num_classes": 10,
    }


def synthetic_retrieval(
    n_train: int = 8192, n_test: int = 1024, seed: int = 0,
    vocab: int = 64, seq_len: int = 256,
) -> dict[str, np.ndarray]:
    """Long-context key-retrieval language-modeling task (token sequences).

    Token 0 of each sequence is a random key, every later input token is
    noise, and the label at position t is ``(key + t) mod vocab`` — so a
    model must attend across the whole context to beat the uniform
    ``-log(1/vocab)`` loss floor (the examples/06 task, promoted to a
    first-class dataset for the ``causal_lm`` zoo model).  "images" here are
    (N, seq_len) int32 token arrays; labels are per-position (N, seq_len).
    """

    def split(n, s):
        rng = np.random.default_rng(s)
        key = rng.integers(0, vocab, (n, 1))
        noise = rng.integers(0, vocab, (n, seq_len - 1))
        tokens = np.concatenate([key, noise], axis=1).astype(np.int32)
        labels = ((key + np.arange(seq_len)[None, :]) % vocab).astype(np.int32)
        return tokens, labels

    train_x, train_y = split(n_train, seed * 2 + 1)
    test_x, test_y = split(n_test, seed * 2 + 2)
    return {
        "train_images": train_x,
        "train_labels": train_y,
        "test_images": test_x,
        "test_labels": test_y,
        "num_classes": vocab,
    }
