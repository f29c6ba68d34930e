"""Per-request sampling of the port: the params, the key schedule, the pick.

:class:`SamplingParams` is the JAX package's validated per-request config,
copied.  A request's token stream is a pure function of its seed: its base
key is ``[seed >> 32, seed & 0xffffffff]`` (:func:`base_key`, numerically
``jax.random.PRNGKey(seed)``), and the token at generated index ``n`` is
picked with ``fold_in(base_key, n)``, so decode-ahead width, dense or paged
layout and an engine restart all consume the same keys.

The key schedule is JAX's own, written in torch integer ops so it runs on
the device the logits live on: :func:`threefry2x32` is the Threefry-2x32
hash (20 rounds, uint32 words carried in int64 under a 32-bit mask), and
:func:`fold_in`, :func:`random_bits`, :func:`split` and :func:`gumbel` are
``jax.random.fold_in`` / ``bits`` / ``split`` / ``gumbel`` as JAX computes
them with ``jax_threefry_partitionable`` on: the bits are equal, the
Gumbel floats within a few ulps (the logs are the libraries' own).
``jax.random.categorical`` is ``argmax(gumbel + logits)``, which
:func:`categorical` does on (B, V) rows with one key per row.

:func:`first_pick` is the first-token pick every landing shares (a fresh
prefill, a prefix-cache hit, a radix extend): hit and miss run the same
pick over the same stored logits, which is what makes the prefix cache
sampling-safe.  No kernel stands behind any of this in the JAX package
(it is XLA there); here it is plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import _pick_rows

_MASK = 0xFFFFFFFF
# Threefry-2x32's rotation schedule and key-parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Validated per-request sampling config.

    ``temperature == 0`` is greedy (argmax; ``top_p``/``top_k``/``min_p``
    must be 0 and the seed is inert), ``temperature > 0`` samples the
    tempered distribution, optionally truncated to the ``top_k``
    highest-logit tokens, nucleus-filtered by ``0 < top_p < 1`` (top-k
    first) and min-p-filtered by ``0 < min_p <= 1`` (tokens below
    ``min_p * max_prob`` cut, applied last).  ``seed`` fixes the stream."""

    temperature: float = 0.0
    top_p: float = 0.0
    top_k: int = 0
    min_p: float = 0.0
    seed: int = 0

    def __post_init__(self):
        t, p, k, s = self.temperature, self.top_p, self.top_k, self.seed
        mp = self.min_p
        if not (isinstance(t, (int, float)) and np.isfinite(t) and t >= 0):
            raise ValueError(
                f"temperature must be a finite float >= 0, got {t!r}")
        if not (isinstance(p, (int, float)) and 0.0 <= float(p) <= 1.0):
            raise ValueError(f"top_p must be in [0, 1], got {p!r}")
        if p and t == 0:
            raise ValueError(
                "top_p filters a SAMPLING distribution; set temperature > 0")
        if (not isinstance(k, (int, np.integer)) or isinstance(k, bool)
                or int(k) < 0):
            raise ValueError(f"top_k must be an int >= 0, got {k!r}")
        if k and t == 0:
            raise ValueError(
                "top_k filters a SAMPLING distribution; set temperature > 0")
        if not (isinstance(mp, (int, float)) and 0.0 <= float(mp) <= 1.0):
            raise ValueError(f"min_p must be in [0, 1], got {mp!r}")
        if mp and t == 0:
            raise ValueError(
                "min_p filters a SAMPLING distribution; set temperature > 0")
        if not isinstance(s, (int, np.integer)) or isinstance(s, bool):
            raise ValueError(f"seed must be an int, got {s!r}")
        if not 0 <= int(s) < (1 << 64):
            raise ValueError(f"seed must fit in uint64, got {s}")

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0

    def key(self) -> np.ndarray:
        """The request's (2,) uint32 Threefry base key."""
        return base_key(self.seed)

    def to_dict(self) -> dict:
        """Strict-JSON form (plain floats/ints), as request_fingerprint
        hashes it."""
        return {"temperature": float(self.temperature),
                "top_p": float(self.top_p), "top_k": int(self.top_k),
                "min_p": float(self.min_p), "seed": int(self.seed)}

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingParams":
        """Rebuild from :meth:`to_dict` output (re-validated)."""
        return cls(**d)


#: The default: greedy decode, seed inert.
GREEDY = SamplingParams()


def base_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw data on the host: the
    ``[hi32, lo32]`` uint32 pair of the 64-bit seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def rng_key(rng) -> np.ndarray:
    """The (2,) uint32 key an ``rng=`` argument names: an int seed
    (:func:`base_key`) or key data, of which the last two words are the
    key (as ``jax.random.key_data`` lays one out)."""
    if isinstance(rng, (int, np.integer)) and not isinstance(rng, bool):
        return base_key(rng)
    if isinstance(rng, torch.Tensor):
        rng = rng.cpu().numpy()
    return np.asarray(rng).astype(np.uint32).reshape(-1)[-2:]


# ----------------------------------------------------------------------
# the key schedule: Threefry-2x32 in int64 words holding uint32 values


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``: int64 tensors holding uint32 values, broadcast
    together; returns the two output words (int64, uint32 values)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key_words(keys) -> torch.Tensor:
    """(..., 2) uint32 key data (numpy or tensor) as int64 words."""
    if isinstance(keys, np.ndarray):
        return torch.from_numpy(keys.astype(np.int64))
    return keys.to(torch.int64) & _MASK


def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in`` per row: (B, 2) keys and (B,) data -> (B, 2)
    new keys (int64 words), the hash of the counter pair ``(0, data)``."""
    keys = key_words(keys)
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack((y0, y1), dim=-1)


def split(key, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)``: one (2,) key -> (num, 2) keys, the
    hashes of the counters ``(0, i)``."""
    key = key_words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack((y0, y1), dim=-1)


def random_bits(keys, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row: (B, 2) keys -> (B, n)
    uint32 values in int64, the xor of the two output words of the
    counters ``(0, i)``."""
    keys = key_words(keys)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1 (JAX's construction)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)  # < 2**31: fits int32
    return mant.view(torch.float32) - 1.0


def uniform(keys, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per row:
    (B, 2) keys -> (B, *shape) float32, bit-equal to JAX's: the floats in
    [0, 1) times the float32 span plus ``minval``, rounded once (XLA fuses
    the two into one multiply-add; the product is exact in float64, so
    float64 then float32 rounds as it does), floored at ``minval``."""
    n = 1
    for d in shape:
        n *= int(d)
    u = _unit_floats(random_bits(keys, n))
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))  # in float32, as JAX
    u = (u.double() * span + lo).float().clamp_min(lo)
    return u.reshape(u.shape[0], *shape)


def gumbel(keys, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row (the default "low"
    mode): a uniform on [tiny, 1), then ``-log(-log(u))``."""
    # uniform(minval=tiny, maxval=1): u * (1 - tiny) + tiny in float32,
    # where 1 - tiny rounds to 1; then max(tiny, .)
    return -torch.log(-torch.log(uniform(keys, (n,), minval=_F32_TINY)))


def categorical(keys, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` for each (B, V) row with its
    own key: the argmax of Gumbel noise plus the logits (first index on a
    tie, as JAX's)."""
    return (gumbel(keys, logits.shape[-1]).to(logits.dtype) + logits).argmax(-1)


def first_pick(logits, temps, topps, topks, minps, keys, pos):
    """The first-token pick every landing shares: fold each row's base key
    at its generated index ``pos`` (0 for a fresh request) and pick with
    the decode window's per-row math (core/generate.py ``_pick_rows``).
    Returns ``((B,) int64 token, (B,) float32 logprob)``."""
    return _pick_rows(logits, temps, topps, topks, minps, fold_in(keys, pos))
