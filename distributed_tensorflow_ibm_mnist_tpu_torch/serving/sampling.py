"""Per-request sampling parameters and the first-token pick of the port.

:class:`SamplingParams` is the JAX package's validated per-request config,
copied.  This slice decodes greedily: :func:`first_pick` takes the argmax,
and the engine refuses a request with ``temperature > 0``.  Sampled
streams (the seed-keyed PRNG schedule, top-p/top-k/min-p filters) are a
later serving slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Validated per-request sampling config: ``temperature == 0`` is greedy
    (``top_p``/``top_k``/``min_p`` must then be 0 and the seed is inert);
    ``temperature > 0`` samples, which this slice refuses at submit."""

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

    def to_dict(self) -> dict:
        """Strict-JSON form (plain floats/ints), as request_fingerprint
        hashes it."""
        return {"temperature": float(self.temperature),
                "top_p": float(self.top_p), "top_k": int(self.top_k),
                "min_p": float(self.min_p), "seed": int(self.seed)}


def first_pick(logits: torch.Tensor):
    """Greedy pick over (B, V) float32 logits: ``((B,) token, (B,) logprob)``
    with the logprob taken from ``log_softmax`` of the raw logits."""
    tok = logits.argmax(-1)
    logp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, logp
