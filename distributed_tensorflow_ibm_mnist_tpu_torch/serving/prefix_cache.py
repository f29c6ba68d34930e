"""Prompt prefix keys of the port.

Only :func:`prefix_key` is ported in this slice: the scheduler stamps it on
every request.  The byte-bounded prefix cache that looks it up (the JAX
package's ``PrefixCache``) is a later serving slice.
"""

from __future__ import annotations

import hashlib

import numpy as np


def prefix_key(bucket: int, tokens) -> str:
    """Content address of a bucket-granular prompt prefix: blake2b over the
    bucket id + the raw int32 token bytes (the bucket is part of the
    prefill identity: it fixes the padded shape and pad positions)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(int(bucket).to_bytes(8, "little"))
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.hexdigest()
