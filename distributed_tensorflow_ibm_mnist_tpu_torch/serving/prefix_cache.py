"""Content-addressed prompt prefix cache of the port.

The counterpart of the JAX package's ``serving/prefix_cache.py``.  Traffic
repeats itself (system prompts, few-shot preambles, retries), and a prefill
is the one per-request dispatch the engine cannot batch away, so a repeated
prompt is redundant work.  The engine keys each admission by a blake2b
digest of its BUCKET-granular prompt (:func:`prefix_key`) and, on a hit,
reuses the stored prefill cache row and last-position logits: no prefill
runs at all.

* **Whole-prompt granularity** — an entry matches only a byte-identical
  (bucket, prompt) pair; partial-prefix reuse is the paged engine's radix
  trie (serving/radix_cache.py).
* **Sampling-safe** — the cache holds only the DETERMINISTIC prefill
  products (the cache row and the logits), never a picked token; every
  admission, hit or miss, picks its own first token from those logits
  through the one shared pick (serving/sampling.py ``first_pick``).

Eviction is byte-bounded LRU over the stored tensors' bytes (device
memory is the budget), not entry-counted.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch


def prefix_key(bucket: int, tokens) -> str:
    """Content address of a bucket-granular prompt prefix: blake2b over the
    bucket id + the raw int32 token bytes (the bucket is part of the
    prefill identity: it fixes the padded shape and pad positions)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(int(bucket).to_bytes(8, "little"))
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.hexdigest()


def _nbytes(tree) -> int:
    """Bytes of every tensor (or array) in a nested dict/list/tuple; a row
    that states its whole size (``nbytes``: a tensor-parallel rank's share
    of it, serving/engine.py) counts that, so the budget holds the same
    entries at any tp."""
    if isinstance(tree, dict):
        stated = getattr(tree, "nbytes", None)
        if stated is not None:
            return int(stated)
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    return int(getattr(tree, "nbytes", 0))


class PrefixCache:
    """Byte-bounded LRU of prefill results keyed by :func:`prefix_key`.

    Values are ``(row_cache, payload)``: the B=1 prefill cache (on the
    device, reused read-only: the slot insert copies it) and a
    deterministic payload replayed on a hit (the engine stores the (1, V)
    last-position logits).  ``get`` counts hits and misses; ``put``
    refuses and counts (``oversized``) an entry larger than the budget."""

    def __init__(self, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError(
                f"max_bytes must be > 0 (omit the cache to disable it), "
                f"got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.oversized = 0
        # key -> (row_cache, payload, entry_bytes); order IS recency
        self._entries: OrderedDict[str, tuple] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str):
        """The (row_cache, payload) stored under ``key``, or None."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry[0], entry[1]

    def put(self, key: str, row_cache, payload) -> None:
        """Store one prefill result, evicting least-recently-used entries
        until the byte budget holds; an entry larger than the whole budget
        is refused and counted (storing it would drain the LRU only to
        miss again)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        nbytes = _nbytes(row_cache) + _nbytes(payload)
        if nbytes > self.max_bytes:
            self.oversized += 1
            return
        self._entries[key] = (row_cache, payload, nbytes)
        self.bytes += nbytes
        while self.bytes > self.max_bytes:
            _, (_, _, nb) = self._entries.popitem(last=False)
            self.bytes -= nb

    def clear(self) -> None:
        """Drop every entry (hit/miss counters survive)."""
        self._entries.clear()
        self.bytes = 0
