"""Radix trie over token blocks: prefix sharing for the paged KV cache.

The port's copy of the JAX package's ``serving/radix_cache.py`` (host-side
Python and numpy, so it carries over unchanged).  With the cache paged
(serving/kv_pool.py), a prefix is a list of page ids, so sharing is a
radix trie keyed by ``page_size``-token blocks: each node owns ONE page
(the same id in every layer's pool) holding its block's K/V, refcounted by
the live requests whose block tables reference it.

* ``match(tokens)`` walks the deepest path of whole blocks equal to the
  prompt's prefix: a partial hit skips ``matched_tokens`` of prefill work
  (the engine computes only the suffix, through kv_pool's extend).
* Matched pages are READ-ONLY to the matching request: its block table
  maps the shared blocks to the trie's pages and every later block to
  private pages, so divergence is copy-on-write by remapping.
* ``insert`` donates a request's freshly computed full blocks into the
  trie (ref=1, held by the donor until retirement); an identical node that
  already exists wins and the donor keeps its duplicate page private.
* ``evict`` frees LRU unreferenced LEAF nodes when the pool runs dry, so
  the trie stays prefix-closed.

LRU order is a monotonic touch counter, not wall-clock, so runs replay
identically.  The trie stores PROMPT blocks only, never a sampled token,
so a sampled request matching a prefix reuses exactly the K/V a greedy one
would have computed.
"""

from __future__ import annotations

import numpy as np


class RadixNode:
    """One ``page_size``-token block of some cached prefix.  ``ref`` counts
    live holders (matching or donating requests); ``page`` is the pool page
    id holding this block's K/V in every layer."""

    __slots__ = ("key", "page", "parent", "children", "ref", "last_use")

    def __init__(self, key: bytes | None, page: int, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict[bytes, RadixNode] = {}
        self.ref = 0
        self.last_use = 0


class RadixCache:
    """Host-side radix trie over token blocks; see the module docstring."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.root = RadixNode(None, -1, None)  # sentinel, owns no page
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def _block_key(self, tokens: np.ndarray, j: int) -> bytes:
        ps = self.page_size
        return np.ascontiguousarray(
            tokens[j * ps:(j + 1) * ps], dtype=np.int32).tobytes()

    @property
    def n_blocks(self) -> int:
        """Resident nodes (= trie-owned pages)."""
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += len(node.children)
            stack.extend(node.children.values())
        return count

    def match(self, tokens) -> tuple[list[RadixNode], int]:
        """Deepest whole-block path equal to the prompt's prefix.  Returns
        (path nodes root-first, matched token count).  Touches the path
        (LRU) but does NOT acquire — callers that will reference the pages
        must ``acquire`` the path before any allocation can evict it."""
        tokens = np.asarray(tokens).reshape(-1)
        path: list[RadixNode] = []
        cur = self.root
        for j in range(len(tokens) // self.page_size):
            child = cur.children.get(self._block_key(tokens, j))
            if child is None:
                break
            self._touch(child)
            path.append(child)
            cur = child
        return path, len(path) * self.page_size

    def acquire(self, nodes) -> None:
        for node in nodes:
            node.ref += 1

    def release(self, nodes) -> None:
        for node in nodes:
            if node.ref <= 0:
                raise ValueError("release of an unheld radix node")
            node.ref -= 1

    def insert(self, tokens, have: int, pages_by_block: dict[int, int],
               path: list[RadixNode]) -> tuple[list[RadixNode], list[int]]:
        """Donate blocks ``have .. have+len(pages_by_block)`` of ``tokens``
        (page ids in ``pages_by_block``, keyed by block index) into the
        trie below ``path`` (the acquired match, ``len(path) == have``).

        Returns ``(held, kept)``: ``held`` are the new nodes (each created
        with ref=1 — the donor holds them until retirement, alongside the
        matched path), ``kept`` the page ids NOT donated because an
        identical node already existed — those stay the donor's private
        pages (its block table already points at them; content-identical
        to the winner's, freed at retirement like any private page)."""
        tokens = np.asarray(tokens).reshape(-1)
        cur = path[-1] if path else self.root
        held: list[RadixNode] = []
        kept: list[int] = []
        for j in sorted(pages_by_block):
            key = self._block_key(tokens, j)
            child = cur.children.get(key)
            if child is not None:
                # same-prefix race: existing node wins, donor keeps its page
                self._touch(child)
                kept.append(pages_by_block[j])
            else:
                child = RadixNode(key, int(pages_by_block[j]), cur)
                child.ref = 1
                self._touch(child)
                cur.children[key] = child
                held.append(child)
            cur = child
        return held, kept

    def evict(self, need: int, free_fn) -> int:
        """Free up to ``need`` pages from unreferenced LEAF nodes, LRU
        first (a parent becomes evictable once its last child goes), calling
        ``free_fn(page_id)`` per page.  Returns pages actually freed."""
        freed = 0
        while freed < need:
            victim = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    if not child.children and child.ref == 0:
                        if victim is None or child.last_use < victim.last_use:
                            victim = child
                    else:
                        stack.append(child)
            if victim is None:
                break
            del victim.parent.children[victim.key]
            free_fn(victim.page)
            freed += 1
        return freed

    def record(self, hit: bool, tokens: int = 0) -> None:
        """Stat accounting: one admission's match outcome."""
        if hit:
            self.hits += 1
            self.hit_tokens += int(tokens)
        else:
            self.misses += 1
