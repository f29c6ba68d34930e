"""Paged KV-cache pool of the port: the serving side of the paged decode.

The counterpart of the JAX package's ``serving/kv_pool.py``.  The dense
engine holds ``slots * max_len`` cache positions from the start; the paged
layout re-blocks them into a pool of ``page_size``-token pages per layer
plus a per-slot BLOCK TABLE mapping each row's virtual positions to pool
pages, so memory scales with LIVE tokens: admission allocates
``ceil((len + max_new) / page_size)`` pages, retirement frees them, and an
engine may run more slots than its pool could hold at worst case
(overcommit), stalling admission, never failing it, while the pool is dry.

Layout, per block (mirrors the dense cache's):

    dense   {"k": (B, max_len, hkv, d), "v": ..., ["k_scale"/"v_scale":
             (B, max_len, hkv)], "index": (B,)}
    paged   {"pages_k": (n_pages, ps, hkv, d), "pages_v": ...,
             ["pages_k_scale"/"pages_v_scale": (n_pages, ps, hkv)],
             "block_table": (B, max_len // ps) int32, "index": (B,)}

The bracketed leaves are the int8 cache's float32 scales
(``kv_cache_dtype="int8"``): every ``pages_*`` leaf is payload, so the
scales travel with K/V through insert, extend, ``gather_page`` /
``page_write`` and ``pool_page_bytes``.

Page 0 is a reserved TRASH page: every unallocated block-table entry
points at it, so idle rows' decode writes land in garbage nobody reads.
:class:`KVPagePool` is the host-side allocator over pages ``1 ..
n_pages-1``; a page id means the same slab in EVERY layer's pool, which is
what lets the radix trie (serving/radix_cache.py) refcount a whole-model
prefix block as one integer.

Every function here updates the cache IN PLACE on the device it lives on
and returns it; none reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import write_held
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import rank_cache_shape

TRASH_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages to hold ``n_tokens`` cache positions (host-side ceil div)."""
    return -(-int(n_tokens) // int(page_size))


class KVPagePool:
    """Host-side page allocator over a pool of ``n_pages`` pages.

    Page 0 is the reserved trash page and is never handed out.  ``alloc``
    is all-or-nothing (a partially admitted request would deadlock the
    pool) and hands out the lowest free ids first, so allocation replays
    exactly.  Sharing is the radix trie's business: it calls ``free`` only
    when a page's count reaches zero."""

    def __init__(self, n_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved trash page), "
                f"got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # pop() takes from the END: stored descending, allocation ascends
        self._free = list(range(self.n_pages - 1, 0, -1))

    @property
    def capacity(self) -> int:
        """Allocatable pages (the trash page excluded)."""
        return self.n_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages, or None (and take nothing) if fewer are free."""
        if n < 0:
            raise ValueError(f"alloc needs n >= 0, got {n}")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        """Return pages to the pool.  Accepts any iterable of page ids."""
        for p in pages:
            p = int(p)
            if not 0 < p < self.n_pages:
                raise ValueError(
                    f"free of invalid page id {p} (pool has pages 1.."
                    f"{self.n_pages - 1}; page 0 is reserved)")
            self._free.append(p)
        if len(self._free) > self.capacity:
            raise ValueError("double free: more pages freed than exist")


def paged_cache_shapes(model, slots: int, max_len: int, page_size: int,
                       n_pages: int) -> dict:
    """``{block: {leaf: (shape, dtype)}}`` of the paged cache
    :func:`init_paged_cache` allocates for ``model``, read from its
    attributes (no forward runs): for a model cut for tensor parallelism,
    this rank's heads of each pool (``tensor_parallel.kv_cache_rule``)."""
    if max_len % page_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of page_size "
            f"({page_size}) so each slot's virtual span is exactly max_len")
    if n_pages < 2:
        raise ValueError(f"n_pages must be >= 2, got {n_pages}")
    int8 = getattr(model, "kv_cache_dtype", "native") == "int8"
    pool = (n_pages, page_size, model.heads_kv, model.head_dim)
    page = (rank_cache_shape(model, "pages_k", pool), torch.int8 if int8 else model.dtype)
    entry = {"pages_k": page, "pages_v": page}
    if int8:
        entry["pages_k_scale"] = entry["pages_v_scale"] = (
            rank_cache_shape(model, "pages_k_scale", pool[:3]), torch.float32)
    entry["block_table"] = ((slots, max_len // page_size), torch.int32)
    entry["index"] = ((slots,), torch.int32)
    return {f"block_{i}": dict(entry) for i in range(model.depth)}


def init_paged_cache(model, slots: int, max_len: int, page_size: int,
                     n_pages: int) -> dict:
    """A zeroed paged decode cache on the model's device: per-layer page
    pools of ``n_pages``, every block table all-TRASH and every cursor 0
    (the state :func:`paged_reset` restores per slot)."""
    dev = model.device
    return {name: {leaf: torch.zeros(shape, dtype=dtype, device=dev)
                   for leaf, (shape, dtype) in entry.items()}
            for name, entry in paged_cache_shapes(
                model, slots, max_len, page_size, n_pages).items()}


def pool_page_bytes(cache: dict) -> int:
    """Bytes one page occupies across every layer's pool leaves (the
    ``kv_bytes_live = pages_live * pool_page_bytes`` unit)."""
    return sum(leaf[0].nbytes for entry in cache.values()
               for key, leaf in entry.items() if key.startswith("pages_"))


def make_paged_insert(page_size: int, max_len: int, shard: tuple[int, int] | None = None
                      ) -> Callable:
    """``insert(cache, row_cache, bt_row, slot) -> cache``: scatter a dense
    prefilled B=1 row (core/generate.py ``make_prefill``'s layout) into
    the pool through ``bt_row`` ((max_len // page_size,) int page ids on
    the cache's device) and install the row's block table and cursor at
    ``slot``.  The whole (max_len,) row is scattered, garbage above the
    cursor included: a dense-prefilled request owns all its pages
    privately, and positions past its allocation map to the trash page.
    ``shard=(index, n_local)``: the pool holds pages ``index * n_local ..
    (index + 1) * n_local - 1`` only (a context-parallel engine's cp row),
    and the row's positions on other pages are left to their ranks."""
    def insert(cache, row_cache, bt_row, slot: int):
        dev = bt_row.device
        pos = torch.arange(max_len, device=dev)
        page = bt_row.long()[pos // page_size]
        off = pos % page_size
        for name, entry in cache.items():
            row = row_cache[name]
            for key, pool in entry.items():
                if key.startswith("pages_"):  # pages_k <- k, pages_k_scale <- k_scale
                    src = row[key[len("pages_"):]][0]
                    if shard is None:
                        pool[page, off] = src.to(pool.dtype)
                    else:  # this rank's pages only
                        write_held(pool, page, off, src, shard[0] * shard[1])
            entry["block_table"][slot] = bt_row
            entry["index"][slot] = row["index"][0]
        return cache
    return insert


def paged_reset(cache: dict, slot_mask: torch.Tensor) -> dict:
    """Per-slot reset of the paged layout: the masked slots' block tables
    point back at the trash page and their cursors go to 0.  The POOL is
    untouched: a freed page's stale K/V is dead data until its next tenant
    overwrites every position its mask will expose."""
    for entry in cache.values():
        entry["block_table"][slot_mask] = TRASH_PAGE
        entry["index"][slot_mask] = 0
    return cache


def pool_page_leaves(cache: dict) -> dict:
    """The ``pages_*`` leaves of a paged cache: the payload one page
    occupies across every layer."""
    return {name: {k: v for k, v in entry.items() if k.startswith("pages_")}
            for name, entry in cache.items()}


def gather_page(cache: dict, page_id: int) -> dict:
    """One page's cross-layer payload ``{layer: {pages_k: (ps, hkv, d),
    ...}}``, copied out of the pool (read-only on the cache)."""
    return {name: {k: v[page_id].clone() for k, v in entry.items()}
            for name, entry in pool_page_leaves(cache).items()}


def page_write(cache: dict, payload: dict, page_id: int) -> dict:
    """Write one page's cross-layer ``payload`` (the :func:`gather_page`
    tree) into page ``page_id`` of every layer's pool."""
    for name, entry in cache.items():
        for key in entry:
            if key.startswith("pages_"):
                entry[key][page_id] = payload[name][key].to(entry[key].dtype)
    return cache


def bt_install(cache: dict, bt_row: torch.Tensor, slot: int, cursor: int) -> dict:
    """Install ``slot``'s block-table row and cursor across every layer,
    with no forward (the row's K/V pages are already in the pool)."""
    for entry in cache.values():
        entry["block_table"][slot] = bt_row
        entry["index"][slot] = cursor
    return cache


def make_paged_extend(model, max_len: int, page_size: int) -> Callable:
    """The PARTIAL-PREFIX prefill: ``extend(cache, slot, bt_row, suffix,
    start, suffix_len) -> (cache, last_logits)``.

    When the radix trie matches the first ``start`` tokens of a prompt
    (whole shared pages), only the unshared suffix runs: as ONE
    decode-mode chunk over the slot's block table, its queries attend the
    shared pages (read-only) plus themselves and its K/V scatter into the
    slot's PRIVATE pages.  ``suffix`` is (1, Sb) right-padded to a bucket;
    positions past ``suffix_len`` write garbage above the cursor (masked,
    later overwritten by decode).  The cursor is set to ``start +
    suffix_len`` and ``last_logits`` is (1, V) float32 at the last real
    suffix position, from which the first token is picked as after a dense
    prefill.  This is plain PyTorch attention over the pool, as in JAX; no
    flash kernel runs here."""
    if max_len % page_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of page_size ({page_size})")

    @torch.no_grad()
    def extend(cache, slot: int, bt_row, suffix, start: int, suffix_len: int):
        sub = pool_page_leaves(cache)  # the pools are shared storage
        for name, entry in cache.items():
            entry["block_table"][slot] = bt_row  # the chunk decodes through it
            sub[name].update(
                block_table=entry["block_table"][slot:slot + 1],
                index=torch.full((1,), start, dtype=torch.int32, device=bt_row.device))
        logits = model(suffix, cache=sub, max_len=max_len, ragged=True)
        for entry in cache.values():
            entry["index"][slot] = start + suffix_len  # the real cursor
        return cache, logits[0, suffix_len - 1][None]

    return extend
