"""Paged-KV handoff: moving a finished prefill between engines (the port's
copy of the JAX package's ``serving/kv_handoff.py``).

The disaggregated tier splits the two phases of serving a request across
role-typed replicas: PREFILL replicas run the prompt through the prefill
(the flash kernel) and the paged extend, and stop at the moment every
monolithic engine would pick the first token; DECODE replicas run the
decode window and never prefill.  This module is the seam between them —
the packaging of a finished prefill into a host-side
:class:`HandoffPacket` and its landing on a decode engine — with JAX's
three invariants:

* **Deferred source-free.**  The packet carries the source slot's page
  HOLD (private pool pages + acquired radix nodes) and nothing frees
  until the router confirms delivery (:meth:`HandoffPacket.release`).  A
  transfer that dies in flight (the ``kv-handoff`` chaos site) releases
  the hold and re-dispatches the request down the normal prefill path —
  the source trie still has the prompt's shared blocks, so the retry's
  re-prefill is a radix hit, and the router's delivered high-water mark
  keeps the replay exactly-once per token.
* **All-or-nothing landing.**  :func:`deliver` takes the radix match, its
  acquire and the request's FULL destination page span before the first
  write to the destination cache; a dry pool returns False with zero
  writes issued, the pool byte-equal (the port writes its cache in place,
  so nothing may be written before the allocation is known to succeed).
  Failures after allocation are the request's own and reclaim every
  destination page.
* **Radix-aware arrival.**  The destination trie is matched before the
  scatter: blocks it already holds are acquired and mapped into the block
  table WITHOUT re-uploading their payload, and freshly landed full prompt
  blocks are donated back so the NEXT handoff of the same prefix skips
  them too.

The packet lives on the HOST, as JAX's does (its payload outlives the
source engine, and the release path is JAX's).  Where JAX reads one page
at a time (``gather_page`` per page, a device sync each), the port reads
the prompt's pages of every ``pages_*`` leaf (K, V, and the int8 cache's
scales) with one ``index_select`` a leaf into ONE byte buffer and copies
it, with the prefill's last logits row, to the host in ONE device-to-host
copy; :func:`deliver` sends the pages the destination lacks up in one
host-to-device copy and scatters them with one ``index_copy_`` a leaf.
The per-page tree of :func:`~.kv_pool.gather_page` is still what
:attr:`HandoffPacket.payloads` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    pages_needed,
    pool_page_leaves,
)


def page_layout(cache: dict) -> list[tuple]:
    """``[(layer, leaf, dtype, page_shape, byte_offset, nbytes), ...]``: where
    each ``pages_*`` leaf's one-page slab sits in a packet's page row."""
    out, off = [], 0
    for name, entry in pool_page_leaves(cache).items():
        for key, pool in entry.items():
            nbytes = pool[0].numel() * pool.element_size()
            out.append((name, key, pool.dtype, tuple(pool.shape[1:]), off, nbytes))
            off += nbytes
    return out


@dataclasses.dataclass
class HandoffPacket:
    """One finished prefill, portable across engines.

    ``req`` is the SAME engine :class:`~.scheduler.Request` object the
    source admitted — its router-wrapped callback (and therefore the
    cross-attempt delivered high-water mark) travels with it.
    ``payload`` is a host ``(n_pages, page_bytes)`` uint8 tensor, one row
    per CONTENT page of the prompt (decode-span pages are garbage by
    contract and never move), laid out by ``layout``
    (:func:`page_layout`); ``last_logits`` is the prefill's (1, V)
    float32 last-position row, from which the destination picks the
    first token through the shared ``first_pick`` — bit-identical to the
    pick the source would have made.  ``hold`` is the source-side page
    hold released only at :meth:`release`.
    """

    req: Any
    n_tok: int
    payload: torch.Tensor
    layout: list
    last_logits: np.ndarray
    source: Any                      # the source InferenceEngine
    hold: list | None                # [private page ids, held radix nodes]
    created_t: float
    gather_s: float
    payload_bytes: int
    trace_ctx: Any = None            # distributed TraceContext riding the
    #   handoff: the prefill-role and decode-role spans of one request
    #   join under trace_ctx.trace_id
    install_s: float | None = None   # the destination's landing seconds

    @property
    def n_pages(self) -> int:
        return int(self.payload.shape[0])

    @property
    def payloads(self) -> list:
        """One host tree per content page, ``{layer: {pages_*: array}}``
        (the :func:`~.kv_pool.gather_page` layout, as numpy)."""
        out = []
        for j in range(self.n_pages):
            tree: dict = {}
            for name, key, dtype, shape, off, nbytes in self.layout:
                leaf = self.payload[j, off:off + nbytes].view(dtype).reshape(shape)
                tree.setdefault(name, {})[key] = (
                    leaf.float().numpy() if dtype == torch.bfloat16 else leaf.numpy())
            out.append(tree)
        return out

    def release(self) -> None:
        """Free the source-side hold — called by the router exactly when
        the packet is consumed (delivered, or abandoned to a re-dispatch
        after a transfer fault).  Idempotent; a closed/dead source engine
        is a no-op (its pool died with it)."""
        hold, self.hold = self.hold, None
        if hold is None:
            return
        src = self.source
        if src is None or getattr(src, "_closed", False):
            return
        pages, nodes = hold
        if pages:
            src._pool.free(pages)
        if nodes:
            src._radix.release(nodes)


def package(engine, req, slot: int, logits_dev, bt_row) -> HandoffPacket:
    """Source half: read ``slot``'s prompt pages to the host and build the
    packet.  Called by the prefill-role engine at the exact point every
    other landing path would run ``first_pick`` — the slot's page hold
    transfers to the packet (the caller clears the slot and queues its
    block-table reset; the PAGES stay allocated until
    :meth:`HandoffPacket.release`).

    The reads leave the source cache untouched, so a fault anywhere in
    here leaves the hold on the slot for the caller's failure path to
    reclaim, exactly as for any admission-tail exception."""
    t0 = engine.clock()
    n_tok = int(req.tokens.size)
    n_blocks = pages_needed(n_tok, engine._page_size)
    layout = page_layout(engine.cache)
    pools = pool_page_leaves(engine.cache)
    with torch.no_grad():
        ids = torch.as_tensor(np.asarray(bt_row[:n_blocks], np.int64),
                              device=engine.device)
        rows = [pools[name][key].index_select(0, ids).reshape(n_blocks, -1)
                .view(torch.uint8)
                for name, key, _dtype, _shape, _off, _nb in layout]
        logits = logits_dev.detach().to(torch.float32).reshape(-1).view(torch.uint8)
        flat = torch.cat([torch.cat(rows, dim=1).reshape(-1), logits]).cpu()
    split = flat.numel() - logits.numel()
    payload = flat[:split].reshape(n_blocks, -1)
    last = flat[split:].view(torch.float32).reshape(1, -1).numpy()
    nbytes = int(flat.numel())
    t1 = engine.clock()
    # the hold moves LAST, after every read succeeded — an exception above
    # leaves it on the slot for _release_slot_alloc to reclaim
    hold = engine._slot_alloc[slot]
    engine._slot_alloc[slot] = None
    if req.admit_t is None:
        req.admit_t = t0
    req.status = "prefilled"
    engine._tr_phase(req, "handoff", slot=slot, pages=n_blocks)
    if engine._tracer is not None and req.trace is not None:
        engine._tracer.complete(
            "gather", t0, t1, cat="handoff",
            parent=req.trace.get("phase") or req.trace["id"],
            tid=req.trace["tid"], pages=n_blocks, bytes=nbytes)
    engine._last_progress_ever = t1
    return HandoffPacket(req=req, n_tok=n_tok, payload=payload, layout=layout,
                         last_logits=last, source=engine, hold=hold,
                         created_t=t0, gather_s=t1 - t0, payload_bytes=nbytes,
                         trace_ctx=req.trace_ctx)


def deliver(engine, packet: HandoffPacket) -> bool:
    """Destination half: land ``packet`` on a decode-capable engine.

    Returns True when the packet was CONSUMED — landed and decoding, or
    failed on its own admission tail (the request is terminal either way)
    — and False when the engine cannot take it RIGHT NOW (no free slot, or
    the all-or-nothing destination allocation found the pool dry): a False
    return issued zero cache writes, so the router re-parks the packet and
    retries after decode frees capacity.  A packet whose page layout is
    not this engine's (another model, dtype or KV quantization) raises
    before anything is taken."""
    if [e[:4] for e in packet.layout] != [e[:4] for e in page_layout(engine.cache)]:
        raise ValueError(
            "handoff packet's page layout differs from this engine's cache "
            "(another model, dtype or kv_cache_dtype): it cannot land here")
    req = packet.req
    slot = next((i for i in range(engine.slots)
                 if engine._slot_req[i] is None), None)
    if slot is None:
        return False
    now = engine.clock()
    ps = engine._page_size
    n_tok = packet.n_tok
    # radix dedup on arrival: full prompt blocks the destination trie
    # already shares need no payload upload — map them straight into the
    # block table (acquired first, so allocation cannot evict them)
    path: list = []
    if engine._radix is not None:
        path, _matched = engine._radix.match(req.tokens)
    m_blocks = len(path)
    if m_blocks:
        engine._radix.acquire(path)
    total = pages_needed(n_tok + req.max_new, ps)
    private = engine._alloc_pages(total - m_blocks)
    if private is None:
        if m_blocks:
            engine._radix.release(path)
        return False
    engine._slot_alloc[slot] = [list(private), list(path)]
    bt_row = np.zeros((engine.max_len // ps,), np.int32)
    for j, node in enumerate(path):
        bt_row[j] = node.page
    bt_row[m_blocks:m_blocks + len(private)] = private
    try:
        t0 = engine.clock()
        n_blocks = pages_needed(n_tok, ps)
        pools = pool_page_leaves(engine.cache)
        with torch.no_grad():
            if n_blocks > m_blocks:
                rows = packet.payload[m_blocks:n_blocks].to(engine.device)
                dest = torch.as_tensor(bt_row[m_blocks:n_blocks].astype(np.int64),
                                       device=engine.device)
                for name, key, dtype, shape, off, nbytes in packet.layout:
                    leaf = rows[:, off:off + nbytes].contiguous().view(dtype)
                    pools[name][key].index_copy_(
                        0, dest, leaf.reshape(n_blocks - m_blocks, *shape))
            bt_dev = torch.as_tensor(bt_row, device=engine.device)
            for entry in engine.cache.values():
                entry["block_table"][slot] = bt_dev
                entry["index"][slot] = n_tok
        t1 = engine.clock()
        packet.install_s = t1 - t0
        if engine._tracer is not None and req.trace is not None:
            engine._tracer.complete(
                "install", t0, t1, cat="handoff",
                parent=req.trace.get("phase") or req.trace["id"],
                tid=req.trace["tid"], pages=n_blocks - m_blocks,
                dedup_pages=m_blocks, slot=slot)
        if engine._radix is not None:
            engine.stats.radix(m_blocks > 0, tokens=m_blocks * ps)
            engine._radix.record(m_blocks > 0, tokens=m_blocks * ps)
            engine._donate(slot, req, bt_row, m_blocks, path)
        req.pages = total
        # first token: the source's logits row through the SAME shared pick
        # every landing path uses — bit-identical to the token a
        # monolithic engine would have picked
        first, first_logp = engine._first_pick(
            req, torch.as_tensor(packet.last_logits, device=engine.device))
        engine._tr_phase(req, "decode", slot=slot, handoff=True)
        engine._first_token(req, slot, first, first_logp, False)
    except Exception as e:
        # the request's OWN failure (poisoned callback and kin): reclaim
        # the destination pages, reset the (possibly installed) row, and
        # report the packet consumed — terminal, not re-parkable
        engine._release_slot_alloc(slot)
        engine._fail(req, e, engine.clock())
        engine._reset_slot_now(slot)
        return True
    engine._slot_req[slot] = req
    engine._slot_tok[slot] = first
    engine._set_planes(slot, req)
    engine.stats.prompt_admitted(n_tok)
    engine.handoffs_in += 1
    if req.admit_t is None:
        req.admit_t = now
    if engine._done_reason(req) is not None:
        engine._retire(slot, engine._done_reason(req), engine.clock())
        engine._reset_slot_now(slot)
    return True
