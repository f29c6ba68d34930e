"""Continuous-batching inference engine of the port: decode-ahead windows,
per-request sampling, the prefix cache and the paged KV cache.

The counterpart of the JAX package's ``serving/engine.py``.  The device
side is a fixed set of shapes: a B=1 prefill per prompt bucket (core/
generate.py ``make_prefill``: the normal forward, through the flash kernel
for ``attn="flash"``), ONE windowed decode across all ``slots`` rows with
per-row cursors (``_sample_window_core``: ``decode_ahead`` fused
decode+pick steps), a slot insert and a per-slot reset.  A host loop
multiplexes a stream of variable-length requests through it.

:meth:`InferenceEngine.step` is one iteration: cancel overdue rows ->
admit into free slots (overlap-prefilled requests first, then the queue;
each picks its first token through the shared ``first_pick``) -> ONE
window dispatch across ALL slots -> while it runs, prefill the next queued
request (the prefill overlap) -> ONE (slots, k) token + logprob readback ->
retire rows on EOS or budget, discarding the overrun tokens of the window
(never delivered) -> reset retired rows.  The active mask is frozen for a
window; idle and retired rows decode garbage into their own rows (or the
trash page), never corruption.  On CUDA tensors nothing leaves the card
between the window dispatch and its readback, and the prefill overlap is
CUDA's asynchronous stream: the host enqueues the next prefill while the
card runs the window.

Sampling: each request's :class:`SamplingParams` (or the engine's
``temperature``/``top_k``/``top_p``/``min_p``/``rng`` defaults) become
per-slot planes; the token at generated index ``n`` is picked with
``fold_in(base_key, n)``, so a stream is a pure function of its seed
whatever ``decode_ahead``, layout or restart.  Every token carries
``log_softmax`` of the RAW logits.

``prefix_cache_bytes`` arms the whole-prompt prefix cache (looked up
before the radix trie when both are on, as in JAX).  ``kv_page_size``
switches the decode cache to the paged layout (serving/kv_pool.py):
``kv_pages`` pages per layer (default: dense-equivalent; fewer
overcommits, and a dry pool stalls admission, never fails it) and, by
default, the radix trie
(serving/radix_cache.py): a prompt whose whole-page prefix is resident
runs only its suffix (the extend program, plain PyTorch attention over
the pool, no flash kernel) and holds zero extra pages for the prefix.

Greedy output is token-identical to the JAX engine on the same weights,
for every ``decode_ahead`` and both layouts; sampled streams too, up to
near-ties of the perturbed scores (tests/test_torch_decode_ahead.py,
tests/test_torch_kv_paging.py, tests/test_torch_sampling.py).  Failure
isolation follows the JAX engine: a request whose own prefill or
``callback`` raises fails alone; a fault in the window fails every
in-flight request and re-raises.  The JAX compile census has no
counterpart until CUDA graphs arrive: nothing is compiled here.

Knobs of the JAX engine that later slices port (speculative decoding,
chunked prefill, tp/cp, int8, disaggregated roles, chaos, tracing,
telemetry) raise ``NotImplementedError`` when set away from their
defaults.  The engine is single-threaded: submit and run from one thread.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    _sample_window_core,
    init_cache,
    make_prefill,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    reset_cache_slots,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    KVPagePool,
    init_paged_cache,
    make_paged_extend,
    make_paged_insert,
    paged_reset,
    pages_needed,
    pool_page_bytes,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import PrefixCache
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.radix_cache import RadixCache
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import (
    SamplingParams,
    first_pick,
    rng_key,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    FIFOScheduler,
    Request,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import ServingStats
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter

# knob -> (default, the later slice that ports it)
_REFUSED = {
    "speculative": (None, "the speculative-decoding slice"),
    "prefill_chunk": (0, "the chunked-prefill slice"),
    "tp": (1, "the tensor-parallel serving slice"),
    "cp": (1, "the context-parallel serving slice"),
    "quant": (None, "the int8 serving slice"),
    "role": ("both", "the disaggregated serving slice"),
    "chaos": (None, "the host serving tier slice"),
    "tracer": (None, "the host serving tier slice"),
    "telemetry": (None, "the host serving tier slice"),
}

# a parked request whose radix match skipped the prefill: the suffix
# extend runs at landing, against the trie and pool of that moment
_RADIX_PREFILL = object()


class InferenceEngine:
    """Slot-multiplexed continuous-batching decoder for a causal LM.

    ``slots`` is the resident decode batch; ``max_len`` the per-slot KV
    length.  ``scheduler`` defaults to a :class:`FIFOScheduler` built from
    ``buckets=`` (or the stock ladder); given both, they must agree.
    ``params``, when given, is a ``state_dict`` loaded into ``model``
    (e.g. from convert.py ``causal_lm_state_dict``); None serves the
    model's own weights.  ``device`` (the GPU unless ``device="cpu"``)
    must be where the model lives.  ``decode_ahead=k`` runs k fused decode
    steps per dispatch and readback; ``prefix_cache_bytes``,
    ``kv_page_size`` / ``kv_pages`` / ``radix_cache`` and the sampling
    defaults are as in the module docstring (``rng`` is an int seed or
    (2,) uint32 key data, required when ``temperature > 0``).

    Usage::

        eng = InferenceEngine(model, slots=4, max_len=128, decode_ahead=4)
        eng.submit([1, 2, 3], max_new=16)
        eng.submit([4, 5], max_new=8,
                   sampling=SamplingParams(temperature=0.8, top_p=0.9, seed=7))
        done = eng.run()          # drive until every request retired
        done[0].generated         # real tokens (EOS kept)
    """

    def __init__(self, model, params: dict | None = None, *, slots: int,
                 max_len: int, scheduler: FIFOScheduler | None = None,
                 buckets: tuple[int, ...] | None = None, decode_ahead: int = 1,
                 speculative: str | None = None, prefix_cache_bytes: int = 0,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 radix_cache: bool | None = None, prefill_chunk: int = 0,
                 tp: int = 1, cp: int = 1, quant: str | None = None,
                 eos_id: int | None = None, pad_id: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 min_p: float = 0.0, rng=None, role: str = "both",
                 writer: MetricWriter | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None, tracer=None, telemetry=None, device=None):
        knobs = dict(speculative=speculative, prefill_chunk=prefill_chunk,
                     tp=tp, cp=cp, quant=None if quant == "none" else quant,
                     role=role, chaos=chaos, tracer=tracer, telemetry=telemetry)
        for name, value in knobs.items():
            default, where = _REFUSED[name]
            if value != default:
                raise NotImplementedError(
                    f"InferenceEngine({name}={value!r}) is not in the PyTorch "
                    f"port yet ({where} ports it); leave it at {default!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(
                f"max_len must be >= 2 (one prompt token + one generated), "
                f"got {max_len}")
        if decode_ahead < 1:
            raise ValueError(
                f"decode_ahead must be >= 1 (1 = one decode step per host "
                f"sync), got {decode_ahead}")
        if eos_id is not None and eos_id == pad_id:
            raise ValueError(
                f"eos_id and pad_id must differ (both {eos_id}): idle slots "
                "are fed pad_id, which must never read as a stop")
        if temperature == 0.0 and (top_k or top_p or min_p):
            raise ValueError(
                "top_k/top_p/min_p filter a SAMPLING distribution; set "
                "temperature > 0")
        if temperature != 0.0 and rng is None:
            raise ValueError("temperature > 0 samples from the model — pass rng=")
        if prefix_cache_bytes < 0:
            raise ValueError(
                f"prefix_cache_bytes must be >= 0 (0 disables the cache), "
                f"got {prefix_cache_bytes}")
        if kv_page_size < 0 or kv_pages < 0:
            raise ValueError(
                f"kv_page_size/kv_pages must be >= 0 (0 = dense layout), "
                f"got {kv_page_size}/{kv_pages}")
        if kv_pages and not kv_page_size:
            raise ValueError(
                "kv_pages sizes the PAGED pool — it needs kv_page_size > 0")
        if radix_cache and not kv_page_size:
            raise ValueError(
                "radix_cache shares whole KV PAGES between requests — it "
                "needs the paged cache (kv_page_size > 0)")
        model_ps = getattr(model, "page_size", 0)
        if model_ps and model_ps != kv_page_size:
            raise ValueError(
                f"the model decodes paged with page_size={model_ps}; build "
                f"the engine with kv_page_size={model_ps}")
        if kv_page_size:
            if max_len % kv_page_size:
                raise ValueError(
                    f"max_len ({max_len}) must be a multiple of kv_page_size "
                    f"({kv_page_size}) so every slot's virtual span is "
                    "exactly max_len (the paged==dense parity contract)")
            if getattr(model, "window", 0):
                raise ValueError(
                    "the paged cache does not compose with sliding-window "
                    "attention (model.window > 0) — the windowed decode "
                    "gathers a contiguous dense span")
        self.device = resolve_device(device)
        mdev = model.device
        if mdev.type != self.device.type or (
                self.device.index is not None and mdev.index != self.device.index):
            raise ValueError(
                f"the model lives on {mdev} but the engine serves on "
                f"{self.device}: build the model on the engine's device")
        if params is not None:
            model.load_state_dict(params, strict=True)
        if scheduler is None:
            scheduler = FIFOScheduler(
                max_len=max_len,
                buckets=buckets if buckets is not None else
                tuple(b for b in (16, 32, 64, 128) if b <= max_len) or (max_len,),
                clock=clock)
        elif buckets is not None:
            want = tuple(sorted(set(int(b) for b in buckets)))
            if want != scheduler.buckets:
                raise ValueError(
                    f"engine buckets= {want} != scheduler buckets "
                    f"{scheduler.buckets} — the prefill runs at the "
                    "scheduler's shapes")
        if scheduler.max_len != max_len:
            raise ValueError(
                f"scheduler.max_len ({scheduler.max_len}) != engine max_len "
                f"({max_len}) — admission would pass requests the cache "
                "cannot hold")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.decode_ahead = int(decode_ahead)
        self.scheduler = scheduler
        self.buckets = scheduler.buckets
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.writer = writer
        self.clock = clock
        self.stats = ServingStats(slots, decode_ahead=self.decode_ahead)
        self._prefill = make_prefill(model, max_len)

        # per-request sampling defaults (requests without SamplingParams)
        self._default_temp = float(temperature)
        self._default_topp = float(top_p)
        self._top_k = int(top_k)
        self._default_minp = float(min_p)
        self._default_key = rng_key(0 if rng is None else rng)

        self._page_size = int(kv_page_size)
        if kv_page_size:
            n_row = max_len // kv_page_size
            if not kv_pages:
                kv_pages = slots * n_row + 1  # dense-equivalent + the trash page
            if kv_pages < n_row + 1:
                raise ValueError(
                    f"kv_pages ({kv_pages}) cannot hold one full-length "
                    f"request: need >= max_len/kv_page_size + 1 "
                    f"({n_row + 1}; page 0 is the reserved trash page)")
            self.cache = init_paged_cache(model, slots, max_len, kv_page_size, kv_pages)
            self._pool = KVPagePool(kv_pages, kv_page_size)
            self._page_bytes = pool_page_bytes(self.cache)
            self._radix = (RadixCache(kv_page_size)
                           if radix_cache is None or radix_cache else None)
            self._insert = make_paged_insert(kv_page_size, max_len)
            self._extend = make_paged_extend(model, max_len, kv_page_size)
        else:
            self.cache = init_cache(model, slots, max_len)
            self._pool = None
            self._radix = None
        # per-slot allocation record [private page ids, held radix nodes],
        # released at retirement but freed only after the slot's reset
        self._slot_alloc: list[list | None] = [None] * slots
        self._deferred_free: list[list] = []
        self._prefix = (PrefixCache(prefix_cache_bytes) if prefix_cache_bytes > 0
                        else None)

        self._slot_req: list[Request | None] = [None] * slots
        self._slot_tok = np.full((slots,), self.pad_id, np.int64)
        # per-slot sampling planes (host mirrors), uploaded once per
        # occupancy change; a retired slot's stale rows are masked by
        # `active`, so retirement does not invalidate them
        self._slot_temp = np.full((slots,), self._default_temp, np.float32)
        self._slot_topp = np.full((slots,), self._default_topp, np.float32)
        self._slot_topk = np.full((slots,), self._top_k, np.int64)
        self._slot_minp = np.full((slots,), self._default_minp, np.float32)
        self._slot_key = np.tile(self._default_key.astype(np.int64), (slots, 1))
        # device copies; None = stale (rebuilt before the next window)
        self._tok_dev = None
        self._active_dev = None
        self._planes_dev = None
        self._pos_dev = None
        self._window_sampled = False  # any active row samples
        # prefill-overlap parking lot: (req, (row_cache, logits, hit))
        self._pending: deque[tuple] = deque()
        # ids of parked requests whose landing STALLED on a dry pool
        self._stalled_ids: set[int] = set()
        self.completed: list[Request] = []
        self._draining = False
        self._closed = False

    # ------------------------------------------------------------------
    # request lifecycle

    def submit(self, prompt, max_new: int, deadline_s: float | None = None,
               callback: Callable | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Enqueue a request (see :meth:`FIFOScheduler.submit`; raises
        ``QueueFull`` under backpressure).  ``callback(request, token)``
        streams every generated token; if it raises, THIS request fails.
        ``sampling`` is the request's :class:`SamplingParams` (None = the
        engine's defaults).  Refused after :meth:`drain` / :meth:`close`."""
        if self._closed or self._draining:
            raise RuntimeError(
                "engine is " + ("closed" if self._closed else "draining")
                + " — no new requests")
        return self.scheduler.submit(prompt, max_new, deadline_s=deadline_s,
                                     callback=callback, sampling=sampling)

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def has_work(self) -> bool:
        return (self.occupied > 0 or len(self.scheduler) > 0
                or len(self._pending) > 0)

    def _req_sampling(self, req: Request):
        """``(temperature, top_p, top_k, min_p, base_key)`` for ``req``: its
        own SamplingParams, or the engine's defaults."""
        s = req.sampling
        if s is None:
            return (self._default_temp, self._default_topp, self._top_k,
                    self._default_minp, self._default_key)
        return (float(s.temperature), float(s.top_p), int(s.top_k),
                float(s.min_p), s.key())

    def _first_pick(self, req: Request, logits) -> tuple[int, float]:
        """Pick ``req``'s FIRST token (generated index 0) from the (1, V)
        prefill logits through the shared ``first_pick``: the same pick for
        a fresh prefill, a prefix-cache hit and a radix extend.  Returns
        host scalars (one device-to-host copy)."""
        temp, topp, topk, minp, key = self._req_sampling(req)
        dev = logits.device
        tok, logp = first_pick(
            logits, torch.tensor([temp], device=dev), torch.tensor([topp], device=dev),
            torch.tensor([topk], device=dev), torch.tensor([minp], device=dev),
            torch.as_tensor(key[None, :].astype(np.int64), device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev))
        out = torch.stack((tok.double(), logp.double())).cpu()
        return int(out[0, 0]), float(out[1, 0])

    def _retire(self, slot: int, status: str, now: float) -> None:
        req = self._slot_req[slot]
        req.status = status
        req.finish_t = now
        self._slot_req[slot] = None
        self._release_slot_alloc(slot)
        self._active_dev = None  # occupancy changed; the next window re-freezes
        self.completed.append(req)
        self.stats.add(req)

    def _fail(self, req: Request, exc: BaseException, now: float) -> None:
        """Move ``req`` to the terminal FAILED state (isolated casualty)."""
        req.status = "failed"
        req.error = f"{type(exc).__name__}: {exc}"
        req.finish_t = now
        self.completed.append(req)
        self.stats.add(req)

    @staticmethod
    def _notify(req: Request, tok: int) -> None:
        if req.callback is not None:
            req.callback(req, tok)

    @staticmethod
    def _insert_impl(cache: dict, row_cache: dict, slot: int) -> None:
        """Write row 0 of a B=1 prefill cache into ``slot`` of the dense
        engine cache, in place (every leaf is (B, ...)-leading)."""
        for name, entry in cache.items():
            for leaf, full in entry.items():
                full[slot].copy_(row_cache[name][leaf][0])

    def _reset(self, mask: np.ndarray) -> None:
        """Reset the masked slots' rows (dense: zero them; paged: point
        their block tables at the trash page), cursors to 0."""
        with torch.no_grad():
            m = torch.as_tensor(mask, device=self.device)
            if self._pool is not None:
                paged_reset(self.cache, m)
            else:
                reset_cache_slots(self.cache, m)

    def _done_reason(self, req: Request) -> str | None:
        if self.eos_id is not None and req.generated and req.generated[-1] == self.eos_id:
            return "done"
        if len(req.generated) >= req.max_new:
            return "done"
        return None

    # ------------------------------------------------------------------
    # prefill, the prefix cache and the paged landing

    def _prefill_request(self, req: Request):
        """The per-request half of admission: a prefix-cache lookup, a
        radix check, or the bucketed B=1 prefill.  Returns ``(row_cache,
        logits, cache_hit)``; an exception is the REQUEST's failure."""
        if self._prefix is not None:
            hit = self._prefix.get(req.prefix_key)
            self.stats.prefix(hit is not None)
            if hit is not None:
                return hit[0], hit[1], True
        if self._radix is not None and self._usable_radix_tokens(req) > 0:
            # partial-prefix hit: the suffix extend runs at landing, against
            # the trie of that moment (the match is re-taken there)
            return _RADIX_PREFILL, None, False
        return (*self._dense_prefill(req), False)

    def _dense_prefill(self, req: Request):
        """The bucketed B=1 prefill: ``(row_cache, (1, V) logits)``; the
        first token is picked at landing, never here."""
        padded = np.full((1, req.bucket), self.pad_id, np.int64)
        padded[0, : req.tokens.size] = req.tokens
        return self._prefill(torch.as_tensor(padded, device=self.device),
                             torch.tensor([req.tokens.size], dtype=torch.int32,
                                          device=self.device))

    def _usable_radix_tokens(self, req: Request, matched: int | None = None) -> int:
        """Whole-page radix match usable for ``req``, capped so at least one
        prompt token remains for the suffix (the extend picks the first
        token from the last real position)."""
        if matched is None:
            _, matched = self._radix.match(req.tokens)
        ps = self._page_size
        return min(matched, ((int(req.tokens.size) - 1) // ps) * ps)

    def _alloc_pages(self, n: int) -> list[int] | None:
        """``n`` pool pages, evicting unreferenced radix leaves to cover a
        shortfall; None = genuinely dry (an admission STALL)."""
        pages = self._pool.alloc(n)
        if pages is None and self._radix is not None:
            self._radix.evict(n - self._pool.free_count,
                              lambda p: self._pool.free([p]))
            pages = self._pool.alloc(n)
        return pages

    def _release_slot_alloc(self, slot: int) -> None:
        """Queue ``slot``'s pages for release, DEFERRED to
        :meth:`_flush_freed_pages` after the step's reset: the slot's stale
        block table references them until then."""
        alloc = self._slot_alloc[slot]
        if alloc is not None:
            self._slot_alloc[slot] = None
            self._deferred_free.append(alloc)

    def _flush_freed_pages(self) -> None:
        """Apply deferred page frees and radix releases."""
        if self._pool is None or not self._deferred_free:
            return
        for pages, nodes in self._deferred_free:
            if pages:
                self._pool.free(pages)
            if nodes:
                self._radix.release(nodes)
        self._deferred_free.clear()

    def _paged_land(self, req: Request, slot: int, prefilled: tuple):
        """Land ``req`` in ``slot`` on the PAGED layout: allocate its page
        span, then scatter the dense prefill row (a full prefill or a
        prefix-cache hit) or run the suffix extend over the radix-shared
        prefix, pick the first token, and donate the prompt's fresh full
        blocks to the trie.  Returns ``(first, first_logprob, cache_hit)``
        or None when the pool cannot cover the request now (a stall)."""
        row_cache, logits, cache_hit = prefilled
        ps = self._page_size
        n_tok = int(req.tokens.size)
        path: list = []
        m_tok = 0
        if row_cache is _RADIX_PREFILL:
            # re-match at landing: the parked match may have been evicted
            path, matched = self._radix.match(req.tokens)
            m_tok = self._usable_radix_tokens(req, matched)
            path = path[: m_tok // ps]
            if not path:
                row_cache, logits = self._dense_prefill(req)
                m_tok = 0
        m_blocks = len(path)
        if m_blocks:
            self._radix.acquire(path)  # pin before any allocation can evict
        total = pages_needed(n_tok + req.max_new, ps)
        private = self._alloc_pages(total - m_blocks)
        if private is None:
            if m_blocks:
                self._radix.release(path)
            return None
        # recorded BEFORE any dispatch: a failure below reclaims the pages
        self._slot_alloc[slot] = [list(private), list(path)]
        bt_row = np.zeros((self.max_len // ps,), np.int32)  # the rest: TRASH
        for j, node in enumerate(path):
            bt_row[j] = node.page
        bt_row[m_blocks:m_blocks + len(private)] = private
        bt_dev = torch.as_tensor(bt_row, device=self.device)
        with torch.no_grad():
            if m_blocks:
                suffix = req.tokens[m_tok:]
                padded = np.full((1, self.scheduler.bucket_for(suffix.size)),
                                 self.pad_id, np.int64)
                padded[0, : suffix.size] = suffix
                self.cache, ext_logits = self._extend(
                    self.cache, slot, bt_dev, torch.as_tensor(padded, device=self.device),
                    m_tok, int(suffix.size))
                first, first_logp = self._first_pick(req, ext_logits)
                self.stats.radix(True, tokens=m_tok)
                self._radix.record(True, tokens=m_tok)
                req.radix_tokens = m_tok
            else:
                self._insert(self.cache, row_cache, bt_dev, slot)
                first, first_logp = self._first_pick(req, logits)
                if self._radix is not None:
                    self.stats.radix(False)
                    self._radix.record(False)
                if self._prefix is not None and not cache_hit:
                    self._prefix.put(req.prefix_key, row_cache, logits)
        if self._radix is not None:
            # donate the freshly computed FULL prompt blocks below the match
            donate = {j: int(bt_row[j]) for j in range(m_blocks, n_tok // ps)}
            if donate:
                priv, nodes = self._slot_alloc[slot]
                held, _kept = self._radix.insert(req.tokens, m_blocks, donate, path)
                for node in held:
                    priv.remove(node.page)
                    nodes.append(node)
        return first, first_logp, cache_hit

    def _admit(self, req: Request, slot: int, now: float,
               prefilled: tuple | None = None):
        """Prefill ``req`` (or take its overlap-dispatched ``prefilled``)
        and land it in ``slot``.  A failure of the request's own processing
        fails it and leaves the slot free.  Returns True when the slot's row
        needs a reset (a failure after the insert, or a request that retired
        at admission), or ``("stall", prefilled)`` when the paged pool is
        momentarily dry."""
        inserted = False
        t_p = self.clock()
        try:
            if prefilled is None:
                prefilled = self._prefill_request(req)
            if self._pool is not None:
                landed = self._paged_land(req, slot, prefilled)
                if landed is None:
                    return ("stall", prefilled)
                first, first_logp, cache_hit = landed
                inserted = True
            else:
                row_cache, logits, cache_hit = prefilled
                with torch.no_grad():
                    self._insert_impl(self.cache, row_cache, slot)
                inserted = True
                # hit or miss, the pick runs HERE, per request: the cache
                # stores logits, never a token
                first, first_logp = self._first_pick(req, logits)
                if self._prefix is not None and not cache_hit:
                    self._prefix.put(req.prefix_key, row_cache, logits)
            req.admit_t = now
            req.generated.append(first)
            req.logprobs.append(first_logp)
            req.first_token_t = self.clock()  # TTFT: first token ON THE HOST
            self.stats.prefill(req.first_token_t - t_p)
            req.status = "running"
            self._notify(req, first)
        except Exception as e:
            self._release_slot_alloc(slot)
            self._fail(req, e, self.clock())
            return inserted
        self._slot_req[slot] = req
        self._slot_tok[slot] = first
        temp, topp, topk, minp, key = self._req_sampling(req)
        self._slot_temp[slot] = temp
        self._slot_topp[slot] = topp
        self._slot_topk[slot] = topk
        self._slot_minp[slot] = minp
        self._slot_key[slot] = key
        self._tok_dev = None
        self._active_dev = None
        self._planes_dev = None
        self._pos_dev = None
        if self._done_reason(req) is not None:
            self._retire(slot, self._done_reason(req), self.clock())
            return True  # the landed row belongs to no live request now
        return False

    def _admit_free_slots(self, reset_mask: np.ndarray) -> bool:
        """Fill free slots: overlap-prefilled pendings first (FIFO order),
        then fresh scheduler pops.  A failed admission frees the slot for
        the next request in the same iteration; a dry pool parks the
        request at the front and stops admitting.  True when anything
        landed."""
        admitted = False
        for slot in range(self.slots):
            while self._slot_req[slot] is None:
                if self._pending:
                    req, prefilled = self._pending.popleft()
                    self._stalled_ids.discard(req.id)
                    now = self.clock()
                    if now > req.overdue_at:
                        # prefilled, then the deadline lapsed before a slot
                        # freed: cancel without landing
                        req.status = "cancelled"
                        req.finish_t = now
                        self.completed.append(req)
                        self.stats.add(req)
                        continue
                    needs_reset = self._admit(req, slot, now, prefilled=prefilled)
                else:
                    req = self.scheduler.pop(self.clock())
                    if req is None:
                        return admitted
                    needs_reset = self._admit(req, slot, self.clock())
                if isinstance(needs_reset, tuple):
                    self._pending.appendleft((req, needs_reset[1]))
                    self._stalled_ids.add(req.id)
                    return admitted
                if self._slot_req[slot] is not None:
                    admitted = True
                    reset_mask[slot] = False  # the insert overwrote the row
                elif needs_reset:
                    reset_mask[slot] = True
        return admitted

    def _overlap_prefill(self) -> None:
        """Prefill the NEXT queued request while a window is in flight: the
        host enqueues it behind the window instead of stalling every slot at
        the next admission.  At most one per window and ``slots`` parked; a
        failure here is the request's own."""
        if len(self._pending) >= self.slots:
            return
        req = self.scheduler.pop(self.clock())
        if req is None:
            return
        t0 = self.clock()
        try:
            self._pending.append((req, self._prefill_request(req)))
        except Exception as e:
            self._fail(req, e, self.clock())
        self.stats.prefill(self.clock() - t0)

    # ------------------------------------------------------------------
    # the host loop

    def _window_inputs(self):
        """The device planes of the next window, re-uploaded only where the
        host mirrors changed since the last one."""
        dev = self.device
        if self._tok_dev is None:
            self._tok_dev = torch.as_tensor(self._slot_tok, device=dev)
        if self._pos_dev is None:
            # PRNG positions = tokens generated so far
            self._pos_dev = torch.as_tensor(np.array(
                [0 if r is None else len(r.generated) for r in self._slot_req],
                np.int64), device=dev)
        if self._active_dev is None:
            active = np.array([r is not None for r in self._slot_req])
            self._active_dev = torch.as_tensor(active, device=dev)
            self._window_sampled = bool((self._slot_temp[active] > 0).any())
        if self._planes_dev is None:
            self._planes_dev = tuple(
                torch.as_tensor(x, device=dev) for x in (
                    self._slot_temp, self._slot_topp, self._slot_topk,
                    self._slot_minp, self._slot_key))
        return self._tok_dev, self._active_dev, self._planes_dev, self._pos_dev

    def step(self) -> int:
        """One host-loop iteration: cancel -> admit -> decode window ->
        retire.  Returns the number of REAL tokens produced by the window
        (tokens past a row's EOS or budget are discarded, never counted)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        t0 = self.clock()
        reset_mask = np.zeros((self.slots,), bool)

        # 1) deadline sweep over running rows (queued rows are swept by the
        #    scheduler at pop time, overlap-prefilled ones at landing)
        for slot, req in enumerate(self._slot_req):
            if req is not None and t0 > req.overdue_at:
                self._retire(slot, "cancelled", t0)
                reset_mask[slot] = True

        # 2) admit into free slots
        self._admit_free_slots(reset_mask)

        # 3) ONE window dispatch across ALL slots; a fault here belongs to
        #    every in-flight request: they fail and the error re-raises
        produced = 0
        decoded = self.occupied > 0
        if decoded:
            k = self.decode_ahead
            n_decoding = self.occupied
            t_d = self.clock()
            try:
                tok, active, planes, pos = self._window_inputs()
                with torch.no_grad():
                    self.cache, blk_dev, logp_dev, last_dev, pos_out = (
                        _sample_window_core(
                            self.model, self.cache, tok, active, *planes, pos, k,
                            self.max_len, True, self.pad_id, self._window_sampled))
                dispatch_s = self.clock() - t_d
                # the window runs on the card: spend the wait prefilling the
                # next queued request
                self._overlap_prefill()
                # ONE device->host copy (and sync) per window
                t_rb = self.clock()
                blk = torch.stack((blk_dev.double(), logp_dev.double())).cpu().numpy()
                readback_s = self.clock() - t_rb
            except Exception as e:
                self._fail_in_flight(e, self.clock())
                raise
            self._tok_dev = last_dev
            self._pos_dev = pos_out
            self._slot_tok = blk[0, :, -1].astype(np.int64)
            now = self.clock()
            self.stats.decode(dispatch_s + readback_s)
            waste = 0
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                appended = 0
                for j in range(k):
                    tok_j = int(blk[0, slot, j])
                    req.generated.append(tok_j)
                    req.logprobs.append(float(blk[1, slot, j]))
                    produced += 1
                    appended += 1
                    try:
                        self._notify(req, tok_j)
                    except Exception as e:
                        # the callback's failure is THIS request's; its
                        # remaining window tokens die with it
                        self._slot_req[slot] = None
                        self._release_slot_alloc(slot)
                        self._active_dev = None
                        self._fail(req, e, now)
                        reset_mask[slot] = True
                        break
                    reason = self._done_reason(req)
                    if reason is not None:
                        # EOS/budget mid-window: keep up to the stop, drop
                        # the overrun
                        self._retire(slot, reason, now)
                        reset_mask[slot] = True
                        break
                waste += k - appended
            self.stats.window(dispatch_s, readback_s, steps=n_decoding * k,
                              waste=waste)

        # 4) reset retired rows so idle cursors restart from 0 and the next
        #    admission starts from a clean row; deferred page frees apply
        #    only after it (stream order puts every read of the stale block
        #    table ahead of any later tenant's writes)
        if reset_mask.any():
            self._reset(reset_mask)
        self._flush_freed_pages()
        if self._pool is not None:
            self.stats.pool_sample(self._pool.allocated, self._pool.capacity,
                                   self._page_size, self._page_bytes)
        self.stats.tick(self.occupied, max(self.clock() - t0, 0.0),
                        decoded=decoded)
        return produced

    def _fail_in_flight(self, exc: BaseException, now: float) -> None:
        """Fail every running request and reset their rows."""
        mask = np.zeros((self.slots,), bool)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_req[slot] = None
            self._release_slot_alloc(slot)
            req.engine_fault = True  # collateral, not the request's own fault
            self._fail(req, exc, now)
            mask[slot] = True
        if mask.any():
            self._reset(mask)
        self._flush_freed_pages()
        self._active_dev = self._planes_dev = self._pos_dev = self._tok_dev = None

    def _book_scheduler_cancels(self) -> None:
        """Queued requests the scheduler cancelled as overdue join the book."""
        for req in self.scheduler.cancelled:
            self.completed.append(req)
            self.stats.add(req)
        self.scheduler.cancelled.clear()

    def _emit(self) -> None:
        if self._prefix is not None:
            self.stats.prefix_oversized(self._prefix.oversized)
        if self.writer is not None:
            self.stats.emit(self.writer)

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drive :meth:`step` until every submitted request has retired (or
        ``max_steps`` iterations elapse) and return the completed requests
        in retirement order.  Emits the stats through ``writer`` on drain."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._book_scheduler_cancels()
        if not self.has_work:
            self._emit()
        return self.completed

    # ------------------------------------------------------------------
    # graceful shutdown

    def drain(self, max_steps: int | None = None) -> list[Request]:
        """Serve every request already accepted, admitting nothing new
        (:meth:`submit` raises from the moment drain starts)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._draining = True
        return self.run(max_steps=max_steps)

    def close(self) -> None:
        """Cancel every queued and in-flight request (``engine_fault`` set,
        partial output kept), emit the stats and refuse further use.  A
        parked request whose landing STALLED on a dry pool is FAILED
        instead: it was accepted and then starved.  Idempotent."""
        if self._closed:
            return
        self._draining = True
        now = self.clock()
        mask = np.zeros((self.slots,), bool)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            req.engine_fault = True
            self._retire(slot, "cancelled", now)
            mask[slot] = True
        if mask.any():
            self._reset(mask)
        self._flush_freed_pages()
        for req, _prefilled in self._pending:  # overlap-prefilled, unlanded
            req.engine_fault = True
            if req.id in self._stalled_ids:
                self._fail(req, RuntimeError(
                    "engine closed while the request was overcommit-stalled "
                    "(accepted, prefilled, starved of KV pages)"), now)
            else:
                req.status = "cancelled"
                req.finish_t = now
                self.completed.append(req)
                self.stats.add(req)
        self._pending.clear()
        self._stalled_ids.clear()
        while (req := self.scheduler.pop(now)) is not None:
            req.engine_fault = True
            req.status = "cancelled"
            req.finish_t = now
            self.completed.append(req)
            self.stats.add(req)
        self._book_scheduler_cancels()
        if self._pool is not None:  # final occupancy, after the flush
            self.stats.pool_sample(self._pool.allocated, self._pool.capacity,
                                   self._page_size, self._page_bytes)
        self._emit()
        self._closed = True

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
