"""Continuous-batching inference engine of the port: decode-ahead windows,
per-request sampling, the prefix cache and the paged KV cache, speculative
decoding, int8 weights and KV, chunked prefill and the stall watchdog.

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

``speculative="ngram"`` replaces the decode window with the verify
window (core/generate.py ``_verify_sample_core``): between windows the
host drafts up to ``draft_len`` tokens per slot from the request's own
prompt and output (serving/drafter.py), and ONE (slots, draft_len + 1)
forward accepts greedy rows by argmax match and sampled rows by rejection
sampling, emitting ``accepted + 1`` tokens a row; the cursor rewinds to
the acceptance point.  Greedy output is the plain greedy stream whatever
the drafts.  ``quant="int8"`` serves a copy of the model with int8
projections (models/quant.py), quantized once here and again at
:meth:`swap_params`; the model's ``kv_cache_dtype="int8"`` makes every
cache int8 with scales.  ``prefill_chunk=C`` (paged only) admits a
prompt without a prefill: its pages are allocated and the slot waits
PREFILLING (occupied, inactive in every window) while C-token chunks run
through the extend program, one chunk an iteration at the overlap seam,
oldest first; the last chunk's logits give the first token.  Prompts up
to ``max_len - max_new`` need no bucket, K3 never runs, and a radix hit
starts chunking at the matched pages.  ``stall_timeout_s`` arms the
watchdog: a window whose dispatch raises is retried until no token has
come for that long, then in-flight requests fail and
:class:`EngineStalled` raises.  The forward writes the cache in place, so
every cursor is put back before a retry; a fault at the readback, after
the whole window ran, is never retried.

Greedy output is token-identical to the JAX engine on the same weights,
for every ``decode_ahead``, both layouts, speculation, int8 and chunking;
sampled streams too, up to near-ties of the perturbed scores
(tests/test_torch_decode_ahead.py, tests/test_torch_kv_paging.py,
tests/test_torch_sampling.py, tests/test_torch_quant.py,
tests/test_torch_speculative.py, tests/test_torch_chunked_prefill.py).
Failure isolation follows the JAX engine: a request whose own prefill,
chunk or ``callback`` raises fails alone; a fault in the window fails
every in-flight request and re-raises (at once, or at the watchdog's
deadline).

The hooks, each nil-guarded (``if self._x is not None``: an unwired engine
runs none of their instructions):

* ``chaos`` (utils/chaos.FaultInjector): ``serving-admit`` fires once per
  admission attempt (a hit fails that request alone), ``serving-step``
  once per window dispatch (a hit is an engine-wide decode fault) and
  ``serving-callback`` once per delivered token (a hit fails that
  request), on the JAX engine's event indices;
* ``tracer`` (utils/tracing.Tracer, shared with the scheduler): a span
  tree per request on its own track (``request`` -> ``queue`` / ``admit``
  (``prefill``, ``prefill_chunk``) / ``decode``, the ``first_token`` and
  ``chaos_fault`` instants) and, on the engine's ``trace_tid`` track, a
  ``window`` span per decode window with its ``dispatch`` and ``readback``
  children, the ``decode_fault`` instant and the ``queue_depth`` /
  ``occupied_slots`` counters;
* ``telemetry`` (utils/telemetry.Telemetry): a vitals source named
  ``engine<trace_tid>``, the ``ttft_s`` / ``latency_s`` / ``tpot_s``
  histograms, the ``tokens_generated`` counter and one ``maybe_sample``
  per step.

Builds are counted by ``utils.tracing.CompileTracker`` (the kernel and
native library builds and loads; there are no XLA programs) and land in
``stats`` as ``n_compiled_programs`` / ``n_loads``.  :meth:`prewarm` runs
every path of the engine once before traffic, so the first request pays
no build or load.  ``compile_cache_dir`` is accepted and has no effect:
the kernels' build directory already persists across processes.

Disaggregation: ``role="prefill"`` engines stop each landing where the
first token would be picked and park it, pages and the last logits row, in
a handoff outbox (serving/kv_handoff.py); ``role="decode"`` engines take no
submissions and land those packets through :meth:`admit_prefilled`, so they
never prefill.  A role needs the paged cache and refuses speculation, as in
JAX.

``tp`` and ``cp`` raise ``NotImplementedError`` away from their defaults,
naming the ROADMAP.md item that ports them.  The engine is
single-threaded: submit and run from one thread (the daemonized tier
gives each engine one pump thread).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    _sample_window_core,
    _set_cursor,
    _verify_sample_core,
    init_cache,
    make_prefill,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    quantize_state_dict_int8,
    weight_stream_bytes,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    check_quant_knobs,
    reset_cache_slots,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import kv_handoff
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.drafter import NgramDrafter
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    KVPagePool,
    init_paged_cache,
    make_paged_extend,
    make_paged_insert,
    paged_reset,
    pages_needed,
    pool_page_bytes,
    pool_page_leaves,
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
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import ChaosFault
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import CompileTracker

# knob -> (default, the ROADMAP.md queue 1 item that ports it)
_REFUSED = {
    "tp": (1, "item 7 ('Remaining parallelism and utilities')"),
    "cp": (1, "item 7 ('Remaining parallelism and utilities')"),
}

# a parked request whose radix match skipped the prefill: the suffix
# extend runs at landing, against the trie and pool of that moment
_RADIX_PREFILL = object()

# the "prefilled" payload of a chunked admission parked on a dry pool:
# nothing ran; the retry starts again from the allocation
_CHUNK_STALL = object()

# the "first token" _paged_land returns on a prefill-role engine: no token
# was picked — the landing went to the handoff outbox and the slot is free
# again (its pages moved to the packet's hold; the caller resets its row)
_HANDOFF = object()


class EngineStalled(RuntimeError):
    """The watchdog's verdict: no token progress across all slots within
    ``stall_timeout_s``.  In-flight requests were failed and their slots
    reset before this raised; the engine stays usable (or closeable)."""


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
    ``kv_page_size`` / ``kv_pages`` / ``radix_cache``, ``speculative`` /
    ``draft_len``, ``quant``, ``prefill_chunk``, ``stall_timeout_s`` and
    the sampling defaults are as in the module docstring (``rng`` is an
    int seed or (2,) uint32 key data, required when ``temperature > 0``).
    With ``quant="int8"``, ``self.model`` is the int8 copy.  ``chaos``,
    ``tracer`` (construct it with the engine's ``clock``), ``trace_tid``
    (the engine's host-loop track; a router gives each replica its own)
    and ``telemetry`` are the hooks of the module docstring.

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
                 speculative: str | None = None, draft_len: int = 3,
                 prefix_cache_bytes: int = 0,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 radix_cache: bool | None = None, prefill_chunk: int = 0,
                 tp: int = 1, cp: int = 1, quant: str | None = None,
                 eos_id: int | None = None, pad_id: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 min_p: float = 0.0, rng=None, role: str = "both",
                 writer: MetricWriter | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 stall_timeout_s: float | None = None,
                 compile_cache_dir: str | None = None,
                 chaos=None, tracer=None, trace_tid: int = 0, telemetry=None,
                 device=None):
        knobs = dict(tp=tp, cp=cp)
        for name, value in knobs.items():
            default, where = _REFUSED[name]
            if value != default:
                raise NotImplementedError(
                    f"InferenceEngine({name}={value!r}) is not in the PyTorch "
                    f"port yet: ROADMAP.md queue 1, {where}; leave it at "
                    f"{default!r}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill', or 'decode', got {role!r}")
        if role != "both" and not kv_page_size:
            raise ValueError(
                "disaggregated roles hand KV off as PAGES — role="
                f"{role!r} needs the paged cache (kv_page_size > 0)")
        if role != "both" and speculative is not None:
            raise ValueError(
                "speculative decoding does not compose with disaggregated "
                "roles yet — the verify path would have to run on both "
                "sides, voiding the per-role split")
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0 (None disables the watchdog), "
                f"got {stall_timeout_s}")
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
        if speculative not in (None, "ngram"):
            raise ValueError(
                f"speculative must be None or 'ngram' (model-free prompt-"
                f"lookup drafting), got {speculative!r}")
        if speculative is not None:
            if draft_len < 1:
                raise ValueError(
                    f"draft_len must be >= 1 (tokens drafted per verify "
                    f"window), got {draft_len}")
            if getattr(model, "window", 0):
                raise ValueError(
                    "speculative decoding does not compose with sliding-"
                    "window attention (model.window > 0): an overrunning "
                    "verify chunk would mislabel the windowed span gather")
        quant = "none" if quant is None else quant
        check_quant_knobs(quant, "native")
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
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = whole-prompt bucketed "
                f"prefill), got {prefill_chunk}")
        if prefill_chunk:
            if not kv_page_size:
                raise ValueError(
                    "prefill_chunk runs prompts through the paged suffix-"
                    "extend program — it needs the paged cache "
                    "(kv_page_size > 0)")
            if prefill_chunk > max_len:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) cannot exceed max_len "
                    f"({max_len}) — a chunk is at most one slot's span")
            if prefix_cache_bytes > 0:
                raise ValueError(
                    "prefill_chunk does not compose with the dense prefix "
                    "cache (prefix_cache_bytes > 0): chunked admission never "
                    "produces the bucketed row the cache stores — the radix "
                    "trie is the prefix-sharing mechanism under chunking")
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
        # weight-only int8: serve an int8 copy of the model and quantize
        # the given weights once, here (swap_params does it again)
        self.quant = quant
        if self.quant == "int8":
            if not hasattr(model, "clone"):
                raise ValueError(
                    f"quant='int8' needs a model with a quant= field (the "
                    f"causal-LM family); {type(model).__name__} has none")
            if model.quant != "int8":
                model = model.clone(quant="int8")
            if params is not None:
                params = quantize_state_dict_int8(params)
        if params is not None:
            model.load_state_dict(params, strict=True)
        if scheduler is None:
            scheduler = FIFOScheduler(
                max_len=max_len,
                buckets=buckets if buckets is not None else
                tuple(b for b in (16, 32, 64, 128) if b <= max_len) or (max_len,),
                clock=clock, tracer=tracer, chunked_prefill=bool(prefill_chunk))
        elif buckets is not None:
            want = tuple(sorted(set(int(b) for b in buckets)))
            if want != scheduler.buckets:
                raise ValueError(
                    f"engine buckets= {want} != scheduler buckets "
                    f"{scheduler.buckets} — the prefill runs at the "
                    "scheduler's shapes")
        if scheduler.chunked_prefill and not prefill_chunk:
            raise ValueError(
                "scheduler.chunked_prefill is set but the engine has no "
                "prefill_chunk= — the scheduler would admit prompts past "
                "the largest bucket that the engine cannot prefill")
        scheduler.chunked_prefill = bool(prefill_chunk)
        if scheduler.max_len != max_len:
            raise ValueError(
                f"scheduler.max_len ({scheduler.max_len}) != engine max_len "
                f"({max_len}) — admission would pass requests the cache "
                "cannot hold")
        # ONE tracer serves a request's whole span tree: the scheduler opens
        # it (submit/queue), the engine continues it; adopt whichever side
        # has one and refuse two different ones
        sched_tracer = getattr(scheduler, "tracer", None)
        if tracer is None:
            tracer = sched_tracer
        elif sched_tracer is None:
            scheduler.tracer = tracer
        elif sched_tracer is not tracer:
            raise ValueError(
                "engine tracer= and scheduler.tracer are different Tracer "
                "objects — a request's span tree would be split across two "
                "buffers; wire ONE tracer (either side) and both will use it")
        self._tracer = tracer
        self._trace_tid = int(trace_tid)
        self._chaos = chaos
        # builds and loads from here to each emission are this engine's
        self._compile = CompileTracker.install()
        self._compile0 = self._compile.snapshot()
        if tracer is not None:
            self._compile.bind(tracer)
        # disaggregated serving: "both" is the monolithic engine.
        # "prefill" runs the prefill and the paged extend only and diverts
        # finished landings to a handoff outbox (serving/kv_handoff.py)
        # instead of decoding; "decode" accepts handed-off pages through
        # admit_prefilled() and never prefills
        self.role = role
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.decode_ahead = int(decode_ahead)
        self.speculative = speculative
        self.draft_len = int(draft_len) if speculative is not None else 0
        self._drafter = NgramDrafter(self.draft_len) if speculative else None
        self._prefill_chunk = int(prefill_chunk)
        self.stall_timeout_s = stall_timeout_s
        self.scheduler = scheduler
        self.buckets = scheduler.buckets
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.writer = writer
        self.clock = clock
        self.stats = ServingStats(slots, decode_ahead=self.decode_ahead, role=role)
        # prefill-role outbox: a HandoffPacket per finished prefill, drained
        # by the router's handoff pump (or the owner directly in tests)
        self._outbox: deque = deque()
        self.handoffs_out = 0   # packets packaged (prefill side)
        self.handoffs_in = 0    # packets landed (decode side)
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
        # chunked prefill: per slot, None while decoding, else the chunk
        # record {"done", "m_blocks", "path", "bt", "bt_dev", "last"} of a
        # PREFILLING slot (occupied, inactive in every window)
        self._slot_prefill: list[dict | None] = [None] * slots
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
        # the watchdog's anchor (reset by a fatal fault) and the heartbeat
        # (the last progress ever, never reset)
        self._last_progress_t: float | None = None
        self._last_progress_ever: float | None = None
        # utils/telemetry.Telemetry | None: a vitals source under the trace
        # track (a respawned replica replaces its predecessor's) and one
        # maybe_sample per step
        self._telemetry = telemetry
        if telemetry is not None:
            telemetry.register_source(f"engine{self._trace_tid}",
                                      self._telemetry_vitals)
        self._stamp_memory()

    def _stamp_memory(self) -> None:
        """Stamp the footprint into ``self.stats`` (at construction and at
        every emission, so a swapped-in stats object still reports it)."""
        self.stats.memory(kv_bytes_per_chip=self.kv_bytes_per_chip(),
                          weight_bytes_per_chip=self.weight_bytes_per_chip(),
                          quant=self.quant)

    def _telemetry_vitals(self) -> dict:
        """Health-sampler vitals: queue, slot and pool state plus the stats
        counters, all O(1) host reads."""
        v = self.stats.vitals()
        v.update(
            queue_depth=len(self.scheduler),
            parked=len(self._pending),
            overcommit_stalled=len(self._stalled_ids),
            occupied_slots=self.occupied,
            slots=self.slots,
            draining=self._draining,
            closed=self._closed,
            last_progress_t=self._last_progress_t,
        )
        return v

    @classmethod
    def from_trainer(cls, trainer, *, slots: int, max_len: int, **kw
                     ) -> "InferenceEngine":
        """An engine over a trained :class:`~..core.trainer.Trainer` run:
        a fresh causal LM of the run's configuration on the trainer's
        device, holding :meth:`Trainer._decode_params`, with the trainer's
        writer and ``compile_cache_dir`` unless ``kw`` sets them."""
        from distributed_tensorflow_ibm_mnist_tpu_torch.models import model_accepts

        if not model_accepts(trainer.config.model, "pos") or not trainer.causal:
            raise ValueError(
                "InferenceEngine needs a causally-trained causal-LM-family "
                f"run; got {trainer.config.model!r}")
        kw.setdefault("writer", trainer.writer)
        kw.setdefault("compile_cache_dir", trainer.config.compile_cache_dir)
        kw.setdefault("device", trainer.device)
        return cls(trainer._decode_model(), trainer._decode_params(),
                   slots=slots, max_len=max_len, **kw)

    def kv_bytes_per_chip(self) -> int:
        """Bytes of the decode cache on the card (the whole cache: one
        card, no tp or cp), block tables and cursors included."""
        return sum(leaf.nbytes for entry in self.cache.values()
                   for leaf in entry.values())

    def weight_bytes_per_chip(self) -> int:
        """Bytes of the served weights on the card (int8 weights 1 byte an
        element, their scales 4)."""
        return weight_stream_bytes(self.model.state_dict())

    # ------------------------------------------------------------------
    # request lifecycle

    def submit(self, prompt, max_new: int, deadline_s: float | None = None,
               callback: Callable | None = None,
               ttft_slo_s: float | None = None,
               tpot_slo_s: float | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Enqueue a request (see :meth:`FIFOScheduler.submit`; raises
        ``QueueFull`` under backpressure).  ``callback(request, token)``
        streams every generated token; if it raises, THIS request fails.
        ``ttft_slo_s`` / ``tpot_slo_s`` are judged, never enforced.
        ``sampling`` is the request's :class:`SamplingParams` (None = the
        engine's defaults).  Refused after :meth:`drain` / :meth:`close`."""
        if self._closed or self._draining:
            raise RuntimeError(
                "engine is " + ("closed" if self._closed else "draining")
                + " — no new requests")
        if self.role == "decode":
            raise RuntimeError(
                "decode-role engine takes no direct submissions — its work "
                "arrives prefilled via admit_prefilled (route admissions "
                "to a prefill/both replica; serving/router.py does)")
        return self.scheduler.submit(prompt, max_new, deadline_s=deadline_s,
                                     callback=callback, ttft_slo_s=ttft_slo_s,
                                     tpot_slo_s=tpot_slo_s, sampling=sampling)

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def _decoding(self) -> int:
        """Occupied slots past their prefill (PREFILLING slots are
        occupied but sit out every window)."""
        return sum(r is not None and p is None
                   for r, p in zip(self._slot_req, self._slot_prefill))

    @property
    def has_work(self) -> bool:
        return (self.occupied > 0 or len(self.scheduler) > 0
                or len(self._pending) > 0)

    @property
    def heartbeat_t(self) -> float | None:
        """Clock time of the engine's last progress (a token, an admission,
        a chunk), or None before any: the liveness signal a supervisor
        reads from outside :meth:`step`."""
        return self._last_progress_ever

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

    # ------------------------------------------------------------------
    # tracing bookkeeping (each helper is a no-op without a tracer)

    def _tr_phase(self, req: Request, name: str, **args) -> None:
        """Close ``req``'s open phase span and open ``name`` in its place,
        under the request's root span."""
        if self._tracer is None or req.trace is None:
            return
        t = req.trace
        if t.get("phase") is not None:
            self._tracer.end(t["phase"])
        t["phase"] = self._tracer.begin(name, cat="serving", parent=t["id"],
                                        tid=t["tid"], **args)

    def _tr_instant(self, req: Request, name: str, **args) -> None:
        """A correlated event on ``req``'s tree."""
        if self._tracer is None or req.trace is None:
            return
        self._tracer.instant(name, cat="serving", parent=req.trace["id"],
                             tid=req.trace["tid"], **args)

    def _tr_close(self, req: Request, **args) -> None:
        """Terminal: close the open phase (if any) and the request root."""
        if self._tracer is None or req.trace is None:
            return
        t = req.trace
        if t.get("phase") is not None:
            self._tracer.end(t["phase"])
        self._tracer.end(t["id"], **args)
        req.trace = None

    def _exemplar(self, req: Request) -> str | None:
        return req.trace_ctx.trace_id if req.trace_ctx is not None else None

    def _retire(self, slot: int, status: str, now: float, waste: int = 0) -> None:
        req = self._slot_req[slot]
        req.status = status
        req.finish_t = now
        # TPOT verdict: mean seconds per output token after the first (a
        # single-token request has no interval: trivially met)
        n = len(req.generated)
        if req.tpot_slo_s is not None and status == "done":
            req.slo_tpot_ok = (True if req.first_token_t is None or n <= 1 else
                               (now - req.first_token_t) / (n - 1) <= req.tpot_slo_s)
        if self._telemetry is not None and status == "done":
            ex = self._exemplar(req)
            self._telemetry.observe("latency_s", now - req.submit_t, exemplar=ex)
            if req.first_token_t is not None and n > 1:
                self._telemetry.observe(
                    "tpot_s", (now - req.first_token_t) / (n - 1), exemplar=ex)
        self._slot_req[slot] = None
        self._slot_prefill[slot] = None  # a PREFILLING slot can be swept too
        self._release_slot_alloc(slot)
        self._active_dev = None  # occupancy changed; the next window re-freezes
        self._tr_close(req, status=status, slot=slot, waste_steps=waste,
                       n_generated=n)
        self.completed.append(req)
        self.stats.add(req)

    def _fail(self, req: Request, exc: BaseException, now: float) -> None:
        """Move ``req`` to the terminal FAILED state (isolated casualty)."""
        req.status = "failed"
        req.error = f"{type(exc).__name__}: {exc}"
        req.finish_t = now
        if self._tracer is not None and req.trace is not None:
            if isinstance(exc, ChaosFault):
                # the injected fault lands ON the request it hit
                self._tr_instant(req, "chaos_fault", site=exc.site,
                                 fault_kind=exc.kind, event=exc.event)
            self._tr_close(req, status="failed", error=req.error)
        self.completed.append(req)
        self.stats.add(req)

    def _cancel_unlanded(self, req: Request, now: float) -> None:
        """Book a request that never held a slot as cancelled."""
        req.status = "cancelled"
        req.finish_t = now
        self._tr_close(req, status="cancelled")
        self.completed.append(req)
        self.stats.add(req)

    def _notify(self, req: Request, tok: int) -> None:
        """Deliver one token to the request's callback; a raise (the
        callback's, or a ``serving-callback`` chaos hit) fails THIS request."""
        if self._chaos is not None:
            self._chaos.raise_if_fired("serving-callback", ChaosFault)
        if req.callback is not None:
            req.callback(req, tok)

    def _first_token(self, req: Request, slot: int, first: int, first_logp: float,
                     cache_hit: bool) -> None:
        """Record ``req``'s first token: TTFT (on the host) and its SLO
        verdict, the heartbeat, telemetry, the trace instant, the callback."""
        req.generated.append(first)
        req.logprobs.append(first_logp)
        req.first_token_t = self.clock()
        self._last_progress_ever = req.first_token_t
        if req.ttft_slo_s is not None:
            req.slo_ttft_ok = req.first_token_t - req.submit_t <= req.ttft_slo_s
        if self._telemetry is not None:
            self._telemetry.observe("ttft_s", req.first_token_t - req.submit_t,
                                    exemplar=self._exemplar(req))
            # step()'s count holds window tokens only; this one lands here
            self._telemetry.inc("tokens_generated")
        req.status = "running"
        self._tr_instant(req, "first_token", slot=slot, cache_hit=cache_hit)
        self._notify(req, first)

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
        radix check, or the bucketed B=1 prefill, after one
        ``serving-admit`` chaos event (hit or miss, inline or overlapped).
        Returns ``(row_cache, logits, cache_hit)``; an exception is the
        REQUEST's failure."""
        if self._chaos is not None:
            self._chaos.raise_if_fired("serving-admit", ChaosFault)
        if self._prefix is not None:
            hit = self._prefix.get(req.prefix_key)
            self.stats.prefix(hit is not None)
            if hit is not None:
                self._tr_instant(req, "prefix_cache_hit", bucket=req.bucket)
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
        span = (self._tracer.begin("prefill", cat="serving",
                                   parent=req.trace["phase"] or req.trace["id"],
                                   tid=req.trace["tid"], bucket=req.bucket)
                if self._tracer is not None and req.trace is not None else None)
        try:
            with self._compile.site(f"prefill[b{req.bucket}]"):
                return self._prefill(torch.as_tensor(padded, device=self.device),
                                     torch.tensor([req.tokens.size], dtype=torch.int32,
                                                  device=self.device))
        finally:
            if span is not None:
                self._tracer.end(span)  # a poisoned prefill still closes it

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
        or None when the pool cannot cover the request now (a stall).  On a
        prefill-role engine nothing is picked: the landing is packaged into
        the handoff outbox and ``first`` is ``_HANDOFF``."""
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
        req.pages = total
        bt_dev = torch.as_tensor(bt_row, device=self.device)
        with torch.no_grad():
            if m_blocks:
                suffix = req.tokens[m_tok:]
                padded = np.full((1, self.scheduler.bucket_for(suffix.size)),
                                 self.pad_id, np.int64)
                padded[0, : suffix.size] = suffix
                self.cache, logits = self._extend(
                    self.cache, slot, bt_dev, torch.as_tensor(padded, device=self.device),
                    m_tok, int(suffix.size))
                self.stats.radix(True, tokens=m_tok)
                self._radix.record(True, tokens=m_tok)
                req.radix_tokens = m_tok
            else:
                self._insert(self.cache, row_cache, bt_dev, slot)
                if self._radix is not None:
                    self.stats.radix(False)
                    self._radix.record(False)
                if self._prefix is not None and not cache_hit:
                    self._prefix.put(req.prefix_key, row_cache, logits)
        if self.role == "prefill":
            # disaggregated: stop where the pick would run — the logits row
            # travels in the packet and the DECODE side picks through the
            # same shared pick.  Packaged AFTER the donation, so the source
            # trie shares this prompt's blocks with later prefills (and with
            # the re-prefill a dead transfer falls back to)
            if self._radix is not None:
                self._donate(slot, req, bt_row, m_blocks, path)
            self._handoff_package(req, slot, logits, bt_row)
            return _HANDOFF, None, cache_hit
        first, first_logp = self._first_pick(req, logits)
        if self._radix is not None:
            self._donate(slot, req, bt_row, m_blocks, path)
        return first, first_logp, cache_hit

    def _admit(self, req: Request, slot: int, now: float,
               prefilled: tuple | None = None):
        """Prefill ``req`` (or take its overlap-dispatched ``prefilled``)
        and land it in ``slot``.  A failure of the request's own processing
        fails it and leaves the slot free.  Returns True when the slot's row
        needs a reset (a failure after the insert, or a request that retired
        at admission), or ``("stall", prefilled)`` when the paged pool is
        momentarily dry."""
        if self._prefill_chunk:
            # chunked: allocate and park the slot PREFILLING; the chunks
            # run one an iteration from _chunk_tick
            return self._chunk_admit(req, slot, now, retry=prefilled is not None)
        inserted = False
        # an inline admission opens its "admit" phase here; an overlapped
        # one opened it at pop, so its phase also covers the parked wait
        if req.trace is not None and req.trace.get("phase") is None:
            self._tr_phase(req, "admit", slot=slot)
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
                if first is _HANDOFF:
                    # prefill role: the landing went to the outbox and the
                    # slot is free again — True asks the caller to reset the
                    # row's block table unless a later admit overwrites it
                    self.stats.prefill(self.clock() - t_p)
                    return True
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
            self.stats.prefill(self.clock() - t_p)
            self._first_token(req, slot, first, first_logp, cache_hit)
        except Exception as e:
            self._release_slot_alloc(slot)
            self._fail(req, e, self.clock())
            return inserted
        self._slot_req[slot] = req
        self._slot_tok[slot] = first
        self._set_planes(slot, req)
        self._tr_phase(req, "decode", slot=slot)
        if self._done_reason(req) is not None:
            self._retire(slot, self._done_reason(req), self.clock())
            return True  # the landed row belongs to no live request now
        return False

    def _set_planes(self, slot: int, req: Request) -> None:
        """Install a landed request's sampling planes at ``slot`` and mark
        every device mirror stale."""
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

    # ------------------------------------------------------------------
    # chunked prefill: the slot holds its pages PREFILLING while C-token
    # chunks of its prompt run through the extend program, one chunk an
    # engine iteration, so any admission costs the others one chunk

    def _chunk_admit(self, req: Request, slot: int, now: float, retry: bool = False):
        """Admit ``req`` into ``slot`` PREFILLING: fire the one
        ``serving-admit`` chaos event (not again on a stall ``retry``), take
        the radix match (a partial hit starts chunking at the matched
        pages), allocate the whole page span and build the chunk record; no
        chunk runs here.  Returns what :meth:`_admit` does: ``("stall",
        _CHUNK_STALL)`` on a dry pool, else False (the slot occupied unless
        the chaos event failed the request).  The block table is installed
        by the first chunk's extend, not here: a reset pending from the
        previous tenant stays pending."""
        if req.trace is not None and req.trace.get("phase") is None:
            self._tr_phase(req, "admit", slot=slot, chunked=True)
        if not retry and self._chaos is not None:
            try:
                self._chaos.raise_if_fired("serving-admit", ChaosFault)
            except ChaosFault as e:
                self._fail(req, e, self.clock())
                return False
        ps = self._page_size
        n_tok = int(req.tokens.size)
        path: list = []
        if self._radix is not None:
            path, matched = self._radix.match(req.tokens)
            path = path[: self._usable_radix_tokens(req, matched) // ps]
        m_blocks = len(path)
        m_tok = m_blocks * ps
        if m_blocks:
            self._radix.acquire(path)  # pin before any allocation can evict
        total = pages_needed(n_tok + req.max_new, ps)
        private = self._alloc_pages(total - m_blocks)
        if private is None:
            if m_blocks:
                self._radix.release(path)
            return ("stall", _CHUNK_STALL)
        self._slot_alloc[slot] = [list(private), list(path)]
        bt_row = np.zeros((self.max_len // ps,), np.int32)  # the rest: TRASH
        for j, node in enumerate(path):
            bt_row[j] = node.page
        bt_row[m_blocks:m_blocks + len(private)] = private
        req.pages = total
        req.admit_t = now
        req.status = "prefilling"
        self._slot_req[slot] = req
        self._slot_prefill[slot] = {
            "done": m_tok, "m_blocks": m_blocks, "path": path, "bt": bt_row,
            "bt_dev": torch.as_tensor(bt_row, device=self.device), "last": None}
        self._active_dev = None  # the slot sits out windows until it lands
        if m_blocks:
            self.stats.radix(True, tokens=m_tok)
            self._radix.record(True, tokens=m_tok)
            req.radix_tokens = m_tok
        elif self._radix is not None:
            self.stats.radix(False)
            self._radix.record(False)
        self.stats.prompt_admitted(n_tok)
        return False

    def _chunk_tick(self, reset_mask: np.ndarray) -> bool:
        """Dispatch ONE chunk of the oldest PREFILLING slot (lowest request
        id) through the extend program.  True when a chunk ran; a chunk's
        failure is its request's own."""
        prefilling = [slot for slot, rec in enumerate(self._slot_prefill)
                      if rec is not None]
        if not prefilling:
            return False
        slot = min(prefilling, key=lambda i: self._slot_req[i].id)
        rec, req = self._slot_prefill[slot], self._slot_req[slot]
        c = self._prefill_chunk
        done = rec["done"]
        part = req.tokens[done:done + c]
        t0 = self.clock()
        try:
            padded = np.full((1, c), self.pad_id, np.int64)
            padded[0, : part.size] = part
            with torch.no_grad():
                self.cache, rec["last"] = self._extend(
                    self.cache, slot, rec["bt_dev"],
                    torch.as_tensor(padded, device=self.device), done, int(part.size))
            rec["done"] = done + int(part.size)
            # the extend installed the slot's block table: a reset pending
            # from its previous tenant must not undo it
            reset_mask[slot] = False
            t1 = self.clock()
            self.stats.chunk(t1 - t0)
            if self._tracer is not None and req.trace is not None:
                # the chunk's first prompt position is ``chunk_start``: a
                # ``start`` keyword would collide with complete()'s own
                self._tracer.complete(
                    "prefill_chunk", t0, t1, cat="serving",
                    parent=req.trace.get("phase") or req.trace["id"],
                    tid=req.trace["tid"], chunk_start=done,
                    tokens=int(part.size))
            return True
        except Exception as e:
            self._drop_prefilling(slot, req, e, reset_mask)
            return False

    def _drop_prefilling(self, slot: int, req: Request, exc: BaseException,
                         reset_mask: np.ndarray) -> None:
        """Fail a PREFILLING (or just landed) request alone: free its slot
        and queue its pages and row for release."""
        self._slot_req[slot] = None
        self._slot_prefill[slot] = None
        self._release_slot_alloc(slot)
        self._active_dev = None
        self._fail(req, exc, self.clock())
        reset_mask[slot] = True

    def _chunk_land(self, reset_mask: np.ndarray) -> None:
        """Land every slot whose last chunk ran: pick its first token from
        the chunk's logits (the shared ``first_pick``), donate its fresh
        whole prompt pages to the trie, and join the windows.  Runs after
        the window's readback, so the wholesale token-mirror copy there
        cannot overwrite the first token."""
        for slot, rec in enumerate(self._slot_prefill):
            if rec is None or rec["last"] is None:
                continue
            req = self._slot_req[slot]
            if rec["done"] < int(req.tokens.size):
                continue
            if self.role == "prefill":
                # disaggregated: donate the chunked prompt's blocks to the
                # source trie, then package instead of picking
                try:
                    if self._radix is not None:
                        self._donate(slot, req, rec["bt"], rec["m_blocks"], rec["path"])
                    self._handoff_package(req, slot, rec["last"], rec["bt"])
                except Exception as e:
                    self._drop_prefilling(slot, req, e, reset_mask)
                    continue
                self._slot_req[slot] = None
                self._slot_prefill[slot] = None
                self._active_dev = None
                reset_mask[slot] = True
                continue
            try:
                first, first_logp = self._first_pick(req, rec["last"])
                if self._radix is not None:
                    self._donate(slot, req, rec["bt"], rec["m_blocks"], rec["path"])
                self._first_token(req, slot, first, first_logp, False)
            except Exception as e:
                self._drop_prefilling(slot, req, e, reset_mask)
                continue
            self._slot_prefill[slot] = None
            self._slot_tok[slot] = first
            self._set_planes(slot, req)
            self._tr_phase(req, "decode", slot=slot)
            if self._done_reason(req) is not None:
                self._retire(slot, self._done_reason(req), self.clock())
                reset_mask[slot] = True

    def _donate(self, slot: int, req: Request, bt_row, m_blocks: int, path) -> None:
        """Donate the prompt's freshly computed whole blocks past the match
        to the radix trie: they move from the slot's private pages to its
        held nodes (ref kept until retirement)."""
        donate = {j: int(bt_row[j])
                  for j in range(m_blocks, int(req.tokens.size) // self._page_size)}
        if donate:
            priv, nodes = self._slot_alloc[slot]
            held, _kept = self._radix.insert(req.tokens, m_blocks, donate, path)
            for node in held:
                priv.remove(node.page)
                nodes.append(node)

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
                        self._cancel_unlanded(req, now)
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
                    if self._slot_prefill[slot] is None:
                        reset_mask[slot] = False  # the insert overwrote the row
                    # PREFILLING: keep a pending reset; the first chunk
                    # installs the block table
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
        # the "admit" phase opens here: it spans the prefill and the parked
        # wait for a slot
        self._tr_phase(req, "admit", overlapped=True)
        t0 = self.clock()
        try:
            self._pending.append((req, self._prefill_request(req)))
        except Exception as e:
            self._fail(req, e, self.clock())
        self.stats.prefill(self.clock() - t0)

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff (serving/kv_handoff.py)

    def _handoff_package(self, req: Request, slot: int, logits, bt_row) -> None:
        """Prefill role: read the landed prompt's pages to the host and park
        the request in the outbox (kv_handoff.package) — the slot's page
        hold transfers to the packet, nothing frees until the router
        confirms delivery."""
        packet = kv_handoff.package(self, req, slot, logits, bt_row)
        self._outbox.append(packet)
        self.handoffs_out += 1

    def admit_prefilled(self, packet) -> bool:
        """Decode side: land a handed-off prefill (kv_handoff.deliver).
        True = packet consumed (decoding, or terminally failed on its own
        admission tail); False = re-park and retry later (no free slot, or
        the all-or-nothing destination allocation found the pool dry —
        zero writes were issued).  Refused on prefill-role and dense
        engines, and after close."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-role engine cannot accept a handoff — deliver to "
                "a decode/both replica")
        if self._pool is None:
            raise RuntimeError(
                "handoff needs the paged KV layout (kv_page_size > 0)")
        return kv_handoff.deliver(self, packet)

    def _reset_slot_now(self, slot: int) -> None:
        """Immediate one-slot block-table reset + deferred-free flush, for
        landing paths that run OUTSIDE step() (admit_prefilled)."""
        mask = np.zeros((self.slots,), bool)
        mask[slot] = True
        self._reset(mask)
        self._flush_freed_pages()

    # ------------------------------------------------------------------
    # the host loop

    def _active_planes(self):
        """The frozen active mask and the sampling planes of the next
        window, re-uploaded only where the host mirrors changed."""
        dev = self.device
        if self._active_dev is None:
            # PREFILLING slots sit out: their garbage writes land above the
            # chunk cursor, where the next chunk overwrites them
            active = np.array([r is not None and p is None
                               for r, p in zip(self._slot_req, self._slot_prefill)])
            self._active_dev = torch.as_tensor(active, device=dev)
            self._window_sampled = bool((self._slot_temp[active] > 0).any())
        if self._planes_dev is None:
            self._planes_dev = tuple(
                torch.as_tensor(x, device=dev) for x in (
                    self._slot_temp, self._slot_topp, self._slot_topk,
                    self._slot_minp, self._slot_key))
        return self._active_dev, self._planes_dev

    def _window_inputs(self):
        """The decode window's device inputs: the pending tokens, the
        active mask, the sampling planes and the PRNG positions."""
        dev = self.device
        if self._tok_dev is None:
            self._tok_dev = torch.as_tensor(self._slot_tok, device=dev)
        if self._pos_dev is None:
            # PRNG positions = tokens generated so far
            self._pos_dev = torch.as_tensor(np.array(
                [0 if r is None else len(r.generated) for r in self._slot_req],
                np.int64), device=dev)
        return (self._tok_dev, *self._active_planes(), self._pos_dev)

    def _window(self, tok, active, planes, pos):
        """The decode-ahead window: ``(cache, tokens, logprobs, last, pos)``."""
        with torch.no_grad():
            return _sample_window_core(
                self.model, self.cache, tok, active, *planes, pos,
                self.decode_ahead, self.max_len, True, self.pad_id,
                self._window_sampled)

    def _verify(self, chunk, draft_lens, active, planes, pos):
        """The speculative verify window: ``(cache, tokens, logprobs,
        accepted, last)``."""
        with torch.no_grad():
            return _verify_sample_core(
                self.model, self.cache, chunk, draft_lens, active, *planes, pos,
                self.max_len, self.pad_id, self._window_sampled)

    def _draft_chunk(self):
        """Draft every decoding slot: the (slots, draft_len + 1) chunk
        (column 0 the pending token), the draft lengths and the PRNG
        positions, uploaded in one copy.  Returns ``(chunk, draft_lens,
        pos)`` on the device and the host draft lengths."""
        k = self.draft_len + 1
        host = np.full((self.slots, k + 2), self.pad_id, np.int64)
        host[:, 0] = self._slot_tok
        host[:, k:] = 0
        for slot, req in enumerate(self._slot_req):
            if req is None or self._slot_prefill[slot] is not None:
                continue
            d = self._drafter.draft(np.concatenate(
                [req.tokens, np.asarray(req.generated, np.int32)]))
            host[slot, 1:1 + d.size] = d
            host[slot, k] = d.size
            host[slot, k + 1] = len(req.generated)  # the PRNG position
        dev = torch.as_tensor(host, device=self.device)
        return (dev[:, :k], dev[:, k], dev[:, k + 1]), host[:, k].copy()

    def step(self) -> int:
        """One host-loop iteration: cancel -> admit -> decode (or verify)
        window, with one prefill or chunk behind it -> retire.  Returns the
        number of REAL tokens produced (tokens past a row's EOS or budget
        are discarded, never counted)."""
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
        admitted = self._admit_free_slots(reset_mask)

        # 3) ONE window dispatch across ALL slots; a fault here belongs to
        #    every in-flight request: they fail and the error re-raises, at
        #    once or, with the watchdog, once no progress came for
        #    stall_timeout_s (until then the window is retried from the
        #    cursors it found: the forward writes K/V and advances every
        #    block's cursor in place, and K/V above a cursor is overwritten)
        produced = 0
        decoded = chunked = ticked = False
        n_decoding = self._decoding
        occupied_at_dispatch = self.occupied
        if n_decoding > 0:
            spec = self._drafter is not None
            k = self.draft_len + 1 if spec else self.decode_ahead
            idx0 = (next(iter(self.cache.values()))["index"].clone()
                    if self.stall_timeout_s is not None else None)
            # the engine track's view of the window: closed spans built from
            # the timestamps the loop takes anyway
            t_w0 = self.clock() if self._tracer is not None else 0.0
            t_d = None
            try:
                if self._chaos is not None:
                    # one event per WINDOW dispatch, whatever decode_ahead
                    self._chaos.raise_if_fired("serving-step", ChaosFault)
                if spec:
                    t_d0 = self.clock()
                    (chunk, dls_dev, pos), dls = self._draft_chunk()
                    t_d1 = self.clock()
                    active, planes = self._active_planes()
                    t_d = self.clock()
                    self.cache, blk_dev, logp_dev, acc_dev, _ = self._verify(
                        chunk, dls_dev, active, planes, pos)
                    tail = [acc_dev[:, None]]
                else:
                    tok, active, planes, pos = self._window_inputs()
                    t_d = self.clock()
                    self.cache, blk_dev, logp_dev, last_dev, pos_out = self._window(
                        tok, active, planes, pos)
                    tail = []
                dispatch_s = self.clock() - t_d
            except Exception as e:
                if self._tracer is not None:
                    # a dispatch fault belongs to every slot: one engine-track
                    # instant; the requests it kills close through _fail
                    now = self.clock()
                    self._tracer.instant(
                        "decode_fault", cat="serving", tid=self._trace_tid,
                        error=f"{type(e).__name__}: {e}")
                    wid = self._tracer.complete(
                        "window", t_w0, now, cat="serving", k=k,
                        tid=self._trace_tid, occupied=occupied_at_dispatch,
                        error=type(e).__name__)
                    if t_d is not None:
                        self._tracer.complete(
                            "dispatch", t_d, now, cat="serving",
                            tid=self._trace_tid, parent=wid,
                            error=type(e).__name__)
                self._window_fault(e, t0, idx0)
                # transient: no tokens this iteration; the watchdog counts on
            else:
                # the window runs on the card: spend the wait on one chunk
                # of the oldest PREFILLING slot, or the next queued prefill
                # (each fails only its own request)
                if self._prefill_chunk:
                    chunked, ticked = self._chunk_tick(reset_mask), True
                else:
                    self._overlap_prefill()
                # ONE device->host copy (and sync) per window; the window has
                # written the cache by now, so a fault here is never retried
                t_rb = self.clock()
                try:
                    host = self._readback([blk_dev, logp_dev] + tail)
                except Exception as e:
                    self._fail_in_flight(e, self.clock())
                    raise
                readback_s = self.clock() - t_rb
                decoded = True
                blk, logps = host[:, :k].astype(np.int64), host[:, k:2 * k]
                if spec:
                    acc = host[:, 2 * k].astype(np.int64)
                    self._tok_dev = None  # the next chunk is built on the host
                else:
                    self._tok_dev = last_dev
                    self._pos_dev = pos_out
                    self._slot_tok = blk[:, -1].copy()
                now = self.clock()
                t_acc0 = t_rb + readback_s
                self.stats.decode(dispatch_s + readback_s)
                waste = 0
                for slot, req in enumerate(self._slot_req):
                    if req is None or self._slot_prefill[slot] is not None:
                        continue  # PREFILLING rows sat the window out
                    n_emit = k
                    if spec:
                        # the accepted drafts and the model's own next token
                        n_emit = int(acc[slot]) + 1
                        self._slot_tok[slot] = blk[slot, n_emit - 1]
                        self.stats.spec(int(dls[slot]), int(acc[slot]))
                        if self._tracer is not None and req.trace is not None:
                            # on the request's track BEFORE the token loop:
                            # a retirement inside it closes the tree
                            par = req.trace.get("phase") or req.trace["id"]
                            rtid = req.trace["tid"]
                            self._tracer.complete(
                                "draft", t_d0, t_d1, cat="speculative",
                                parent=par, tid=rtid, drafted=int(dls[slot]))
                            self._tracer.complete(
                                "verify", t_d, t_acc0, cat="speculative",
                                parent=par, tid=rtid)
                            self._tracer.complete(
                                "accept", t_acc0, now, cat="speculative",
                                parent=par, tid=rtid, accepted=int(acc[slot]),
                                drafted=int(dls[slot]))
                    appended = 0
                    for j in range(n_emit):
                        tok_j = int(blk[slot, j])
                        req.generated.append(tok_j)
                        req.logprobs.append(float(logps[slot, j]))
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
                            self._retire(slot, reason, now, waste=k - appended)
                            reset_mask[slot] = True
                            break
                    # k device steps (or verify lanes) for `appended` tokens
                    waste += k - appended
                self.stats.window(dispatch_s, readback_s, steps=n_decoding * k,
                                  waste=waste)
                if self._tracer is not None:
                    wid = self._tracer.complete(
                        "window", t_w0, self.clock(), cat="serving", k=k,
                        tid=self._trace_tid, occupied=occupied_at_dispatch,
                        produced=produced, waste=waste)
                    self._tracer.complete("dispatch", t_d, t_d + dispatch_s,
                                          cat="serving", tid=self._trace_tid,
                                          parent=wid)
                    self._tracer.complete("readback", t_rb, t_rb + readback_s,
                                          cat="serving", tid=self._trace_tid,
                                          parent=wid)

        if self._prefill_chunk:
            if not ticked:
                # nothing decoding (or the window faulted before its tick):
                # the chunks still advance, one an iteration
                chunked = self._chunk_tick(reset_mask)
            # land AFTER the readback, so the wholesale token-mirror copy
            # above cannot overwrite a landed request's first token
            self._chunk_land(reset_mask)

        # 4) reset retired rows so idle cursors restart from 0 and the next
        #    admission starts from a clean row; deferred page frees apply
        #    only after it (stream order puts every read of the stale block
        #    table ahead of any later tenant's writes)
        if reset_mask.any():
            self._reset(reset_mask)
        self._flush_freed_pages()
        if produced > 0 or admitted or chunked or self.occupied == 0:
            self._last_progress_t = self.clock()
            self._last_progress_ever = self._last_progress_t
        if self._pool is not None:
            self.stats.pool_sample(self._pool.allocated, self._pool.capacity,
                                   self._page_size, self._page_bytes)
        self.stats.tick(self.occupied, max(self.clock() - t0, 0.0),
                        decoded=decoded)
        # counters only where they change (admission, retirement)
        if self._tracer is not None and (admitted or reset_mask.any()):
            self._tracer.counter("queue_depth", len(self.scheduler),
                                 tid=self._trace_tid)
            self._tracer.counter("occupied_slots", self.occupied,
                                 tid=self._trace_tid)
        if self._telemetry is not None:
            if produced:
                self._telemetry.inc("tokens_generated", int(produced))
            self._telemetry.maybe_sample()  # a clock read between samples
        return produced

    @staticmethod
    def _readback(parts) -> np.ndarray:
        """The window's outputs as one (slots, n) float64 host array."""
        return torch.cat([x.double() for x in parts], dim=1).cpu().numpy()

    def _window_fault(self, exc: Exception, t0: float, idx0) -> None:
        """A window dispatch raised.  Without the watchdog, or once no
        progress came for ``stall_timeout_s``, the in-flight requests fail
        and the error re-raises; before that every cursor goes back to
        ``idx0`` so the next iteration retries the same window."""
        now = self.clock()
        if self._last_progress_t is None:
            self._last_progress_t = t0
        if self.stall_timeout_s is None:
            self._fail_in_flight(exc, now)
            raise exc
        try:
            _set_cursor(self.cache, idx0)
        except Exception:
            self._fail_in_flight(exc, now)
            raise exc
        if now - self._last_progress_t > self.stall_timeout_s:
            self._fail_in_flight(exc, now)
            raise EngineStalled(
                f"no token progress across {self.slots} slots within "
                f"{self.stall_timeout_s}s (last decode error: "
                f"{type(exc).__name__}: {exc})") from exc

    def _fail_in_flight(self, exc: BaseException, now: float) -> None:
        """Fail every running request and reset their rows (the engine
        stays consistent for a caller that catches the error)."""
        mask = np.zeros((self.slots,), bool)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_req[slot] = None
            self._slot_prefill[slot] = None
            self._release_slot_alloc(slot)
            req.engine_fault = True  # collateral, not the request's own fault
            self._fail(req, exc, now)
            mask[slot] = True
        if mask.any():
            self._reset(mask)
        self._flush_freed_pages()
        self._active_dev = self._planes_dev = self._pos_dev = self._tok_dev = None
        self._last_progress_t = None

    def _book_scheduler_cancels(self) -> None:
        """Queued requests the scheduler cancelled as overdue join the book."""
        for req in self.scheduler.cancelled:
            self.completed.append(req)
            self.stats.add(req)
        self.scheduler.cancelled.clear()

    def _emit(self) -> None:
        if self._prefix is not None:
            self.stats.prefix_oversized(self._prefix.oversized)
        self.stats.set_compile(CompileTracker.delta(self._compile.snapshot(),
                                                    self._compile0))
        self._stamp_memory()
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
                self._cancel_unlanded(req, now)
        self._pending.clear()
        self._stalled_ids.clear()
        while self._outbox:
            # packaged-but-undelivered handoffs: accepted work the engine
            # quit on — cancelled with engine_fault, so the router's
            # failover harvest re-dispatches exactly these
            packet = self._outbox.popleft()
            packet.release()
            req = packet.req
            req.engine_fault = True
            req.status = "cancelled"
            req.finish_t = now
            self._tr_close(req, status="cancelled")
            self.completed.append(req)
            self.stats.add(req)
        while (req := self.scheduler.pop(now)) is not None:
            req.engine_fault = True
            self._cancel_unlanded(req, now)
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

    # ------------------------------------------------------------------
    # live weight replacement

    def swap_params(self, params: dict) -> None:
        """Load a new ``state_dict`` into the served model of an IDLE
        engine (no occupied slot, parked request or queued request).  An
        int8 engine quantizes it first (a quantized one passes as it is).
        Every cached K/V was computed under the old weights, so the prefix
        cache is cleared and the radix trie evicted whole, its pages back
        to the pool."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.has_work or self._outbox:
            # a parked handoff packet HOLDS pool pages and radix nodes: the
            # wholesale trie eviction below assumes no outstanding
            # references, so an undelivered outbox counts as busy too
            raise RuntimeError(
                f"swap_params on a busy engine (occupied={self.occupied}, "
                f"pending={len(self._pending)}, queued={len(self.scheduler)}, "
                f"outbox={len(self._outbox)})"
                " — drain it first (stop submitting, pump step() until "
                "has_work is False)")
        if self.quant == "int8":
            params = quantize_state_dict_int8(params)
        self.model.load_state_dict(params, strict=True)
        if self._prefix is not None:
            self._prefix.clear()
        if self._radix is not None:
            # every node is unreferenced on an idle engine
            self._radix.evict(self._radix.n_blocks, lambda p: self._pool.free([p]))

    # ------------------------------------------------------------------
    # launch-path prewarm

    def prewarm(self) -> dict:
        """Run every path this engine dispatches once, on the IDLE engine,
        before the first request: each bucket's prefill (the flash kernel's
        build and library load happen here, under ``prefill[b<bucket>]``),
        or the chunk extend; the shared first-token pick; the slot insert
        and, paged, each bucket's suffix extend; the decode or verify window
        over all-inactive rows; and the slot reset.  A role-typed engine
        runs its own half: a prefill engine the prefill side and the
        handoff's page read (no pick, no window), a decode engine the pick,
        the handoff's page write and the window (no prefill, so no flash
        launch).  Dummy work lands in idle rows and the trash page, and
        every slot is reset at the end, so prewarmed output is
        token-identical to cold output.

        Returns ``{"programs", "loads", "compile_s", "wall_s", "by_site"}``:
        the builds and loads this call caused (a second engine in the same
        process, or a respawn, reads 0 and 0)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.has_work:
            raise RuntimeError(
                f"prewarm on a busy engine (occupied={self.occupied}, "
                f"pending={len(self._pending)}, queued={len(self.scheduler)}) "
                "— prewarm belongs in the launch path, before the first submit")
        t0 = self.clock()
        before = self._compile.snapshot()
        dev = self.device
        slots = self.slots
        with torch.no_grad():
            bt_dev = (torch.zeros((self.max_len // self._page_size,), dtype=torch.int32,
                                  device=dev) if self._pool is not None else None)
            one = torch.tensor([1], dtype=torch.int32, device=dev)
            if self.role == "decode":
                # pages arrive through admit_prefilled: the handoff's
                # one-page write and block-table install, into the trash page
                last_logits = torch.zeros((1, self.model.num_classes),
                                          dtype=torch.float32, device=dev)
                with self._compile.site("handoff_install"):
                    for entry in pool_page_leaves(self.cache).values():
                        for pool in entry.values():
                            pool.index_copy_(0, torch.zeros((1,), dtype=torch.int64, device=dev),
                                             torch.zeros_like(pool[:1]))
                    for entry in self.cache.values():
                        entry["block_table"][0] = bt_dev
                        entry["index"][0] = 0
            elif self._prefill_chunk:
                c = self._prefill_chunk
                with self._compile.site(f"extend[b{c}]"):
                    self.cache, last_logits = self._extend(
                        self.cache, 0, bt_dev,
                        torch.zeros((1, c), dtype=torch.int64, device=dev), 0, 1)
            else:
                for b in self.buckets:
                    with self._compile.site(f"prefill[b{b}]"):
                        row_cache, last_logits = self._prefill(
                            torch.zeros((1, b), dtype=torch.int64, device=dev), one)
            if self.role == "prefill":
                # the source half of the handoff: the page read every packet
                # takes (read-only on the cache)
                with self._compile.site("handoff_gather"):
                    for entry in pool_page_leaves(self.cache).values():
                        for pool in entry.values():
                            pool.index_select(0, torch.zeros((1,), dtype=torch.int64,
                                                             device=dev)).cpu()
            else:
                zeros_f = torch.zeros((1,), dtype=torch.float32, device=dev)
                zeros_i = torch.zeros((1,), dtype=torch.int64, device=dev)
                with self._compile.site("first_pick"):
                    tok, logp = first_pick(
                        last_logits, zeros_f, zeros_f, zeros_i, zeros_f,
                        torch.zeros((1, 2), dtype=torch.int64, device=dev), zeros_i)
                    torch.stack((tok.double(), logp.double())).cpu()
            if not self._prefill_chunk and self.role != "decode":
                with self._compile.site("slot_insert"):
                    if self._pool is not None:
                        self._insert(self.cache, row_cache, bt_dev, 0)
                    else:
                        self._insert_impl(self.cache, row_cache, 0)
                if self._pool is not None:
                    for b in self.buckets:
                        with self._compile.site(f"extend[b{b}]"):
                            self.cache, _ = self._extend(
                                self.cache, 0, bt_dev,
                                torch.zeros((1, b), dtype=torch.int64, device=dev), 0, 1)
            if self.role != "prefill":
                # a prefill-role engine never dispatches a window
                inactive = torch.zeros((slots,), dtype=torch.bool, device=dev)
                planes = tuple(torch.zeros(shape, dtype=dtype, device=dev)
                               for shape, dtype in (
                                   ((slots,), torch.float32), ((slots,), torch.float32),
                                   ((slots,), torch.int64), ((slots,), torch.float32),
                                   ((slots, 2), torch.int64)))
                pos0 = torch.zeros((slots,), dtype=torch.int64, device=dev)
                if self._drafter is not None:
                    k = self.draft_len + 1
                    with self._compile.site(f"verify_window[k{k}]"):
                        self.cache = self._verify(
                            torch.full((slots, k), self.pad_id, dtype=torch.int64,
                                       device=dev),
                            torch.zeros((slots,), dtype=torch.int64, device=dev),
                            inactive, planes, pos0)[0]
                else:
                    with self._compile.site(f"decode_window[k{self.decode_ahead}]"):
                        self.cache = self._window(
                            torch.zeros((slots,), dtype=torch.int64, device=dev),
                            inactive, planes, pos0)[0]
        with self._compile.site("slot_reset"):
            self._reset(np.ones((slots,), bool))
        delta = CompileTracker.delta(self._compile.snapshot(), before)
        return {"programs": delta["n_compiled_programs"], "loads": delta["n_loads"],
                "compile_s": delta["compile_time_s"],
                "wall_s": round(self.clock() - t0, 6), "by_site": delta["by_site"]}
