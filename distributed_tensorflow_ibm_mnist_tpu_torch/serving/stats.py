"""Serving metrics of the port: TTFT/latency, tokens/sec, occupancy, and
what decode-ahead, sampling, SLOs, the prefix cache and paging produce
(the port's copy of the JAX package's ``serving/stats.py``, same keys).

* **TTFT** — submit to the first token ON THE HOST (queue wait included);
* **latency** — submit to retirement of ``done`` requests;
* **tokens/sec** — generated tokens over the engine's busy window (first
  admission to last retirement);
* **occupancy** — time-weighted mean fraction of slots holding a request;
* the done / cancelled / failed counts, and ``n_engine_fault`` (terminal
  states that are collateral of an engine-wide fault);
* **windows** — per decode-ahead window: dispatch vs readback seconds,
  occupied-slot steps dispatched vs WASTE steps (decoded past a row's
  EOS/budget inside a window, discarded on the host);
* **speculative acceptance** — drafted, accepted and corrected tokens,
  ``accept_rate`` and ``useful_tokens_per_window``;
* **sampling** — ``n_sampled_requests``, ``mean_temperature`` over them,
  and per-token NLL percentiles from a utils/telemetry.HistogramSketch;
* **SLO / goodput** — a request may declare ``(ttft_slo_s, tpot_slo_s)``;
  the engine judges TTFT at the first token and TPOT at retirement.  A
  tracked request is **met** iff it retired ``done`` with no judged
  constraint failed (:func:`slo_verdict`); ``goodput_rps`` is SLO-met
  requests per busy-window second;
* **prefix cache**, **paged KV**, **radix sharing** and **chunked
  prefill** counters; the memory stamp (``tp``/``cp`` are 1: one card);
* **builds** — ``n_compiled_programs`` / ``compile_time_s`` /
  ``compile_by_site``: the engine's ``utils.tracing.CompileTracker``
  delta (kernel and native library builds, and ``n_loads``, not XLA
  programs);
* the port's own split of host time: ``prefill_s`` (inside admissions)
  and ``decode_s`` (inside decode windows, dispatch through readback).

Counters are exact; the percentile SAMPLE list (``self.requests``) is a
seeded reservoir (Algorithm R, ``sample_cap`` records).  Ratios are None,
never NaN, when their denominators are zero, so ``summary()`` is strict
JSON.  Every mutator and snapshot holds the record's lock (an RLock): the
daemonized tier reads a record (``merge``/``summary``/``vitals``) while its
engine's pump thread writes it.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import threading

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import Request
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import HistogramSketch


def slo_verdict(req: "Request") -> str | None:
    """None = untracked (no SLO declared); else ``"met"`` / ``"miss"``.

    Met requires terminal status ``done`` AND no judged constraint
    failed.  A tracked request that failed or was cancelled is a miss
    even when no constraint was ever judged — an answer that never
    arrived did not meet its latency target.
    """
    if req.ttft_slo_s is None and req.tpot_slo_s is None:
        return None
    if req.status != "done":
        return "miss"
    if req.slo_ttft_ok is False or req.slo_tpot_ok is False:
        return "miss"
    return "met"


def percentiles(xs, qs=(50, 95, 99)) -> dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} over xs (empty -> None values)."""
    if not len(xs):
        return {f"p{q}": None for q in qs}
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": round(float(np.percentile(arr, q)), 6) for q in qs}


def transcript_digest(tokens) -> str:
    """Content address of one token transcript: blake2b over the int32
    stream.  The token-parity primitive of the crash bench and the
    recovery tests (serving/journal.py): a client transcript stitched
    across a SIGKILL — pre-crash SSE prefix + post-recovery resume —
    must digest identically to the uncrashed reference's, which is a
    stronger statement than equal lengths and cheaper to ship in a
    one-line bench record than the streams themselves."""
    return hashlib.blake2b(np.asarray(tokens, np.int32).tobytes(),
                           digest_size=16).hexdigest()


class ServingStats:
    """Accumulates request records and engine-loop samples.

    The engine calls :meth:`tick` once per host-loop iteration (occupancy
    integration, weighted by the iteration's wall time) and :meth:`add`
    once per retired request; :meth:`summary` folds everything into one
    flat dict and :meth:`emit` writes it through a :class:`MetricWriter`
    (non-finite values are sanitized to null by the writer itself).

    Thread model (the daemonized tier — serving/daemon.py): each stats
    object has ONE writer — the engine that owns it, driven by exactly one
    pump thread — but is READ from other threads (``merge``/``summary``/
    ``vitals`` on the daemon's control and telemetry paths).  Every
    mutator and every snapshot therefore holds ``self._lock`` (an RLock,
    uncontended in the single-threaded case), so a reader can never see a
    half-applied :meth:`add` (request counted, reservoir/SLO counters not
    yet) and :meth:`merge` folds N live records without torn counters.
    """

    def __init__(self, slots: int, decode_ahead: int = 1,
                 sample_cap: int = 2048, role: str = "both"):
        if sample_cap < 1:
            raise ValueError(f"sample_cap must be >= 1, got {sample_cap}")
        self.slots = slots
        self.decode_ahead = decode_ahead
        # which serving role produced this record ("both" = monolithic;
        # "prefill"/"decode" = a disaggregated tier).  The
        # router rollup groups per-role so prefill-side figures (chunk
        # stalls, radix skips) never blend into decode-side TPOT.
        self.role = str(role)
        self._lock = threading.RLock()
        # bounded percentile-sample reservoir (Algorithm R; see module
        # docstring).  Counters below are EXACT regardless of the cap;
        # only the percentile samples are subject to reservoir sampling.
        # Seeded so soak reruns keep identical sample populations.
        self.sample_cap = int(sample_cap)
        self.requests: list[Request] = []
        self._rng = random.Random(0)
        self._n_requests = 0
        self._n_done = 0
        self._n_cancelled = 0
        self._n_failed = 0
        self._n_engine_fault = 0
        self._tokens = 0
        # --- SLO / goodput accounting --- all zero when no
        # request declares an SLO, so the schema stays stable
        self._slo_tracked = 0
        self._slo_met = 0
        self._slo_miss = 0
        self._slo_ttft_miss = 0
        self._slo_tpot_miss = 0
        self._occ_time = 0.0   # integral of occupied_slots * dt
        self._busy_time = 0.0  # integral of dt while the engine had work
        self._decode_steps = 0
        self._start_t: float | None = None
        self._end_t: float | None = None
        # --- decode-ahead window accounting ---
        self._windows = 0
        self._dispatch_time = 0.0  # window launch time (async dispatch)
        self._readback_time = 0.0  # the blocking (slots, k) host sync
        self._window_steps = 0     # occupied-slot decode steps dispatched
        self._waste_steps = 0      # of those, discarded post-retirement
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_oversized = 0
        # --- speculative acceptance accounting --- all zero on
        # non-speculative engines, so the schema stays stable across modes
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_corrected = 0
        # --- per-request sampling accounting --- all zero on
        # greedy-only traffic, so the schema stays stable.  The NLL sketch
        # holds -logprob per generated token (every request — greedy rows
        # included, their logprobs are the same raw-logits convention), a
        # streaming model-confidence figure; [1e-4, 1e2] nats spans
        # near-certain (1e-4) to vocab-uniform-at-any-real-vocab (1e2)
        self._n_sampled = 0          # requests that decoded with temp > 0
        self._temp_sum = 0.0         # over sampled requests only
        self._n_logprob_tokens = 0
        self._nll = HistogramSketch(lo=1e-4, hi=1e2)
        # --- paged KV pool + radix prefix accounting --- the
        # engine samples pool occupancy each step (pool_sample) and records
        # each admission's radix-match outcome (radix); all zero/None for
        # dense engines, so the schema stays stable across layouts
        self._kv_page_size = 0
        self._kv_pages_total = 0
        self._kv_pages_live = 0
        self._kv_pages_peak = 0
        self._kv_page_bytes = 0
        self._radix_hits = 0
        self._radix_misses = 0
        self._radix_hit_tokens = 0
        # --- chunked-prefill accounting --- all zero/None on
        # whole-prompt engines, so the schema stays stable across regimes
        self._prefill_chunks = 0     # extend[b{C}] dispatches
        self._chunk_stall_s = 0.0    # total wall seconds inside chunk
        #   dispatches (the decode-latency budget chunking bounds)
        self._longest_prompt = 0     # max admitted prompt tokens; 0 = no
        #   admission recorded (summary reports None)
        # --- build accounting --- the engine's own kernel and native
        # library builds and loads: a CompileTracker snapshot DELTA from
        # engine construction to stats emission (utils/tracing.py)
        self._compile: dict | None = None
        # the port's host-time split: admissions vs decode windows
        self._prefill_s = 0.0
        self._decode_s = 0.0
        # --- tensor-parallel per-chip footprint --- stamped by
        # the engine (memory()); tp=1 with whole-tree bytes on single-chip
        # engines, so the schema never branches on the mesh
        self._tp = 1
        self._cp = 1  # context-parallel degree; 1 off-mesh
        self._kv_bytes_per_chip: int | None = None
        self._weight_bytes_per_chip: int | None = None
        self._quant = "none"  # weight storage scheme ("int8" when the
        #   engine quantizes at upload); stamped with memory()

    def tick(self, occupied: int, dt: float, decoded: bool = False) -> None:
        with self._lock:
            self._occ_time += occupied * dt
            self._busy_time += dt
            if decoded:
                self._decode_steps += 1

    def prefill(self, seconds: float) -> None:
        """One admission's prefill + first pick, in host seconds."""
        with self._lock:
            self._prefill_s += seconds

    def decode(self, seconds: float) -> None:
        """One decode window, dispatch through readback, in host seconds."""
        with self._lock:
            self._decode_s += seconds

    def window(self, dispatch_s: float, readback_s: float, steps: int,
               waste: int) -> None:
        """One decode-ahead window: ``steps`` = occupied slots × window
        length dispatched, ``waste`` = the subset discarded on the host
        (tokens decoded past a row's EOS/budget inside the window)."""
        with self._lock:
            self._windows += 1
            self._dispatch_time += dispatch_s
            self._readback_time += readback_s
            self._window_steps += steps
            self._waste_steps += waste

    def prefix(self, hit: bool) -> None:
        """One prefix-cache lookup (hit = prefill skipped entirely)."""
        with self._lock:
            if hit:
                self._prefix_hits += 1
            else:
                self._prefix_misses += 1

    def spec(self, drafted: int, accepted: int, corrected: int = 1) -> None:
        """One slot's outcome in one speculative verify window: ``drafted``
        tokens proposed, ``accepted`` of them reproduced by the target
        model's argmax, plus ``corrected`` free correction/continuation
        tokens (1 per verified slot — the model's own next token after the
        accepted prefix, emitted whether or not anything was accepted)."""
        with self._lock:
            self._spec_drafted += int(drafted)
            self._spec_accepted += int(accepted)
            self._spec_corrected += int(corrected)

    def prefix_oversized(self, count: int) -> None:
        """Absolute count of PrefixCache.put refusals (entry > max_bytes);
        the engine copies the cache's own counter at emission time."""
        self._prefix_oversized = int(count)

    def pool_sample(self, pages_live: int, pages_total: int,
                    page_size: int, page_bytes: int) -> None:
        """One page-pool occupancy sample (the paged engine calls this per
        step): live/total allocatable pages, the page size in tokens, and
        the cross-layer bytes one page occupies (kv_pool.pool_page_bytes)."""
        with self._lock:
            self._kv_pages_live = int(pages_live)
            self._kv_pages_peak = max(self._kv_pages_peak, int(pages_live))
            self._kv_pages_total = int(pages_total)
            self._kv_page_size = int(page_size)
            self._kv_page_bytes = int(page_bytes)

    def radix(self, hit: bool, tokens: int = 0) -> None:
        """One admission's radix-trie match outcome: ``tokens`` = shared
        prefix length whose prefill was skipped (whole pages only)."""
        with self._lock:
            if hit:
                self._radix_hits += 1
                self._radix_hit_tokens += int(tokens)
            else:
                self._radix_misses += 1

    def chunk(self, stall_s: float) -> None:
        """One chunked-prefill dispatch: ``stall_s`` = wall
        seconds the dispatch occupied the host loop — the bounded
        per-iteration decode-latency cost the chunked_prefill bench leg
        gates on."""
        with self._lock:
            self._prefill_chunks += 1
            self._chunk_stall_s += float(stall_s)

    def prompt_admitted(self, n_tokens: int) -> None:
        """One admission's prompt length (chunked engines call this at
        allocation) — ``longest_prompt_admitted`` documents the regime's
        headline capability: prompts past every bucket."""
        self._longest_prompt = max(self._longest_prompt, int(n_tokens))

    def memory(self, kv_bytes_per_chip: int, weight_bytes_per_chip: int,
               quant: str = "none", tp: int = 1, cp: int = 1) -> None:
        """Stamp the engine's footprint on its card, its weight storage
        scheme (``quant``) and its parallel degrees (1: the port serves a
        replica on one card).  Re-stamped at every emit point, so a stats
        object swapped in mid-run still reports them."""
        self._tp = int(tp)
        self._cp = int(cp)
        self._kv_bytes_per_chip = int(kv_bytes_per_chip)
        self._weight_bytes_per_chip = int(weight_bytes_per_chip)
        self._quant = str(quant)

    def set_compile(self, delta: dict) -> None:
        """Record the engine's build accounting — a ``CompileTracker.delta``
        dict (``n_compiled_programs``, ``n_loads``, ``compile_time_s``,
        ``by_site``) from its construction to this emission."""
        self._compile = delta

    def add(self, req: Request) -> None:
        with self._lock:
            self._add_locked(req)

    def _add_locked(self, req: Request) -> None:
        self._n_requests += 1
        if req.status == "done":
            self._n_done += 1
        elif req.status == "cancelled":
            self._n_cancelled += 1
        elif req.status == "failed":
            self._n_failed += 1
        if req.engine_fault:
            self._n_engine_fault += 1
        self._tokens += len(req.generated)
        # sampling accounting: a request is "sampled" when its
        # own SamplingParams asked for temperature > 0 (engine-default
        # sampling is a construction knob, not per-request traffic mix);
        # NLL is recorded for EVERY generated token — greedy rows share
        # the raw-logits logprob convention, so the sketch is one
        # model-confidence distribution across the whole traffic
        if req.sampling is not None and req.sampling.sampled:
            self._n_sampled += 1
            self._temp_sum += float(req.sampling.temperature)
        for lp in req.logprobs:
            self._nll.record(-lp)
        self._n_logprob_tokens += len(req.logprobs)
        verdict = slo_verdict(req)
        if verdict is not None:
            self._slo_tracked += 1
            if verdict == "met":
                self._slo_met += 1
            else:
                self._slo_miss += 1
                # per-constraint attribution; a miss judged on neither
                # constraint (failed/cancelled before any verdict) counts
                # in slo_miss only
                if req.slo_ttft_ok is False:
                    self._slo_ttft_miss += 1
                if req.slo_tpot_ok is False:
                    self._slo_tpot_miss += 1
        if len(self.requests) < self.sample_cap:
            self.requests.append(req)
        else:
            j = self._rng.randrange(self._n_requests)
            if j < self.sample_cap:
                self.requests[j] = req
        if req.admit_t is not None:
            self._start_t = req.admit_t if self._start_t is None else min(
                self._start_t, req.admit_t)
        if req.finish_t is not None:
            self._end_t = req.finish_t if self._end_t is None else max(
                self._end_t, req.finish_t)

    def summary(self) -> dict:
        # counters are exact; ttft/latency percentiles are computed over
        # the bounded reservoir (exact below sample_cap)
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> dict:
        done = [r for r in self.requests if r.status == "done"]
        ttft = [r.first_token_t - r.submit_t for r in self.requests
                if r.first_token_t is not None]
        latency = [r.finish_t - r.submit_t for r in done
                   if r.finish_t is not None]
        window = (
            (self._end_t - self._start_t)
            if self._start_t is not None and self._end_t is not None
            and self._end_t > self._start_t else None
        )
        out = {
            "slots": self.slots,
            "role": self.role,
            "n_requests": self._n_requests,
            "n_done": self._n_done,
            "n_cancelled": self._n_cancelled,
            "n_failed": self._n_failed,
            "tokens_generated": int(self._tokens),
            "tokens_per_sec": (
                round(self._tokens / window, 3) if window else None
            ),
            "sample_cap": self.sample_cap,
            "percentile_samples": len(self.requests),
            # SLO / goodput: tracked = requests that declared
            # ≥1 SLO; goodput = SLO-met requests per busy-window second
            "slo_tracked": self._slo_tracked,
            "slo_met": self._slo_met,
            "slo_miss": self._slo_miss,
            "slo_ttft_miss": self._slo_ttft_miss,
            "slo_tpot_miss": self._slo_tpot_miss,
            "slo_met_rate": (
                round(self._slo_met / self._slo_tracked, 4)
                if self._slo_tracked > 0 else None
            ),
            "goodput_rps": (
                round(self._slo_met / window, 3)
                if window and self._slo_tracked > 0 else None
            ),
            "busy_s": round(self._busy_time, 6),
            "decode_steps": self._decode_steps,
            "slot_occupancy": (
                round(self._occ_time / (self._busy_time * self.slots), 4)
                if self._busy_time > 0 else None
            ),
            "decode_ahead": self.decode_ahead,
            "n_windows": self._windows,
            "window_dispatch_s": round(self._dispatch_time, 6),
            "window_readback_s": round(self._readback_time, 6),
            "window_steps": self._window_steps,
            "window_waste_steps": self._waste_steps,
            "window_waste_frac": (
                round(self._waste_steps / self._window_steps, 4)
                if self._window_steps > 0 else None
            ),
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_hit_rate": (
                round(self._prefix_hits
                      / (self._prefix_hits + self._prefix_misses), 4)
                if (self._prefix_hits + self._prefix_misses) > 0 else None
            ),
            "prefix_oversized": self._prefix_oversized,
            # speculative acceptance (all-zero/None on non-spec engines)
            "drafted_tokens": self._spec_drafted,
            "accepted_tokens": self._spec_accepted,
            "corrected_tokens": self._spec_corrected,
            "accept_rate": (
                round(self._spec_accepted / self._spec_drafted, 4)
                if self._spec_drafted > 0 else None
            ),
            "useful_tokens_per_window": (
                round((self._window_steps - self._waste_steps)
                      / self._windows, 4)
                if self._windows > 0 else None
            ),
            # per-request sampling (all-zero/None on greedy-only
            # traffic).  mean_temperature averages SAMPLED requests only —
            # folding greedy zeros in would report a fictitious lukewarm
            # cluster.  NLL percentiles stream from the sketch (no stored
            # per-token samples), None when no token recorded a logprob.
            "n_sampled_requests": self._n_sampled,
            "mean_temperature": (
                round(self._temp_sum / self._n_sampled, 4)
                if self._n_sampled > 0 else None
            ),
            "logprob_tokens": self._n_logprob_tokens,
            "nll_p50": self._nll.percentile(50),
            "nll_p95": self._nll.percentile(95),
            "nll_p99": self._nll.percentile(99),
            # paged KV pool (all-zero/None on dense engines)
            "kv_page_size": self._kv_page_size or None,
            "kv_pages_total": self._kv_pages_total,
            "kv_pages_live": self._kv_pages_live,
            "kv_pages_peak": self._kv_pages_peak,
            "kv_bytes_live": self._kv_pages_live * self._kv_page_bytes,
            "kv_bytes_peak": self._kv_pages_peak * self._kv_page_bytes,
            # tensor/context-parallel per-chip footprint (tp=cp=1 / None
            # until the engine stamps it — null, never NaN)
            "tp": self._tp,
            "cp": self._cp,
            "kv_bytes_per_chip": self._kv_bytes_per_chip,
            "weight_bytes_per_chip": self._weight_bytes_per_chip,
            "quant": self._quant,
            # radix prefix sharing (partial-prefix prefill skips)
            "radix_hits": self._radix_hits,
            "radix_misses": self._radix_misses,
            "radix_hit_tokens": self._radix_hit_tokens,
            "radix_hit_rate": (
                round(self._radix_hits
                      / (self._radix_hits + self._radix_misses), 4)
                if (self._radix_hits + self._radix_misses) > 0 else None
            ),
            # chunked prefill (all-zero/None on whole-prompt
            # engines).  chunk_stall_frac = share of busy time spent
            # inside chunk dispatches — the interleaving tax the bench
            # leg bounds.
            "n_prefill_chunks": self._prefill_chunks,
            "chunk_stall_s": round(self._chunk_stall_s, 6),
            "chunk_stall_frac": (
                round(self._chunk_stall_s / self._busy_time, 4)
                if self._busy_time > 0 and self._prefill_chunks > 0
                else None
            ),
            "longest_prompt_admitted": (
                self._longest_prompt if self._longest_prompt > 0 else None
            ),
            # compile accounting (None until set_compile — an engine that
            # never emitted stats has no delta to report)
            "n_compiled_programs": (
                self._compile["n_compiled_programs"]
                if self._compile is not None else None),
            "compile_time_s": (
                self._compile["compile_time_s"]
                if self._compile is not None else None),
            "compile_by_site": (
                self._compile["by_site"]
                if self._compile is not None else None),
            "prefill_s": round(self._prefill_s, 6),
            "decode_s": round(self._decode_s, 6),
        }
        for name, xs in (("ttft_s", ttft), ("latency_s", latency)):
            for k, v in percentiles(xs).items():
                out[f"{name}_{k}"] = v
        return out

    def vitals(self) -> dict:
        """Cheap live subset for the telemetry health sampler
        (utils/telemetry.Telemetry): counters and rates only, no
        percentile work, safe to call every sampling interval."""
        with self._lock:
            return self._vitals_locked()

    def _vitals_locked(self) -> dict:
        p_total = self._prefix_hits + self._prefix_misses
        r_total = self._radix_hits + self._radix_misses
        return {
            "n_requests": self._n_requests,
            "n_done": self._n_done,
            "n_cancelled": self._n_cancelled,
            "n_failed": self._n_failed,
            "tokens_generated": self._tokens,
            "prefix_hit_rate": (round(self._prefix_hits / p_total, 4)
                                if p_total > 0 else None),
            "radix_hit_rate": (round(self._radix_hits / r_total, 4)
                               if r_total > 0 else None),
            "accept_rate": (round(self._spec_accepted / self._spec_drafted, 4)
                            if self._spec_drafted > 0 else None),
            "n_sampled_requests": self._n_sampled,
            "n_prefill_chunks": self._prefill_chunks,
            "kv_pages_live": self._kv_pages_live,
            "kv_pages_total": self._kv_pages_total,
            "slo_tracked": self._slo_tracked,
            "slo_met": self._slo_met,
            "slo_miss": self._slo_miss,
        }

    def emit(self, writer: MetricWriter, kind: str = "serving") -> dict:
        return writer.write(kind, **self.summary())

    @classmethod
    def merge(cls, records: list["ServingStats"]) -> dict:
        """Cluster-level rollup over N engine records (the router's one
        ``router`` metric record — serving/router.py).

        Counters SUM; percentiles are recomputed over the MERGED request
        samples (a percentile of percentiles is not a percentile); every
        ratio is re-derived from merged numerator/denominator and is None
        — never NaN — when the denominator is zero, so the record stays
        strict-JSON.  ``kv_pages_peak`` sums per-engine peaks: an upper
        bound on the cluster's concurrent peak (per-engine peaks need not
        align in time).  ``per_engine`` carries each engine's own summary
        as a sub-record, so the rollup never hides a sick replica.

        Counters come from each record's EXACT counters; percentiles are
        recomputed over the union of the per-engine sample reservoirs
        (exact while every engine stayed below its ``sample_cap``).
        SLO counters sum and ``slo_met_rate``/``goodput_rps`` re-derive
        over the merged totals, so the cluster goodput is met-requests
        per second of the CLUSTER's busy window, not a mean of rates.

        Safe against LIVE records: every record's lock is held for the
        whole fold (the daemonized tier merges while pump threads are
        still retiring requests), so the rollup is a consistent snapshot
        — no counter is read mid-:meth:`add`.
        """
        with contextlib.ExitStack() as stack:
            # canonical acquisition order: two concurrent merges over
            # overlapping record sets can never deadlock (RLock, so a
            # duplicate record in the list re-enters harmlessly)
            for rec in sorted(records, key=id):
                stack.enter_context(rec._lock)
            return cls._merge_locked(records)

    @classmethod
    def _merge_locked(cls, records: list["ServingStats"]) -> dict:
        reqs = [r for rec in records for r in rec.requests]
        done = [r for r in reqs if r.status == "done"]
        ttft = [r.first_token_t - r.submit_t for r in reqs
                if r.first_token_t is not None]
        latency = [r.finish_t - r.submit_t for r in done
                   if r.finish_t is not None]
        n_tokens = sum(rec._tokens for rec in records)
        slo_tracked = sum(rec._slo_tracked for rec in records)
        slo_met = sum(rec._slo_met for rec in records)
        starts = [rec._start_t for rec in records if rec._start_t is not None]
        ends = [rec._end_t for rec in records if rec._end_t is not None]
        window = (max(ends) - min(starts)
                  if starts and ends and max(ends) > min(starts) else None)
        slots = sum(rec.slots for rec in records)
        busy_weighted = sum(rec._busy_time * rec.slots for rec in records)
        occ_time = sum(rec._occ_time for rec in records)
        w_steps = sum(rec._window_steps for rec in records)
        waste = sum(rec._waste_steps for rec in records)
        p_hits = sum(rec._prefix_hits for rec in records)
        p_miss = sum(rec._prefix_misses for rec in records)
        drafted = sum(rec._spec_drafted for rec in records)
        accepted = sum(rec._spec_accepted for rec in records)
        n_windows = sum(rec._windows for rec in records)
        r_hits = sum(rec._radix_hits for rec in records)
        r_miss = sum(rec._radix_misses for rec in records)
        compiled = [rec._compile for rec in records if rec._compile is not None]
        n_chunks = sum(rec._prefill_chunks for rec in records)
        chunk_stall = sum(rec._chunk_stall_s for rec in records)
        busy_total = sum(rec._busy_time for rec in records)
        longest = [rec._longest_prompt for rec in records
                   if rec._longest_prompt > 0]
        n_sampled = sum(rec._n_sampled for rec in records)
        temp_sum = sum(rec._temp_sum for rec in records)
        nll = HistogramSketch.merge([rec._nll for rec in records])
        # replicas hold disjoint cards, so the cluster's per-chip figure
        # is the worst card anywhere (max), the cluster total sums
        # per_chip * tp * cp per engine, and `tp`/`cp` report the common
        # degree or None when mixed
        tps = {rec._tp for rec in records}
        cps = {rec._cp for rec in records}
        quants = {rec._quant for rec in records}
        stamped = [rec for rec in records
                   if rec._kv_bytes_per_chip is not None]
        out = {
            "n_engines": len(records),
            "slots": slots,
            "n_requests": sum(rec._n_requests for rec in records),
            "n_done": sum(rec._n_done for rec in records),
            "n_cancelled": sum(rec._n_cancelled for rec in records),
            "n_failed": sum(rec._n_failed for rec in records),
            "n_engine_fault": sum(rec._n_engine_fault for rec in records),
            "tokens_generated": int(n_tokens),
            "tokens_per_sec": (round(n_tokens / window, 3) if window else None),
            "percentile_samples": len(reqs),
            "slo_tracked": slo_tracked,
            "slo_met": slo_met,
            "slo_miss": sum(rec._slo_miss for rec in records),
            "slo_ttft_miss": sum(rec._slo_ttft_miss for rec in records),
            "slo_tpot_miss": sum(rec._slo_tpot_miss for rec in records),
            "slo_met_rate": (round(slo_met / slo_tracked, 4)
                             if slo_tracked > 0 else None),
            "goodput_rps": (round(slo_met / window, 3)
                            if window and slo_tracked > 0 else None),
            "busy_s": round(sum(rec._busy_time for rec in records), 6),
            "decode_steps": sum(rec._decode_steps for rec in records),
            "slot_occupancy": (round(occ_time / busy_weighted, 4)
                               if busy_weighted > 0 else None),
            "n_windows": n_windows,
            "window_dispatch_s": round(
                sum(rec._dispatch_time for rec in records), 6),
            "window_readback_s": round(
                sum(rec._readback_time for rec in records), 6),
            "window_steps": w_steps,
            "window_waste_steps": waste,
            "window_waste_frac": (round(waste / w_steps, 4)
                                  if w_steps > 0 else None),
            "prefix_hits": p_hits,
            "prefix_misses": p_miss,
            "prefix_hit_rate": (round(p_hits / (p_hits + p_miss), 4)
                                if (p_hits + p_miss) > 0 else None),
            "prefix_oversized": sum(rec._prefix_oversized for rec in records),
            # acceptance counters SUM; accept_rate re-derives over the
            # merged totals (a rate of rates overweights idle engines) and
            # stays None when nothing was drafted cluster-wide
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "corrected_tokens": sum(rec._spec_corrected for rec in records),
            "accept_rate": (round(accepted / drafted, 4)
                            if drafted > 0 else None),
            "useful_tokens_per_window": (
                round((w_steps - waste) / n_windows, 4)
                if n_windows > 0 else None),
            # sampling: counters sum, mean_temperature
            # re-derives over the merged sampled-request count (a mean of
            # means overweights idle engines), the NLL sketches merge
            # bucket-wise (HistogramSketch.merge) so cluster percentiles
            # come from one histogram, not a percentile of percentiles
            "n_sampled_requests": n_sampled,
            "mean_temperature": (round(temp_sum / n_sampled, 4)
                                 if n_sampled > 0 else None),
            "logprob_tokens": sum(rec._n_logprob_tokens for rec in records),
            "nll_p50": nll.percentile(50),
            "nll_p95": nll.percentile(95),
            "nll_p99": nll.percentile(99),
            "kv_pages_total": sum(rec._kv_pages_total for rec in records),
            "kv_pages_live": sum(rec._kv_pages_live for rec in records),
            "kv_pages_peak": sum(rec._kv_pages_peak for rec in records),
            "kv_bytes_live": sum(rec._kv_pages_live * rec._kv_page_bytes
                                 for rec in records),
            "kv_bytes_peak": sum(rec._kv_pages_peak * rec._kv_page_bytes
                                 for rec in records),
            "radix_hits": r_hits,
            "radix_misses": r_miss,
            "radix_hit_tokens": sum(rec._radix_hit_tokens for rec in records),
            "radix_hit_rate": (round(r_hits / (r_hits + r_miss), 4)
                               if (r_hits + r_miss) > 0 else None),
            # chunked prefill: counters sum, the stall fraction
            # re-derives over the merged busy time, and the longest prompt
            # is a cluster-wide max (None when no engine recorded one)
            "n_prefill_chunks": n_chunks,
            "chunk_stall_s": round(chunk_stall, 6),
            "chunk_stall_frac": (
                round(chunk_stall / busy_total, 4)
                if busy_total > 0 and n_chunks > 0 else None),
            "longest_prompt_admitted": (
                max(longest) if longest else None),
            "tp": tps.pop() if len(tps) == 1 else None,
            "cp": cps.pop() if len(cps) == 1 else None,
            # common scheme or None when replicas disagree (a mid-rollout
            # mixed fleet is visible, never silently averaged)
            "quant": quants.pop() if len(quants) == 1 else None,
            "kv_bytes_per_chip": (
                max(rec._kv_bytes_per_chip for rec in stamped)
                if stamped else None),
            "weight_bytes_per_chip": (
                max(rec._weight_bytes_per_chip for rec in stamped)
                if stamped else None),
            "kv_bytes_cluster": (
                sum(rec._kv_bytes_per_chip * rec._tp * rec._cp
                    for rec in stamped)
                if stamped else None),
            "weight_bytes_cluster": (
                sum(rec._weight_bytes_per_chip * rec._tp * rec._cp
                    for rec in stamped)
                if stamped else None),
            "n_compiled_programs": (
                sum(c["n_compiled_programs"] for c in compiled)
                if compiled else None),
            "compile_time_s": (
                round(sum(c["compile_time_s"] for c in compiled), 6)
                if compiled else None),
            "per_role": cls._role_rollups(records),
            "per_engine": [rec.summary() for rec in records],
        }
        for name, xs in (("ttft_s", ttft), ("latency_s", latency)):
            for k, v in percentiles(xs).items():
                out[f"{name}_{k}"] = v
        return out

    @classmethod
    def _role_rollups(cls, records: list["ServingStats"]) -> dict:
        """Per-role sub-rollups: group engine records by the
        serving role that produced them so a disaggregated tier's rollup
        separates prefill-side figures (chunk dispatches, radix skips,
        page pressure) from decode-side service latency.  TTFT/latency
        land where requests RETIRE — the decode side in a disaggregated
        tier — so the decode sub-rollup carries the user-visible
        percentiles plus TPOT (time-per-output-token over the post-first-
        token stretch), while the prefill sub-rollup shows the work that
        never retires a request locally.  A monolithic tier reports one
        ``"both"`` entry; every ratio/percentile is None — never NaN —
        when its denominator is empty (strict-JSON, like everything else
        in the record).  Callers hold every record's lock (``merge``).
        """
        out: dict[str, dict] = {}
        for role in sorted({rec.role for rec in records}):
            recs = [rec for rec in records if rec.role == role]
            reqs = [r for rec in recs for r in rec.requests]
            done = [r for r in reqs if r.status == "done"]
            ttft = [r.first_token_t - r.submit_t for r in reqs
                    if r.first_token_t is not None]
            tpot = [(r.finish_t - r.first_token_t) / (len(r.generated) - 1)
                    for r in done
                    if r.finish_t is not None and r.first_token_t is not None
                    and len(r.generated) > 1]
            sub = {
                "n_engines": len(recs),
                "n_requests": sum(rec._n_requests for rec in recs),
                "n_done": sum(rec._n_done for rec in recs),
                "tokens_generated": sum(rec._tokens for rec in recs),
                "busy_s": round(sum(rec._busy_time for rec in recs), 6),
                "n_prefill_chunks": sum(rec._prefill_chunks
                                        for rec in recs),
                "radix_hits": sum(rec._radix_hits for rec in recs),
                "radix_hit_tokens": sum(rec._radix_hit_tokens
                                        for rec in recs),
                "kv_pages_peak": sum(rec._kv_pages_peak for rec in recs),
            }
            for name, xs in (("ttft_s", ttft), ("tpot_s", tpot)):
                for k, v in percentiles(xs).items():
                    sub[f"{name}_{k}"] = v
            out[role] = sub
        return out
