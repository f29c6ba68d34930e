"""Serving metrics of the port: TTFT/latency, tokens/sec, occupancy, and
what decode-ahead, sampling, the prefix cache and paging produce.

The subset of the JAX package's ``ServingStats`` the port's engine fills,
under JAX's names:

* **TTFT** — submit to the first token ON THE HOST (queue wait included);
* **latency** — submit to retirement of ``done`` requests;
* **tokens/sec** — generated tokens over the engine's busy window (first
  admission to last retirement);
* **occupancy** — time-weighted mean fraction of slots holding a request;
* the done / cancelled / failed counts;
* ``prefill_s`` / ``decode_s`` — host seconds inside admissions (prefill
  or landing + first pick) and inside decode windows (dispatch through
  the one readback), the split of where the serving time goes;
* **windows** — per decode-ahead window: dispatch vs readback seconds,
  occupied-slot steps dispatched vs WASTE steps (decoded past a row's
  EOS/budget inside a window, discarded on the host); ``window_waste_frac``
  rises with ``decode_ahead`` and is what it trades for fewer syncs;
* **sampling** — ``n_sampled_requests`` (requests whose own
  SamplingParams sampled), ``mean_temperature`` over them (None when
  none), and per-token NLL percentiles (``-logprob`` of every generated
  token, greedy rows included) from a fixed-memory log-bucketed sketch;
* **prefix cache** — hits, misses, hit rate and oversized refusals;
* **paged KV** — page size, pool pages total / live / peak and their
  bytes, radix hits, misses and hit tokens (prefill skipped for them);
* **speculative acceptance** — per verify window and slot: drafted
  tokens, accepted drafts, one corrected token; ``accept_rate`` and
  ``useful_tokens_per_window`` (what speculation raises);
* **chunked prefill** — ``n_prefill_chunks``, ``chunk_stall_s`` (host
  seconds inside chunk dispatches) and its share of the busy time, the
  longest prompt admitted;
* **memory** — ``quant``, ``weight_bytes_per_chip``,
  ``kv_bytes_per_chip`` (the whole model and cache on one card), stamped
  by the engine once it is built.

Ratios are None, never NaN, when their denominators are zero, so
``summary()`` is strict JSON.  Percentiles are p50/p95/p99 over every
completed request.  The JAX package's compile census (``CompileTracker``)
has no counterpart here: PyTorch runs eagerly and nothing is compiled
until CUDA graphs arrive.
"""

from __future__ import annotations

import math

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import Request
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter


def percentiles(xs, qs=(50, 95, 99)) -> dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} over xs (empty -> None values)."""
    if not len(xs):
        return {f"p{q}": None for q in qs}
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": round(float(np.percentile(arr, q)), 6) for q in qs}


class HistogramSketch:
    """Log-bucketed histogram with fixed memory (the JAX package's
    ``utils/telemetry.HistogramSketch``, record and percentile only):
    values below ``lo`` count as underflow, at or above ``hi`` as
    overflow, and a percentile is its bucket's geometric midpoint clamped
    to the observed [min, max] (the exact min/max in the open regions)."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e4, growth: float = 1.1):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(f"need 0 < lo < hi and growth > 1, got {lo}, {hi}, {growth}")
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._log_growth = math.log(self.growth)
        self.counts = [0] * int(math.ceil(math.log(self.hi / self.lo) / self._log_growth))
        self.underflow = self.overflow = self.count = 0
        self.min: float | None = None
        self.max: float | None = None

    def record(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v < self.lo:
            self.underflow += 1
        elif v >= self.hi:
            self.overflow += 1
        else:
            i = int(math.log(v / self.lo) / self._log_growth)
            self.counts[min(i, len(self.counts) - 1)] += 1

    def percentile(self, q: float) -> float | None:
        if self.count == 0:
            return None
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        seen = self.underflow
        v = self.min if seen >= rank else None
        if v is None:
            for i, c in enumerate(self.counts):
                seen += c
                if c and seen >= rank:
                    v = self.lo * self.growth ** (i + 0.5)
                    break
            if v is None:
                v = self.max
        return round(float(min(max(v, self.min), self.max)), 6)


def _ratio(num: float, den: float, digits: int = 4) -> float | None:
    return round(num / den, digits) if den > 0 else None


class ServingStats:
    """Accumulates request records and engine-loop samples: the engine
    calls :meth:`tick` once per host-loop iteration, :meth:`add` once per
    retired request; :meth:`summary` folds them into one flat dict."""

    def __init__(self, slots: int, decode_ahead: int = 1):
        self.slots = slots
        self.decode_ahead = decode_ahead
        self.requests: list[Request] = []
        self._counts = {"done": 0, "cancelled": 0, "failed": 0}
        self._tokens = 0
        self._occ_time = 0.0   # integral of occupied_slots * dt
        self._busy_time = 0.0  # integral of dt while the engine had work
        self._decode_steps = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._start_t: float | None = None
        self._end_t: float | None = None
        # decode-ahead windows
        self._windows = 0
        self._dispatch_s = 0.0
        self._readback_s = 0.0
        self._window_steps = 0
        self._waste_steps = 0
        # per-request sampling: NLL over [1e-4, 1e2] nats
        self._n_sampled = 0
        self._temp_sum = 0.0
        self._n_logprob_tokens = 0
        self._nll = HistogramSketch(lo=1e-4, hi=1e2)
        # prefix cache
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_oversized = 0
        # paged pool and radix sharing (all zero on dense engines)
        self._kv_page_size = 0
        self._kv_pages_total = 0
        self._kv_pages_live = 0
        self._kv_pages_peak = 0
        self._kv_page_bytes = 0
        self._radix_hits = 0
        self._radix_misses = 0
        self._radix_hit_tokens = 0
        # speculative acceptance and chunked prefill (zero elsewhere)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_corrected = 0
        self._prefill_chunks = 0
        self._chunk_stall_s = 0.0
        self._longest_prompt = 0
        # memory, stamped by the engine (memory())
        self._kv_bytes_per_chip: int | None = None
        self._weight_bytes_per_chip: int | None = None
        self._quant = "none"

    def tick(self, occupied: int, dt: float, decoded: bool = False) -> None:
        self._occ_time += occupied * dt
        self._busy_time += dt
        self._decode_steps += int(decoded)

    def prefill(self, seconds: float) -> None:
        """One admission's prefill + first pick, in host seconds."""
        self._prefill_s += seconds

    def decode(self, seconds: float) -> None:
        """One decode window, dispatch through readback, in host seconds."""
        self._decode_s += seconds

    def window(self, dispatch_s: float, readback_s: float, steps: int,
               waste: int) -> None:
        """One decode-ahead window: ``steps`` = occupied slots x window
        length dispatched, ``waste`` = those discarded on the host (decoded
        past a row's EOS or budget)."""
        self._windows += 1
        self._dispatch_s += dispatch_s
        self._readback_s += readback_s
        self._window_steps += steps
        self._waste_steps += waste

    def prefix(self, hit: bool) -> None:
        """One prefix-cache lookup (hit = the prefill was skipped)."""
        if hit:
            self._prefix_hits += 1
        else:
            self._prefix_misses += 1

    def prefix_oversized(self, count: int) -> None:
        """The prefix cache's own count of refused (too large) entries."""
        self._prefix_oversized = int(count)

    def pool_sample(self, pages_live: int, pages_total: int, page_size: int,
                    page_bytes: int) -> None:
        """One page-pool occupancy sample (the paged engine, each step)."""
        self._kv_pages_live = int(pages_live)
        self._kv_pages_peak = max(self._kv_pages_peak, int(pages_live))
        self._kv_pages_total = int(pages_total)
        self._kv_page_size = int(page_size)
        self._kv_page_bytes = int(page_bytes)

    def radix(self, hit: bool, tokens: int = 0) -> None:
        """One admission's radix match: ``tokens`` shared prompt tokens
        whose prefill was skipped."""
        if hit:
            self._radix_hits += 1
            self._radix_hit_tokens += int(tokens)
        else:
            self._radix_misses += 1

    def spec(self, drafted: int, accepted: int, corrected: int = 1) -> None:
        """One slot's outcome in one speculative verify window: ``drafted``
        tokens proposed, ``accepted`` of them kept, and the ``corrected``
        token the model adds after them."""
        self._spec_drafted += int(drafted)
        self._spec_accepted += int(accepted)
        self._spec_corrected += int(corrected)

    def chunk(self, stall_s: float) -> None:
        """One chunked-prefill dispatch and its host seconds."""
        self._prefill_chunks += 1
        self._chunk_stall_s += float(stall_s)

    def prompt_admitted(self, n_tokens: int) -> None:
        """One chunked admission's prompt length."""
        self._longest_prompt = max(self._longest_prompt, int(n_tokens))

    def memory(self, kv_bytes_per_chip: int, weight_bytes_per_chip: int,
               quant: str = "none") -> None:
        """The engine's footprint on its card and its weight storage."""
        self._kv_bytes_per_chip = int(kv_bytes_per_chip)
        self._weight_bytes_per_chip = int(weight_bytes_per_chip)
        self._quant = str(quant)

    def add(self, req: Request) -> None:
        self.requests.append(req)
        if req.status in self._counts:
            self._counts[req.status] += 1
        self._tokens += len(req.generated)
        if req.sampling is not None and req.sampling.sampled:
            self._n_sampled += 1
            self._temp_sum += float(req.sampling.temperature)
        for lp in req.logprobs:
            self._nll.record(-lp)
        self._n_logprob_tokens += len(req.logprobs)
        if req.admit_t is not None:
            self._start_t = (req.admit_t if self._start_t is None
                             else min(self._start_t, req.admit_t))
        if req.finish_t is not None:
            self._end_t = (req.finish_t if self._end_t is None
                           else max(self._end_t, req.finish_t))

    def summary(self) -> dict:
        ttft = [r.first_token_t - r.submit_t for r in self.requests
                if r.first_token_t is not None]
        latency = [r.finish_t - r.submit_t for r in self.requests
                   if r.status == "done" and r.finish_t is not None]
        window = (self._end_t - self._start_t
                  if self._start_t is not None and self._end_t is not None
                  and self._end_t > self._start_t else None)
        out = {
            "slots": self.slots,
            "n_requests": len(self.requests),
            "n_done": self._counts["done"],
            "n_cancelled": self._counts["cancelled"],
            "n_failed": self._counts["failed"],
            "tokens_generated": self._tokens,
            "tokens_per_sec": round(self._tokens / window, 3) if window else None,
            "busy_s": round(self._busy_time, 6),
            "decode_steps": self._decode_steps,
            "slot_occupancy": (
                round(self._occ_time / (self._busy_time * self.slots), 4)
                if self._busy_time > 0 else None),
            "prefill_s": round(self._prefill_s, 6),
            "decode_s": round(self._decode_s, 6),
            "decode_ahead": self.decode_ahead,
            "n_windows": self._windows,
            "window_dispatch_s": round(self._dispatch_s, 6),
            "window_readback_s": round(self._readback_s, 6),
            "window_steps": self._window_steps,
            "window_waste_steps": self._waste_steps,
            "window_waste_frac": _ratio(self._waste_steps, self._window_steps),
            "useful_tokens_per_window": _ratio(
                self._window_steps - self._waste_steps, self._windows),
            "n_sampled_requests": self._n_sampled,
            "mean_temperature": _ratio(self._temp_sum, self._n_sampled),
            "logprob_tokens": self._n_logprob_tokens,
            "nll_p50": self._nll.percentile(50),
            "nll_p95": self._nll.percentile(95),
            "nll_p99": self._nll.percentile(99),
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_hit_rate": _ratio(self._prefix_hits,
                                      self._prefix_hits + self._prefix_misses),
            "prefix_oversized": self._prefix_oversized,
            "kv_page_size": self._kv_page_size or None,
            "kv_pages_total": self._kv_pages_total,
            "kv_pages_live": self._kv_pages_live,
            "kv_pages_peak": self._kv_pages_peak,
            "kv_bytes_live": self._kv_pages_live * self._kv_page_bytes,
            "kv_bytes_peak": self._kv_pages_peak * self._kv_page_bytes,
            "radix_hits": self._radix_hits,
            "radix_misses": self._radix_misses,
            "radix_hit_tokens": self._radix_hit_tokens,
            "radix_hit_rate": _ratio(self._radix_hits,
                                     self._radix_hits + self._radix_misses),
            "drafted_tokens": self._spec_drafted,
            "accepted_tokens": self._spec_accepted,
            "corrected_tokens": self._spec_corrected,
            "accept_rate": _ratio(self._spec_accepted, self._spec_drafted),
            "n_prefill_chunks": self._prefill_chunks,
            "chunk_stall_s": round(self._chunk_stall_s, 6),
            "chunk_stall_frac": (_ratio(self._chunk_stall_s, self._busy_time)
                                 if self._prefill_chunks else None),
            "longest_prompt_admitted": self._longest_prompt or None,
            "kv_bytes_per_chip": self._kv_bytes_per_chip,
            "weight_bytes_per_chip": self._weight_bytes_per_chip,
            "quant": self._quant,
        }
        for name, xs in (("ttft_s", ttft), ("latency_s", latency)):
            for k, v in percentiles(xs).items():
                out[f"{name}_{k}"] = v
        return out

    def emit(self, writer: MetricWriter, kind: str = "serving") -> dict:
        return writer.write(kind, **self.summary())
