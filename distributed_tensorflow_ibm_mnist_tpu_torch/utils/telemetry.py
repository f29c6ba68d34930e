"""Live telemetry: metrics registry, histogram sketches, health sampler
(the port's copy of the JAX package's ``utils/telemetry.py``; same classes,
same text expositions, same JSONL records on the same clock).

Every other observability surface is post-hoc:
``ServingStats`` folds percentiles at emission time, the tracer exports
after the run, ``MetricWriter`` writes one record per completed phase.
This layer answers *what is the tier doing right now* and *is it meeting
its latency targets* — while the run is still going — without growing
memory with traffic.  Three pieces:

* **`HistogramSketch`** — a log-bucketed histogram with FIXED memory:
  bucket ``i`` covers ``[lo * growth^i, lo * growth^(i+1))``, so the
  number of buckets is ``ceil(log(hi/lo)/log(growth))`` regardless of how
  many values are recorded, and any reported percentile is within one
  bucket of the exact sample percentile — a relative error of at most
  ``growth - 1`` (~10% at the default 1.1).  Sketches ``merge()`` across
  engines/replicas exactly (bucket counts add), the property
  ``ServingStats.merge`` gets from storing raw samples but at O(buckets)
  memory, and round-trip through strict JSON (``to_dict``/``from_dict``).
* **`MetricsRegistry`** — named counters (monotone, merge by SUM), gauges
  (point-in-time, merge keeps the MAX — per-source detail lives in the
  sampler's JSONL, not the merged rollup), and rolling histograms (a
  lifetime sketch plus a ring of per-interval sub-sketches the sampler
  rotates, so ``window_p99`` reflects only the last ``window`` sampling
  intervals — rolling percentiles without storing a single sample).
  ``to_prometheus()`` renders the standard text exposition format
  (counter/gauge/histogram with cumulative ``le`` buckets).
* **`Telemetry`** — the health sampler and the single object components
  are wired with.  Engines/routers/trainers ``register_source(name, fn)``
  (re-registration replaces — a respawned replica takes over its name);
  ``maybe_sample()`` is called from their step loops and is a clock read
  plus one comparison until ``interval_s`` has elapsed, at which point it
  snapshots every source's vitals dict plus the registry into ONE
  strict-JSON line appended to ``jsonl_path`` and rewrites ``prom_path``
  (atomically, via ``os.replace``) in Prometheus text format.  A vitals
  source that raises is recorded as an error string in that sample —
  never an exception on the serving hot loop.

Wiring follows the nil-guard zero-cost-off contract of ``chaos`` and
``Tracer``: every instrumented site is ``if self._telemetry is not None:
...``, so a component built without telemetry pays a single attribute
test.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Callable

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import _sanitize


class HistogramSketch:
    """Mergeable log-bucketed histogram: fixed memory, bounded error.

    Values below ``lo`` (including zero/negative) land in ``underflow``,
    values at/above ``hi`` in ``overflow``; a rank landing in either
    region reports the exact observed ``min``/``max`` (the only honest
    figure for an unbucketed region), and every in-range representative
    is clamped to [min, max], so percentiles never invent values outside
    the data.  Non-finite values are counted (``nonfinite``) and
    otherwise ignored — a NaN can never poison a percentile.
    """

    __slots__ = ("lo", "hi", "growth", "_log_growth", "n_buckets", "counts",
                 "underflow", "overflow", "nonfinite", "count", "sum",
                 "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = 1.1):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        self.n_buckets = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_growth))
        self.counts = [0] * self.n_buckets
        self.underflow = 0
        self.overflow = 0
        self.nonfinite = 0
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def record(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            self.nonfinite += 1
            return
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v < self.lo:
            self.underflow += 1
        elif v >= self.hi:
            self.overflow += 1
        else:
            i = int(math.log(v / self.lo) / self._log_growth)
            if i >= self.n_buckets:  # float edge at the top boundary
                i = self.n_buckets - 1
            self.counts[i] += 1

    def bucket_index(self, value: float) -> int | None:
        """Which bucket ``value`` would land in: ``-1`` for underflow,
        ``n_buckets`` for overflow, None for non-finite.  The key the
        exemplar store shares with the exposition renderers."""
        v = float(value)
        if not math.isfinite(v):
            return None
        if v < self.lo:
            return -1
        if v >= self.hi:
            return self.n_buckets
        i = int(math.log(v / self.lo) / self._log_growth)
        return min(i, self.n_buckets - 1)

    def _same_config(self, other: "HistogramSketch") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.growth == other.growth)

    def merge_from(self, other: "HistogramSketch") -> None:
        """Add ``other``'s counts into this sketch (bucket configs must
        match exactly — merging differently-bucketed sketches would
        silently mis-bin)."""
        if not self._same_config(other):
            raise ValueError(
                f"cannot merge sketches with different bucket configs: "
                f"(lo={self.lo}, hi={self.hi}, growth={self.growth}) vs "
                f"(lo={other.lo}, hi={other.hi}, growth={other.growth})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.underflow += other.underflow
        self.overflow += other.overflow
        self.nonfinite += other.nonfinite
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min,
                                                              other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max,
                                                              other.max)

    @classmethod
    def merge(cls, sketches) -> "HistogramSketch":
        sketches = list(sketches)
        if not sketches:
            return cls()
        out = cls(lo=sketches[0].lo, hi=sketches[0].hi,
                  growth=sketches[0].growth)
        for s in sketches:
            out.merge_from(s)
        return out

    def percentile(self, q: float) -> float | None:
        """The q-th percentile's bucket representative (geometric bucket
        midpoint), clamped to the exact observed [min, max]; None when
        the sketch is empty."""
        if self.count == 0:
            return None
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        seen = self.underflow
        if seen >= rank:
            v = self.min  # underflow region: [min, lo) — report exactly
        else:
            v = None
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                seen += c
                if seen >= rank:
                    v = self.lo * self.growth ** (i + 0.5)
                    break
            if v is None:  # overflow region: [hi, max] — report exactly
                v = self.max
        v = min(max(v, self.min), self.max)
        return round(float(v), 6)

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        """Same shape as serving/stats.percentiles: {"p50": ..., ...}."""
        return {f"p{q}": self.percentile(q) for q in qs}

    def to_dict(self) -> dict:
        """Strict-JSON, mergeable dump (sparse buckets, string keys)."""
        return _sanitize({
            "lo": self.lo, "hi": self.hi, "growth": self.growth,
            "count": self.count, "sum": round(self.sum, 9),
            "min": self.min, "max": self.max,
            "underflow": self.underflow, "overflow": self.overflow,
            "nonfinite": self.nonfinite,
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        })

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        out = cls(lo=d["lo"], hi=d["hi"], growth=d["growth"])
        for i, c in d.get("buckets", {}).items():
            out.counts[int(i)] = int(c)
        out.underflow = int(d.get("underflow", 0))
        out.overflow = int(d.get("overflow", 0))
        out.nonfinite = int(d.get("nonfinite", 0))
        out.count = int(d["count"])
        out.sum = float(d["sum"])
        out.min = d.get("min")
        out.max = d.get("max")
        return out


class RollingHistogram:
    """A lifetime sketch plus a ring of per-interval sub-sketches.

    ``record`` feeds both; the sampler calls ``rotate()`` once per
    sampling interval, retiring the current sub-sketch into a ring of
    the last ``window - 1`` intervals.  ``window_sketch()`` merges the
    ring plus the open interval, so its percentiles cover exactly the
    last ``window`` sampling intervals — rolling p50/p95/p99 with no
    stored samples and memory fixed at ``(window + 1) * O(buckets)``.

    Exemplars (OpenMetrics): ``record(v, exemplar="<trace id>")`` keeps,
    per lifetime bucket, the LAST exemplar'd observation that landed
    there — ``(trace_id, value, unix_t)`` — so a scrape of a latency
    histogram carries a recent trace id for each populated bucket and a
    p99 outlier becomes a one-click jump into its distributed trace.
    Memory is one tuple per bucket, regardless of traffic.
    """

    def __init__(self, window: int = 8, **sketch_kw):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._sketch_kw = dict(sketch_kw)
        self.lifetime = HistogramSketch(**sketch_kw)
        self._cur = HistogramSketch(**sketch_kw)
        self._ring: deque[HistogramSketch] = deque(maxlen=self.window - 1)
        self.exemplars: dict[int, tuple[str, float, float]] = {}

    def record(self, value: float, exemplar: str | None = None) -> None:
        self.lifetime.record(value)
        self._cur.record(value)
        if exemplar is not None:
            i = self.lifetime.bucket_index(value)
            if i is not None:
                self.exemplars[i] = (str(exemplar), float(value),
                                     time.time())

    def rotate(self) -> None:
        if self.window > 1:
            self._ring.append(self._cur)
        self._cur = HistogramSketch(**self._sketch_kw)

    def window_sketch(self) -> HistogramSketch:
        return HistogramSketch.merge([*self._ring, self._cur])


def _prom_name(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_][a-zA-Z0-9_]*."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _flatten_numeric(prefix: str, obj, out: dict) -> None:
    """Numeric leaves of a nested dict as flat gauge names (bools as
    0/1; None and strings skipped — Prometheus carries numbers only)."""
    if isinstance(obj, bool):
        out[prefix] = 1.0 if obj else 0.0
    elif isinstance(obj, (int, float)) and math.isfinite(obj):
        out[prefix] = float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten_numeric(f"{prefix}_{_prom_name(k)}", v, out)


class MetricsRegistry:
    """Named counters, gauges, and rolling histograms; mergeable.

    Merge semantics (``MetricsRegistry.merge`` over ``to_dict`` dumps,
    the ``ServingStats.merge`` discipline): counters SUM, histogram
    sketches merge bucket-wise with percentiles re-derived from the
    merged counts (a percentile of percentiles is not a percentile),
    gauges keep the MAX across sources — a gauge is a point-in-time
    reading, so the honest cluster rollup is "worst observed", with
    per-source values preserved in the sampler's JSONL time-series.

    Thread-safe (the daemonized tier calls ``inc``/``observe`` from N
    pump threads into ONE shared registry): every mutator and snapshot
    holds one internal lock, so ``counters[k] = counters.get(k) + n``
    can never lose an increment between threads and a snapshot never
    reads a histogram mid-rotate.
    """

    def __init__(self, *, window: int = 8, lo: float = 1e-6,
                 hi: float = 1e4, growth: float = 1.1):
        self._window = int(window)
        self._sketch_kw = {"lo": lo, "hi": hi, "growth": growth}
        self._lock = threading.RLock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, RollingHistogram] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float,
                exemplar: str | None = None) -> None:
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = RollingHistogram(
                    window=self._window, **self._sketch_kw)
            h.record(value, exemplar=exemplar)

    def rotate(self) -> None:
        with self._lock:
            for h in self.histograms.values():
                h.rotate()

    def snapshot(self) -> dict:
        """One sample's registry view: lifetime count/sum/min/max +
        lifetime and rolling-window percentiles per histogram."""
        with self._lock:
            hists = {}
            for name, h in self.histograms.items():
                lt, w = h.lifetime, h.window_sketch()
                d = {"count": lt.count, "sum": round(lt.sum, 6),
                     "min": lt.min, "max": lt.max}
                d.update(lt.percentiles())
                d["window_count"] = w.count
                d.update({f"window_{k}": v
                          for k, v in w.percentiles().items()})
                hists[name] = d
            return _sanitize({"counters": dict(self.counters),
                              "gauges": dict(self.gauges),
                              "histograms": hists})

    def to_dict(self) -> dict:
        """Mergeable strict-JSON dump (full sketches, not percentiles)."""
        with self._lock:
            return _sanitize({
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {n: h.lifetime.to_dict()
                               for n, h in self.histograms.items()},
            })

    @classmethod
    def merge(cls, dumps: list[dict]) -> dict:
        """Cluster rollup over N ``to_dict`` dumps (see class docstring
        for the per-kind semantics)."""
        counters: dict[str, float] = {}
        gauges: dict[str, float] = {}
        sketches: dict[str, list[HistogramSketch]] = {}
        for d in dumps:
            for k, v in d.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
            for k, v in d.get("gauges", {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    gauges[k] = v if k not in gauges else max(gauges[k], v)
            for k, v in d.get("histograms", {}).items():
                sketches.setdefault(k, []).append(
                    HistogramSketch.from_dict(v))
        hists = {}
        for k, group in sketches.items():
            s = HistogramSketch.merge(group)
            hists[k] = {"count": s.count, "sum": round(s.sum, 6),
                        "min": s.min, "max": s.max, **s.percentiles()}
        return _sanitize({"n_sources": len(dumps), "counters": counters,
                          "gauges": gauges, "histograms": hists})

    def to_prometheus(self, prefix: str = "dtm",
                      extra_gauges: dict | None = None) -> str:
        """Prometheus text exposition (format 0.0.4): counters and
        gauges verbatim, histograms as cumulative ``le`` buckets over
        the LIFETIME sketch (underflow folds into the first bucket,
        overflow into ``+Inf`` only; ``le`` is each log-bucket's upper
        bound).  ``extra_gauges`` lets the sampler export source vitals
        without registering them as registry gauges."""
        with self._lock:
            return self._to_prometheus_locked(prefix, extra_gauges)

    def _to_prometheus_locked(self, prefix, extra_gauges):
        lines: list[str] = []
        for name in sorted(self.counters):
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self.counters[name]}")
        gauges = dict(self.gauges)
        if extra_gauges:
            gauges.update(extra_gauges)
        for name in sorted(gauges):
            v = gauges[name]
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                continue  # Prometheus carries finite numbers only
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {v}")
        for name in sorted(self.histograms):
            s = self.histograms[name].lifetime
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} histogram")
            cum = s.underflow
            for i, c in enumerate(s.counts):
                if c == 0:
                    continue
                cum += c
                le = s.lo * s.growth ** (i + 1)
                lines.append(f'{m}_bucket{{le="{le:.6g}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {s.count}')
            lines.append(f"{m}_sum {round(s.sum, 9)}")
            lines.append(f"{m}_count {s.count}")
        return "\n".join(lines) + "\n"

    def to_openmetrics(self, prefix: str = "dtm",
                       extra_gauges: dict | None = None,
                       exemplar_label: str = "trace_id") -> str:
        """OpenMetrics 1.0 text exposition — same data as
        :meth:`to_prometheus` plus EXEMPLARS: each populated histogram
        bucket that has a recorded exemplar carries
        ``# {trace_id="<id>"} <value> <unix_t>`` after its count, which
        is how a scraper (and Grafana) jump from a latency bucket to the
        distributed trace of a request that landed in it.  Counters get
        the spec's ``_total`` suffix; the exposition ends with ``# EOF``.
        Serve it for ``Accept: application/openmetrics-text``.
        """
        with self._lock:
            return self._to_openmetrics_locked(prefix, extra_gauges,
                                               exemplar_label)

    def _to_openmetrics_locked(self, prefix, extra_gauges, exemplar_label):
        lines: list[str] = []

        def ex(tup) -> str:
            if tup is None:
                return ""
            eid, value, unix_t = tup
            return (f' # {{{exemplar_label}="{eid}"}} {value:.6g}'
                    f" {unix_t:.3f}")

        for name in sorted(self.counters):
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m}_total {self.counters[name]}")
        gauges = dict(self.gauges)
        if extra_gauges:
            gauges.update(extra_gauges)
        for name in sorted(gauges):
            v = gauges[name]
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                continue
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {v}")
        for name in sorted(self.histograms):
            h = self.histograms[name]
            s = h.lifetime
            m = f"{prefix}_{_prom_name(name)}"
            lines.append(f"# TYPE {m} histogram")
            cum = s.underflow
            for i, c in enumerate(s.counts):
                if c == 0:
                    continue
                cum += c
                le = s.lo * s.growth ** (i + 1)
                exemplar = h.exemplars.get(i)
                if exemplar is None and cum == s.underflow + c:
                    exemplar = h.exemplars.get(-1)  # underflow folds here
                lines.append(f'{m}_bucket{{le="{le:.6g}"}} {cum}'
                             f"{ex(exemplar)}")
            lines.append(f'{m}_bucket{{le="+Inf"}} {s.count}'
                         f"{ex(h.exemplars.get(s.n_buckets))}")
            lines.append(f"{m}_sum {round(s.sum, 9)}")
            lines.append(f"{m}_count {s.count}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


class Telemetry:
    """The health sampler: interval-gated vitals snapshots to JSONL +
    Prometheus, over one shared :class:`MetricsRegistry`.

    ``maybe_sample()`` is the hot-loop entry point — one clock read and
    one comparison between samples.  ``sample()`` forces one.  ``close()``
    takes a final sample and closes the JSONL file (idempotent; also a
    context manager).  The JSONL file is opened in APPEND mode, so a
    crashed run's partial time-series survives and a restarted run
    continues the same file.

    Thread-safe: the daemonized tier calls ``maybe_sample()`` from every
    pump thread against one shared sampler.  The interval pre-check is a
    lock-free fast path (a stale read at worst defers one sample by one
    call); the sample itself — sources, JSONL append, Prometheus rewrite,
    window rotate — runs under an RLock (reentrant because ``close()``
    takes a final sample) with the due-check repeated inside, so two
    threads arriving at the same tick produce ONE record, not two.
    """

    def __init__(self, *, interval_s: float = 1.0,
                 jsonl_path: str | None = None,
                 prom_path: str | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 window: int = 8, prefix: str = "dtm",
                 registry: MetricsRegistry | None = None,
                 fsync: bool = False):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.clock = clock
        self.prefix = prefix
        # fsync=True makes every JSONL sample and Prometheus rewrite
        # crash-durable (survives SIGKILL, not just process exit) at the
        # cost of one fsync per sample — the crash-bench post-mortem mode
        self.fsync = bool(fsync)
        self.registry = (registry if registry is not None
                         else MetricsRegistry(window=window))
        self.jsonl_path = jsonl_path
        self.prom_path = prom_path
        self._file = (open(jsonl_path, "a", encoding="utf-8")
                      if jsonl_path else None)
        self._sources: dict[str, Callable[[], dict]] = {}
        self._last_t: float | None = None
        self.samples = 0
        self.source_errors = 0
        self._closed = False
        self._sample_lock = threading.RLock()

    # --- wiring -----------------------------------------------------
    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register (or REPLACE — respawn semantics) a vitals source:
        a zero-arg callable returning a JSON-able dict."""
        if not callable(fn):
            raise ValueError(f"source {name!r} must be callable")
        self._sources[str(name)] = fn

    def unregister_source(self, name: str) -> None:
        self._sources.pop(str(name), None)

    # --- registry conveniences (what instrumented sites call) -------
    def inc(self, name: str, n: float = 1) -> None:
        self.registry.inc(name, n)

    def set_gauge(self, name: str, value) -> None:
        self.registry.set_gauge(name, value)

    def observe(self, name: str, value: float,
                exemplar: str | None = None) -> None:
        self.registry.observe(name, value, exemplar=exemplar)

    def heartbeat(self, name: str) -> None:
        """Stamp ``{name}_heartbeat_t`` with the sampler clock — the
        liveness gauge a stalled component stops moving."""
        self.registry.set_gauge(f"{name}_heartbeat_t", self.clock())

    # --- sampling ---------------------------------------------------
    def maybe_sample(self, now: float | None = None) -> dict | None:
        """Take a sample iff ``interval_s`` has elapsed since the last
        one (the first call always samples).  Returns the record, or
        None when not yet due / already closed."""
        if self._closed:
            return None
        now = self.clock() if now is None else now
        if self._last_t is not None and (now - self._last_t) < self.interval_s:
            return None  # lock-free fast path: not due (stale read is benign)
        with self._sample_lock:
            if self._closed:
                return None
            # re-check under the lock: another thread may have sampled
            # between our pre-check and our acquisition
            if (self._last_t is not None
                    and (now - self._last_t) < self.interval_s):
                return None
            return self.sample(now)

    def sample(self, now: float | None = None) -> dict:
        """Force one sample: collect every source's vitals, snapshot the
        registry, append one strict-JSON line, rewrite the Prometheus
        file, rotate the rolling-histogram windows."""
        with self._sample_lock:
            if self._closed:
                raise RuntimeError("Telemetry is closed — no further samples")
            now = self.clock() if now is None else now
            self._last_t = now
            sources: dict[str, dict] = {}
            for name, fn in list(self._sources.items()):
                try:
                    sources[name] = fn()
                except Exception as e:  # a sick source must not kill the loop
                    self.source_errors += 1
                    sources[name] = {"error": f"{type(e).__name__}: {e}"}
            record = _sanitize({"t": round(now, 6), "sample": self.samples,
                                "sources": sources,
                                **self.registry.snapshot()})
            self.samples += 1
            if self._file is not None:
                self._file.write(json.dumps(record, allow_nan=False) + "\n")
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())
            if self.prom_path is not None:
                self._write_prom(record)
            self.registry.rotate()
            return record

    def _write_prom(self, record: dict) -> None:
        extra: dict[str, float] = {}
        _flatten_numeric("src", record.get("sources", {}), extra)
        text = self.registry.to_prometheus(prefix=self.prefix,
                                           extra_gauges=extra)
        tmp = f"{self.prom_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self.prom_path)  # scrapers never see a torn file

    def close(self) -> None:
        """Final sample + file close; idempotent."""
        with self._sample_lock:
            if self._closed:
                return
            try:
                self.sample()
            finally:
                self._closed = True
                if self._file is not None:
                    self._file.close()
                    self._file = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
