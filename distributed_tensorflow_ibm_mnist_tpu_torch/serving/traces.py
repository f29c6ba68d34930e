"""Recorded arrival traces: workload shapes as DATA, not harness code (the
port's copy of the JAX package's ``serving/traces.py``; numpy and the
stdlib only, so a trace of a seed equals JAX's event for event).

An open-loop harness with an inlined Poisson generator measures overload,
but only ONE shape of it, and the shape is not a thing you can save,
diff, or replay against two tiers.  This module
makes the workload a first-class artifact:

* :class:`TraceEvent` / :class:`ArrivalTrace` — the schema: each event
  is an arrival offset from trace start plus the request's shape
  (``prompt_len``, ``max_new``), its CLASS (``interactive`` vs
  ``batch`` — the two-tier traffic mix every serving paper's goodput
  story turns on), priority, and optional per-request SLOs.  Traces
  round-trip through JSONL (:meth:`ArrivalTrace.save` /
  :meth:`ArrivalTrace.load`), so a shape generated once replays
  byte-identically against any tier configuration.
* Generators for the canonical shapes: :func:`poisson_trace`
  (homogeneous, now recordable),
  :func:`bursty_trace` (on/off modulated: quiet base load with periodic
  arrival bursts — the autoscaler's reason to exist),
  :func:`diurnal_trace` (sinusoidal rate via Lewis-Shedler thinning —
  the day/night curve, compressed to seconds), and
  :func:`heavy_tail_trace` (Pareto-shaped request LENGTHS over Poisson
  arrivals — a few giants among many mice, the shape that breaks
  FIFO-behind-a-giant tiers).
* :func:`replay_trace` — drive a :class:`~.daemon.ServingDaemon` with a
  trace on the arrival clock (open-loop, coordinated-omission-free:
  submit at each event's offset regardless of completions) and return
  per-class dispositions + goodput, the report
  :func:`per_class_report` computes from delivered streams.

SLOs live in seconds, so a recorded trace would bake one machine's
latency scale into a portable artifact.  :func:`with_slos` is the seam:
generators emit SHAPE only (offsets, lengths, classes), and the replay
harness stamps calibrated SLOs per class right before driving — the
same trace replays on any box against SLOs measured on that box.

Rates are offered-load knobs in requests/second; generators are seeded
(`numpy` Generator) and deterministic — same seed, same trace.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

_SCHEMA = "dtm-arrival-trace/1"
INTERACTIVE = "interactive"
BATCH = "batch"
_CLASSES = (INTERACTIVE, BATCH)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded arrival.  ``t_offset`` is seconds from trace start;
    ``cls`` is the traffic class (``interactive``/``batch``); SLOs are
    optional per-request overrides (usually stamped by
    :func:`with_slos`, not recorded)."""

    t_offset: float
    prompt_len: int
    max_new: int
    cls: str = INTERACTIVE
    priority: int = 0
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None

    def __post_init__(self):
        if self.t_offset < 0:
            raise ValueError(f"t_offset must be >= 0, got {self.t_offset}")
        if self.prompt_len < 1 or self.max_new < 1:
            raise ValueError(
                f"prompt_len/max_new must be >= 1, got "
                f"{self.prompt_len}/{self.max_new}")
        if self.cls not in _CLASSES:
            raise ValueError(f"cls must be one of {_CLASSES}, got {self.cls!r}")


class ArrivalTrace:
    """An ordered list of :class:`TraceEvent` with a name and JSONL
    round-trip.  Events are kept sorted by offset — replay is a single
    forward walk of the arrival clock."""

    def __init__(self, name: str, events: Iterable[TraceEvent]):
        self.name = str(name)
        self.events = sorted(events, key=lambda e: e.t_offset)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def duration_s(self) -> float:
        return self.events[-1].t_offset if self.events else 0.0

    def class_counts(self) -> dict:
        out = {c: 0 for c in _CLASSES}
        for ev in self.events:
            out[ev.cls] += 1
        return out

    def save(self, path) -> Path:
        """JSONL: a schema header line, then one event per line."""
        path = Path(path)
        with path.open("w") as fh:
            fh.write(json.dumps({"schema": _SCHEMA, "name": self.name,
                                 "n_events": len(self.events)}) + "\n")
            for ev in self.events:
                fh.write(json.dumps(dataclasses.asdict(ev)) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "ArrivalTrace":
        path = Path(path)
        with path.open() as fh:
            header = json.loads(fh.readline())
            if header.get("schema") != _SCHEMA:
                raise ValueError(
                    f"{path}: not an arrival trace "
                    f"(schema {header.get('schema')!r}, want {_SCHEMA!r})")
            events = [TraceEvent(**json.loads(line))
                      for line in fh if line.strip()]
        if len(events) != header.get("n_events", len(events)):
            raise ValueError(
                f"{path}: truncated trace — header says "
                f"{header['n_events']} events, file has {len(events)}")
        return cls(header.get("name", path.stem), events)


def with_slos(trace: ArrivalTrace, *,
              interactive_ttft_slo_s: float | None,
              batch_ttft_slo_s: float | None = None,
              interactive_tpot_slo_s: float | None = None,
              batch_tpot_slo_s: float | None = None) -> ArrivalTrace:
    """Stamp calibrated, per-class SLOs onto a shape-only trace (a new
    trace — the recorded artifact stays machine-independent)."""
    ttft = {INTERACTIVE: interactive_ttft_slo_s, BATCH: batch_ttft_slo_s}
    tpot = {INTERACTIVE: interactive_tpot_slo_s, BATCH: batch_tpot_slo_s}
    return ArrivalTrace(trace.name, (
        dataclasses.replace(ev, ttft_slo_s=ttft[ev.cls],
                            tpot_slo_s=tpot[ev.cls])
        for ev in trace.events))


# ----------------------------------------------------------------------
# shape generators (seeded, deterministic)


def _draw_shape(rng, *, prompt_len, max_new, interactive_frac: float):
    """Common per-event draws: class (interactive gets priority 1 —
    PriorityPolicy drains it first under backlog), prompt/output lengths
    uniform in their inclusive ranges."""
    cls = INTERACTIVE if rng.random() < interactive_frac else BATCH
    return {
        "prompt_len": int(rng.integers(prompt_len[0], prompt_len[1] + 1)),
        "max_new": int(rng.integers(max_new[0], max_new[1] + 1)),
        "cls": cls,
        "priority": 1 if cls == INTERACTIVE else 0,
    }


def poisson_trace(n: int, rate_rps: float, *, seed: int,
                  prompt_len=(2, 6), max_new=(2, 4),
                  interactive_frac: float = 0.5) -> ArrivalTrace:
    """Homogeneous Poisson arrivals — exponential gaps at ``rate_rps``."""
    rng = np.random.default_rng(seed)
    t, events = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rate_rps)
        events.append(TraceEvent(
            t_offset=t, **_draw_shape(rng, prompt_len=prompt_len,
                                      max_new=max_new,
                                      interactive_frac=interactive_frac)))
    return ArrivalTrace(f"poisson-r{rate_rps:g}-s{seed}", events)


def bursty_trace(n: int, base_rps: float, burst_rps: float, *, seed: int,
                 burst_every_s: float, burst_len_s: float,
                 prompt_len=(2, 6), max_new=(2, 4),
                 interactive_frac: float = 0.5) -> ArrivalTrace:
    """On/off modulated Poisson: ``base_rps`` background with windows of
    ``burst_rps`` every ``burst_every_s`` lasting ``burst_len_s`` — the
    quiet-then-slammed shape elastic capacity is judged on."""
    if burst_rps <= base_rps:
        raise ValueError(
            f"burst_rps ({burst_rps}) must exceed base_rps ({base_rps})")
    rng = np.random.default_rng(seed)
    t, events = 0.0, []
    for _ in range(n):
        in_burst = (t % burst_every_s) < burst_len_s
        t += rng.exponential(1.0 / (burst_rps if in_burst else base_rps))
        events.append(TraceEvent(
            t_offset=t, **_draw_shape(rng, prompt_len=prompt_len,
                                      max_new=max_new,
                                      interactive_frac=interactive_frac)))
    return ArrivalTrace(f"bursty-b{base_rps:g}-p{burst_rps:g}-s{seed}", events)


def diurnal_trace(n: int, mean_rps: float, *, seed: int, period_s: float,
                  depth: float = 0.8, prompt_len=(2, 6), max_new=(2, 4),
                  interactive_frac: float = 0.5) -> ArrivalTrace:
    """Sinusoidal rate ``mean_rps * (1 + depth*sin)`` via Lewis-Shedler
    thinning of a Poisson process at the peak rate — the day/night curve
    compressed to a ``period_s``-second day."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    rng = np.random.default_rng(seed)
    peak = mean_rps * (1.0 + depth)
    t, events = 0.0, []
    while len(events) < n:
        t += rng.exponential(1.0 / peak)
        rate_t = mean_rps * (1.0 + depth * np.sin(2 * np.pi * t / period_s))
        if rng.random() * peak <= rate_t:     # thinning acceptance
            events.append(TraceEvent(
                t_offset=t, **_draw_shape(rng, prompt_len=prompt_len,
                                          max_new=max_new,
                                          interactive_frac=interactive_frac)))
    return ArrivalTrace(f"diurnal-m{mean_rps:g}-s{seed}", events)


def heavy_tail_trace(n: int, rate_rps: float, *, seed: int,
                     alpha: float = 1.5, prompt_len=(2, 8), max_new=(2, 8),
                     interactive_frac: float = 0.5) -> ArrivalTrace:
    """Poisson arrivals with Pareto(``alpha``)-shaped LENGTHS, clipped to
    the inclusive ranges: most requests are mice at the range floor, a
    heavy tail of giants pins the ceiling — the mix where per-class
    accounting matters, because giants behind-the-counter starve mice."""
    if alpha <= 1.0:
        raise ValueError(f"alpha must be > 1 (finite mean), got {alpha}")
    rng = np.random.default_rng(seed)

    def tail(lo: int, hi: int) -> int:
        return int(min(hi, lo + np.floor(lo * (rng.pareto(alpha)))))

    t, events = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / rate_rps)
        base = _draw_shape(rng, prompt_len=prompt_len, max_new=max_new,
                           interactive_frac=interactive_frac)
        base["prompt_len"] = tail(prompt_len[0], prompt_len[1])
        base["max_new"] = tail(max_new[0], max_new[1])
        events.append(TraceEvent(t_offset=t, **base))
    return ArrivalTrace(f"heavytail-a{alpha:g}-s{seed}", events)


# ----------------------------------------------------------------------
# replay


def replay_trace(daemon, trace: ArrivalTrace, *, vocab: int = 16,
                 seed: int = 0, speed: float = 1.0,
                 timeout_s: float = 120.0,
                 prompt_fn: Callable | None = None) -> dict:
    """Drive ``daemon`` with ``trace`` on the arrival clock and return
    :func:`per_class_report` over the outcomes.

    Open-loop: each event submits at ``t_offset / speed`` seconds after
    replay start whether or not earlier requests finished; rejections
    (:class:`~.scheduler.QueueFull`, including policy sheds) are counted
    per class, never retried — the trace IS the offered load.  Prompts
    are deterministic from ``seed`` (or ``prompt_fn(event, rng)``), so
    two replays of one trace offer identical requests.
    """
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
        QueueFull,
    )

    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    rng = np.random.default_rng(seed)
    if prompt_fn is None:
        def prompt_fn(ev, rng):
            return rng.integers(1, vocab, size=(ev.prompt_len,)).astype(
                np.int32)

    outcomes = []      # (event, dr | None, stream)
    t0 = time.monotonic()
    for ev in trace.events:
        lag = t0 + ev.t_offset / speed - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        prompt = prompt_fn(ev, rng)
        stream: list[int] = []
        try:
            dr = daemon.submit(
                prompt, ev.max_new, priority=ev.priority,
                ttft_slo_s=ev.ttft_slo_s, tpot_slo_s=ev.tpot_slo_s,
                callback=lambda dr, tok, s=stream: s.append(int(tok)))
        except QueueFull:
            outcomes.append((ev, None, stream))
            continue
        outcomes.append((ev, dr, stream))
    deadline = time.monotonic() + timeout_s
    for _ev, dr, _stream in outcomes:
        if dr is not None:
            dr.wait(timeout=max(0.0, deadline - time.monotonic()))
    wall_s = time.monotonic() - t0
    return per_class_report(outcomes, wall_s)


def per_class_report(outcomes, wall_s: float) -> dict:
    """Per-class dispositions + goodput from replay outcomes.

    A request counts toward GOODPUT only if it finished ``done``, its
    delivered stream matches its final tokens (exactly-once), and every
    SLO it carried held end-to-end: TTFT = submit→first delivered token,
    TPOT = mean inter-token time over the remaining tokens.  Classes are
    reported separately — one aggregate number hides exactly the
    interactive-starved-by-batch failure the class split exists to show.
    """
    per = {c: {"offered": 0, "accepted": 0, "rejected": 0, "done": 0,
               "cancelled": 0, "failed": 0, "unfinished": 0,
               "slo_met": 0, "exactly_once": True, "ttfts": []}
           for c in _CLASSES}
    for ev, dr, stream in outcomes:
        row = per[ev.cls]
        row["offered"] += 1
        if dr is None:
            row["rejected"] += 1
            continue
        row["accepted"] += 1
        if not dr.done:
            row["unfinished"] += 1
            continue
        if dr.status != "done":
            row["cancelled" if dr.status == "cancelled" else "failed"] += 1
            continue
        row["done"] += 1
        if stream != dr.tokens:
            row["exactly_once"] = False
        met = True
        if dr.first_token_t is not None:
            ttft = dr.first_token_t - dr.submit_t
            row["ttfts"].append(ttft)
            if ev.ttft_slo_s is not None and ttft > ev.ttft_slo_s:
                met = False
            if (ev.tpot_slo_s is not None and dr.rr is not None
                    and dr.rr.req is not None and len(dr.tokens) > 1):
                req = dr.rr.req
                if req.finish_t is not None and req.first_token_t is not None:
                    tpot = ((req.finish_t - req.first_token_t)
                            / (len(dr.tokens) - 1))
                    if tpot > ev.tpot_slo_s:
                        met = False
        elif ev.ttft_slo_s is not None:
            met = False
        if met:
            row["slo_met"] += 1
    out = {"wall_s": round(wall_s, 3), "per_class": {}}
    for c, row in per.items():
        ttfts = row.pop("ttfts")
        row["goodput_rps"] = (round(row["slo_met"] / wall_s, 3)
                              if wall_s > 0 else None)
        row["ttft_p50_s"] = (round(float(np.percentile(ttfts, 50)), 4)
                             if ttfts else None)
        row["ttft_p99_s"] = (round(float(np.percentile(ttfts, 99)), 4)
                             if ttfts else None)
        out["per_class"][c] = row
    totals = {k: sum(out["per_class"][c][k] for c in _CLASSES)
              for k in ("offered", "accepted", "rejected", "done",
                        "cancelled", "failed", "unfinished", "slo_met")}
    totals["goodput_rps"] = (round(totals["slo_met"] / wall_s, 3)
                             if wall_s > 0 else None)
    totals["exactly_once"] = all(out["per_class"][c]["exactly_once"]
                                 for c in _CLASSES)
    out["total"] = totals
    return out
