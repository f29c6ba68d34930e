"""End-to-end request/step tracing with build accounting (the port's copy
of the JAX package's ``utils/tracing.py``).

``ServingStats`` percentiles and MetricWriter records say *that* a tail
latency moved; this module records *why*: a per-request / per-step span
tree on one monotonic clock, exportable to the Chrome/Perfetto trace
viewer, plus per-site attribution of every run-time build the port makes.

The pieces:

* :class:`Tracer` — a bounded ring buffer of typed events (spans with
  parent ids, instants, counters) on one monotonic clock.  ~Zero cost when
  unwired: every call site guards with ``if self._tracer is not None`` (the
  nil-guard pattern of the chaos hooks, utils/chaos.py), so a run built
  without a tracer executes no tracing instructions on its hot paths.
  ``export_trace(path)`` writes Chrome-trace-viewer / Perfetto-loadable
  JSON (strict: non-finite numbers sanitized to null); ``summary()`` folds
  the buffer into one strict-JSON dict.  The class, its event schema and
  its documents are the JAX module's, byte for byte on the same clock.
* :class:`CompileTracker` — process-global accounting of what the port
  compiles at run time: each ``nvcc`` build and library load of
  ``ops/_build.py`` and the ``g++`` build and load of ``data/native.py``,
  attributed to the SITE active at the time (``with tracker.site(
  "prefill[b32]")``).  PyTorch runs eagerly, so there are no XLA programs
  to count: a build is the port's unit of cold start, and a steady engine
  after :meth:`~..serving.engine.InferenceEngine.prewarm` shows zero
  builds and zero loads.
* :func:`validate_trace` — the schema gate for exported traces: strict
  JSON (no NaN/Infinity tokens), every span closed, every parent id
  resolving.
* The distributed layer: :class:`TraceContext` — the W3C-``traceparent``-
  compatible request identity carried through daemon admission, router
  dispatch and failover replay (span ``links``); :class:`TraceSampler` —
  deterministic head sampling on the trace-id prefix plus tail always-keep
  for failed/cancelled/shed/SLO-missing traces, applied per trace group at
  EXPORT time (the ring records everything); :func:`merge_traces` /
  :func:`trace_forest` / :meth:`Tracer.trace_events` — multi-process
  exports joined through hex ``span_ctx``/``parent_ctx`` edges into
  per-trace trees whose connectivity a test can gate.

Event schema (what ``export_trace`` writes): one JSON object
``{"traceEvents": [...], "displayTimeUnit": "ms"}``.  Spans are ``ph:
"X"`` complete events (``ts``/``dur`` in microseconds since the tracer
epoch) carrying ``args.id`` (unique per span) and ``args.parent`` (another
span's id, or absent for roots); instants are ``ph: "i"`` with the same
correlation args; counters are ``ph: "C"``.  Spans still open at export
time are written as ``ph: "B"`` (begin-without-end) so an unclosed span is
VISIBLE in the file — and rejected by :func:`validate_trace` — instead of
silently dropped.  Track (``tid``) 0 is the engine/trainer host loop; each
serving request gets its own track (named ``req <id>``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, IO

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import _sanitize

_UNSET = object()
_HEX = set("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


class Tracer:
    """Bounded ring buffer of span/instant/counter events, one clock.

    ``capacity`` bounds CLOSED events (open spans live outside the ring
    until ended, so a long-lived request can never be evicted mid-flight);
    when full, the oldest closed event is dropped and ``dropped``
    increments — a soak that outruns the buffer degrades to a sliding
    window, never to unbounded memory.  ``clock`` must be monotonic and
    SHARED with the component being traced (the engine's default
    ``time.monotonic`` matches this default) so span durations agree with
    the latencies the component reports.

    Usage::

        tracer = Tracer()
        with tracer.span("prefill", cat="serving", bucket=32):
            ...
        rid = tracer.begin("request", tid=tracer.track("req 0"))
        ...
        tracer.end(rid, status="done")
        tracer.export_trace("/tmp/serve.trace.json")

    Not thread-safe by design: the engine/trainer host loops are single
    threads (the same contract as the rest of their state); a lock on the
    hot path would be cost without a customer.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.t0 = clock()
        self._events: deque[dict] = deque()  # closed events, ring-bounded
        self._open: dict[int, dict] = {}     # span id -> event under way
        self._ids = itertools.count(1)
        self._tids = itertools.count(1)      # tid 0 = the host loop
        self._track_names: dict[int, str] = {0: "host"}
        self._last_counter: dict[tuple[str, int], float] = {}
        self.dropped = 0

    # ------------------------------------------------------------------
    # recording
    #
    # Closed events are stored as flat 9-tuples, not dicts —
    # ``(kind, id, parent, name, cat, tid, ts, dur_or_value, args)`` —
    # because the ring push is the tracer's hot path (hundreds of events
    # per serving rep land inside the ≤2% overhead budget) and a tuple is
    # several times cheaper to build than a keyed dict.  ``events()``
    # materializes the documented dict shape on demand; only the cold
    # paths (summary/export) ever read the tuples.

    def _push(self, ev: tuple) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

    def track(self, name: str) -> int:
        """Allocate a new track (Chrome ``tid``) named ``name`` — one lane
        in the viewer.  Track 0 (the host loop) always exists."""
        tid = next(self._tids)
        self._track_names[tid] = str(name)
        return tid

    def begin(self, name: str, cat: str = "", parent: int | None = None,
              tid: int = 0, **args: Any) -> int:
        """Open a span; returns its id (pass to :meth:`end`, or as
        ``parent=`` of children).  ``args`` are correlation payload
        (sanitized to strict JSON at export)."""
        sid = next(self._ids)
        # `args` is the **kwargs dict — already fresh, owned by this event
        self._open[sid] = {
            "type": "span", "id": sid, "parent": parent, "name": name,
            "cat": cat, "tid": tid, "ts": self.clock() - self.t0,
            "args": args,
        }
        return sid

    def end(self, span_id: int, **args: Any) -> None:
        """Close a span.  Unknown/already-closed ids are ignored (an
        error path that double-ends must not crash the traced system)."""
        ev = self._open.pop(span_id, None)
        if ev is None:
            return
        ts = ev["ts"]
        if args:
            ev["args"].update(args)
        self._push(("span", span_id, ev["parent"], ev["name"], ev["cat"],
                    ev["tid"], ts, max(0.0, self.clock() - self.t0 - ts),
                    ev["args"]))

    def annotate(self, span_id: int, parent: Any = _UNSET,
                 links: list[int] | None = None, **args: Any) -> bool:
        """Mutate an OPEN span in place: re-parent it, attach span
        ``links`` (ids of related spans in other trees — a failover
        replay links to the attempt it replaces), and/or merge ``args``.

        This is what lets a component that did not create a span claim it
        for a distributed trace after the fact — the router annotates the
        engine's request span with the trace id and the daemon-side parent
        without the engine's ``submit()`` signature knowing about trace
        contexts.  Returns False (no-op) for unknown/closed ids: the
        annotation races request retirement by design, and losing that
        race must not crash the annotator.
        """
        ev = self._open.get(span_id)
        if ev is None:
            return False
        if parent is not _UNSET:
            ev["parent"] = parent
        if links:
            ev["args"].setdefault("links", []).extend(links)
        if args:
            ev["args"].update(args)
        return True

    def complete(self, name: str, start: float, end: float, cat: str = "",
                 parent: int | None = None, tid: int = 0,
                 **args: Any) -> int:
        """Record an already-measured span from caller-supplied clock
        readings (``start``/``end`` are values of THIS tracer's ``clock``).
        One ring push, no open-span bookkeeping, no extra clock calls —
        the cheap path for hot loops that already time their phases (the
        engine's window dispatch/readback reuse their stats timestamps)."""
        sid = next(self._ids)
        self._push(("span", sid, parent, name, cat, tid, start - self.t0,
                    max(0.0, end - start), args))
        return sid

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", parent: int | None = None,
             tid: int = 0, **args: Any):
        """Lexically-scoped span; yields the span id for child nesting."""
        sid = self.begin(name, cat=cat, parent=parent, tid=tid, **args)
        try:
            yield sid
        finally:
            self.end(sid)

    def instant(self, name: str, cat: str = "", parent: int | None = None,
                tid: int = 0, **args: Any) -> int:
        """A zero-duration correlated event (fault injections, cache hits,
        restarts); ``parent`` attaches it to a span's tree."""
        iid = next(self._ids)
        self._push(("instant", iid, parent, name, cat, tid,
                    self.clock() - self.t0, None, args))
        return iid

    def counter(self, name: str, value: float, tid: int = 0) -> None:
        """A sampled scalar series (queue depth, occupancy, compile count).
        Deduplicated: a sample equal to the last recorded value for this
        (name, tid) is dropped — counters are step functions and Chrome
        viewers hold the last value, so repeats are pure ring pressure
        (the engine samples every host iteration; steady state is flat)."""
        key = (name, tid)
        if self._last_counter.get(key) == value:
            return
        self._last_counter[key] = value
        self._push(("counter", None, None, name, "", tid,
                    self.clock() - self.t0, value, None))

    # ------------------------------------------------------------------
    # reading

    @property
    def open_spans(self) -> int:
        return len(self._open)

    @staticmethod
    def _as_dict(ev: tuple) -> dict:
        kind, sid, parent, name, cat, tid, ts, x, args = ev
        if kind == "span":
            return {"type": "span", "id": sid, "parent": parent,
                    "name": name, "cat": cat, "tid": tid, "ts": ts,
                    "dur": x, "args": args}
        if kind == "instant":
            return {"type": "instant", "id": sid, "parent": parent,
                    "name": name, "cat": cat, "tid": tid, "ts": ts,
                    "args": args}
        return {"type": "counter", "name": name, "tid": tid, "ts": ts,
                "value": x}

    def events(self) -> list[dict]:
        """Closed events in record order (materialized from the internal
        tuple ring; counters included)."""
        return [self._as_dict(ev) for ev in self._events]

    def _all_correlated(self) -> list[dict]:
        """Closed spans/instants plus OPEN spans (marked ``"open": True``)
        as dicts — the working set for trace-scoped reads."""
        evs = [self._as_dict(ev) for ev in self._events
               if ev[0] != "counter"]
        for sid, ev in self._open.items():
            evs.append({"type": "span", "id": sid, "parent": ev["parent"],
                        "name": ev["name"], "cat": ev["cat"],
                        "tid": ev["tid"], "ts": ev["ts"], "dur": None,
                        "open": True, "args": dict(ev["args"])})
        return evs

    @staticmethod
    def _closure(evs: list[dict], seeds: set[int]) -> set[int]:
        """Expand ``seeds`` with every event reachable via ``parent``
        edges (children of members join their parent's set).  Fixpoint
        loop — trees are shallow (≤5 hops) so this converges fast."""
        keep = set(seeds)
        changed = True
        while changed:
            changed = False
            for d in evs:
                if d["id"] in keep:
                    continue
                if d.get("parent") in keep:
                    keep.add(d["id"])
                    changed = True
        return keep

    def trace_events(self, trace_id: str) -> list[dict]:
        """Every event (closed or still open) belonging to the trace:
        events stamped ``args.trace == trace_id`` plus their descendants
        via ``parent`` edges.  Feeds ``GET /v1/requests/{id}/trace``."""
        evs = self._all_correlated()
        seeds = {d["id"] for d in evs
                 if (d.get("args") or {}).get("trace") == trace_id}
        keep = self._closure(evs, seeds)
        return [_sanitize(d) for d in evs if d["id"] in keep]

    @staticmethod
    def _trace_owner(evs: list[dict]) -> dict[int, str]:
        """Map event id -> owning trace id: events stamped ``args.trace``
        seed the map; descendants inherit through ``parent`` edges
        (fixpoint loop; trees are ≤5 hops deep)."""
        owner: dict[int, str] = {}
        for d in evs:
            t = (d.get("args") or {}).get("trace")
            if t is not None:
                owner[d["id"]] = t
        changed = True
        while changed:
            changed = False
            for d in evs:
                if d["id"] in owner:
                    continue
                p = d.get("parent")
                if p in owner:
                    owner[d["id"]] = owner[p]
                    changed = True
        return owner

    def _sampled_out(self, sampler: "TraceSampler") -> set[int]:
        """Event ids belonging to trace groups the sampler DROPS.  A
        group is a trace id's stamped events plus their descendants;
        events with no trace affiliation are never dropped."""
        evs = self._all_correlated()
        owner = self._trace_owner(evs)
        groups: dict[str, list[dict]] = {}
        for d in evs:
            t = owner.get(d["id"])
            if t is not None:
                groups.setdefault(t, []).append(d)
        drop: set[int] = set()
        for group in groups.values():
            if not sampler.keep(group):
                drop.update(d["id"] for d in group)
        return drop

    def summary(self) -> dict:
        """Strict-JSON rollup: per-(cat, name) span counts/durations,
        final counter values, buffer health.  Same sanitizer as
        MetricWriter (non-finite -> null), so a diverged duration can
        never corrupt the record it lands in."""
        phases: dict[str, dict] = {}
        counters: dict[str, Any] = {}
        for kind, _sid, _parent, name, cat, _tid, _ts, x, _args in (
                self._events):
            if kind == "counter":
                counters[name] = x
                continue
            if kind != "span":
                continue
            key = f"{cat}/{name}" if cat else name
            p = phases.setdefault(
                key, {"n": 0, "total_s": 0.0, "max_s": 0.0})
            p["n"] += 1
            p["total_s"] += x
            p["max_s"] = max(p["max_s"], x)
        for p in phases.values():
            p["mean_s"] = p["total_s"] / p["n"] if p["n"] else None
            p["total_s"] = round(p["total_s"], 6)
            p["max_s"] = round(p["max_s"], 6)
            if p["mean_s"] is not None:
                p["mean_s"] = round(p["mean_s"], 6)
        return _sanitize({
            "events": len(self._events),
            "open_spans": len(self._open),
            "dropped": self.dropped,
            "phases": phases,
            "counters": counters,
        })

    # ------------------------------------------------------------------
    # export

    def to_doc(self, sampler: "TraceSampler | None" = None) -> dict:
        """Build the Chrome-trace-viewer / Perfetto JSON document.

        With ``sampler``, trace groups (events stamped ``args.trace``
        plus descendants) that the sampler's head+tail policy rejects are
        omitted wholesale; unaffiliated events (host loop, counters,
        metadata) always export.  See :meth:`export_trace` for schema
        guarantees.
        """
        drop: set[int] = (set() if sampler is None
                          else self._sampled_out(sampler))
        present = {ev[1] for ev in self._events
                   if ev[0] == "span" and ev[1] not in drop}
        present.update(sid for sid in self._open if sid not in drop)
        out: list[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "distributed_tensorflow_ibm_mnist_tpu"}},
        ]
        for tid, name in sorted(self._track_names.items()):
            out.append({"ph": "M", "pid": 0, "tid": tid,
                        "name": "thread_name", "args": {"name": name}})

        def corr(args: dict, sid: int, parent: int | None) -> dict:
            args = dict(args)
            args["id"] = sid
            if parent is not None and parent in present:
                args["parent"] = parent
            links = [l for l in args.pop("links", ()) if l in present]
            if links:
                args["links"] = links
            return _sanitize(args)

        for kind, sid, parent, name, cat, tid, ts, x, args in self._events:
            if sid in drop:
                continue
            base = {"pid": 0, "tid": tid, "ts": round(ts * 1e6, 3)}
            if kind == "span":
                out.append({**base, "ph": "X", "name": name,
                            "cat": cat or "trace",
                            "dur": round(x * 1e6, 3),
                            "args": corr(args, sid, parent)})
            elif kind == "instant":
                out.append({**base, "ph": "i", "s": "t", "name": name,
                            "cat": cat or "trace",
                            "args": corr(args, sid, parent)})
            elif kind == "counter":
                out.append({**base, "ph": "C", "name": name,
                            "args": _sanitize({"value": x})})
        for sid, ev in self._open.items():  # unclosed: visible, not hidden
            if sid in drop:
                continue
            out.append({"pid": 0, "tid": ev["tid"], "ph": "B",
                        "ts": round(ev["ts"] * 1e6, 3), "name": ev["name"],
                        "cat": ev["cat"] or "trace",
                        "args": corr(ev["args"], sid, ev["parent"])})
        return {"displayTimeUnit": "ms", "traceEvents": out}

    def export_trace(self, path_or_file: str | IO[str],
                     sampler: "TraceSampler | None" = None) -> dict:
        """Write the buffer as Chrome-trace-viewer / Perfetto JSON.

        Strict JSON end to end: args pass through the MetricWriter
        sanitizer and the dump refuses NaN/Infinity tokens outright.
        Spans whose parent was evicted from the ring are kept with the
        dangling ``parent`` DROPPED (the span is real; the broken edge is
        not) so exported files always pass :func:`validate_trace`'s
        parent-resolution check; span ``links`` are filtered the same
        way.  OPEN spans export as ``ph: "B"`` — visibly unclosed, and
        rejected by the validator — because a span that never ended is a
        finding, not something to paper over.  ``sampler`` applies the
        head+tail keep/drop policy per trace group at export time (the
        ring is the tail buffer: everything is recorded, the decision is
        deferred to here).  Returns ``{"events": n, "path": ...}``.
        """
        doc = self.to_doc(sampler=sampler)
        if hasattr(path_or_file, "write"):
            json.dump(doc, path_or_file, allow_nan=False)
            path = getattr(path_or_file, "name", None)
        else:
            with open(path_or_file, "w") as f:
                json.dump(doc, f, allow_nan=False)
            path = path_or_file
        return {"events": len(doc["traceEvents"]), "path": path}


def _reject_constant(s: str):
    raise ValueError(f"non-strict JSON token {s!r} in trace file")


def load_trace(path: str) -> dict:
    """Parse an exported trace STRICTLY: bare ``NaN``/``Infinity`` tokens
    (legal to Python's json, fatal to every other consumer) are errors."""
    with open(path) as f:
        return json.load(f, parse_constant=_reject_constant)


def validate_trace(path: str) -> list[str]:
    """Validate an exported trace against the documented schema.

    Returns a list of problems (empty == valid):
    * strict JSON — no NaN/Infinity anywhere in the file;
    * a ``traceEvents`` list of objects with ``ph``/``ts``;
    * every span closed — any ``ph: "B"`` event is an unclosed span;
    * span ids unique, and every ``args.parent`` resolving to a span id;
    * every ``args.links`` entry resolving to a span id;
    * timestamps/durations finite and non-negative.
    """
    problems: list[str] = []
    try:
        doc = load_trace(path)
    except (ValueError, OSError) as e:
        return [f"unparseable: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    span_ids: set[int] = set()
    spans: list[dict] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: not an object with ph")
            continue
        ph = ev["ph"]
        if ph == "B":
            problems.append(
                f"event {i}: unclosed span {ev.get('name')!r} (ph B)")
            continue
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            sid = (ev.get("args") or {}).get("id")
            if sid is None:
                problems.append(f"event {i}: span without args.id")
            elif sid in span_ids:
                problems.append(f"event {i}: duplicate span id {sid}")
            else:
                span_ids.add(sid)
            spans.append(ev)
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        parent = args.get("parent")
        if parent is not None and parent not in span_ids:
            problems.append(
                f"{ev.get('name')!r}: parent {parent} does not resolve")
        links = args.get("links")
        if links is not None:
            if not isinstance(links, list):
                problems.append(
                    f"{ev.get('name')!r}: links is not a list")
            else:
                for link in links:
                    if link not in span_ids:
                        problems.append(f"{ev.get('name')!r}: link {link} "
                                        "does not resolve")
    return problems


# ----------------------------------------------------------------------
# distributed trace context (W3C traceparent) + sampling


class TraceContext:
    """One hop's view of a distributed trace: W3C-``traceparent``-
    compatible ``(trace_id, span_id, sampled)``.

    ``trace_id`` (32 lowercase hex, non-zero) names the whole request's
    trace across every component; ``span_id`` (16 lowercase hex,
    non-zero) is THIS hop's id — a downstream hop puts it in
    ``parent_ctx`` and mints its own via :meth:`child`.  ``sampled`` is
    the HEAD sampling decision, made once where the context is minted and
    carried unchanged, so every component agrees without coordination
    (the tail-keep rules in :class:`TraceSampler` can still rescue an
    unsampled trace at export time).
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        if len(trace_id) != 32 or not _is_hex(trace_id) \
                or trace_id == "0" * 32:
            raise ValueError(f"bad trace_id {trace_id!r}")
        if len(span_id) != 16 or not _is_hex(span_id) \
                or span_id == "0" * 16:
            raise ValueError(f"bad span_id {span_id!r}")
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    @staticmethod
    def _rand_hex(nbytes: int) -> str:
        while True:
            h = os.urandom(nbytes).hex()
            if any(c != "0" for c in h):
                return h

    @classmethod
    def mint(cls, sampled: bool = True) -> "TraceContext":
        """A fresh root context (random non-zero ids)."""
        return cls(cls._rand_hex(16), cls._rand_hex(8), sampled)

    def child(self) -> "TraceContext":
        """A downstream hop's context: same trace, fresh span id, the
        sampling decision inherited."""
        return TraceContext(self.trace_id, self._rand_hex(8), self.sampled)

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    @classmethod
    def parse_traceparent(cls, header: str | None) -> "TraceContext | None":
        """Parse a ``traceparent`` header per W3C Trace Context.

        Returns None (caller mints a fresh context) on anything invalid:
        wrong field count for version 00, non-hex or wrongly-sized
        fields, uppercase (the spec requires lowercase), the forbidden
        version ``ff``, or all-zero trace/span ids.  Versions above 00
        are accepted with their first four fields (the spec's
        forward-compat rule); their extra fields are ignored.
        """
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[:4]
        if len(version) != 2 or not _is_hex(version) or version == "ff":
            return None
        if version == "00" and len(parts) != 4:
            return None
        if len(trace_id) != 32 or not _is_hex(trace_id) \
                or trace_id == "0" * 32:
            return None
        if len(span_id) != 16 or not _is_hex(span_id) \
                or span_id == "0" * 16:
            return None
        if len(flags) != 2 or not _is_hex(flags):
            return None
        return cls(trace_id, span_id, sampled=bool(int(flags, 16) & 0x01))

    def __repr__(self) -> str:
        return f"TraceContext({self.to_traceparent()!r})"

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.sampled == other.sampled)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.sampled))


class TraceSampler:
    """Per-request head+tail sampling policy.

    HEAD: :meth:`head` hashes the trace id against ``rate`` — a
    deterministic function of the id alone, so every component that sees
    the same trace id reaches the same verdict with zero coordination.
    The verdict travels as ``TraceContext.sampled``.

    TAIL: :meth:`keep` decides a whole trace group at export time.  The
    tracer's ring buffer IS the tail buffer — spans are recorded for
    every request regardless of the head verdict (bounded memory, oldest
    evicted) and the drop happens only when a file is written.  Always
    kept, regardless of head verdict: groups containing an error, a
    terminal ``status`` in ``tail_statuses`` (failed / cancelled / shed),
    an ``slo_miss`` stamp, or a ``shed`` span.  That is what makes low
    ``rate`` affordable under open-loop load without losing the traces
    anyone actually needs to read.
    """

    TAIL_STATUSES = ("failed", "cancelled", "shed")

    def __init__(self, rate: float = 1.0,
                 tail_statuses: tuple[str, ...] = TAIL_STATUSES):
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.tail_statuses = frozenset(tail_statuses)

    def head(self, trace_id: str) -> bool:
        """Deterministic head decision for a trace id."""
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        return int(trace_id[:8], 16) / 0xFFFFFFFF < self.rate

    def tail_keep(self, group: list[dict]) -> bool:
        """True when a trace group trips an always-keep rule."""
        for ev in group:
            if ev.get("name") == "shed":
                return True
            args = ev.get("args") or {}
            if args.get("status") in self.tail_statuses:
                return True
            if args.get("slo_miss") or args.get("error"):
                return True
        return False

    def keep(self, group: list[dict]) -> bool:
        """Export-time verdict for one trace group (event dicts with
        ``name``/``args``): head-sampled OR tail-kept."""
        if any((ev.get("args") or {}).get("sampled") for ev in group):
            return True
        return self.tail_keep(group)


def merge_traces(sources: list, path_or_file: str | IO[str] | None = None,
                 names: list[str] | None = None) -> dict:
    """Merge several tracers'/trace files' events into ONE viewer file.

    ``sources`` may mix live :class:`Tracer` instances, already-built
    docs (``{"traceEvents": [...]}``), and file paths.  Each source
    becomes its own ``pid`` (its own process group in the viewer), named
    from ``names`` when given; span/instant ids are remapped to a single
    global sequence so the merged file keeps the ids-unique invariant,
    and ``parent``/``links`` references are rewritten through the same
    map (cross-source references cannot exist by construction; dangling
    ones are dropped).  The W3C correlation args (``trace``,
    ``span_ctx``, ``parent_ctx``) pass through untouched — they are how
    one request's spans join across sources.  Writes ``path_or_file``
    when given; returns the merged doc either way.
    """
    merged: list[dict] = []
    next_id = itertools.count(1)
    for k, src in enumerate(sources):
        if isinstance(src, Tracer):
            doc = src.to_doc()
        elif isinstance(src, dict):
            doc = src
        else:
            doc = load_trace(src)
        events = doc.get("traceEvents", [])
        remap: dict[Any, int] = {}
        for ev in events:
            old = (ev.get("args") or {}).get("id")
            if old is not None:
                remap[old] = next(next_id)
        for ev in events:
            ev = dict(ev)
            ev["pid"] = k
            args = ev.get("args")
            if isinstance(args, dict) and (
                    "id" in args or "parent" in args or "links" in args):
                args = dict(args)
                if "id" in args:
                    args["id"] = remap.get(args["id"], args["id"])
                if "parent" in args:
                    parent = remap.get(args["parent"])
                    if parent is None:
                        args.pop("parent")
                    else:
                        args["parent"] = parent
                if "links" in args:
                    links = [remap[l] for l in args["links"] if l in remap]
                    if links:
                        args["links"] = links
                    else:
                        args.pop("links")
                ev["args"] = args
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                label = (names[k] if names and k < len(names)
                         else f"{(ev.get('args') or {}).get('name', 'trace')}"
                              f" #{k}")
                ev["args"] = {"name": label}
            merged.append(ev)
    doc = {"displayTimeUnit": "ms", "traceEvents": merged}
    if path_or_file is not None:
        if hasattr(path_or_file, "write"):
            json.dump(doc, path_or_file, allow_nan=False)
        else:
            with open(path_or_file, "w") as f:
                json.dump(doc, f, allow_nan=False)
    return doc


def trace_forest(doc: dict) -> dict:
    """Group a (possibly merged) trace doc's spans by trace id and test
    each group's CONNECTIVITY — the bench's trace-completeness gate.

    Edges considered: in-file ``args.parent`` ids, ``args.links``, the
    W3C hex edges (a span whose ``args.parent_ctx`` equals another
    member's ``args.span_ctx``) that join spans across merged sources,
    and SHARED lost parents — two members claiming the same
    ``parent_ctx`` are siblings of one tree even when that parent's span
    never made it into the file (the crash-recovery case: the pre-crash
    and post-crash ``daemon_request`` spans both hang off the front
    door's context from the process that died).  Returns ``{trace_id:
    {"spans", "connected", "roots", "names", "sampled", "statuses"}}``
    where ``connected`` means the group forms ONE component and
    ``roots`` lists members with no in-group parent (a complete request
    tree has exactly one; a recovered-across-crash tree legitimately
    shows one root per process generation).
    """
    events = doc.get("traceEvents", [])
    spans = [ev for ev in events if ev.get("ph") in ("X", "B")
             and isinstance(ev.get("args"), dict) and "id" in ev["args"]]
    byid = {ev["args"]["id"]: ev for ev in spans}
    byctx: dict[str, Any] = {}
    for ev in spans:
        ctx = ev["args"].get("span_ctx")
        if ctx is not None:
            byctx[ctx] = ev["args"]["id"]
    # ownership: stamped spans seed; descendants inherit via parent edges
    owner: dict[Any, str] = {}
    for sid, ev in byid.items():
        t = ev["args"].get("trace")
        if t is not None:
            owner[sid] = t
    changed = True
    while changed:
        changed = False
        for sid, ev in byid.items():
            if sid in owner:
                continue
            p = ev["args"].get("parent")
            if p in owner:
                owner[sid] = owner[p]
                changed = True
    groups: dict[str, list] = {}
    for sid, t in owner.items():
        groups.setdefault(t, []).append(sid)
    out: dict[str, dict] = {}
    for t, members in groups.items():
        mset = set(members)
        uf = {m: m for m in members}

        def find(x):
            while uf[x] != x:
                uf[x] = uf[uf[x]]
                x = uf[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                uf[ra] = rb

        roots = []
        by_lost_parent: dict[str, Any] = {}
        for m in members:
            args = byid[m]["args"]
            parented = False
            p = args.get("parent")
            if p in mset:
                union(m, p)
                parented = True
            pc = args.get("parent_ctx")
            target = byctx.get(pc)
            if pc is not None and target in mset and target != m:
                union(m, target)
                parented = True
            elif pc is not None and target is None:
                # the named parent never reached this file (it died with
                # its process) — members sharing it are still siblings
                if pc in by_lost_parent:
                    union(m, by_lost_parent[pc])
                else:
                    by_lost_parent[pc] = m
            for link in args.get("links") or ():
                if link in mset:
                    union(m, link)
            if not parented:
                roots.append(m)
        components = {find(m) for m in members}
        out[t] = {
            "spans": len(members),
            "connected": len(components) == 1,
            "roots": sorted(byid[m]["name"] for m in roots),
            "names": sorted({byid[m]["name"] for m in members}),
            "sampled": any(byid[m]["args"].get("sampled")
                           for m in members),
            "statuses": sorted({byid[m]["args"].get("status")
                                for m in members
                                if byid[m]["args"].get("status")}),
        }
    return out


# ----------------------------------------------------------------------
# build accounting


class CompileTracker:
    """Process-global accounting of the port's run-time builds, by site.

    Two kinds of event are recorded (:func:`record_build` is the hook
    ``ops/_build.py`` and ``data/native.py`` call):

    * ``build`` — a compiler run: ``nvcc`` for a ``csrc/*.cu`` library
      whose hashed file is missing, ``g++`` for the native library;
    * ``load`` — a library loaded into the process (``ctypes.CDLL``),
      once per library per process.

    A library already built on disk costs a load and no build.  The
    snapshot keeps the JAX tracker's key names: ``n_compiled_programs``
    counts builds, ``n_loads`` loads, and ``compile_time_s`` the seconds
    both took.

    Attribution: the innermost active ``with tracker.site("label")``
    (thread-local stack) owns events fired inside it; outside any site they
    land in ``"unattributed"``.  ``install()`` returns the singleton;
    everything downstream reads snapshot DELTAS, never absolute counts.
    ``mode`` is ``"builds"``: what the tracker listens to.
    """

    _instance: "CompileTracker | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self.n = 0
        self.loads = 0
        self.time_s = 0.0
        self.by_site: dict[str, dict[str, float]] = {}
        self.mode = "builds"
        self._tl = threading.local()
        self._mu = threading.Lock()
        self._tracer: Tracer | None = None

    @classmethod
    def install(cls) -> "CompileTracker":
        """The process singleton."""
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _record(self, kind: str, name: str, secs: float) -> None:
        stack = getattr(self._tl, "stack", None)
        site = stack[-1] if stack else "unattributed"
        with self._mu:
            if kind == "build":
                self.n += 1
            else:
                self.loads += 1
            self.time_s += secs
            s = self.by_site.setdefault(site, {"n": 0, "loads": 0, "time_s": 0.0})
            s["n" if kind == "build" else "loads"] += 1
            s["time_s"] += secs
        if self._tracer is not None:
            self._tracer.instant(
                f"library_{kind}", cat="compile", site=site, library=name,
                compile_time_s=round(secs, 6))

    @contextlib.contextmanager
    def site(self, label: str):
        """Attribute builds and loads inside the block to ``label`` (nested
        sites: innermost wins)."""
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        stack.append(str(label))
        try:
            yield
        finally:
            stack.pop()

    def bind(self, tracer: Tracer | None) -> None:
        """Mirror each build or load as a ``library_build`` /
        ``library_load`` instant into ``tracer`` (None unbinds).  One
        tracer at a time — the singleton serves whoever wired it last."""
        self._tracer = tracer

    def snapshot(self) -> dict:
        """Monotonic totals since install: ``{"n_compiled_programs",
        "n_loads", "compile_time_s", "by_site"}`` (strict JSON; a copy)."""
        with self._mu:
            return {
                "n_compiled_programs": self.n,
                "n_loads": self.loads,
                "compile_time_s": round(self.time_s, 6),
                "by_site": {
                    k: {"n": v["n"], "loads": v["loads"],
                        "time_s": round(v["time_s"], 6)}
                    for k, v in self.by_site.items()
                },
            }

    @staticmethod
    def delta(after: dict, before: dict) -> dict:
        """What was built or loaded BETWEEN two snapshots — the figure
        every consumer (ServingStats, the engine's prewarm) reports."""
        by_site: dict[str, dict] = {}
        b_sites = before.get("by_site", {})
        for site, v in after.get("by_site", {}).items():
            b = b_sites.get(site, {"n": 0, "loads": 0, "time_s": 0.0})
            dn, dl = v["n"] - b["n"], v["loads"] - b["loads"]
            if dn > 0 or dl > 0:
                by_site[site] = {"n": dn, "loads": dl,
                                 "time_s": round(v["time_s"] - b["time_s"], 6)}
        return {
            "n_compiled_programs": (
                after["n_compiled_programs"] - before["n_compiled_programs"]),
            "n_loads": after["n_loads"] - before["n_loads"],
            "compile_time_s": round(
                after["compile_time_s"] - before["compile_time_s"], 6),
            "by_site": by_site,
        }


def record_build(kind: str, name: str, secs: float) -> None:
    """One ``build`` (a compiler run) or ``load`` (a library loaded) of
    library ``name`` that took ``secs``, into the process tracker."""
    if kind not in ("build", "load"):
        raise ValueError(f"kind must be 'build' or 'load', got {kind!r}")
    CompileTracker.install()._record(kind, str(name), float(secs))


def compile_site(label: str):
    """Module-level convenience: ``with compile_site("eval"): ...``
    attributes builds without threading the tracker through call
    signatures.  Installs the singleton on first use."""
    return CompileTracker.install().site(label)
