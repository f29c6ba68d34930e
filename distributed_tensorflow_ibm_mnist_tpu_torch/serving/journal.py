"""Crash durability for the serving tier: the write-ahead request journal
(the port's copy of the JAX package's ``serving/journal.py``; the
records, their framing and the scan are JAX's, byte for byte).

Every durability guarantee the tier has without this module — replica
failover, the daemonized tier, the disaggregated handoff, the front
door — lives inside ONE process: a SIGKILL drops every queued, parked,
and in-flight request, and an HTTP client that retries after a
connection reset double-executes.  This module extends the repo's
signature exactly-once contract ACROSS the process boundary, the same
move the reference lineage makes for training (parameter-server
checkpoint recovery, PAPERS.md 1605.08695; TF-Replicator's point that
replication inside a job is not durability across job restarts,
1902.00465).

Three record types, appended write-ahead by :class:`~.daemon.
ServingDaemon` (wired via ``ServingDaemon(journal=...)``):

* ``admitted`` — the full request identity (prompt, ``max_new``,
  deadline, priority, SLOs, sampling params, idempotency key,
  fingerprint), written BEFORE the request enters the admission heap:
  an acknowledged submit is on disk before the caller hears "yes", so
  an accepted request can never be lost to a crash.  A raising append
  fails the submit — the caller never gets an ack the journal cannot
  back.
* ``delivered`` — the per-request delivered-token high-water mark,
  appended AFTER each token crosses to the caller.  The mark therefore
  never overstates what the client received: replay after a crash can
  re-emit a small suffix the client already has (closed client-side by
  SSE ``id:``/``Last-Event-ID`` stitching — frontend.py) but can never
  create a gap the client cannot fill.
* ``retired`` — the terminal verdict (done/cancelled/failed).  A
  request with no ``retired`` record is incomplete and gets replayed.

Why replay works: greedy and seeded-sampled streams are pure functions
of ``(prompt, max_new, SamplingParams)`` — the token at generated index
``n`` is picked with ``fold_in(base_key, n)`` (serving/sampling.py), so
a fresh tier re-derives the exact token stream and
``Router.submit(resume_from=...)`` suppresses the already-delivered
prefix through the SAME high-water wrapper that keeps failover replays
exactly-once (router.py).  Exactly-once ACROSS the crash, not just
across a replica.

On-disk format — segment-rotated JSONL, every line checksummed::

    <crc32 hex, 8 chars> <compact JSON payload>\n

Segments are ``journal-<n>.jsonl`` files in one directory, rotated at
``segment_bytes``; a writer never appends to a pre-existing segment (a
crashed process's torn tail stays exactly where the scan expects it —
at the end of a dead segment).  :func:`scan_journal` is torn-tail
tolerant the way ``restore_latest_intact`` is for checkpoints:
a record that fails to parse or checksum is dropped and counted
(``records_dropped``), a bad FINAL record of the FINAL segment is the
expected crash signature (``torn_tail``), and missing segment numbers
are surfaced (``segment_gaps``) — recovery proceeds on everything that
survived instead of refusing.

``fsync_policy`` prices durability explicitly.  At EVERY policy an
``admitted`` record is flushed to the kernel before the append returns
— that is the WAL ack contract (a SIGKILLed process cannot lose a
request it acknowledged).  ``delivered``/``retired`` marks are safe to
lose (replay re-emits the suffix and SSE ids dedup it; a lost retire
merely re-runs a finished request to the same tokens), so outside
``always`` they ride the userspace buffer until the next flush:

* ``"never"`` — no fsync, ever (admitted marks survive the process
  dying, nothing is promised against the host dying);
* ``"interval"`` (default) — a background syncer thread flushes and
  ``os.fsync``-s at most every ``fsync_interval_s`` seconds when dirty
  (group commit: bounded host-crash exposure, and the ~ms fsync never
  rides the serving path);
* ``"always"`` — flush + fsync every append (a database WAL).

Chaos: the ``journal-write`` site (utils/chaos.py) fires one event per
append.  ``kind="torn"`` writes a prefix of the encoded line and stops
(the crash-mid-write signature), ``kind="corrupt"`` flips one payload
byte (bit-rot), any other kind raises :class:`JournalWriteError` before
the write (a full disk).  All consultation is nil-guarded — a journal
built without an injector pays zero chaos instructions per append.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import SamplingParams

_SEG_PREFIX = "journal-"
_SEG_SUFFIX = ".jsonl"
FSYNC_POLICIES = ("never", "interval", "always")


class JournalWriteError(RuntimeError):
    """An append the journal could not land (I/O fault, chaos ``io``).

    On the ADMITTED path this propagates out of ``ServingDaemon.submit``
    — the caller is never acknowledged for a request the journal cannot
    back (the front door maps it to a 503).  On the delivered/retired
    paths the daemon counts it (``journal_errors``) and keeps serving:
    a sick journal degrades durability, never availability.
    """


def _segment_name(n: int) -> str:
    return f"{_SEG_PREFIX}{n:08d}{_SEG_SUFFIX}"


def _segment_index(name: str) -> int | None:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    digits = name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
    return int(digits) if digits.isdigit() else None


def _encode(rec: dict) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    data = payload.encode("utf-8")
    return b"%08x " % zlib.crc32(data) + data + b"\n"


class RequestJournal:
    """Append-only, checksummed, segment-rotated request journal.

    Thread-safe: one lock serializes append/rotate/close — the daemon
    appends from its submit callers AND its delivery thread.  ``stats()``
    is the overhead ledger an overhead gate reads (append count/bytes/
    seconds, fsyncs, rotations).
    """

    def __init__(self, directory: str, *,
                 fsync_policy: str = "interval",
                 fsync_interval_s: float = 0.05,
                 segment_bytes: int = 1 << 20,
                 chaos=None):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync_policy must be one of {FSYNC_POLICIES}, "
                f"got {fsync_policy!r}")
        if fsync_interval_s <= 0:
            raise ValueError(
                f"fsync_interval_s must be > 0, got {fsync_interval_s}")
        if segment_bytes < 1:
            raise ValueError(f"segment_bytes must be >= 1, got {segment_bytes}")
        self.directory = str(directory)
        self.fsync_policy = fsync_policy
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_bytes = int(segment_bytes)
        self._chaos = chaos
        os.makedirs(self.directory, exist_ok=True)
        # never reopen an existing segment: a previous process's torn
        # tail must stay at the end of ITS segment, where the scan's
        # torn-tail verdict expects it
        existing = [i for i in (_segment_index(n)
                                for n in os.listdir(self.directory))
                    if i is not None]
        self._seg_idx = (max(existing) + 1) if existing else 0
        self._lock = threading.Lock()
        self._fh = None
        self._seg_written = 0
        self._last_fsync = time.monotonic()
        self._closed = False
        self._stats = {"records": 0, "bytes": 0, "fsyncs": 0,
                       "rotations": 0, "append_s": 0.0, "errors": 0,
                       "chaos_torn": 0, "chaos_corrupt": 0,
                       "by_type": {"admitted": 0, "delivered": 0,
                                   "retired": 0}}
        # interval policy = group commit: appends only write + flush
        # (microseconds); a background syncer fsyncs every
        # fsync_interval_s WHEN dirty.  The durability contract is the
        # same — at most interval_s of exposure — but the ~1ms fsync
        # never rides the serving path, which is what keeps a
        # 2% overhead gate honest.
        self._dirty = False
        self._syncer = None
        if self.fsync_policy == "interval":
            self._syncer = threading.Thread(
                target=self._sync_loop, name="journal-syncer", daemon=True)
            self._syncer.start()

    # ------------------------------------------------------------------
    # write side

    def append(self, rec: dict) -> None:
        """Land one record (checksummed line) per the fsync policy.
        Raises :class:`JournalWriteError` on any failure to write.

        ``append_s`` accounting: this thread's CPU time plus the wall
        time of any I/O the append actually awaited (flush/fsync).
        Wall-clock over the whole call would bill the journal for GIL
        preemptions that land inside the span — scheduler noise an
        order of magnitude above the journal's own work — and the
        overhead gate would be measuring the scheduler.
        """
        t0 = time.thread_time()
        io_s = 0.0
        line = _encode(rec)
        with self._lock:
            if self._closed:
                raise JournalWriteError("journal is closed")
            torn = False
            if self._chaos is not None:          # nil-guarded, like every site
                event, spec = self._chaos.fire_event("journal-write")
                if spec is not None:
                    if spec.kind == "torn":
                        # crash-mid-write: a prefix lands, no newline —
                        # the scan must drop exactly this record
                        line = line[:max(1, len(line) // 2)]
                        torn = True
                        self._stats["chaos_torn"] += 1
                    elif spec.kind == "corrupt":
                        # bit-rot: full-length line, one payload byte
                        # flipped — the checksum must catch it
                        mid = len(line) // 2
                        line = (line[:mid]
                                + bytes([line[mid] ^ 0x01])
                                + line[mid + 1:])
                        self._stats["chaos_corrupt"] += 1
                    else:
                        self._stats["errors"] += 1
                        raise JournalWriteError(
                            f"chaos: injected {spec.kind!r} fault at site "
                            f"'journal-write' event {event}")
            try:
                if self._fh is None or self._seg_written >= self.segment_bytes:
                    self._rotate()
                self._fh.write(line)
                self._seg_written += len(line)
                self._dirty = True
                # flush discipline: `admitted` is the WAL ack contract —
                # it must reach the kernel before the submit returns, at
                # every policy.  delivered/retired marks are safe to
                # lose (replay re-emits, SSE ids dedup; a lost retire
                # re-runs a finished request to the same tokens), so
                # they ride the userspace buffer until the syncer, the
                # next admitted, a rotate, or close flushes them —
                # nothing but an 8-byte buffered write on the per-token
                # path.
                if self.fsync_policy == "always":
                    t_io = time.perf_counter()
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    io_s += time.perf_counter() - t_io
                    self._last_fsync = time.monotonic()
                    self._stats["fsyncs"] += 1
                    self._dirty = False
                elif rec.get("t") == "admitted":
                    t_io = time.perf_counter()
                    self._fh.flush()
                    io_s += time.perf_counter() - t_io
            except OSError as e:
                self._stats["errors"] += 1
                raise JournalWriteError(f"journal append failed: {e}") from e
            self._stats["records"] += 1
            self._stats["bytes"] += len(line)
            kind = rec.get("t")
            if kind in self._stats["by_type"]:
                self._stats["by_type"][kind] += 1
            self._stats["append_s"] += (time.thread_time() - t0) + io_s
            if torn:
                # the torn prefix has no newline: close the segment so
                # later appends (this process survived the "crash") land
                # in a fresh one instead of gluing onto the torn tail
                self._close_segment(sync=False)

    def _sync_loop(self) -> None:
        """Interval-policy background syncer: fsync when dirty, at most
        once per ``fsync_interval_s``.  Exits when the journal closes
        (close() does the final sync itself)."""
        while True:
            time.sleep(self.fsync_interval_s)
            with self._lock:
                if self._closed:
                    return
                if not self._dirty or self._fh is None:
                    continue
                # dup the fd so the ~ms fsync runs OUTSIDE the lock —
                # holding it would make some unlucky append pay the
                # fsync it was moved off-path to avoid (and the dup
                # survives a concurrent rotate closing the original)
                try:
                    self._fh.flush()   # buffered delivered/retired marks
                    fd = os.dup(self._fh.fileno())
                except OSError:
                    self._stats["errors"] += 1
                    continue
                self._dirty = False
            try:
                os.fsync(fd)
                with self._lock:
                    self._last_fsync = time.monotonic()
                    self._stats["fsyncs"] += 1
            except OSError:
                with self._lock:
                    self._dirty = True
                    self._stats["errors"] += 1
            finally:
                try:
                    os.close(fd)
                except OSError:
                    pass

    def _rotate(self) -> None:
        self._close_segment(sync=self.fsync_policy != "never")
        path = os.path.join(self.directory, _segment_name(self._seg_idx))
        self._seg_idx += 1
        self._fh = open(path, "ab")
        self._seg_written = 0
        self._stats["rotations"] += 1

    def _close_segment(self, sync: bool) -> None:
        if self._fh is None:
            return
        try:
            self._fh.flush()
            if sync:
                os.fsync(self._fh.fileno())
                self._stats["fsyncs"] += 1
        finally:
            self._fh.close()
            self._fh = None

    # convenience writers — the daemon's three journaling points

    def admitted(self, dr) -> None:
        """WAL the full identity of one :class:`~.daemon.DaemonRequest`
        (call BEFORE acknowledging the submit)."""
        self.append({
            "t": "admitted", "id": int(dr.id),
            "prompt": [int(t) for t in dr.prompt],
            "max_new": int(dr.max_new),
            "deadline_s": dr.deadline_s,
            "priority": int(dr.priority),
            "ttft_slo_s": dr.ttft_slo_s, "tpot_slo_s": dr.tpot_slo_s,
            "sampling": (dr.sampling.to_dict()
                         if dr.sampling is not None else None),
            "key": dr.idempotency_key,
            "fp": dr.fingerprint,
            "resume_from": int(dr.resume_from),
            # the W3C traceparent, so a post-crash replay CONTINUES the
            # request's distributed trace instead of starting a new one
            "tp": (dr.trace_ctx.to_traceparent()
                   if getattr(dr, "trace_ctx", None) is not None else None),
            "wall_t": time.time(),
        })

    def delivered(self, rid: int, n: int) -> None:
        """High-water: the client has been handed tokens ``[0, n)`` (in
        LOGICAL indices — a recovered request's count includes the
        suppressed prefix it resumed past)."""
        self.append({"t": "delivered", "id": int(rid), "n": int(n)})

    def retired(self, rid: int, status: str, error: str | None) -> None:
        self.append({"t": "retired", "id": int(rid), "status": str(status),
                     "error": error})

    def sync(self) -> None:
        """Force everything buffered onto the disk, regardless of policy."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._last_fsync = time.monotonic()
                self._stats["fsyncs"] += 1

    def close(self) -> None:
        """Flush + fsync + close the active segment.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._close_segment(sync=True)

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["by_type"] = dict(self._stats["by_type"])
            out["policy"] = self.fsync_policy
            out["segments"] = self._seg_idx
            return out


# ----------------------------------------------------------------------
# read side: the torn-tail-tolerant recovery scan


@dataclass
class JournalScan:
    """What survived on disk, folded into per-request state.

    ``requests`` maps request id -> ``{"meta": <admitted record>,
    "delivered": <logical high-water>, "retired": <status | None>}``.
    ``records_dropped`` counts lines that failed to parse or checksum
    (``torn_tail`` flags the expected crash signature: the bad record
    was the LAST line of the LAST segment); ``orphan_records`` counts
    delivered/retired records whose admitted record did not survive —
    nothing can be replayed for those, so they are surfaced, not
    silently absorbed.
    """

    directory: str
    requests: dict = field(default_factory=dict)
    records: int = 0
    records_dropped: int = 0
    torn_tail: bool = False
    orphan_records: int = 0
    segments: list = field(default_factory=list)
    segment_gaps: list = field(default_factory=list)

    def incomplete(self) -> list:
        """Admitted-but-never-retired request states, in id order — the
        replay set."""
        return [state for _rid, state in sorted(self.requests.items())
                if state["retired"] is None]

    def report(self) -> dict:
        retired = sum(1 for s in self.requests.values()
                      if s["retired"] is not None)
        return {
            "records": self.records,
            "journal_records_dropped": self.records_dropped,
            "torn_tail": self.torn_tail,
            "orphan_records": self.orphan_records,
            "segments": len(self.segments),
            "segment_gaps": list(self.segment_gaps),
            "requests": len(self.requests),
            "retired": retired,
            "incomplete": len(self.requests) - retired,
        }


def scan_journal(directory: str) -> JournalScan:
    """Read every segment, drop exactly what cannot be trusted.

    Tolerates: a torn final record (crash mid-append), bit-flipped
    checksums anywhere, empty segments, and missing segment numbers —
    each dropped record costs exactly itself, never the scan.
    """
    scan = JournalScan(directory=str(directory))
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return scan
    numbered = sorted((i, n) for i, n in
                      ((_segment_index(n), n) for n in names)
                      if i is not None)
    scan.segments = [n for _i, n in numbered]
    for prev, cur in zip(numbered, numbered[1:]):
        for missing in range(prev[0] + 1, cur[0]):
            scan.segment_gaps.append(_segment_name(missing))
    for seg_pos, (_idx, name) in enumerate(numbered):
        with open(os.path.join(directory, name), "rb") as fh:
            lines = fh.read().split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()   # trailing newline, not an empty record
        for line_pos, raw in enumerate(lines):
            rec = _decode(raw)
            if rec is None:
                scan.records_dropped += 1
                if (seg_pos == len(numbered) - 1
                        and line_pos == len(lines) - 1):
                    scan.torn_tail = True
                continue
            scan.records += 1
            _apply(scan, rec)
    return scan


def _decode(raw: bytes) -> dict | None:
    if len(raw) < 10 or raw[8:9] != b" ":
        return None
    try:
        if int(raw[:8], 16) != zlib.crc32(raw[9:]):
            return None
        rec = json.loads(raw[9:])
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def _apply(scan: JournalScan, rec: dict) -> None:
    kind, rid = rec.get("t"), rec.get("id")
    if not isinstance(rid, int):
        scan.records_dropped += 1
        scan.records -= 1
        return
    if kind == "admitted":
        scan.requests[rid] = {"meta": rec,
                              "delivered": int(rec.get("resume_from") or 0),
                              "retired": None}
    elif kind == "delivered":
        state = scan.requests.get(rid)
        if state is None:
            scan.orphan_records += 1
        else:
            state["delivered"] = max(state["delivered"], int(rec.get("n", 0)))
    elif kind == "retired":
        state = scan.requests.get(rid)
        if state is None:
            scan.orphan_records += 1
        else:
            state["retired"] = rec.get("status", "done")
    else:
        scan.orphan_records += 1


# ----------------------------------------------------------------------
# whole-process recovery


@dataclass
class RecoveredRequest:
    """One incomplete journal entry re-submitted into the fresh tier."""

    orig_id: int                 # id in the CRASHED process's journal
    dr: object                   # the fresh DaemonRequest serving it
    resume_from: int             # delivered high-water it resumed past
    idempotency_key: str | None


@dataclass
class Recovery:
    """The rebuilt tier plus the replay ledger.

    ``bindings`` seeds ``FrontDoor(idempotency_bindings=...)`` so a
    client's retried POST (same ``Idempotency-Key``) binds to the
    replayed request instead of double-executing — the cross-crash half
    of the front door's dedup table.
    """

    daemon: object
    scan: JournalScan
    requests: list
    bindings: dict

    def wait(self, timeout: float | None = None) -> bool:
        """Block until every replayed request is terminal."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for rec in self.requests:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not rec.dr.wait(left):
                return False
        return True

    def report(self) -> dict:
        out = self.scan.report()
        out["replayed"] = len(self.requests)
        out["rebound_keys"] = len(self.bindings)
        return out


def recover(journal, make_daemon: Callable, *, start: bool = True,
            resubmit_timeout_s: float = 60.0) -> Recovery:
    """Rebuild a serving tier from what the journal preserved.

    ``journal`` is a journal directory path (or a
    :class:`RequestJournal`, whose directory is used).  ``make_daemon``
    builds the fresh :class:`~.daemon.ServingDaemon` — wire a NEW
    journal into it (same directory is fine: segments are never
    reopened) and the re-admissions are re-journaled with their original
    idempotency keys, so recovery composes: a crash during recovery
    recovers.  The fresh daemon's id counter is bumped past every
    journaled id (no cross-generation collisions) and each crashed
    entry is closed with a ``retired(status="replayed")`` record the
    moment its replacement is admitted — the replay's own admitted
    record carries the request from there.

    Every admitted-but-not-retired request is re-submitted with its
    original identity and ``resume_from=<delivered high-water>``: the
    stream is a pure function of its seed (sampling.py), so the replay
    re-derives the exact tokens and the router's high-water wrapper
    suppresses the prefix the client already received.  Deadlines are
    re-anchored by wall-clock elapsed time (the journal stamps
    ``wall_t``): a request that lapsed while the process was dead is
    re-admitted already overdue and retires ``cancelled`` — counted,
    journaled, never silently dropped.
    """
    directory = (journal.directory if isinstance(journal, RequestJournal)
                 else str(journal))
    scan = scan_journal(directory)
    daemon = make_daemon()
    if scan.requests:
        # fresh ids must never collide with journaled ids: the replay's
        # own admitted/delivered/retired records would otherwise fold
        # into a DIFFERENT crashed request's state on the next scan
        daemon._ids = max(daemon._ids, max(scan.requests) + 1)
    if start and not daemon._started:
        daemon.start()
    requests: list[RecoveredRequest] = []
    bindings: dict[str, object] = {}
    now_wall = time.time()
    for state in scan.incomplete():
        meta = state["meta"]
        sampling = (SamplingParams.from_dict(meta["sampling"])
                    if meta.get("sampling") else None)
        deadline = meta.get("deadline_s")
        if deadline is not None:
            elapsed = max(0.0, now_wall - float(meta.get("wall_t", now_wall)))
            # 1e-9, not 0: an already-lapsed deadline must still ADMIT so
            # the dispatcher retires it down the normal cancelled path
            deadline = max(float(deadline) - elapsed, 1e-9)
        dr = _submit_with_retry(
            daemon, meta, sampling, deadline, state["delivered"],
            resubmit_timeout_s)
        if daemon._journal is not None:
            # close the crashed entry: its replay's OWN admitted record
            # (fresh id, resume_from baked in) now carries the request,
            # so a crash during recovery replays the replay, once
            try:
                daemon._journal.retired(
                    int(meta["id"]), "replayed",
                    f"resumed as request {dr.id}")
            except Exception:
                pass   # degraded durability must not abort recovery
        requests.append(RecoveredRequest(
            orig_id=int(meta["id"]), dr=dr,
            resume_from=int(state["delivered"]),
            idempotency_key=meta.get("key")))
        if meta.get("key"):
            bindings[meta["key"]] = dr
    return Recovery(daemon=daemon, scan=scan, requests=requests,
                    bindings=bindings)


def _submit_with_retry(daemon, meta, sampling, deadline, resume_from,
                       timeout_s: float):
    """Re-admit one journaled request, waiting out transient QueueFull
    (the replay set may exceed ``max_queue``; the dispatcher drains it)."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
        QueueFull,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import (
        TraceContext,
    )
    # the crashed process's traceparent: the replay CONTINUES that trace
    # (same trace id; this hop parents under the journaled span via the
    # parent_ctx hex edge in the merged export)
    trace_ctx = TraceContext.parse_traceparent(meta.get("tp"))
    give_up = time.monotonic() + timeout_s
    while True:
        try:
            return daemon.submit(
                meta["prompt"], meta["max_new"], deadline_s=deadline,
                priority=int(meta.get("priority") or 0),
                ttft_slo_s=meta.get("ttft_slo_s"),
                tpot_slo_s=meta.get("tpot_slo_s"),
                sampling=sampling,
                idempotency_key=meta.get("key"),
                resume_from=int(resume_from),
                trace_ctx=trace_ctx)
        except QueueFull:
            if time.monotonic() >= give_up:
                raise
            time.sleep(daemon.watchdog_interval_s)
