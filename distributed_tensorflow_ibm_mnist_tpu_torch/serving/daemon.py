"""The daemonized serving tier: a long-lived, thread-safe service front
(the port's copy of the JAX package's ``serving/daemon.py``).

The router is step-pumped — it only moves when a caller calls
:meth:`Router.step` — while a deployment is an always-on SERVICE absorbing
asynchronous traffic (TF-Replicator, PAPERS.md 1902.00465, is the pattern
reference for asynchronous replica orchestration).  :class:`ServingDaemon`
wraps a
:class:`~..serving.router.Router` in a small set of threads so callers
``submit()`` from anywhere and tokens stream back while they do.

Thread topology (N replicas → N+3 threads)::

    callers ──submit()──▶ admission heap ──dispatcher──▶ router._dispatch
                                                             │ tier lock
    pump[i] ──engine.step()──▶ token callbacks ──▶ delivery queue
                                                             │
    delivery ──▶ per-request stream queues + user callbacks (in order)
    watchdog ──▶ liveness / orphan retry / completions / telemetry

* **Pumps** — one per replica, each driving ONE engine's
  ``step()`` loop, preserving the engine's single-threaded contract
  (engine.py §Thread model).  A pump that sees ``step()`` raise fails
  its replica over under the tier lock (harvest + re-dispatch to
  siblings — exactly :meth:`Router.step`'s isolation, minus the shared
  iteration) and exits; sibling pumps never stall.
* **Dispatcher** — drains the admission heap in policy order
  (serving/policies.py) into :meth:`Router._dispatch` under the tier
  lock.  Router-level ``QueueFull`` is absorbed here (the request waits
  in admission); only the ADMISSION bound surfaces to callers, so
  backpressure stays end-to-end bounded.
* **Delivery** — the single thread that crosses tokens back to callers.
  Pumps enqueue ``(request, token)`` onto one FIFO queue as callbacks
  fire; since one request's tokens are produced by one pump in order,
  and a failover re-dispatches only after the dead attempt's callbacks
  have stopped (harvest holds the tier lock), FIFO delivery preserves
  PER-REQUEST order end to end — and the router's delivered high-water
  mark (router.py) keeps replayed failover prefixes suppressed, so
  streams stay exactly-once.  User callbacks run HERE, not on pumps: a
  raising callback is counted and isolated, never a pump casualty.
* **Watchdog** — the external liveness check ``stall_timeout_s`` cannot
  provide: the engine's watchdog is judged INSIDE ``step()``, so a pump
  wedged mid-step (or parked by ``daemon-pump`` chaos) never trips it.
  The watchdog reads :attr:`InferenceEngine.heartbeat_t` from outside:
  a HEALTHY replica with work whose heartbeat stays frozen past
  ``liveness_timeout_s`` is declared wedged and failed over.  It also
  pumps prefill→decode handoffs on disaggregated tiers (below), retries
  router orphans, scans for completions when no pump is alive to, and
  ticks ``telemetry.maybe_sample()``.

Disaggregation: on a role-typed tier the watchdog drains the
prefill replicas' outboxes each tick (``Router._pump_handoffs`` under the
tier lock).  Landing a packet mutates the DESTINATION engine, whose pump
thread may be mid-``step()`` — so each replica's engine carries a daemon
lock: pumps hold their replica's lock around ``step()``, and the handoff
pump holds the destination's around ``admit_prefilled`` (installed via
``Router._admit_guard``).  Outbox appends/pops themselves are CPython
atomic deque ops, so the SOURCE side needs no lock beyond the tier's.

Locking: ONE tier lock serializes every router-level mutation (dispatch,
failover harvest, orphan retry, close) — the router itself stays
lock-free single-threaded code (router.py §docstring).  ``engine.step()``
runs OUTSIDE the tier lock (pumping is the hot path; CPython's atomic
``deque.append``/``popleft`` make the scheduler's queue safe to pop
while the dispatcher appends — scheduler.py §Thread model).  Stats and
telemetry objects carry their own locks (stats.py, telemetry.py).

Chaos: the ``daemon-pump`` site (utils/chaos.py) fires one event per
pump-thread activation — a pump consults it the FIRST time it finds work
to serve.  ``kind="wedge"`` parks the pump with its heartbeat frozen
(exercising the watchdog → failover path); any other kind raises in the
pump loop (an engine-wide fault, failed over like a real one).  Chaos
stays deterministic under threads because every site's event counter is
its own lock-ordered sequence (chaos.py §Concurrency).

Durability: ``journal=`` wires a write-ahead request journal
(serving/journal.py).  Submit WALs the full request identity before the
caller is acknowledged, the delivery thread appends the delivered
high-water after each token crosses, and the terminal event appends the
verdict — ``journal.recover()`` rebuilds a fresh tier from those three
record streams after a SIGKILL, replaying every incomplete request with
its prefix suppressed (streams are pure functions of their seed, so the
replay is token-identical).  All journal touches are nil-guarded like
chaos/telemetry: an unjournaled daemon pays nothing.

Lifecycle: ``start()`` spawns the threads; ``drain(timeout)`` stops
admission, waits for in-flight work to finish, then joins everything;
``close()`` after a clean drain leaves ``tracer.open_spans == 0`` and
every KV pool at refcount zero (pinned in tests/test_torch_daemon.py).
Conservation is exact and exposed in :attr:`counters`::

    submitted == done + cancelled + failed + outstanding
    (+ rejected never entered the tier — raised back to the caller)
"""

from __future__ import annotations

import heapq
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.policies import (
    AdmissionPolicy,
    FIFOPolicy,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.replica import (
    DRAINING,
    FAILED,
    HEALTHY,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.router import (
    NoHealthyReplica,
    Router,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    QueueFull,
    request_fingerprint,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import ChaosFault

_END = "end"
_TOK = "tok"


class DaemonRequest:
    """Thread-safe caller handle for one logical request.

    ``tokens``/``status``/``error`` are safe to read from any thread;
    they settle once :meth:`wait` (or the ``end`` event in
    :meth:`ServingDaemon.stream`) returns.  ``priority`` orders the
    admission heap under :class:`~.policies.PriorityPolicy`.
    """

    def __init__(self, did: int, prompt, max_new: int, *,
                 deadline_s: float | None, submit_t: float,
                 callback: Callable | None, priority: int = 0,
                 ttft_slo_s: float | None = None,
                 tpot_slo_s: float | None = None, sampling=None,
                 idempotency_key: str | None = None, resume_from: int = 0,
                 trace_ctx=None):
        self.id = did
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.deadline_s = deadline_s
        self.submit_t = submit_t
        self.callback = callback        # runs on the DELIVERY thread
        self.priority = int(priority)
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.sampling = sampling
        # durability identity (serving/journal.py): the client's retry
        # key, the replay fingerprint the front door checks key reuse
        # against, and the delivered high-water this request resumed
        # past (0 for anything but a crash-recovered replay)
        self.idempotency_key = idempotency_key
        self.fingerprint: str | None = None
        self.resume_from = int(resume_from)
        # True when receipt is confirmed OUTSIDE the delivery callback
        # (the front door: tokens count as received only after the
        # drained socket write, which journals the high-water itself —
        # the delivery loop must not, or the mark would overstate)
        self.external_receipt = False
        # delivered-mark pacing (daemon-native requests): when the last
        # mark was journaled and at what logical length — submit() sets
        # the anchor so the first mark waits out a full interval
        self._hw_mark_t = 0.0
        self._hw_mark_n = 0
        # distributed tracing (utils/tracing.TraceContext): minted or
        # parsed at the front door, persisted in the journal's admitted
        # record, restored by recover() — the SAME trace id follows the
        # request across dispatch, failover, handoff, and crash replay
        self.trace_ctx = trace_ctx
        self._tspan: dict | None = None  # daemon-side span bookkeeping:
        #   {"root": daemon_request span, "admit": open admission-wait
        #   span or None, "tid": the request's daemon track}; None when
        #   untraced — every touch nil-guarded like the chaos hooks
        self.rr = None                  # RouterRequest once dispatched
        self.tokens: list[int] = []     # delivered tokens SINCE resume_from,
        #   in order (logical index of tokens[i] is resume_from + i)
        self.first_token_t: float | None = None
        # terminal state set by the daemon (delivery thread / close)
        self.final_status: str | None = None
        self.final_error: str | None = None
        self._events: queue.Queue = queue.Queue()   # stream() feed
        self._done = threading.Event()
        self._ended = False             # delivery-side end-once latch

    @property
    def status(self) -> str:
        if self.final_status is not None:
            return self.final_status
        return self.rr.status if self.rr is not None else "queued"

    @property
    def error(self) -> str | None:
        if self.final_error is not None:
            return self.final_error
        return self.rr.error if self.rr is not None else None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def overdue_at(self) -> float:
        return (np.inf if self.deadline_s is None
                else self.submit_t + self.deadline_s)

    @property
    def total_tokens(self) -> int:
        """LOGICAL stream length: the suppressed resumed prefix plus the
        tokens this process delivered — what the journal's delivered
        high-water and the SSE ``id:`` counter speak in."""
        return self.resume_from + len(self.tokens)

    def wait(self, timeout: float | None = None) -> bool:
        """Block until terminal (done/cancelled/failed); False on timeout."""
        return self._done.wait(timeout)


class ServingDaemon:
    """Own a :class:`Router` as a long-lived concurrent service.

    The router must be dedicated to this daemon once :meth:`start` runs
    (the daemon owns its pumping; callers go through :meth:`submit`).
    ``max_queue`` bounds the ADMISSION set — waiting + in-flight logical
    requests — and is the only bound callers see as :class:`QueueFull`.
    ``policy`` orders/sheds admission (default :class:`FIFOPolicy`).
    ``liveness_timeout_s`` is the watchdog's wedge deadline: a HEALTHY
    replica with work and a frozen heartbeat for this long fails over —
    set it above worst-case first-token latency (cold compiles!) or
    prewarm first.  ``chaos`` defaults to the router's injector.
    """

    def __init__(self, router: Router, *,
                 policy: AdmissionPolicy | None = None,
                 max_queue: int = 256,
                 liveness_timeout_s: float = 10.0,
                 watchdog_interval_s: float = 0.02,
                 idle_sleep_s: float = 0.0005,
                 telemetry=None, chaos=None, journal=None,
                 journal_hw_interval_s: float = 0.05):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if liveness_timeout_s <= 0:
            raise ValueError(
                f"liveness_timeout_s must be > 0, got {liveness_timeout_s}")
        if journal_hw_interval_s < 0:
            raise ValueError(
                f"journal_hw_interval_s must be >= 0, "
                f"got {journal_hw_interval_s}")
        self.router = router
        self.policy = policy if policy is not None else FIFOPolicy()
        self.max_queue = int(max_queue)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.idle_sleep_s = float(idle_sleep_s)
        self.clock = router.clock
        self._tracer = router._tracer
        self._chaos = chaos if chaos is not None else router._chaos
        self._telemetry = (telemetry if telemetry is not None
                           else router._telemetry)
        if self._telemetry is not None:
            self._telemetry.register_source("daemon", self._telemetry_vitals)
        # serving/journal.RequestJournal | None — the write-ahead request
        # journal (crash durability).  Nil-guarded like _chaos/_telemetry:
        # an unjournaled daemon pays zero instructions per submit/token.
        # Three journaling points: `admitted` WAL in submit() (before the
        # ack — a raising append fails the submit), `delivered` high-water
        # on the delivery thread AFTER each token crosses (the mark never
        # overstates what the client got), `retired` at the terminal
        # event.  The daemon owns the journal's lifecycle: close() syncs
        # and closes it, like it closes the router.
        self._journal = journal
        # delivered-mark pacing: a mark finer than the journal's flush
        # cadence adds ZERO durability — an unflushed mark does not
        # survive the crash either — so per-token marks just tax the
        # delivery thread.  Marks land at most every
        # journal_hw_interval_s per request (matched to the journal's
        # fsync_interval_s default), understating by at most one
        # interval of tokens: replay re-emits that suffix and SSE ids
        # dedup it.  The exact mark lands once, with the terminal.
        # 0 restores per-token marks.
        self.journal_hw_interval_s = float(journal_hw_interval_s)

        # the ONE lock for router-level mutations (module docstring)
        self._tier_lock = threading.RLock()
        # per-replica ENGINE locks (module docstring §Disaggregation):
        # a replica's pump holds its own around step(); the watchdog's
        # handoff pump holds the destination's around admit_prefilled.
        # Keyed by index — stable across respawns.
        self._engine_locks = {rep.index: threading.Lock()
                              for rep in router.replicas}
        router._admit_guard = lambda rep: self._engine_locks[rep.index]
        # admission: policy-ordered heap + its own condition variable
        self._adm_cv = threading.Condition()
        self._admission: list[tuple[tuple, DaemonRequest]] = []
        self._inflight: list[DaemonRequest] = []   # dispatched, not ended
        # popped by the dispatcher, not yet in _inflight nor ended: the
        # third place a counted request can be.  Every move between the
        # three, and every terminal count, happens under _adm_cv, so
        # conservation() is exact at every instant
        self._dispatching = 0
        self._delivery_q: queue.Queue = queue.Queue()
        self._ids = 0
        self._counts_lock = threading.Lock()
        self.counters = {"submitted": 0, "rejected": 0,
                         "rejected_with_hint": 0, "done": 0,
                         "cancelled": 0, "failed": 0,
                         "delivered_tokens": 0, "callback_errors": 0,
                         "pump_faults": 0, "pump_wedges": 0,
                         "journal_errors": 0}
        self._work_since: dict[int, float] = {}    # watchdog anchors
        self._threads: list[threading.Thread] = []
        self._started = False
        self._draining = False
        self._stop = threading.Event()
        self._closed = False

    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counters[name] += n

    def _reject(self, exc: QueueFull, queued: int) -> None:
        """Stamp the policy's backoff hint onto a rejection about to be
        raised and keep the books: ``rejected`` counts every rejection,
        ``rejected_with_hint`` the subset that carried a machine-readable
        estimate (the 429/503 Retry-After source).  Called under the
        admission lock — the depth the hint is computed at is exactly the
        depth the verdict was made at."""
        if getattr(exc, "retry_after_s", None) is None:
            try:
                exc.retry_after_s = self.policy.retry_after_s(queued)
            except Exception:
                exc.retry_after_s = None   # a sick policy never blocks a 429
        self._count("rejected")
        if exc.retry_after_s is not None:
            self._count("rejected_with_hint")

    # ------------------------------------------------------------------
    # caller API

    def submit(self, prompt, max_new: int, *, deadline_s: float | None = None,
               callback: Callable | None = None, priority: int = 0,
               ttft_slo_s: float | None = None,
               tpot_slo_s: float | None = None,
               sampling=None, idempotency_key: str | None = None,
               resume_from: int = 0, trace_ctx=None,
               trace_parent: int | None = None) -> DaemonRequest:
        """Thread-safe admission.  Raises :class:`QueueFull` at the
        admission bound, :class:`~.policies.SLOUnmeetable` when the
        policy sheds, ``RuntimeError`` after drain/close.  Every raised
        rejection carries ``retry_after_s`` — the policy's wait-predictor
        backoff hint (None when it has no basis), the machine-readable
        half of a 429/503 ``Retry-After`` header.  ``callback``
        (``cb(dr, tok)``) runs on the delivery thread, in stream order.

        ``idempotency_key`` rides into the journal so a recovered tier
        can rebind a client's retry; ``resume_from`` (crash recovery —
        serving/journal.py) suppresses the first ``resume_from`` tokens
        of the regenerated stream.  When a journal is wired, the
        ``admitted`` record lands BEFORE this method returns: a raising
        journal (:class:`~.journal.JournalWriteError`) means the request
        was never admitted — no ack without the WAL behind it.

        ``trace_ctx`` (utils/tracing.TraceContext) makes the request a
        member of a distributed trace: the daemon opens its own span
        lane, threads the context through the router to every engine
        attempt, and persists the traceparent in the journal's admitted
        record so a post-crash replay CONTINUES the same trace.
        ``trace_parent`` is the caller's span id in the shared tier
        tracer (the front door's http span) — the daemon span parents
        under it; when absent the daemon span records the context's
        ``parent_ctx`` hex edge instead, which is how a recovered
        process's spans join the original trace in a merged export."""
        if self._closed or self._draining:
            raise RuntimeError(
                "daemon is " + ("closed" if self._closed else "draining")
                + " — no new requests")
        if resume_from < 0:
            raise ValueError(f"resume_from must be >= 0, got {resume_from}")
        with self._adm_cv:
            # bound + policy verdict decided atomically with the insert,
            # so concurrent submitters cannot oversubscribe the bound
            queued = len(self._admission) + len(self._inflight)
            if queued >= self.max_queue:
                exc = QueueFull(
                    f"daemon admission queue at bound ({self.max_queue}) "
                    "— retry later or shed load")
                self._reject(exc, queued)
                raise exc
            try:
                dr_id = self._ids
                dr = DaemonRequest(dr_id, prompt, max_new,
                                   deadline_s=deadline_s,
                                   submit_t=self.clock(),
                                   callback=callback, priority=priority,
                                   ttft_slo_s=ttft_slo_s,
                                   tpot_slo_s=tpot_slo_s, sampling=sampling,
                                   idempotency_key=idempotency_key,
                                   resume_from=resume_from,
                                   trace_ctx=trace_ctx)
                self.policy.admit(dr, queued)
            except QueueFull as exc:
                self._reject(exc, queued)
                raise
            if self._journal is not None:
                # write-ahead: on disk before the caller hears "yes".  A
                # raising append propagates — the request was never
                # admitted, so nothing is lost and nothing is counted.
                dr.fingerprint = request_fingerprint(
                    dr.prompt, dr.max_new, dr.sampling)
                try:
                    self._journal.admitted(dr)
                except Exception:
                    self._count("journal_errors")
                    raise
                dr._hw_mark_t = self.clock()
            self._ids += 1
            if self._tracer is not None and trace_ctx is not None:
                # the request's daemon lane: root span for the whole
                # daemon-side lifetime, admit child for the admission
                # wait.  parent = the front door's span when the tracer
                # is shared; otherwise the W3C hex edge (parent_ctx)
                # joins this lane to the upstream span in a merged export
                ttid = self._tracer.track(f"dreq {dr.id}")
                kw = dict(trace=trace_ctx.trace_id,
                          sampled=trace_ctx.sampled, request=dr.id,
                          resume_from=resume_from)
                if trace_parent is None:
                    kw["parent_ctx"] = trace_ctx.span_id
                root = self._tracer.begin("daemon_request", cat="daemon",
                                          parent=trace_parent, tid=ttid,
                                          **kw)
                admit = self._tracer.begin("admit", cat="daemon",
                                           parent=root, tid=ttid)
                dr._tspan = {"root": root, "admit": admit, "tid": ttid}
            heapq.heappush(self._admission, (self.policy.key(dr), dr))
            self._count("submitted")
            self._adm_cv.notify()
        return dr

    def stream(self, dr: DaemonRequest,
               timeout: float | None = None) -> Iterator[int]:
        """Yield ``dr``'s tokens as they are delivered; returns at the
        terminal event.  ``timeout`` bounds the wait per event (raises
        ``queue.Empty`` — a liveness guard for tests)."""
        while True:
            kind, payload = dr._events.get(timeout=timeout)
            if kind == _TOK:
                yield payload
            else:
                return

    def cancel(self, dr: DaemonRequest,
               reason: str = "cancelled by caller") -> bool:
        """Cancel one request wherever it currently is (the front
        door's client-disconnect path).  Returns False when ``dr``
        is already terminal, True when cancellation was initiated.

        Still waiting in admission: removed from the heap and ended
        ``cancelled`` immediately (it holds nothing).  Already in the
        tier: :meth:`Router.cancel` forces its deadline clocks into the
        past under the tier lock, so the next pump sweep retires it down
        the lapsed-deadline path — slot freed, KV pages freed, tracer
        span closed — and :meth:`_scan_completions` delivers the
        terminal event.  Conservation stays exact: the request counts
        ``cancelled``, never dropped."""
        if dr.done:
            return False
        # force the daemon-level clock first: whatever in-between state
        # the dispatcher has the request in (popped but not dispatched,
        # requeued after transient backpressure), its next overdue check
        # cancels it — there is no unguarded window
        dr.deadline_s = -1e18
        with self._adm_cv:
            for i, (_key, queued_dr) in enumerate(self._admission):
                if queued_dr is dr:
                    del self._admission[i]
                    heapq.heapify(self._admission)
                    self._end_request(dr, "cancelled", reason)
                    return True
        with self._tier_lock:
            if dr.rr is not None and not dr.rr.done:
                self.router.cancel(dr.rr, reason=reason)
        return True

    @property
    def outstanding(self) -> int:
        with self._adm_cv:
            return (len(self._admission) + self._dispatching
                    + len(self._inflight))

    def conservation(self) -> dict:
        """The exact-accounting check: every submitted request is
        terminal or still in the tier, and nothing is double-counted.
        One snapshot under ``_adm_cv`` then ``_counts_lock`` (the order
        ``_reject`` already takes them in), so it holds at every instant."""
        with self._adm_cv:
            with self._counts_lock:
                c = dict(self.counters)
            c["outstanding"] = self.outstanding
        c["conserved"] = (c["submitted"] == c["done"] + c["cancelled"]
                          + c["failed"] + c["outstanding"])
        return c

    def summary(self) -> dict:
        """The service-level rollup: the router's cluster ``ServingStats``
        merge + router counters, with the daemon's front-door books
        (submitted/rejected/``rejected_with_hint``/conservation) folded in
        under ``"daemon"`` — rejections never reach engine stats (they
        never entered the tier), so this is where they surface."""
        out = self.router.summary()
        out["daemon"] = self.conservation()
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        return out

    # ------------------------------------------------------------------
    # elastic capacity: the autoscaler's seam.  All three are
    # thread-safe; scale-ups become dispatchable the moment they return.

    def add_replica(self, role: str = "both"):
        """Scale-up: append one fresh replica (warm: the kernels are
        already built and loaded in the process), give it an engine lock, and
        start its pump thread.  Returns the new
        :class:`~.replica.Replica`."""
        if self._closed:
            raise RuntimeError("daemon is closed")
        with self._tier_lock:
            rep = self.router.add_replica(role=role)
            self._engine_locks.setdefault(rep.index, threading.Lock())
        self._ensure_pump(rep)
        return rep

    def restart_replica(self, index: int) -> float:
        """Scale-up, warm path: respawn a retired (or failed) replica in
        place through :meth:`Router.restart` — no kernel build or library
        load runs again (``CompileTracker`` reads 0 and 0), which bounds the scale-up TTFT
        penalty — and start a fresh pump for it.  Returns the measured
        bring-up seconds (the autoscaler's TTFT-penalty bound)."""
        if self._closed:
            raise RuntimeError("daemon is closed")
        with self._tier_lock:
            spawn_s = self.router.restart(index)
            rep = self.router.replicas[index]
            self._engine_locks.setdefault(rep.index, threading.Lock())
        self._ensure_pump(rep)
        return spawn_s

    def retire_replica(self, index: int) -> bool:
        """Scale-down, zero-drop: begin the drain (no new dispatches; the
        pump keeps serving what is in flight).  The watchdog closes the
        replica once idle (:meth:`Router.finish_retires`) and its pump
        exits.  False when the router refuses (replica not HEALTHY, or
        it is the last prefill/decode-capable capacity)."""
        with self._tier_lock:
            return self.router.begin_retire(index)

    def _ensure_pump(self, rep) -> None:
        """Start a pump thread for ``rep`` unless a live one exists.
        Before :meth:`start` this is a no-op — start() pumps every
        replica then in ``router.replicas``, scale-ups included."""
        if not self._started or self._stop.is_set():
            return
        name = f"dtm-pump-{rep.index}"
        if any(t.name == name and t.is_alive() for t in self._threads):
            return
        t = threading.Thread(target=self._pump, args=(rep,),
                             name=name, daemon=True)
        self._threads.append(t)
        t.start()

    # ------------------------------------------------------------------
    # lifecycle

    def start(self) -> "ServingDaemon":
        if self._closed:
            raise RuntimeError("daemon is closed")
        if self._started:
            return self
        self._started = True
        for rep in self.router.replicas:
            t = threading.Thread(target=self._pump, args=(rep,),
                                 name=f"dtm-pump-{rep.index}", daemon=True)
            self._threads.append(t)
        self._threads.append(threading.Thread(
            target=self._dispatch_loop, name="dtm-dispatch", daemon=True))
        self._threads.append(threading.Thread(
            target=self._watchdog_loop, name="dtm-watchdog", daemon=True))
        self._delivery_thread = threading.Thread(
            target=self._delivery_loop, name="dtm-delivery", daemon=True)
        for t in self._threads:
            t.start()
        self._delivery_thread.start()
        return self

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission, serve everything in flight, join the threads.
        Returns True when the tier drained clean within ``timeout``
        (False = work remained; :meth:`close` will cancel it)."""
        self._draining = True
        deadline = None if timeout is None else self.clock() + timeout
        clean = True
        while self.outstanding > 0:
            if deadline is not None and self.clock() > deadline:
                clean = False
                break
            if not self._live_pumps() and not self.router.healthy():
                clean = self.outstanding == 0   # dead tier: nothing will move
                break
            time.sleep(self.watchdog_interval_s)
        self._shutdown_threads()
        return clean and self.outstanding == 0

    def close(self) -> None:
        """Stop everything, cancel whatever :meth:`drain` left, close the
        router.  Idempotent; safe without a prior drain."""
        if self._closed:
            return
        self._draining = True
        self._shutdown_threads()
        self._closed = True
        with self._adm_cv:
            leftovers = [dr for _, dr in self._admission] + list(self._inflight)
            self._admission.clear()
            self._inflight.clear()
            leftovers = [dr for dr in leftovers if not dr._done.is_set()]
            for dr in leftovers:
                dr.final_status = "cancelled"
                dr.final_error = "daemon closed with request outstanding"
                self._count("cancelled")
        for dr in leftovers:
            if self._journal is not None:
                # leftovers bypass the delivery queue (it is already
                # joined) — journal their terminal verdict here so a
                # clean close leaves zero incomplete entries
                try:
                    self._journal.retired(dr.id, "cancelled",
                                          dr.final_error)
                except Exception:
                    self._count("journal_errors")
            self._tr_close_dr(dr, "cancelled")
            dr._events.put((_END, "cancelled"))
            dr._done.set()
        with self._tier_lock:
            self.router.close()
        if self._journal is not None:
            try:
                self._journal.close()   # final flush + fsync
            except Exception:
                self._count("journal_errors")
        if self._telemetry is not None:
            self._telemetry.unregister_source("daemon")

    def __enter__(self) -> "ServingDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _shutdown_threads(self) -> None:
        if not self._started or self._stop.is_set():
            self._stop.set()
            return
        self._stop.set()
        with self._adm_cv:
            self._adm_cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        # pumps are joined: no further token enqueues — the sentinel
        # lands after every token already delivered, so the delivery
        # thread drains the queue completely before exiting
        self._delivery_q.put(None)
        self._delivery_thread.join(timeout=5.0)
        self._scan_completions()   # finalize anything the pumps raced

    # ------------------------------------------------------------------
    # pump threads

    def _pump(self, rep) -> None:
        consulted = False
        while not self._stop.is_set():
            if rep.state == FAILED or not rep.alive:
                return
            if not rep.engine.has_work:
                if self._draining and self.outstanding == 0:
                    return
                time.sleep(self.idle_sleep_s)
                continue
            if not consulted and self._chaos is not None:
                # one daemon-pump event per pump activation, consulted
                # the FIRST time this pump finds work (mid-wave by
                # construction; chaos.py docstring)
                consulted = True
                event, spec = self._chaos.fire_event("daemon-pump")
                if spec is not None:
                    if spec.kind == "wedge":
                        self._count("pump_wedges")
                        self._park_wedged(rep)
                        return
                    self._fail_from_pump(
                        rep, ChaosFault("daemon-pump", spec.kind, event))
                    return
            try:
                with self._engine_locks[rep.index]:
                    # re-check under the engine lock: finish_retires()
                    # closes a drained replica's engine under this same
                    # lock, so a pump that raced the idle check must see
                    # the terminal state here, never step a closed engine
                    if rep.state == FAILED or not rep.alive:
                        return
                    rep.engine.step()
            except Exception as e:
                self._fail_from_pump(rep, e)
                return
            self._scan_completions()

    def _park_wedged(self, rep) -> None:
        """Chaos ``kind="wedge"``: stop stepping but stay alive, heartbeat
        frozen — exactly what a pump stuck in a hung device call looks
        like from outside.  The watchdog must notice and fail the replica
        over; the parked thread exits once it does (or on shutdown)."""
        if self._tracer is not None:
            self._tracer.instant("pump_wedged", cat="daemon", tid=rep.tid,
                                 replica=rep.index)
        while not self._stop.is_set() and rep.state != FAILED:
            time.sleep(self.idle_sleep_s)

    def _fail_from_pump(self, rep, exc: BaseException) -> None:
        self._count("pump_faults")
        with self._tier_lock:
            if rep.state != FAILED:
                try:
                    self.router._fail_replica(rep, exc)
                except Exception:
                    pass   # replica already marked FAILED (first statement)
        self._scan_completions()

    def _live_pumps(self) -> int:
        return sum(t.is_alive() for t in self._threads
                   if t.name.startswith("dtm-pump-"))

    # ------------------------------------------------------------------
    # dispatcher thread

    def _dispatch_loop(self) -> None:
        while True:
            with self._adm_cv:
                while not self._admission and not self._stop.is_set():
                    self._adm_cv.wait(timeout=0.05)
                if self._stop.is_set() and not self._admission:
                    return
                key, dr = heapq.heappop(self._admission)
                self._dispatching += 1
            if self._stop.is_set() and self._closed:
                self._end_request(dr, "cancelled",
                                  "daemon closed with request outstanding",
                                  dispatching=True)
                return
            requeue = False
            with self._tier_lock:
                if self.clock() > dr.overdue_at:
                    self._end_request(dr, "cancelled",
                                      "deadline lapsed in admission queue",
                                      dispatching=True)
                    continue
                remaining = (None if dr.deadline_s is None
                             else dr.overdue_at - self.clock())
                try:
                    rr = self.router.submit(
                        dr.prompt, dr.max_new, deadline_s=remaining,
                        callback=self._delivery_cb(dr),
                        ttft_slo_s=dr.ttft_slo_s, tpot_slo_s=dr.tpot_slo_s,
                        sampling=dr.sampling, resume_from=dr.resume_from,
                        trace_ctx=dr.trace_ctx,
                        trace_parent=(dr._tspan["root"]
                                      if dr._tspan is not None else None))
                except QueueFull:
                    requeue = True   # transient: wait in admission
                except NoHealthyReplica:
                    if not self.router.healthy():
                        self._end_request(dr, "failed",
                                          "no healthy replica remained",
                                          dispatching=True)
                        continue
                    requeue = True
                except RuntimeError as e:   # router closed under us
                    self._end_request(dr, "failed", str(e),
                                      dispatching=True)
                    continue
                else:
                    dr.rr = rr
                    if self._tracer is not None and dr._tspan is not None \
                            and dr._tspan.get("admit") is not None:
                        self._tracer.end(dr._tspan["admit"])
                        dr._tspan["admit"] = None
                    with self._adm_cv:
                        self._dispatching -= 1
                        self._inflight.append(dr)
            if requeue:
                with self._adm_cv:
                    self._dispatching -= 1
                    heapq.heappush(self._admission, (key, dr))
                time.sleep(self.idle_sleep_s)   # let pumps free slots

    # ------------------------------------------------------------------
    # delivery thread

    def _delivery_cb(self, dr: DaemonRequest) -> Callable:
        def _cb(_rr, tok):
            # pump thread → FIFO queue; the router's high-water wrapper
            # already suppressed replayed failover prefixes before us
            self._delivery_q.put((_TOK, dr, int(tok)))
        return _cb

    def _delivery_loop(self) -> None:
        while True:
            item = self._delivery_q.get()
            if item is None:
                return
            kind, dr, payload = item
            if kind == _TOK:
                if dr._ended:
                    continue   # post-terminal stragglers are dropped
                if dr.first_token_t is None:
                    dr.first_token_t = self.clock()
                    try:
                        self.policy.note_first_token(
                            dr.first_token_t - dr.submit_t)
                    except Exception:
                        pass
                dr.tokens.append(payload)
                self._count("delivered_tokens")
                dr._events.put((_TOK, payload))
                if dr.callback is not None:
                    try:
                        dr.callback(dr, payload)
                    except Exception:
                        # a sick user callback must not kill delivery
                        self._count("callback_errors")
                if (self._journal is not None and not dr.external_receipt
                        and self.clock() - dr._hw_mark_t
                        >= self.journal_hw_interval_s):
                    # high-water AFTER the token crossed: the mark may
                    # UNDERstate what the client holds (crash in the
                    # seam, or the up-to-one-interval of tokens since
                    # the last paced mark → a few replayed tokens,
                    # deduped client-side by their SSE ids) but never
                    # overstates — replay can re-emit, it can never
                    # leave a gap.  A sick journal is counted, never a
                    # delivery casualty.  For front-door requests
                    # (external_receipt) the callback only ENQUEUES to
                    # the event loop — marking here would overstate, so
                    # the front door journals after each drained socket
                    # write instead (frontend.py).
                    dr._hw_mark_t = self.clock()
                    dr._hw_mark_n = dr.total_tokens
                    try:
                        self._journal.delivered(dr.id, dr.total_tokens)
                    except Exception:
                        self._count("journal_errors")
            else:
                if not dr._ended:
                    dr._ended = True
                    if self._journal is not None:
                        try:
                            if (not dr.external_receipt
                                    and dr.total_tokens > 0
                                    and dr.total_tokens != dr._hw_mark_n):
                                # the exact mark the pacing skipped — a
                                # cleanly-retired request always
                                # journals delivered == total
                                self._journal.delivered(
                                    dr.id, dr.total_tokens)
                            self._journal.retired(dr.id, payload, dr.error)
                        except Exception:
                            self._count("journal_errors")
                    self._tr_close_dr(dr, payload)
                    dr._events.put((_END, payload))
                    dr._done.set()

    def _tr_close_dr(self, dr: DaemonRequest, status: str) -> None:
        """Close the request's daemon spans at its terminal event —
        stamping the tail-keep signals (status / error / slo_miss /
        redispatch count) the export-time sampler reads."""
        if self._tracer is None or dr._tspan is None:
            return
        t, dr._tspan = dr._tspan, None
        if t.get("admit") is not None:
            self._tracer.end(t["admit"])
        kw: dict = {"status": status}
        error = dr.final_error if dr.final_error is not None else (
            dr.rr.error if dr.rr is not None else None)
        if error is not None:
            kw["error"] = error
        rr = dr.rr
        req = rr.req if rr is not None else None
        if req is not None and (req.slo_ttft_ok is False
                                or req.slo_tpot_ok is False):
            kw["slo_miss"] = True
        if rr is not None and rr.redispatches:
            kw["redispatches"] = rr.redispatches
        self._tracer.end(t["root"], **kw)

    def _end_request(self, dr: DaemonRequest, status: str,
                     error: str | None, *, dispatching: bool = False) -> None:
        """Terminal verdict for a request the ROUTER never finished (or
        never saw).  Counted once, in the same ``_adm_cv`` section that
        takes it out of the dispatcher's hands (``dispatching``) or that
        the caller removed it from admission in; the end event rides the
        delivery queue so it lands after any tokens already enqueued."""
        if dr.final_status is None and (dr.rr is None or not dr.rr.done):
            dr.final_status = status
            dr.final_error = error
        with self._adm_cv:
            if dispatching:
                self._dispatching -= 1
            self._count(status if status in ("done", "cancelled", "failed")
                        else "failed")
        self._delivery_q.put((_END, dr, status))

    def _scan_completions(self) -> None:
        """Move router-terminal requests out of ``_inflight`` and enqueue
        their end events.  Runs on pumps and the watchdog; the claim and the terminal
        count are made in one admission-lock section, so each request
        ends exactly once and is never uncounted in between."""
        ended: list[tuple[DaemonRequest, str]] = []
        with self._adm_cv:
            still: list[DaemonRequest] = []
            for dr in self._inflight:
                rr = dr.rr
                if rr is not None and rr.done:
                    ended.append((dr, dr.status))
                else:
                    still.append(dr)
            self._inflight[:] = still
            for dr, status in ended:
                self._count(status if status in ("done", "cancelled",
                                                 "failed") else "failed")
        for dr, status in ended:
            self._delivery_q.put((_END, dr, status))

    # ------------------------------------------------------------------
    # watchdog thread

    def _watchdog_loop(self) -> None:
        while not self._stop.is_set():
            self._scan_completions()
            with self._tier_lock:
                try:
                    self.router._pump_handoffs()
                except Exception:
                    pass   # a sick handoff pump must not kill the watchdog
                if self.router._retiring:
                    try:
                        self.router.finish_retires()
                    except Exception:
                        pass
                if self.router._orphans:
                    try:
                        self.router._retry_orphans()
                    except Exception:
                        pass
            self._check_liveness()
            if self._telemetry is not None:
                try:
                    self._telemetry.maybe_sample()
                except Exception:
                    pass
            self._stop.wait(self.watchdog_interval_s)

    def _check_liveness(self) -> None:
        """The external wedge detector (module docstring): a HEALTHY
        replica with work whose heartbeat has not moved for
        ``liveness_timeout_s`` — judged from OUTSIDE ``step()`` — is
        failed over even though its pump never returns."""
        now = self.clock()
        for rep in self.router.replicas:
            # retiring drains are watched too: a replica that wedges with
            # work mid-retire would stall the scale-down forever — failing
            # it over instead harvests its in-flight work (still zero-drop)
            watched = (rep.state == HEALTHY
                       or (rep.state == DRAINING
                           and rep.index in self.router._retiring))
            if not watched or not rep.alive:
                self._work_since.pop(rep.index, None)
                continue
            if not rep.engine.has_work:
                self._work_since.pop(rep.index, None)
                continue
            anchor = self._work_since.setdefault(rep.index, now)
            hb = rep.engine.heartbeat_t
            last = anchor if hb is None else max(hb, anchor)
            if now - last <= self.liveness_timeout_s:
                continue
            if self._tracer is not None:
                self._tracer.instant(
                    "pump_wedge_detected", cat="daemon", tid=rep.tid,
                    replica=rep.index,
                    frozen_s=round(now - last, 6))
            self._work_since.pop(rep.index, None)
            with self._tier_lock:
                if rep.state in (HEALTHY, DRAINING):
                    try:
                        self.router._fail_replica(rep, RuntimeError(
                            f"pump wedged: no progress for "
                            f"{now - last:.3f}s with work in flight"))
                    except Exception:
                        pass
            self._scan_completions()

    # ------------------------------------------------------------------
    # telemetry

    def _telemetry_vitals(self) -> dict:
        with self._adm_cv:
            with self._counts_lock:
                c = dict(self.counters)
            admission = len(self._admission)
            inflight = self._dispatching + len(self._inflight)
        return {
            "policy": self.policy.name,
            "admission_depth": admission,
            "inflight": inflight,
            "live_pumps": self._live_pumps(),
            "draining": self._draining,
            **c,
        }
