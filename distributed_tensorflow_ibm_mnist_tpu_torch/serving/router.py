"""Multi-replica serving tier: least-loaded routing, failover, hot swap
(the port's copy of the JAX package's ``serving/router.py``).

One :class:`~.engine.InferenceEngine` is a single failure domain and a
single weight version.  Serving traffic needs N of them — and the moment there are N, three problems exist that the single-engine
contract never had to answer: WHERE does a request go (routing), what
happens to accepted work when a replica dies (failover), and how do
serving weights track a trainer that never stops (hot swap).  This module
is that layer — the TF-Replicator / TensorFlow-paper separation of cluster
topology from the step function (PAPERS.md), applied one level above the
engine: the engine multiplexes requests over slots; the router multiplexes
REPLICAS over failures and weight versions.

Routing — :meth:`Router.submit` picks the HEALTHY replica with the lowest
live load score (queued + parked + occupied requests, KV-pool fraction as
tiebreak — serving/replica.py); per-replica bounded queues still raise
``QueueFull`` when EVERY candidate is saturated (backpressure surfaces,
never buffers unboundedly).

Failover — when a replica raises an engine-wide fault (EngineStalled, a
decode fault with no watchdog) or flunks its health probe, the router
closes it and harvests exactly the requests the ENGINE gave up on:
``Request.engine_fault`` marks terminal states that are collateral of the
engine-wide fault (failed in-flight rows, close-cancelled queued/parked
work) as opposed to a request's OWN failure (poisoned prompt, raising
callback, lapsed deadline) — own failures stay failed, exactly the
single-engine isolation contract.  Collateral requests re-dispatch to
survivors with the failed replica excluded (the ``excluded``-set retry
pattern) and their REMAINING deadline recomputed.  A re-dispatched request
regenerates from token zero — decode is deterministic per request (greedy
by construction; sampled because a stream is a pure function of its
``SamplingParams`` seed, serving/sampling.py), so the replayed prefix is
token-identical and the per-request delivered-token high-water mark turns
at-most-once delivery per attempt into exactly-once delivery per TOKEN
across attempts, greedy and sampled alike.

Hot swap — :class:`WeightWatcher` polls the trainer's checkpoint directory
on its OWN read-only :class:`~..utils.checkpoint.CheckpointManager` (its
``restore_latest_intact`` waits on ITS manager's in-flight saves — none —
so polling can never block the trainer's save pipeline) and validates new
steps through the full intact-walk (torn newest step → previous intact
one), on the port's checkpoint format.  A validated step swaps into replicas ONE at a time: drain (stop
dispatching to the replica, keep pumping it until idle while the others
absorb traffic) → ``engine.swap_params`` (stale prefix/radix caches
dropped) → re-admit.  Zero requests drop by construction: draining never
cancels, and N−1 replicas keep serving throughout.

Disaggregation (``roles=``: prefill/decode-typed replicas and the KV
handoff between them) is ROADMAP.md queue 1 item 6, sub-slice 5; the port
refuses it.

Chaos sites (utils/chaos.py): ``router-dispatch`` fires once per
router→replica dispatch attempt — a hit excludes that replica for THAT
request and retries the next-best survivor; ``weight-swap`` fires once per
swap attempt after the drain and before the params replacement — a hit
re-admits the replica on its OLD weights (the swap is all-or-nothing) and
the watcher retries at the next poll.  Both follow the engine's nil-guard
pattern: zero chaos instructions when unwired.

Tracing: all replicas share ONE tracer; each gets its own track
(``replica <i>``), so N host loops render as N lanes, with
``replica_failed`` / ``failover_redispatch`` / ``weight_swap`` instants on
the lane they happened to.  The router itself is single-threaded like the
engine — one thread calls submit/step/close — and that is still how the
step-pumped benchmarks drive it.  The daemonized tier
(serving/daemon.py) is the concurrency seam: it serializes every
router-level mutation (submit/dispatch, failover, orphan retry) under
its tier lock and gives each replica its own pump thread, so the router
never needs internal locks of its own.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.engine import EngineStalled
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.replica import (
    DRAINING,
    FAILED,
    HEALTHY,
    Replica,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import QueueFull, Request
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import ServingStats


class NoHealthyReplica(RuntimeError):
    """Every replica is FAILED/DRAINING (or excluded for this request) —
    the router cannot place work.  Distinct from :class:`QueueFull`
    (healthy replicas exist but all their queues are at bound)."""


class RouterRequest:
    """One LOGICAL request across however many engine attempts it takes.

    The router owns the identity; each dispatch creates a fresh engine
    :class:`Request` (the attempt).  ``status``/``generated``/``error``
    delegate to the CURRENT attempt, so a failed-over request reads like
    any other once its retry completes.  ``delivered`` is the streaming
    high-water mark: attempt-local token counts below it are replayed
    prefix (suppressed), above it are new tokens (delivered once).
    """

    def __init__(self, rid: int, tokens, max_new: int,
                 deadline_s: float | None, submit_t: float,
                 callback: Callable | None,
                 ttft_slo_s: float | None = None,
                 tpot_slo_s: float | None = None,
                 sampling=None, trace_ctx=None, trace_parent: int | None = None):
        self.id = rid
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.deadline_s = deadline_s      # relative to submit_t, like Request
        self.submit_t = submit_t          # router clock at FIRST dispatch
        self.callback = callback          # the USER's hook; router wraps it
        # per-request SamplingParams, identical on every attempt — the
        # seed makes a failover replay token-identical, which is what
        # keeps the delivered high-water mark exactly-once for SAMPLED
        # streams too (module docstring)
        self.sampling = sampling
        # SLO targets ride along to every attempt's engine Request.  The
        # SLO clock is PER-ATTEMPT (each attempt's submit_t), matching
        # deadline_s semantics: a failed-over attempt is judged on its own
        # service time, and the failover cost itself shows up as the dead
        # attempt's miss in the merged slo_miss counter
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.req: Request | None = None   # current engine attempt
        self.replica: int | None = None   # current attempt's replica index
        self.attempts: list[tuple[int, Request]] = []
        self.excluded: set[int] = set()   # replicas barred for THIS request
        self.redispatches = 0
        # cross-attempt delivery high-water: a failover retry regenerates
        # the stream from scratch (a pure function of the seed), and the
        # wrapper below suppresses everything at or below the mark
        self.delivered = 0
        self._attempt_delivered = 0       # tokens seen in the CURRENT attempt
        # router-level terminal override: set when the ROUTER ends the
        # request (deadline lapsed between attempts, no replica left)
        self.final_status: str | None = None
        self.final_error: str | None = None
        # distributed tracing: the W3C TraceContext this request carries
        # (None for untraced callers) and the span id — in the SHARED
        # tier tracer — that each attempt's engine span should parent
        # under (the daemon's per-request root).  ``_last_attempt_span``
        # is the previous attempt's engine span id: a failover replay
        # attaches it as a span LINK, so the replay reads as a
        # continuation of the original attempt, not a silent restart.
        self.trace_ctx = trace_ctx
        self.trace_parent = trace_parent
        self._last_attempt_span: int | None = None

    @property
    def status(self) -> str:
        if self.final_status is not None:
            return self.final_status
        return self.req.status if self.req is not None else "queued"

    @property
    def generated(self) -> list[int]:
        return self.req.generated if self.req is not None else []

    @property
    def logprobs(self) -> list[float]:
        return self.req.logprobs if self.req is not None else []

    @property
    def error(self) -> str | None:
        if self.final_error is not None:
            return self.final_error
        return self.req.error if self.req is not None else None

    @property
    def done(self) -> bool:
        """Terminal at the ROUTER level: a terminal engine status only
        counts once the router has decided not to re-dispatch it (an
        engine_fault casualty is terminal for the ATTEMPT, transit for the
        request — the failover harvest resolves it synchronously)."""
        if self.final_status is not None:
            return True
        return (self.req is not None and not self.req.engine_fault
                and self.req.status in ("done", "cancelled", "failed"))

    @property
    def overdue_at(self) -> float:
        return (np.inf if self.deadline_s is None
                else self.submit_t + self.deadline_s)


class Router:
    """Front N engine replicas: see the module docstring.

    ``make_engine(trace_tid)`` is the replica factory (serving/replica.py
    — pass ``trace_tid`` and this router's ``tracer``/``telemetry`` to the
    engine, share this router's ``clock`` for deadline coherence, leave
    ``writer=`` unset).  A two-parameter factory ``make_engine(trace_tid,
    replica_index)`` lets replica ``i`` pick its own device.
    ``probe=`` optionally layers a policy health check (``probe(replica)
    -> bool``) over the structural one; a False verdict fails the replica
    exactly like an engine-wide fault.  ``max_drain_steps`` bounds how
    long a hot-swap drain may pump before giving up (the replica re-admits
    on its old weights — never a hang, never a drop).
    """

    def __init__(self, make_engine: Callable, n_replicas: int, *,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None, tracer=None, writer=None,
                 probe: Callable | None = None,
                 max_drain_steps: int = 10_000,
                 telemetry=None, roles: list | None = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if roles is not None:
            raise NotImplementedError(
                "Router(roles=...) (disaggregated prefill/decode replicas) is "
                "not in the PyTorch port yet: ROADMAP.md queue 1, item 6, "
                "sub-slice 5 (disaggregation)")
        self.clock = clock
        self._chaos = chaos
        self._tracer = tracer
        # utils/telemetry.Telemetry | None, nil-guarded like _chaos.  The
        # router's source reports cluster state + per-replica vitals
        # (state/load/heartbeat — serving/replica.Replica.vitals); wire
        # the SAME object into the factory's engines for per-engine
        # queue/pool vitals alongside
        self._telemetry = telemetry
        if telemetry is not None:
            telemetry.register_source("router", self._telemetry_vitals)
        self.writer = writer
        self._probe = probe
        self.max_drain_steps = int(max_drain_steps)
        self.tid = tracer.track("router") if tracer is not None else 0
        self.replicas = [Replica(i, make_engine, tracer=tracer)
                         for i in range(n_replicas)]
        for rep in self.replicas:
            rep.spawn()
        # the record keeps JAX's handoff counters; no replica hands off
        self.handoffs = 0
        self.handoff_faults = 0
        self._ids = itertools.count()
        self.requests: list[RouterRequest] = []   # submit order, forever
        # engine Request (by object identity) -> owning RouterRequest: the
        # failover harvest walks a dead engine's completed list and needs
        # the logical request each casualty belongs to
        self._owner: dict[int, RouterRequest] = {}
        # accepted-then-unplaceable requests (failover raced a full/absent
        # survivor): re-dispatched every step until they land or lapse —
        # the zero-drop guarantee under transient backpressure
        self._orphans: list[RouterRequest] = []
        self.failovers = 0   # replicas failed over
        # scale-down arrives with the autoscaler (ROADMAP.md queue 1, item
        # 6, sub-slice 4); the record keeps JAX's key
        self.retires = 0
        self.scale_ups = 0   # replicas restarted
        self.swapped_steps: list[int] = []  # checkpoint steps hot-swapped in
        # the newest (params, step) any hot_swap delivered: a restarted
        # replica re-applies these — the factory rebuilds on its ORIGINAL
        # params, which are stale the moment a swap has happened
        self._current_weights: tuple | None = None
        self._closed = False

    # ------------------------------------------------------------------
    # dispatch

    def healthy(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == HEALTHY and r.alive]

    def submit(self, prompt, max_new: int, deadline_s: float | None = None,
               callback: Callable | None = None,
               ttft_slo_s: float | None = None,
               tpot_slo_s: float | None = None,
               sampling=None, trace_ctx=None, trace_parent: int | None = None
               ) -> RouterRequest:
        """Place one request on the least-loaded healthy replica.  Raises
        :class:`NoHealthyReplica` when no replica can be tried and
        :class:`QueueFull` when every healthy replica's queue is at bound
        (backpressure — the caller sheds or retries, as with one engine).
        ``ttft_slo_s``/``tpot_slo_s`` ride to every attempt (see
        :class:`RouterRequest` for the per-attempt clock semantics);
        ``sampling`` (serving/sampling.SamplingParams) rides identically,
        so a failover replay consumes the same seed.  ``trace_ctx``
        (utils/tracing.TraceContext) joins every attempt's engine spans
        into the request's distributed trace; ``trace_parent`` is the
        caller's span id in the SHARED tier tracer (the attempt spans
        re-parent under it)."""
        if self._closed:
            raise RuntimeError("router is closed")
        rr = RouterRequest(next(self._ids), prompt, max_new, deadline_s,
                           self.clock(), callback,
                           ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                           sampling=sampling, trace_ctx=trace_ctx,
                           trace_parent=trace_parent)
        self._dispatch(rr)   # propagates QueueFull / NoHealthyReplica
        self.requests.append(rr)
        return rr

    def _wrap_callback(self, rr: RouterRequest) -> Callable:
        def _cb(_req, tok):
            rr._attempt_delivered += 1
            if rr._attempt_delivered > rr.delivered:
                rr.delivered = rr._attempt_delivered
                if rr.callback is not None:
                    rr.callback(rr, tok)
        return _cb

    def _dispatch(self, rr: RouterRequest) -> None:
        """Place ``rr`` on the best candidate, walking the load order.

        Durable exclusions (``rr.excluded``) are replicas that FAILED this
        request — a chaos ``router-dispatch`` hit or the replica it died
        on; ``QueueFull`` is transient backpressure, so a full replica is
        skipped this round but stays eligible for a later re-dispatch.
        """
        full: list[Replica] = []
        while True:
            cands = sorted(
                (r for r in self.healthy()
                 if r.index not in rr.excluded and r not in full),
                key=lambda r: r.load)
            if not cands:
                if full:
                    raise QueueFull(
                        f"every healthy replica's queue is at bound "
                        f"({len(full)} tried) — retry later or shed load")
                raise NoHealthyReplica(
                    f"no healthy replica to place request {rr.id} on "
                    f"({len(self.replicas)} total, {len(rr.excluded)} "
                    "excluded for this request)")
            rep = cands[0]
            if self._chaos is not None:
                # one router-dispatch event per ATTEMPT, so seeded plans
                # are stable across retries; a hit bars this replica for
                # this request only (at-most-once per replica)
                spec = self._chaos.fire("router-dispatch")
                if spec is not None:
                    rr.excluded.add(rep.index)
                    if self._tracer is not None:
                        self._tracer.instant(
                            "dispatch_fault", cat="router", tid=self.tid,
                            request=rr.id, replica=rep.index,
                            fault_kind=spec.kind)
                    continue
            remaining = None
            if rr.deadline_s is not None:
                remaining = rr.overdue_at - self.clock()
                if remaining <= 0:
                    rr.final_status = "cancelled"
                    return
            try:
                req = rep.engine.submit(rr.tokens, rr.max_new,
                                        deadline_s=remaining,
                                        callback=self._wrap_callback(rr),
                                        ttft_slo_s=rr.ttft_slo_s,
                                        tpot_slo_s=rr.tpot_slo_s,
                                        sampling=rr.sampling)
            except QueueFull:
                full.append(rep)
                continue
            rr.req = req
            rr.replica = rep.index
            rr.attempts.append((rep.index, req))
            rr._attempt_delivered = 0
            self._owner[id(req)] = rr
            if rr.trace_ctx is not None:
                # distributed trace join: stamp the context on the engine
                # attempt (the telemetry exemplars read it) and claim
                # the engine's request span for the trace — re-parented
                # under the daemon's span, replays LINKED to the attempt
                # they replace (not silent restarts)
                req.trace_ctx = rr.trace_ctx
                if self._tracer is not None and req.trace is not None:
                    prior = rr._last_attempt_span
                    self._tracer.annotate(
                        req.trace["id"], parent=rr.trace_parent,
                        links=[prior] if prior is not None else None,
                        trace=rr.trace_ctx.trace_id,
                        sampled=rr.trace_ctx.sampled,
                        attempt=len(rr.attempts), replica=rep.index)
                    rr._last_attempt_span = req.trace["id"]
            return

    # ------------------------------------------------------------------
    # the pump

    def step(self) -> int:
        """One cluster iteration: probe health, pump every live replica one
        host-loop step, retry orphans.  Engine-wide faults become replica
        failovers IN this step (collateral harvested and re-dispatched
        before returning).  Returns real tokens produced."""
        if self._closed:
            raise RuntimeError("router is closed")
        produced = 0
        for rep in self.replicas:
            if rep.state == FAILED or not rep.alive:
                continue
            try:
                if (rep.state == HEALTHY and self._probe is not None
                        and not self._probe(rep)):
                    raise RuntimeError("health probe failed")
                if not rep.engine.has_work:
                    continue
                produced += rep.engine.step()
            except Exception as e:
                # per-request faults never propagate from step() (the
                # single-engine isolation contract) — anything that does
                # is engine-wide: EngineStalled after the watchdog, a raw
                # decode fault without one, a probe that raised instead of
                # returning False.  The blast radius is ONE replica: fail
                # it over and keep pumping the siblings this same
                # iteration (a raising probe used to propagate out of
                # step() and starve every replica after it in the loop).
                if rep.state != FAILED:
                    try:
                        self._fail_replica(rep, e)
                    except Exception as fe:
                        # failover machinery itself failing (a close that
                        # raises mid-harvest) still must not starve
                        # siblings; the replica is already marked FAILED
                        # (first statement of _fail_replica), so nothing
                        # re-dispatches to it
                        if self._tracer is not None:
                            self._tracer.instant(
                                "failover_error", cat="router", tid=rep.tid,
                                replica=rep.index,
                                error=f"{type(fe).__name__}: {fe}")
        if self._orphans:
            self._retry_orphans()
        if self._telemetry is not None:
            self._telemetry.maybe_sample()
        return produced

    def _telemetry_vitals(self) -> dict:
        """Health-sampler source: cluster counters + per-replica vitals
        (every replica, dead or alive — a killed replica's ``state`` /
        frozen ``heartbeat_t`` must stay visible in the time-series)."""
        return {
            "n_replicas": len(self.replicas),
            "healthy": len(self.healthy()),
            "failovers": self.failovers,
            "retires": self.retires,
            "scale_ups": self.scale_ups,
            "retiring": 0,
            "orphans": len(self._orphans),
            "router_requests": len(self.requests),
            "outstanding": sum(1 for rr in self.requests if not rr.done),
            "weight_swaps": len(self.swapped_steps),
            "handoffs": self.handoffs,
            "handoff_faults": self.handoff_faults,
            "replicas": {str(r.index): r.vitals() for r in self.replicas},
        }

    def _fail_replica(self, rep: Replica, exc: BaseException) -> None:
        rep.state = FAILED
        self.failovers += 1
        if self._tracer is not None:
            self._tracer.instant("replica_failed", cat="router", tid=rep.tid,
                                 replica=rep.index,
                                 error=f"{type(exc).__name__}: {exc}")
        # close() converts everything the engine had accepted into
        # engine_fault-marked terminal records (failed in-flight rows were
        # already marked by the fault path itself); harvest = exactly the
        # collateral, never a request's own failure.  A close that raises
        # (the engine is already sick) must not abort the harvest —
        # whatever made it into ``completed`` still gets re-dispatched.
        try:
            rep.close()
        except Exception as ce:
            if self._tracer is not None:
                self._tracer.instant("replica_close_error", cat="router",
                                     tid=rep.tid, replica=rep.index,
                                     error=f"{type(ce).__name__}: {ce}")
        casualties = [
            self._owner[id(req)]
            for req in rep.engine.completed
            if req.engine_fault and id(req) in self._owner
            and self._owner[id(req)].req is req
        ]
        for rr in sorted(casualties, key=lambda rr: rr.id):
            rr.excluded.add(rep.index)
            rr.redispatches += 1
            try:
                self._dispatch(rr)
            except (QueueFull, NoHealthyReplica) as e:
                if isinstance(e, NoHealthyReplica) and not self.healthy():
                    # the whole tier is down — terminal, not retryable
                    rr.final_status = "failed"
                    rr.final_error = f"{type(e).__name__}: {e}"
                    continue
                self._orphans.append(rr)
                continue
            if self._tracer is not None and rr.replica is not None:
                kw = {}
                t = getattr(rr.req, "trace", None)
                if t is not None:
                    kw["parent"] = t["id"]
                if rr.trace_ctx is not None:
                    kw["trace"] = rr.trace_ctx.trace_id
                self._tracer.instant(
                    "failover_redispatch", cat="router",
                    tid=self.replicas[rr.replica].tid, request=rr.id,
                    source=rep.index, replica=rr.replica, **kw)

    def _retry_orphans(self) -> None:
        still: list[RouterRequest] = []
        for rr in self._orphans:
            if rr.done:
                continue
            if self.clock() > rr.overdue_at:
                rr.final_status = "cancelled"
                continue
            try:
                self._dispatch(rr)
            except (QueueFull, NoHealthyReplica):
                if not self.healthy():
                    rr.final_status = "failed"
                    rr.final_error = "no healthy replica remained"
                    continue
                still.append(rr)
        self._orphans = still

    @property
    def outstanding(self) -> int:
        return sum(not rr.done for rr in self.requests)

    def run_until_done(self, max_steps: int | None = None
                       ) -> list[RouterRequest]:
        """Pump :meth:`step` until every submitted request is terminal (or
        ``max_steps``); the multi-replica analog of ``engine.run()``."""
        steps = 0
        while self.outstanding:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if not self.healthy() and not any(
                    r.state == DRAINING for r in self.replicas):
                self._retry_orphans()  # finalize strands against a dead tier
                break
        return self.requests

    # ------------------------------------------------------------------
    # replica lifecycle

    def prewarm(self) -> dict:
        """Fan :meth:`InferenceEngine.prewarm` across every healthy
        replica: run each replica's paths BEFORE the first request, so no
        request anywhere in the tier pays a first-use build or load as
        TTFT (the first replica builds and loads; the rest read 0 and 0).
        Call after construction, before traffic.

        Returns per-replica prewarm reports keyed by replica index
        (see :meth:`InferenceEngine.prewarm`), plus ``"total_s"``.
        """
        if self._closed:
            raise RuntimeError("router is closed")
        t0 = self.clock()
        by_replica = {}
        for rep in self.healthy():
            by_replica[rep.index] = rep.engine.prewarm()
        out = {"replicas": by_replica,
               "total_s": round(self.clock() - t0, 6)}
        if self._tracer is not None:
            self._tracer.instant(
                "prewarm", cat="router", tid=self.tid,
                replicas=len(by_replica), total_s=out["total_s"])
        return out

    def restart(self, index: int) -> float:
        """Respawn a FAILED replica in place (fresh engine via the factory;
        the kernels are already built and loaded).  When
        the tier has hot-swapped since the factory's params were captured,
        the fresh engine immediately re-applies the CURRENT weights — a
        restart must never quietly reintroduce a stale weight version.
        Returns the bring-up seconds."""
        rep = self.replicas[index]
        if rep.state != FAILED:
            raise RuntimeError(
                f"replica {index} is {rep.state}, not failed — restart "
                "replaces dead replicas only")
        spawn_s = rep.spawn()
        self.scale_ups += 1
        if self._current_weights is not None:
            params, step = self._current_weights
            rep.engine.swap_params(params)  # fresh engine: trivially idle
            rep.weight_step = step
        return spawn_s

    def swap_replica(self, rep: Replica, params) -> bool:
        """Drain → swap → re-admit ONE replica; the others keep serving.
        Returns False without harm when the swap cannot proceed (replica
        busy past ``max_drain_steps``, failed mid-drain, chaos hit) — the
        replica re-admits on its old weights and the caller retries later.
        """
        if rep.state != HEALTHY or not rep.alive:
            return False
        rep.state = DRAINING
        if self._tracer is not None:
            self._tracer.instant("swap_drain_begin", cat="router",
                                 tid=rep.tid, replica=rep.index)
        steps = 0
        while rep.engine is not None and rep.alive and rep.engine.has_work:
            self.step()  # the whole tier keeps moving while rep drains
            steps += 1
            if steps >= self.max_drain_steps:
                rep.state = HEALTHY
                return False
        if rep.state == FAILED or not rep.alive:
            return False  # died mid-drain; failover already handled it
        if self._chaos is not None:
            # one weight-swap event per attempt, after the drain and
            # before the replacement: a hit models the swap interrupted —
            # all-or-nothing, so the replica re-admits on OLD weights
            spec = self._chaos.fire("weight-swap")
            if spec is not None:
                rep.state = HEALTHY
                if self._tracer is not None:
                    self._tracer.instant("swap_aborted", cat="router",
                                         tid=rep.tid, replica=rep.index,
                                         fault_kind=spec.kind)
                return False
        rep.engine.swap_params(params)
        rep.swaps += 1
        rep.state = HEALTHY
        if self._tracer is not None:
            self._tracer.instant("weight_swap", cat="router", tid=rep.tid,
                                 replica=rep.index, swap=rep.swaps)
        return True

    def hot_swap(self, params, step: int | None = None) -> int:
        """Swap ``params`` into every healthy replica, one at a time.
        Returns how many swapped this call.  A chaos-aborted or busy
        replica stays on its old weights with its ``weight_step`` behind —
        re-calling with the same ``step`` retries exactly those (the
        watcher's rollout-completion loop); replicas already stamped with
        ``step`` are skipped, so the retry never double-drains."""
        self._current_weights = (params, step)
        swapped = 0
        for rep in list(self.replicas):
            if step is not None and rep.weight_step == step:
                continue
            if self.swap_replica(rep, params):
                rep.weight_step = step if step is not None else rep.weight_step
                swapped += 1
        if swapped and step is not None and (
                not self.swapped_steps or self.swapped_steps[-1] != int(step)):
            self.swapped_steps.append(int(step))
        return swapped

    # ------------------------------------------------------------------
    # stats / shutdown

    def stats_records(self) -> list[ServingStats]:
        """Every engine stats record the tier has produced: closed engines
        (failed-over, shut down) plus each replica's live one."""
        out: list[ServingStats] = []
        for rep in self.replicas:
            out.extend(rep.stats_records)
            if rep.alive:
                out.append(rep.engine.stats)
        return out

    def summary(self) -> dict:
        """Cluster rollup (``ServingStats.merge``) plus router-level
        counters: failovers, redispatches, spawn timings, swapped steps."""
        merged = ServingStats.merge(self.stats_records())
        merged.update({
            "n_replicas": len(self.replicas),
            "replicas_failed": sum(r.state == FAILED and not r.retired
                                   for r in self.replicas),
            "replicas_retired": sum(r.retired for r in self.replicas),
            "failovers": self.failovers,
            "retires": self.retires,
            "scale_ups": self.scale_ups,
            "redispatches": sum(rr.redispatches for rr in self.requests),
            "router_requests": len(self.requests),
            "weight_swaps": sum(r.swaps for r in self.replicas),
            "handoffs": self.handoffs,
            "handoff_faults": self.handoff_faults,
            "swapped_steps": list(self.swapped_steps),
            "spawn_s_by_replica": [
                [round(s, 6) for s in r.spawn_history] for r in self.replicas],
        })
        return merged

    def emit(self, writer=None) -> dict:
        """Write the cluster rollup as ONE ``router`` record."""
        writer = writer if writer is not None else self.writer
        if writer is None:
            raise ValueError("no MetricWriter wired (writer=)")
        return writer.write("router", **self.summary())

    def close(self) -> None:
        """Close every replica engine and (when a writer is wired) emit
        the merged ``router`` record.  Idempotent."""
        if self._closed:
            return
        for rep in self.replicas:
            rep.close()
        if self.writer is not None:
            self.emit(self.writer)
        self._closed = True

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class WeightWatcher:
    """Poll a trainer's checkpoint directory and hot-swap validated steps.

    Owns its OWN read-only :class:`~..utils.checkpoint.CheckpointManager`
    over ``directory`` — ``restore_latest_intact`` begins by waiting on
    ITS manager's in-flight saves (none, ever), so a poll can never block
    the trainer's async save pipeline, and the intact-walk (manifest
    digests → restorability → finiteness/step agreement) makes a torn
    newest step cost one poll, not a bad swap: the walk lands on the
    previous intact step, which ``poll`` then ignores as not-new.

    ``target`` is an optional restore target (a ``TrainState``, loaded in
    place); without one the restore yields the save form (CPU tensors:
    ``step``, ``params``, ``buffers``...).  ``extract(state)`` maps what the
    restore returned to the ``state_dict`` the engines' ``swap_params``
    consume; by default the form's parameters and buffers.  ``min_poll_s``
    rate-limits directory walks against a hot loop calling :meth:`poll`
    per step.
    """

    def __init__(self, directory: str, target, router: Router, *,
                 extract: Callable = None, min_poll_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        from distributed_tensorflow_ibm_mnist_tpu_torch.utils.checkpoint import (
            CheckpointManager,
        )

        self._mgr = CheckpointManager(directory)
        self._target = target
        self._router = router
        self._extract = extract if extract is not None else (
            lambda form: {**form["params"], **form["buffers"]})
        self._clock = clock
        self.min_poll_s = float(min_poll_s)
        self._last_poll_t: float | None = None
        self.last_step: int | None = None   # newest FULLY-rolled-out step
        self._pending: tuple | None = None  # (params, step) mid-rollout
        self.polls = 0
        self.skipped: list[tuple[int, str]] = []  # (step, why) torn/raced

    def _rolled_out(self, step: int) -> bool:
        """True when every serving replica is stamped with ``step`` — a
        FAILED replica doesn't count against completion (a restart
        re-applies the tier's current weights anyway)."""
        live = [rep for rep in self._router.replicas
                if rep.alive and rep.state != FAILED]
        return bool(live) and all(rep.weight_step == step for rep in live)

    def poll(self) -> int | None:
        """One watch iteration: look for a newer intact step, then push the
        pending rollout (a chaos-aborted or busy replica declines a swap
        and stays behind — each poll retries exactly the stragglers).
        Returns the step once it is on EVERY serving replica, else None
        (nothing new, not yet intact, rate-limited, rollout incomplete)."""
        now = self._clock()
        if (self._last_poll_t is not None
                and now - self._last_poll_t < self.min_poll_s):
            return None
        self._last_poll_t = now
        self.polls += 1
        horizon = (self._pending[1] if self._pending is not None
                   else self.last_step)
        try:
            # the watcher OBSERVES a directory someone else writes: drop
            # the manager's cached step listing before every look
            self._mgr.reload()
            newest = self._mgr.latest_step()
        except Exception:
            newest = None
        if newest is not None and (horizon is None or newest > horizon):
            try:
                state = self._mgr.restore_latest_intact(self._target)
                step = int(state["step"] if isinstance(state, dict)
                           else getattr(state, "step", newest))
                if horizon is None or step > horizon:
                    self._pending = (self._extract(state), step)
                else:
                    # the intact-walk fell back behind what we already
                    # serve (newest step torn mid-write): retry next poll
                    self.skipped.append(
                        (int(newest), f"intact walk fell back to {step}"))
            except FileNotFoundError as e:
                # nothing intact YET (first save still landing / torn):
                # the next poll retries — never surface a transient race
                self.skipped.append((int(newest), f"no intact step: {e}"))
        if self._pending is None:
            return None
        params, step = self._pending
        self._router.hot_swap(params, step=step)
        if self._rolled_out(step):
            self._pending = None
            self.last_step = step
            return step
        return None
