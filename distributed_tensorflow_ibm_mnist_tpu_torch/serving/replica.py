"""One engine replica under the router: lifecycle, health, load score
(the port's copy of the JAX package's ``serving/replica.py``).

The router (serving/router.py) never constructs an :class:`InferenceEngine`
directly — it holds N :class:`Replica` wrappers, each owning the engine's
LIFECYCLE: spawn (build via the caller's factory, timed — the cold-vs-warm
bring-up figure), health state, restart after failure, and the live load
score the least-loaded dispatch sorts by.  The split mirrors the engine/scheduler split one level
up: the engine multiplexes requests over slots; the replica multiplexes
ENGINES over failures and weight swaps.

Health is a three-state machine, transitions owned by the router:

* ``HEALTHY`` — dispatchable; pumped every router step.
* ``DRAINING`` — pumped but NOT dispatchable: a weight hot-swap is
  waiting for the engine to quiesce (``has_work`` to go False) while the
  other replicas absorb the traffic.  Transient by construction.
* ``FAILED`` — the engine raised an engine-wide fault (EngineStalled, a
  decode fault with no watchdog) or flunked a health probe; the router
  closed it, harvested its collateral requests for failover, and may
  :meth:`spawn` a replacement in place.

The factory (``make_engine(trace_tid)``) is the configuration seam: it
chooses slots/paging/decode-ahead.  In the port a respawn is warm by
construction: the kernels' libraries are built on disk and loaded in the
process once, so ``spawn_history`` shows the first spawn's engine build
against the later ones'.  The ``trace_tid`` argument is the replica's own
timeline track: all N engines share ONE tracer, and per-replica tracks keep
their host loops from interleaving on a single lane.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable

HEALTHY = "healthy"
DRAINING = "draining"
FAILED = "failed"


class Replica:
    """Engine lifecycle wrapper: see the module docstring.

    ``make_engine(trace_tid)`` must return a fresh
    :class:`~.engine.InferenceEngine`; it is called at every (re)spawn.
    A factory that takes a SECOND positional parameter is called as
    ``make_engine(trace_tid, replica_index)`` (a replica's own device, for
    one).  The arity is inspected once at construction, so respawns never
    re-probe.
    The factory should NOT wire a per-engine ``writer=`` — the router
    emits ONE merged cluster record (``ServingStats.merge``) instead of N
    interleaved per-engine records.
    """

    def __init__(self, index: int, make_engine: Callable, tracer=None,
                 role: str = "both"):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', got {role!r}")
        self.index = int(index)
        self._make_engine = make_engine
        # serving role: "both" adopts whatever role the
        # factory's engine declares (monolithic replicas stay "both");
        # an explicit "prefill"/"decode" is VALIDATED against the spawned
        # engine — a replica advertised as prefill capacity whose engine
        # would decode locally (or vice versa) is a misconfiguration, not
        # a policy choice
        self._role = str(role)
        try:
            n_params = len(inspect.signature(make_engine).parameters)
        except (TypeError, ValueError):  # builtins/partials w/o signature
            n_params = 1
        self._factory_wants_index = n_params >= 2
        self._tracer = tracer
        # the replica's own timeline lane, stable across respawns — every
        # engine this replica ever runs logs its host loop here
        self.tid = tracer.track(f"replica {self.index}") if tracer is not None else 0
        self.engine = None
        self.state = FAILED  # nothing to serve until spawn()
        # elastic capacity: a retired replica is terminal-FAILED for every
        # dispatch/liveness purpose (nothing routes to it, its pump exits)
        # but ``retired`` records that it drained CLEAN — the autoscaler
        # scaled it down, it did not crash — so vitals and the failover
        # counters keep the two exits distinguishable.  restart() (warm:
        # no kernel build or load) clears it on the way back up.
        self.retired = False
        self.spawns = 0
        self.swaps = 0
        # checkpoint step of the weights this replica currently serves;
        # None = the factory's originals.  The router stamps it on every
        # successful swap (and on restart, which re-applies the tier's
        # current weights) — the watcher's rollout-completeness check
        # reads it to retry replicas a chaos hit left behind
        self.weight_step: int | None = None
        self.spawn_s: float | None = None     # last bring-up wall seconds
        self.spawn_history: list[float] = []  # all bring-ups (cold vs warm)
        # ServingStats of engines this replica has already CLOSED (failure
        # or shutdown); the router folds these + the live engine's stats
        # into the cluster rollup
        self.stats_records: list = []
        # last non-None engine progress stamp seen by vitals(): the
        # engine's fault path resets its own watchdog anchor, so the
        # health sampler needs this copy to show a killed replica's
        # heartbeat FROZEN at its final progress instead of null
        self._heartbeat_t: float | None = None

    def spawn(self) -> float:
        """Build a fresh engine via the factory and mark HEALTHY.  Returns
        the bring-up wall seconds (the factory call: construction, and any
        kernel build or library load it causes)."""
        if self.engine is not None and not self.engine._closed:
            raise RuntimeError(
                f"replica {self.index} already has a live engine — close it "
                "(router failover does) before respawning")
        t0 = time.perf_counter()
        self.engine = (self._make_engine(self.tid, self.index)
                       if self._factory_wants_index
                       else self._make_engine(self.tid))
        engine_role = getattr(self.engine, "role", "both")
        if self._role != "both" and engine_role != self._role:
            raise RuntimeError(
                f"replica {self.index} declared role {self._role!r} but the "
                f"factory built a {engine_role!r}-role engine — the router "
                "would route the wrong traffic here")
        self.spawn_s = time.perf_counter() - t0
        self.spawn_history.append(self.spawn_s)
        self.spawns += 1
        self.state = HEALTHY
        self.retired = False
        if self._tracer is not None:
            self._tracer.instant("replica_spawn", cat="router", tid=self.tid,
                                 replica=self.index, spawn=self.spawns,
                                 spawn_s=round(self.spawn_s, 6))
        return self.spawn_s

    @property
    def alive(self) -> bool:
        return self.engine is not None and not self.engine._closed

    @property
    def role(self) -> str:
        """The replica's serving role: the live engine's declaration when
        one exists (stable across respawns — the factory rebuilds the
        same configuration), else the constructor's."""
        if self.engine is not None:
            return getattr(self.engine, "role", self._role)
        return self._role

    def probe(self) -> bool:
        """Liveness check the router runs each step on HEALTHY replicas.
        The base probe is structural (an engine exists and is not closed);
        the router's injectable ``probe=`` hook layers policy on top."""
        return self.alive

    @property
    def load(self) -> float:
        """Least-loaded sort key: requests ahead of a new arrival (queued +
        parked + occupied slots) plus the live KV-pool fraction as the
        fractional tiebreak — two replicas with equal request counts route
        to the one with more free pages (pool-aware routing), and the
        fraction is < 1 so it can never outvote a whole request."""
        e = self.engine
        if e is None:
            return float("inf")
        # role-aware: a prefill replica's outbox is accepted
        # work not yet delivered — its pages are still held, so it counts
        # ahead of a new arrival exactly like a parked request (empty on
        # both/decode replicas, where the term vanishes)
        ahead = (len(e.scheduler) + len(e._pending) + e.occupied
                 + len(getattr(e, "_outbox", ())))
        frac = (e._pool.allocated / e._pool.capacity
                if e._pool is not None else e.occupied / e.slots)
        return ahead + frac

    def vitals(self) -> dict:
        """Health-sampler vitals for the router's telemetry source
        (utils/telemetry): state, spawn/swap counts, served weight step,
        the load score, and the engine's last-progress heartbeat.  A
        killed replica stays VISIBLE in every sample — ``state`` goes
        ``failed``, ``heartbeat_t`` freezes at its last observed progress
        (None only if it never made any) — instead of vanishing from the
        dict."""
        e = self.engine
        if e is not None and e.heartbeat_t is not None:
            self._heartbeat_t = e.heartbeat_t
        return {
            "state": self.state,
            "retired": self.retired,
            "role": self.role,
            "outbox": (len(e._outbox)
                       if e is not None and hasattr(e, "_outbox") else 0),
            "alive": self.alive,
            "spawns": self.spawns,
            "swaps": self.swaps,
            "weight_step": self.weight_step,
            "spawn_s": self.spawn_s,
            "load": self.load if self.alive else None,
            "heartbeat_t": self._heartbeat_t,
        }

    def close(self) -> None:
        """Close the live engine (if any) and bank its stats record for
        the router's cluster rollup."""
        if self.engine is not None and not self.engine._closed:
            self.engine.close()
            self.stats_records.append(self.engine.stats)
