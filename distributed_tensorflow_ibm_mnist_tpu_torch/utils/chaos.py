"""Deterministic, seeded fault injection (the port's copy of the JAX
package's ``utils/chaos.py``).

A :class:`FaultPlan` names WHERE faults fire (injection sites), WHAT they do
(a per-site ``kind`` tag) and WHEN (explicit event indices and/or a seeded
per-event probability); a :class:`FaultInjector` executes that schedule
deterministically: the same plan against the same program fires the same
faults at the same events, every run.  The classes are the JAX module's,
line for line, so a plan written for the JAX package loads unchanged and
fires on the same event indices.

Sites and their consumers in the port:

========================  ====================================================
``checkpoint-write``      one event per ``CheckpointManager.save``
                          (utils/checkpoint.py).  ``kind="torn"`` lets the
                          write land, then truncates the step's largest
                          file and writes no manifest (the crash-mid-write
                          signature); any other kind raises ``OSError``
                          before the write.
``checkpoint-read``       one event per restore attempt (utils/checkpoint.py);
                          raises ``OSError``: a transient read fault.
``data-batch``            one event per host batch on the Trainer's stream
                          path (core/trainer.py); raises ``OSError``: a
                          data-loader hiccup.
``train-step``            one event per epoch dispatch (core/trainer.py).
                          ``kind="nan"`` poisons one parameter element
                          (``utils.debug.inject_nan``) so the epoch's loss is
                          non-finite: the divergence -> detect -> restore
                          path; other kinds raise :class:`ChaosFault`.
``serving-admit``         one event per admission attempt
                          (serving/engine.py); a hit fails that request.
``serving-step``          one event per decode-window dispatch
                          (serving/engine.py); a hit is an engine-wide
                          fault (the router fails the replica over).
``serving-callback``      one event per delivered token (serving/engine.py);
                          a hit fails that request.
``router-dispatch``       one event per router -> replica dispatch attempt
                          (serving/router.py); a hit bars that replica for
                          that request.
``weight-swap``           one event per hot-swap attempt, after the drain
                          (serving/router.py); a hit keeps the old weights.
``daemon-pump``           one event per pump-thread activation
                          (serving/daemon.py); ``kind="wedge"`` parks the
                          pump, other kinds raise in it.
``kv-handoff``            one event per handoff delivery attempt
                          (serving/router.py); a hit releases the source
                          hold and re-dispatches the request.
``journal-write``         one event per journal append (serving/journal.py);
                          ``kind="torn"`` writes half a record,
                          ``kind="corrupt"`` flips a byte, other kinds raise
                          ``JournalWriteError``.
========================  ====================================================

Every hook is guarded by ``if <owner>._chaos is not None`` at the call
site: a run built without an injector executes no chaos instruction.
Each site owns an event counter that counts every consultation and
outlives the trainer it is wired into (``run_with_recovery`` passes the
same injector to every rebuilt trainer), so ``at=(k,)`` fires once, at
the k-th event ever.  Probabilistic firing is a pure function of (plan
seed, site, spec index, event index).  Each site has its own lock, held
for the increment-and-match of one event.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from dataclasses import dataclass

SITES = (
    "checkpoint-write",
    "checkpoint-read",
    "data-batch",
    "train-step",
    "serving-admit",
    "serving-step",
    "serving-callback",
    "router-dispatch",
    "weight-swap",
    "daemon-pump",
    "kv-handoff",
    "journal-write",
)


class ChaosFault(RuntimeError):
    """An injected fault standing in for a transient infrastructure failure.

    Deliberately a ``RuntimeError`` subclass so it is NOT retryable by
    default in ``run_with_recovery`` — sites that model retryable faults
    raise ``OSError`` instead; sites that model poison/divergence raise
    this (or corrupt state and let the real detector fire).
    """

    def __init__(self, site: str, kind: str, event: int):
        super().__init__(f"chaos: injected {kind!r} fault at site {site!r} event {event}")
        self.site = site
        self.kind = kind
        self.event = event


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault stream at one site.

    ``at`` — absolute per-site event indices that always fire.
    ``prob`` — additionally fire on any event with this probability
    (seeded; replayable).  ``max_fires`` caps total fires of THIS spec
    (None = unbounded).  ``kind`` is interpreted by the site (see module
    docstring); unknown kinds raise :class:`ChaosFault` at the site.
    """

    site: str
    kind: str = "raise"
    at: tuple[int, ...] = ()
    prob: float = 0.0
    max_fires: int | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; known: {SITES}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        object.__setattr__(self, "at", tuple(int(a) for a in self.at))


@dataclass(frozen=True)
class FaultPlan:
    """A seed plus the full fault schedule — the replayable chaos input."""

    seed: int = 0
    faults: tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))


def _hash_uniform(seed: int, site: str, spec_idx: int, event: int) -> float:
    """Uniform [0, 1) as a pure function of its arguments (blake2b-based) —
    the stateless RNG behind ``prob`` firing, immune to call interleaving."""
    h = hashlib.blake2b(
        site.encode() + struct.pack("<qqq", seed, spec_idx, event), digest_size=8
    ).digest()
    return int.from_bytes(h, "little") / 2.0**64


@dataclass
class _Fired:
    site: str
    event: int
    kind: str
    spec_idx: int


class FaultInjector:
    """Executes a :class:`FaultPlan`: per-site event counters + fired log.

    Usage at a site (``spec`` is None on the overwhelming majority of
    events — the schedule decides)::

        if self._chaos is not None:            # zero-overhead when unwired
            spec = self._chaos.fire("checkpoint-write")
            if spec is not None:
                ...  # act per spec.kind

    ``fire`` consumes one event at the site whether or not anything fires,
    which is what makes schedules replayable across recovery restarts.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_site: dict[str, list[tuple[int, FaultSpec]]] = {s: [] for s in SITES}
        for idx, spec in enumerate(plan.faults):
            self._by_site[spec.site].append((idx, spec))
        self._events: dict[str, int] = {s: 0 for s in SITES}
        # one lock PER SITE (module docstring §Concurrency): an event's
        # increment-and-match is atomic against other threads at the same
        # site, and sites never contend with each other.  A spec belongs
        # to exactly one site, so _spec_fires entries are only ever
        # touched under that spec's site lock.
        self._locks: dict[str, threading.Lock] = {s: threading.Lock() for s in SITES}
        self._spec_fires: dict[int, int] = {}
        self.fired: list[_Fired] = []

    def events(self, site: str) -> int:
        """How many events the site has consumed so far."""
        return self._events[site]

    def fire(self, site: str) -> FaultSpec | None:
        """Consume one event at ``site``; return the firing spec, if any.

        The first matching spec (plan order) wins the event; explicit
        ``at`` indices are checked before the seeded coin so a plan can mix
        pinned and probabilistic faults at one site.  Thread-safe: the
        event index and its match verdict are assigned under the site's
        lock, so concurrent consultations of one site serialize into a
        gap-free per-site order.
        """
        return self.fire_event(site)[1]

    def fire_event(self, site: str) -> tuple[int, FaultSpec | None]:
        """:meth:`fire`, also returning THIS consultation's event index —
        the concurrency-safe form (re-reading the counter after the fact
        would observe other threads' events)."""
        if site not in self._by_site:
            raise ValueError(f"unknown chaos site {site!r}; known: {SITES}")
        with self._locks[site]:
            event = self._events[site]
            self._events[site] = event + 1
            for idx, spec in self._by_site[site]:
                if spec.max_fires is not None and self._spec_fires.get(idx, 0) >= spec.max_fires:
                    continue
                hit = event in spec.at or (
                    spec.prob > 0.0
                    and _hash_uniform(self.plan.seed, site, idx, event) < spec.prob
                )
                if hit:
                    self._spec_fires[idx] = self._spec_fires.get(idx, 0) + 1
                    self.fired.append(_Fired(site=site, event=event, kind=spec.kind, spec_idx=idx))
                    return event, spec
        return event, None

    def raise_if_fired(self, site: str, exc: type[Exception] = ChaosFault) -> None:
        """Convenience for raise-only sites: fire, and raise on a hit.

        ``exc`` is instantiated as ``exc(site, kind, event)`` when it is
        :class:`ChaosFault`, else ``exc(message)`` (e.g. ``OSError``).
        """
        event, spec = self.fire_event(site)
        if spec is None:
            return
        if exc is ChaosFault:
            raise ChaosFault(site, spec.kind, event)
        raise exc(f"chaos: injected {spec.kind!r} fault at site {site!r} event {event}")

    def summary(self) -> dict:
        """Faults injected so far, for soak reports: total + per-site."""
        by_site: dict[str, int] = {}
        for f in self.fired:
            by_site[f.site] = by_site.get(f.site, 0) + 1
        return {
            "faults_injected": len(self.fired),
            "by_site": by_site,
            "events": {s: n for s, n in self._events.items() if n},
        }
