"""Telemetry-driven elastic capacity for the daemonized tier (the port's
copy of the JAX package's ``serving/autoscaler.py``).

The tier already has every mechanism elasticity needs — ``Replica``
lifecycle with warm respawn (the kernels stay built and loaded),
drain-before-close (the weight-swap quiesce), failover harvest, and a
telemetry stream of queue depth and occupancy.  What it lacks is the
POLICY loop that turns those signals into capacity decisions.  This
module is that loop, deliberately small and deliberately mechanism-free:

* **Scale up** when backlog pressure holds: admitted-but-unserved
  requests per slot above ``up_backlog_per_slot`` (or the admission
  policy shedding — sheds are goodput ALREADY lost, the strongest
  possible up signal) for ``hysteresis_up`` consecutive ticks.  Capacity
  comes from :meth:`ServingDaemon.restart_replica` when a retired
  replica exists (WARM: no kernel build or library load, and
  the router re-stamps the tier's current weights so a late-spawned
  replica never serves stale parameters) else
  :meth:`ServingDaemon.add_replica`.
* **Scale down** when the tier idles: an empty admission queue (nothing
  WAITING — in-flight work shows up as occupancy, not as a reason to
  hold idle capacity) and slot occupancy below ``down_occupancy`` for
  ``hysteresis_down`` ticks, never below ``min_replicas`` — via :meth:`ServingDaemon.retire_replica`, which
  DRAINS first (the replica finishes its in-flight work undispatchable,
  then the watchdog closes it under the pump lock).  Scale-down drops
  nothing, ever; that is the router's ``begin_retire`` contract.

Hysteresis is the whole art here: both verdicts must hold for N
consecutive ticks, and any tick of contrary evidence resets the streak —
a burst ending mid-count does not strand capacity, and one noisy sample
does not flap the tier.  After every action the OTHER direction's streak
resets too (an up decision is evidence against down, and vice versa).

The controller runs either embedded (call :meth:`tick` from your own
loop — the deterministic path the tests drive) or as its own
daemon thread (:meth:`start` / :meth:`stop`) ticking every
``interval_s``.  :meth:`chip_seconds` integrates healthy-engines x
seconds over the capacity log — the denominator that makes elastic and
fixed tiers comparable at equal hardware cost (goodput per chip-second).
"""

from __future__ import annotations

import threading
import time

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.replica import HEALTHY


class Autoscaler:
    """Capacity controller over one :class:`~.daemon.ServingDaemon`.

    ``min_replicas``/``max_replicas`` bound the healthy count the
    controller will steer toward.  ``up_backlog_per_slot`` is the
    backlog-pressure threshold (waiting + in-flight logical requests per
    healthy slot); ``down_occupancy`` the idle threshold (occupied
    slots / total slots).  ``hysteresis_up``/``hysteresis_down`` are the
    consecutive-tick streaks each verdict needs.  ``clock`` is
    injectable for tests.
    """

    def __init__(self, daemon, *, min_replicas: int = 1,
                 max_replicas: int | None = None,
                 up_backlog_per_slot: float = 1.0,
                 down_occupancy: float = 0.25,
                 hysteresis_up: int = 2, hysteresis_down: int = 4,
                 interval_s: float = 0.05, clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        if hysteresis_up < 1 or hysteresis_down < 1:
            raise ValueError("hysteresis streaks must be >= 1")
        self.daemon = daemon
        self.min_replicas = int(min_replicas)
        self.max_replicas = (int(max_replicas)
                             if max_replicas is not None else None)
        self.up_backlog_per_slot = float(up_backlog_per_slot)
        self.down_occupancy = float(down_occupancy)
        self.hysteresis_up = int(hysteresis_up)
        self.hysteresis_down = int(hysteresis_down)
        self.interval_s = float(interval_s)
        self.clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_shed = self._policy_shed()
        self.events: list[dict] = []   # every action, timestamped
        self.ticks = 0
        # capacity log: (t, healthy_engines) at construction + after
        # every action — chip_seconds() integrates it
        self._capacity_log: list[tuple[float, int]] = [
            (self.clock(), self._healthy_count())]
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    # signals

    def _policy_shed(self) -> int:
        return int(getattr(self.daemon.policy, "shed", 0))

    def _healthy(self):
        router = self.daemon.router
        return [r for r in router.replicas
                if r.state == HEALTHY and r.alive]

    def _healthy_count(self) -> int:
        return len(self._healthy())

    def signals(self) -> dict:
        """One telemetry sample: backlog (admission depth + logical
        in-flight), healthy capacity in slots, slot occupancy, and the
        policy's shed delta since the previous sample."""
        healthy = self._healthy()
        slots = sum(r.engine.slots for r in healthy)
        occupied = sum(r.engine.occupied for r in healthy)
        with self.daemon._adm_cv:
            waiting = len(self.daemon._admission)
            backlog = waiting + len(self.daemon._inflight)
        shed_now = self._policy_shed()
        shed_delta, self._last_shed = shed_now - self._last_shed, shed_now
        return {
            "healthy": len(healthy),
            "retiring": len(self.daemon.router._retiring),
            "slots": slots,
            "waiting": waiting,
            "backlog": backlog,
            "backlog_per_slot": (backlog / slots) if slots else float("inf"),
            "occupancy": (occupied / slots) if slots else 0.0,
            "shed_delta": shed_delta,
        }

    # ------------------------------------------------------------------
    # the control loop

    def tick(self) -> str | None:
        """One control decision; returns ``"up"``/``"down"`` when an
        action fired, else None."""
        self.ticks += 1
        sig = self.signals()
        # a retire in flight is capacity already leaving — freeze
        # decisions until the drain settles rather than double-steer
        if sig["retiring"]:
            return None
        up_pressure = (sig["shed_delta"] > 0
                       or sig["backlog_per_slot"] > self.up_backlog_per_slot)
        down_pressure = (sig["waiting"] == 0
                         and sig["occupancy"] < self.down_occupancy)
        self._up_streak = self._up_streak + 1 if up_pressure else 0
        self._down_streak = self._down_streak + 1 if down_pressure else 0
        at_ceiling = (self.max_replicas is not None
                      and sig["healthy"] >= self.max_replicas)
        if self._up_streak >= self.hysteresis_up and not at_ceiling:
            return self._scale_up(sig)
        if (self._down_streak >= self.hysteresis_down
                and sig["healthy"] > self.min_replicas):
            return self._scale_down(sig)
        return None

    def _scale_up(self, sig: dict) -> str | None:
        router = self.daemon.router
        retired = [r for r in router.replicas if r.retired and not r.alive]
        try:
            if retired:
                index = retired[0].index
                spawn_s = self.daemon.restart_replica(index)
                warm = True
            else:
                rep = self.daemon.add_replica()
                index, spawn_s, warm = rep.index, rep.spawn_s, False
        except RuntimeError:
            return None       # tier closing under us — not an error
        self._record("up", index=index, spawn_s=spawn_s, warm=warm, sig=sig)
        return "up"

    def _scale_down(self, sig: dict) -> str | None:
        # least-loaded retires first; equal load breaks toward the higher
        # index, keeping replica 0 (the longest-lived lane) resident
        victims = sorted(self._healthy(), key=lambda r: (r.load, -r.index))
        for rep in victims:
            if self.daemon.retire_replica(rep.index):
                self._record("down", index=rep.index, spawn_s=None,
                             warm=None, sig=sig)
                return "down"
        return None   # role constraints vetoed every candidate

    def _record(self, action: str, *, index, spawn_s, warm, sig) -> None:
        self._up_streak = self._down_streak = 0
        now = self.clock()
        self.events.append({
            "t": now, "action": action, "replica": index,
            "spawn_s": spawn_s, "warm": warm, "signals": sig,
        })
        self._capacity_log.append((now, self._healthy_count()))
        tel = self.daemon._telemetry
        if tel is not None:
            tel.inc(f"autoscale_{action}")

    # ------------------------------------------------------------------
    # accounting

    def chip_seconds(self, until: float | None = None) -> float:
        """Integral of healthy engines over time since construction —
        the hardware-cost denominator for goodput-per-chip-second."""
        until = self.clock() if until is None else until
        total = 0.0
        log = self._capacity_log
        for (t0, n), (t1, _) in zip(log, log[1:] + [(until, 0)]):
            total += max(0.0, min(t1, until) - t0) * n
        return total

    def summary(self) -> dict:
        ups = [e for e in self.events if e["action"] == "up"]
        return {
            "ticks": self.ticks,
            "scale_ups": len(ups),
            "scale_downs": sum(1 for e in self.events
                               if e["action"] == "down"),
            "warm_ups": sum(1 for e in ups if e["warm"]),
            "spawn_s": [round(e["spawn_s"], 6) for e in ups
                        if e["spawn_s"] is not None],
            "chip_seconds": round(self.chip_seconds(), 3),
            "healthy": self._healthy_count(),
        }

    # ------------------------------------------------------------------
    # threaded runner

    def start(self) -> "Autoscaler":
        """Tick on a daemon thread every ``interval_s`` until stop()."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    # a failed decision must not kill the control loop;
                    # the next sample decides again
                    pass

        self._thread = threading.Thread(target=_loop, name="dtm-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
