"""Failure detection + elastic recovery: preemption and divergence restart
(the port's counterpart of the JAX package's ``utils/elastic.py``).

* :class:`PreemptionHandler` — catches SIGTERM/SIGINT and flips a flag the
  training loop polls (between epochs, and every ``preempt_poll_every``
  steps on the stream path); the Trainer then checkpoints and exits
  cleanly instead of dying mid-epoch.  Off the main thread
  (``signal.signal`` is main-thread-only) it degrades to manual trigger
  only, with a warning, instead of crashing.
* :func:`run_with_recovery` — supervision loop: build a Trainer, run it; on
  a RETRYABLE failure (divergence, FP errors, I/O faults — the set is
  configurable), rebuild and resume from the latest INTACT checkpoint,
  with exponential backoff (deterministic jitter), a restart budget that
  counts only restarts inside a sliding window (``restart_window_s``), and
  a ``restart`` record through the trainer's MetricWriter.

Replays are deterministic: the resumed trainer derives each epoch's data
order from the ABSOLUTE epoch index (restored step // steps_per_epoch),
so a recovered run retraces the trajectory the fault-free run takes.  The
schedule (``_jitter``, the window, the backoff) is the JAX module's, number
for number.
"""

from __future__ import annotations

import hashlib
import signal
import struct
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.debug import TrainingDiverged

# Retryable by default: divergence (restore + replay recovers transient
# numeric faults), FP traps, and I/O faults (OSError covers checkpoint
# read/write hiccups, data-loader errors, FileNotFoundError from a
# checkpoint dir whose every step was condemned).  ChaosFault and
# programming errors are deliberately NOT here.
DEFAULT_RETRYABLE: tuple[type[BaseException], ...] = (
    TrainingDiverged,
    FloatingPointError,
    OSError,
)


class PreemptionHandler:
    """Flag-on-signal; install around the training loop.

    >>> with PreemptionHandler() as h:
    ...     trainer.fit(preemption=h)   # loop polls h.triggered

    ``signal.signal`` only works on the main thread of the main
    interpreter; entered anywhere else (worker threads, some notebook/
    server harnesses) the handler degrades to MANUAL trigger only — a
    warning is emitted, :meth:`trigger` and :attr:`triggered` keep
    working, and no signal handlers are (un)installed.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._prev: dict[int, Any] = {}
        self._event = threading.Event()
        self.installed = False  # did signal handlers actually install?

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Manual trigger (tests, external schedulers, degraded mode)."""
        self._event.set()

    def _handle(self, signum, frame):
        self._event.set()

    def __enter__(self) -> "PreemptionHandler":
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
            self.installed = True
        except ValueError:
            # not the main thread: roll back whatever did install, degrade
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self.installed = False
            warnings.warn(
                "PreemptionHandler entered off the main thread: signal "
                "handlers cannot install (signal.signal is main-thread-"
                "only); degraded to manual trigger() only",
                RuntimeWarning,
                stacklevel=2,
            )
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False


def _jitter(seed: int, attempt: int) -> float:
    """Deterministic jitter factor in [0.5, 1.0) — a pure function of
    (seed, attempt), so chaos replays back off identically."""
    h = hashlib.blake2b(struct.pack("<qq", seed, attempt), digest_size=8).digest()
    return 0.5 + 0.5 * (int.from_bytes(h, "little") / 2.0**64)


def run_with_recovery(
    make_trainer: Callable[[], Any],
    max_restarts: int = 2,
    on_restart: Callable[[int, BaseException], None] | None = None,
    preemption: PreemptionHandler | None = None,
    retryable: tuple[type[BaseException], ...] = DEFAULT_RETRYABLE,
    backoff_base_s: float = 0.25,
    backoff_max_s: float = 30.0,
    restart_window_s: float | None = None,
    jitter_seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    tracer=None,
) -> dict[str, Any]:
    """Run ``make_trainer().fit()`` with restart-from-checkpoint supervision.

    ``make_trainer`` must return a fresh Trainer whose config has a
    ``checkpoint_dir`` (the recovery anchor) — each retry constructs a new
    trainer with ``resume=True`` forced, restores the latest INTACT
    checkpoint (torn/corrupt steps are walked past —
    ``CheckpointManager.restore_latest_intact``), and runs only the
    REMAINING epochs with the original data schedule, so the recovered
    trajectory is the fault-free trajectory.  ``preemption`` is forwarded
    to every ``fit`` so SIGTERM still means checkpoint-and-exit under
    supervision.

    Restart policy: an exception in ``retryable`` triggers a restart,
    after ``min(backoff_max_s, backoff_base_s * 2**(k-1)) * jitter``
    seconds (k = restarts counted INSIDE ``restart_window_s``; jitter is
    deterministic per (``jitter_seed``, attempt)).  Only restarts within
    the window count against ``max_restarts`` — with a window set, N
    faults spread over a month don't kill the run; without one
    (``None``), the budget is lifetime, as before.  Every restart writes a
    ``restart`` record (attempt, exception type, resume step, backoff)
    through the new trainer's MetricWriter.  Returns the final summary
    with a ``restarts`` count added.

    ``tracer`` (utils/tracing.Tracer | None, nil-guarded): each restart
    lands as a ``restart`` instant (attempt, exception, resume step,
    backoff), and a trainer built without a tracer inherits this one, so
    its ``checkpoint_restore`` and epoch spans share the timeline.
    """
    attempt = 0
    pending_restart: dict[str, Any] | None = None
    window: deque[float] = deque()
    while True:
        trainer = make_trainer()
        if tracer is not None and getattr(trainer, "_tracer", None) is None:
            trainer._tracer = tracer
            trainer._compile.bind(tracer)
        if attempt > 0:
            cfg = trainer.config
            if not cfg.checkpoint_dir:
                raise ValueError("run_with_recovery needs checkpoint_dir to resume")
            trainer.config = cfg.replace(resume=True)
            resume_step = 0
            if trainer._ckpt is not None and trainer._ckpt.latest_step() is not None:
                try:
                    resume_step = trainer.restore_checkpoint()
                except FileNotFoundError:
                    resume_step = 0  # every step condemned: restart fresh
            done_epochs = resume_step // trainer.steps_per_epoch
            if done_epochs:
                # continue-to-total: cfg.epochs is the TOTAL the caller asked
                # for; the resumed trainer runs only what is left (clamped to
                # 1 for the pathological fault-after-final-save case), and
                # fit()'s absolute-epoch data schedule picks up where the
                # restored step left off
                trainer.config = trainer.config.replace(
                    epochs=max(1, cfg.epochs - done_epochs)
                )
            if pending_restart is not None:
                trainer.writer.write(
                    "restart", step=resume_step,
                    attempt=attempt,
                    exception=pending_restart["exception"],
                    resume_step=resume_step,
                    backoff_s=pending_restart["backoff_s"],
                )
                if tracer is not None:
                    tracer.instant(
                        "restart", cat="elastic", attempt=attempt,
                        exception=pending_restart["exception"],
                        resume_step=resume_step,
                        backoff_s=pending_restart["backoff_s"])
                pending_restart = None
        try:
            summary = trainer.fit(preemption=preemption)
            summary["restarts"] = attempt
            return summary
        except tuple(retryable) as e:
            now = clock()
            if restart_window_s is not None:
                while window and now - window[0] > restart_window_s:
                    window.popleft()
            window.append(now)
            if len(window) > max_restarts:
                raise
            attempt += 1
            backoff = min(
                backoff_max_s, backoff_base_s * 2.0 ** (len(window) - 1)
            ) * _jitter(jitter_seed, attempt)
            pending_restart = {
                "exception": type(e).__name__,
                "backoff_s": round(backoff, 4),
            }
            if on_restart is not None:
                on_restart(attempt, e)
            if backoff > 0:
                sleep(backoff)
