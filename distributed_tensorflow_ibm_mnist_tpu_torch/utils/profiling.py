"""Tracing and timing (the port's counterpart of the JAX package's
``utils/profiling.py``), on ``torch.profiler`` and CUDA fences:

* :func:`trace` — capture a ``torch.profiler`` trace of the enclosed region
  (host ops, and the card's kernels when CUDA is available) and write it
  as a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``;
* :class:`TraceSession` — the same capture, started and stopped where a
  loop decides (``Trainer.fit`` with ``profile_dir`` starts it after the
  first epoch's fence, at once when ``epochs == 1``); ``stop`` is
  idempotent and safe without ``start``;
* :class:`StepTimer` — wall time per step with a fence at the end of each
  (``torch.cuda.synchronize`` on the fence tensor's device: the host only
  queues kernels, so an unfenced timer measures the enqueue) and warm-up
  exclusion;
* :func:`profile_fn` — time a callable that way.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import _sanitize

TRACE_FILE = "trace.json"


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class TraceSession:
    """A ``torch.profiler`` capture written to ``log_dir/trace.json`` (a
    Chrome trace) when it stops."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.active = False
        self._prof: torch.profiler.profile | None = None

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, TRACE_FILE)

    def start(self) -> None:
        if not self.active:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
            self.active = True

    def stop(self) -> None:
        if self.active:
            self.active = False
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.path)
            self._prof = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into ``log_dir/trace.json``."""
    session = TraceSession(log_dir)
    session.start()
    try:
        yield session
    finally:
        session.stop()


def _fence(obj: Any) -> None:
    """Wait for the work that produces ``obj`` (a tensor or a nest of them):
    synchronize each CUDA device it lives on."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(obj)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall time per step with device fencing and warm-up exclusion.

    >>> timer = StepTimer(warmup=2)
    >>> for batch in batches:
    ...     with timer.step() as t:
    ...         t.set_fence(train_step(state, batch))  # fenced on exit
    >>> timer.summary(items_per_step=batch_size)
    """

    def __init__(self, warmup: int = 1):
        self._warmup = warmup
        self._times: list[float] = []
        self._fence_obj: Any = None

    @contextlib.contextmanager
    def step(self, fence: Any = None):
        """Time one step; ``fence`` (a tensor or a nest of them, or one
        registered with :meth:`set_fence` in the body) is waited for on
        exit."""
        t0 = time.perf_counter()
        self._fence_obj = fence
        yield self
        if self._fence_obj is not None:
            _fence(self._fence_obj)
        self._times.append(time.perf_counter() - t0)

    def set_fence(self, obj: Any):
        self._fence_obj = obj

    @property
    def times(self) -> list[float]:
        """Post-warm-up samples only; empty until a non-warm-up step lands."""
        return self._times[self._warmup:]

    def summary(self, items_per_step: int | None = None) -> dict[str, Any]:
        """Post-warm-up timing stats, strict-JSON-safe: with no post-warm-up
        sample every field is None (never NaN)."""
        samples = self.times
        if not samples:
            out: dict[str, Any] = {
                "steps": int(len(self._times)),
                "mean_s": None, "p50_s": None, "p90_s": None, "max_s": None,
            }
            if items_per_step:
                out["items_per_sec"] = None
            return out
        ts = np.asarray(samples)
        out = {
            "steps": int(len(self._times)),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p90_s": float(np.percentile(ts, 90)),
            "max_s": float(ts.max()),
        }
        if items_per_step:
            out["items_per_sec"] = float(items_per_step / ts.mean())
        return _sanitize(out)


def profile_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> dict[str, float]:
    """Time ``fn(*args)``: ``warmup`` calls off the clock, then ``iters``
    calls, each fenced on its result."""
    for _ in range(warmup):
        _fence(fn(*args))
    timer = StepTimer(warmup=0)
    for _ in range(iters):
        with timer.step() as t:
            t.set_fence(fn(*args))
    return timer.summary()
