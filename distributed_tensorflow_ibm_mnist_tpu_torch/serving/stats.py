"""Serving metrics of the port: TTFT/latency, tokens/sec, occupancy.

The subset of the JAX package's ``ServingStats`` this slice fills:

* **TTFT** — submit to the first token ON THE HOST (queue wait included);
* **latency** — submit to retirement of ``done`` requests;
* **tokens/sec** — generated tokens over the engine's busy window (first
  admission to last retirement);
* **occupancy** — time-weighted mean fraction of slots holding a request;
* the done / cancelled / failed counts;
* ``prefill_s`` / ``decode_s`` — host seconds inside prefill admissions
  and inside decode steps (each ends in a device sync), the split of
  where the serving time goes.

Percentiles are p50/p95/p99 over every completed request.
"""

from __future__ import annotations

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import Request
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter


def percentiles(xs, qs=(50, 95, 99)) -> dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} over xs (empty -> None values)."""
    if not len(xs):
        return {f"p{q}": None for q in qs}
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": round(float(np.percentile(arr, q)), 6) for q in qs}


class ServingStats:
    """Accumulates request records and engine-loop samples: the engine
    calls :meth:`tick` once per host-loop iteration, :meth:`add` once per
    retired request; :meth:`summary` folds them into one flat dict."""

    def __init__(self, slots: int):
        self.slots = slots
        self.requests: list[Request] = []
        self._counts = {"done": 0, "cancelled": 0, "failed": 0}
        self._tokens = 0
        self._occ_time = 0.0   # integral of occupied_slots * dt
        self._busy_time = 0.0  # integral of dt while the engine had work
        self._decode_steps = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._start_t: float | None = None
        self._end_t: float | None = None

    def tick(self, occupied: int, dt: float, decoded: bool = False) -> None:
        self._occ_time += occupied * dt
        self._busy_time += dt
        self._decode_steps += int(decoded)

    def prefill(self, seconds: float) -> None:
        """One admission's prefill + first pick, in host seconds."""
        self._prefill_s += seconds

    def decode(self, seconds: float) -> None:
        """One batched decode step + readback, in host seconds."""
        self._decode_s += seconds

    def add(self, req: Request) -> None:
        self.requests.append(req)
        if req.status in self._counts:
            self._counts[req.status] += 1
        self._tokens += len(req.generated)
        if req.admit_t is not None:
            self._start_t = (req.admit_t if self._start_t is None
                             else min(self._start_t, req.admit_t))
        if req.finish_t is not None:
            self._end_t = (req.finish_t if self._end_t is None
                           else max(self._end_t, req.finish_t))

    def summary(self) -> dict:
        ttft = [r.first_token_t - r.submit_t for r in self.requests
                if r.first_token_t is not None]
        latency = [r.finish_t - r.submit_t for r in self.requests
                   if r.status == "done" and r.finish_t is not None]
        window = (self._end_t - self._start_t
                  if self._start_t is not None and self._end_t is not None
                  and self._end_t > self._start_t else None)
        out = {
            "slots": self.slots,
            "n_requests": len(self.requests),
            "n_done": self._counts["done"],
            "n_cancelled": self._counts["cancelled"],
            "n_failed": self._counts["failed"],
            "tokens_generated": self._tokens,
            "tokens_per_sec": round(self._tokens / window, 3) if window else None,
            "busy_s": round(self._busy_time, 6),
            "decode_steps": self._decode_steps,
            "slot_occupancy": (
                round(self._occ_time / (self._busy_time * self.slots), 4)
                if self._busy_time > 0 else None),
            "prefill_s": round(self._prefill_s, 6),
            "decode_s": round(self._decode_s, 6),
        }
        for name, xs in (("ttft_s", ttft), ("latency_s", latency)):
            for k, v in percentiles(xs).items():
                out[f"{name}_{k}"] = v
        return out

    def emit(self, writer: MetricWriter, kind: str = "serving") -> dict:
        return writer.write(kind, **self.summary())
