"""Admission control for the port's continuous-batching engine: FIFO + buckets.

The port's copy of the JAX package's ``serving/scheduler.py``.  Three jobs:

* **Bucketing** — a prompt rides in the smallest of ``buckets`` that fits,
  right-padded with ``pad_id``, so the prefill sees a closed set of shapes
  (the causal mask keeps real tokens from seeing the pads).
* **Backpressure** — the queue is bounded (``max_queue``); ``submit`` on a
  full queue raises :class:`QueueFull` instead of buffering without bound.
* **Deadlines** — a request may carry ``deadline_s`` (seconds from submit).
  Overdue QUEUED requests are cancelled at pop time, never admitted;
  overdue RUNNING rows are cancelled by the engine's per-iteration sweep.

With ``chunked_prefill`` (the engine's ``prefill_chunk``) a prompt needs
no bucket: any length with ``len + max_new <= max_len`` is admitted, its
``bucket`` capped at the largest (a label for ``prefix_key``, never a
prefill shape).

With a ``tracer`` (utils/tracing.Tracer) the scheduler opens each
request's span tree at submit: the ``request`` root on its own track and
its ``queue`` phase, closed at pop (or at an overdue cancel); the engine
adopts the same tracer and continues the tree.

The queue is a ``collections.deque``, whose ``append`` and ``popleft`` are
each atomic under CPython, so a daemon pump can pop while a producer
appends.  ``submit``'s bounded check-then-append is not atomic: concurrent
submitters serialize it themselves (the daemon does, under its tier lock).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import prefix_key
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import SamplingParams


def request_fingerprint(prompt, max_new: int, sampling=None) -> str:
    """Content address of one request's replay identity: blake2b over the
    prompt tokens, the budget and the sampling params (which together fix
    the token stream).  Deadlines and SLOs are left out on purpose."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(prompt, np.int32).tobytes())
    h.update(int(max_new).to_bytes(8, "little"))
    if sampling is not None:
        h.update(json.dumps(sampling.to_dict(), sort_keys=True).encode())
    return h.hexdigest()


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the caller must retry or shed load.

    ``retry_after_s`` is the machine-readable retry hint (seconds), or None
    when the rejecting layer has no basis to predict one; the daemon stamps
    it from its admission policy's wait predictor (serving/policies.py)."""

    retry_after_s: float | None = None


@dataclass
class Request:
    """One generation request and its lifecycle record.

    The scheduler fills the identity/admission fields; the engine fills
    the timing/output fields.  ``status`` walks queued -> running ->
    (done | cancelled | failed); ``failed`` is the terminal state of a
    request whose own processing raised (``error`` says why)."""

    id: int
    tokens: np.ndarray          # (len,) int32 — the real (unpadded) prompt
    max_new: int                # generation budget (EOS may stop earlier)
    bucket: int                 # padded prefill length the prompt rides in
    deadline_s: float | None    # seconds from submit; None = no deadline
    submit_t: float             # scheduler clock at submit
    callback: Callable | None = None    # callback(request, token) after
    #   every generated token; an exception fails this request only
    ttft_slo_s: float | None = None     # SLO target: submit -> first token
    #   on the host, seconds; None = no TTFT SLO
    tpot_slo_s: float | None = None     # SLO target: mean seconds per output
    #   token after the first; None = no TPOT SLO.  Neither cancels
    #   anything: the engine judges them (slo_ttft_ok at the first token,
    #   slo_tpot_ok at retirement) and ServingStats counts the verdicts
    admit_t: float | None = None        # engine: slot admission (prefill)
    first_token_t: float | None = None  # engine: first token on host (TTFT)
    finish_t: float | None = None       # engine: retirement
    generated: list[int] = field(default_factory=list)  # engine: output
    status: str = "queued"
    error: str | None = None            # engine: why status == "failed"
    slo_ttft_ok: bool | None = None     # engine verdict at the first token;
    #   None = not judged (no SLO, or no first token)
    slo_tpot_ok: bool | None = None     # engine verdict at retirement; None =
    #   not judged (no SLO, or not retired "done")
    engine_fault: bool = False          # engine: the terminal status is
    #   collateral of an engine-wide fault or close(), not the request's own
    prefix_key: str | None = None       # blake2b of (bucket, prompt)
    sampling: SamplingParams | None = None  # None = the engine default
    logprobs: list[float] = field(default_factory=list)  # engine: one
    #   log_softmax(raw logits)[token] per generated token
    pages: int = 0                      # paged engine: KV pages this
    #   request's block table spans (shared radix pages included)
    radix_tokens: int = 0               # engine: prompt tokens served from
    #   shared radix pages (prefill skipped for them)
    trace: dict | None = None           # tracing bookkeeping: {"id": the
    #   request span, "tid": its track, "phase": the open lifecycle-phase
    #   span (queue/admit/decode) or None}; None without a tracer
    trace_ctx: "object | None" = None   # utils/tracing.TraceContext stamped
    #   by the router after submit; None for direct engine callers

    @property
    def overdue_at(self) -> float:
        return np.inf if self.deadline_s is None else self.submit_t + self.deadline_s


class FIFOScheduler:
    """Bounded FIFO request queue with prompt-length bucketing.

    ``max_len`` is the engine's KV-cache length: a request must satisfy
    ``len(prompt) + max_new <= max_len`` and fit some bucket.  ``clock``
    is injectable for tests."""

    def __init__(self, max_len: int, buckets: tuple[int, ...] = (16, 32, 64, 128),
                 max_queue: int = 64, clock: Callable[[], float] = time.monotonic,
                 tracer=None, chunked_prefill: bool = False):
        if not buckets:
            raise ValueError("need at least one prefill bucket")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_len = max_len
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if self.buckets[-1] > max_len:
            raise ValueError(
                f"largest bucket ({self.buckets[-1]}) exceeds max_len "
                f"({max_len}) — a prompt that long could never prefill")
        self.max_queue = max_queue
        self.clock = clock
        self.chunked_prefill = bool(chunked_prefill)
        # utils/tracing.Tracer | None: share the scheduler's clock with it
        self.tracer = tracer
        self._queue: deque[Request] = deque()
        self._ids = itertools.count()
        self.cancelled: list[Request] = []  # overdue-before-admission

    def __len__(self) -> int:
        return len(self._queue)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding an n-token prompt; raises if none does."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"({self.buckets[-1]}) — raise buckets=, shorten the prompt, "
            f"or serve with InferenceEngine(prefill_chunk=...) (chunked "
            f"prefill admits any prompt that fits the cache)")

    def submit(self, prompt, max_new: int, deadline_s: float | None = None,
               callback: Callable | None = None,
               ttft_slo_s: float | None = None,
               tpot_slo_s: float | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Enqueue one request; raises :class:`QueueFull` (backpressure) or
        ``ValueError`` (the request can never be served).  ``ttft_slo_s`` /
        ``tpot_slo_s`` are the optional latency SLO targets."""
        tokens = np.asarray(prompt, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if ttft_slo_s is not None and ttft_slo_s <= 0:
            raise ValueError(f"ttft_slo_s must be > 0, got {ttft_slo_s}")
        if tpot_slo_s is not None and tpot_slo_s <= 0:
            raise ValueError(f"tpot_slo_s must be > 0, got {tpot_slo_s}")
        if callback is not None and not callable(callback):
            raise ValueError("callback must be callable")
        if sampling is not None and not isinstance(sampling, SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got {type(sampling).__name__}")
        if tokens.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({tokens.size}) + max_new ({max_new}) exceeds the "
                f"engine cache length ({self.max_len})")
        if self.chunked_prefill and tokens.size > self.buckets[-1]:
            bucket = self.buckets[-1]  # a label: chunks never run at a bucket
        else:
            bucket = self.bucket_for(tokens.size)
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"request queue full ({self.max_queue}) — retry later or "
                "shed load (bounded-queue backpressure)")
        req = Request(id=next(self._ids), tokens=tokens, max_new=int(max_new),
                      bucket=bucket, deadline_s=deadline_s,
                      submit_t=self.clock(), callback=callback,
                      ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                      prefix_key=prefix_key(bucket, tokens), sampling=sampling)
        if self.tracer is not None:
            # the request's root span on its own track; "queue" is its
            # first phase (closed at pop, or at an overdue cancel)
            tid = self.tracer.track(f"req {req.id}")
            rid = self.tracer.begin(
                "request", cat="serving", tid=tid, req=req.id,
                bucket=bucket, prompt_len=int(tokens.size),
                max_new=int(max_new))
            req.trace = {
                "id": rid, "tid": tid,
                "phase": self.tracer.begin("queue", cat="serving",
                                           parent=rid, tid=tid),
            }
        self._queue.append(req)
        return req

    def pop(self, now: float | None = None) -> Request | None:
        """Next admissible request (FIFO), or None.  Overdue queued requests
        are cancelled in passing, never returned."""
        now = self.clock() if now is None else now
        while self._queue:
            req = self._queue.popleft()
            if now > req.overdue_at:
                req.status = "cancelled"
                req.finish_t = now
                if req.trace is not None and self.tracer is not None:
                    # terminal here: the engine never sees this request
                    self.tracer.end(req.trace["phase"])
                    self.tracer.end(req.trace["id"], status="cancelled")
                    req.trace = None
                self.cancelled.append(req)
                continue
            if req.trace is not None and self.tracer is not None:
                self.tracer.end(req.trace["phase"])  # the queue wait is over
                req.trace["phase"] = None
            return req
        return None
