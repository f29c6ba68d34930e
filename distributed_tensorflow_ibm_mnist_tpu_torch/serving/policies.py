"""Pluggable admission policies for the daemonized serving tier.

The step-pumped tier had exactly one admission decision: a bounded FIFO
queue that raises :class:`~..serving.scheduler.QueueFull` at the bound.
The daemon (serving/daemon.py) keeps that backpressure contract but adds
a policy seam AT THE FRONT DOOR — the admission queue between
``ServingDaemon.submit()`` and the router dispatch — because that is the
only place where requests WAIT in a reorderable set.  Once a request
reaches a replica's scheduler it is FIFO like before; the policy decides
(a) who gets rejected at submit time and (b) in what order the waiting
set drains into the tier.

Three policies, mirroring the classic serving triad:

* :class:`FIFOPolicy` — arrival order, reject only at the queue bound.
  The baseline: identical end-to-end behaviour to the step-pumped tier.
* :class:`PriorityPolicy` — strict priority classes (higher first), FIFO
  within a class.  An overloaded tier serves interactive traffic before
  batch traffic instead of interleaving them.
* :class:`DeadlineAwarePolicy` — shed-at-submit: reject a request whose
  TTFT SLO is already unmeetable given the predicted queue wait, raising
  :class:`SLOUnmeetable` (a :class:`QueueFull` subclass, so existing
  backpressure handlers shed it the same way).  Rejecting doomed work at
  the door is what keeps GOODPUT (requests meeting SLO per second) high
  under overload — admitting it would burn slots on requests that can
  only ever count as misses.

The wait predictor is deliberately a heuristic: an EMA of observed
submit→first-token latency (fed back by the daemon's delivery thread via
:meth:`AdmissionPolicy.note_first_token`), scaled by the queue depth
ahead of the candidate over the tier's concurrency.  Until the first
observation the policy is optimistic (admit everything) — the cold tier
has no basis to shed.

Thread model: ``admit``/``key`` are called under the daemon's admission
lock and ``note_first_token`` from the single delivery thread, so a
policy needs no internal locking of its own.
"""

from __future__ import annotations

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import QueueFull


class SLOUnmeetable(QueueFull):
    """Rejected at submit: the predicted queue wait already exceeds the
    request's TTFT SLO, so admitting it could only produce an SLO miss.
    Subclasses :class:`QueueFull` so callers that already turn
    backpressure into shed/429 handle deadline shedding for free."""


class AdmissionPolicy:
    """Base policy: FIFO order, no shedding beyond the queue bound.

    Subclass hooks:

    ``key(dr)``
        Sort key for the admission heap — smallest drains first.  Must
        embed a tiebreaker (``dr.id`` — monotone submit order) so equal
        keys stay FIFO and the heap never compares request objects.
    ``admit(dr, queued)``
        Called BEFORE the request enters the admission queue, with the
        number of requests already waiting or in flight ahead of it.
        Raise (:class:`SLOUnmeetable` or any :class:`QueueFull`) to shed;
        return normally to admit.
    ``note_first_token(wait_s)``
        Feedback from the daemon's delivery thread: one request's
        observed submit→first-token latency.  Policies that predict wait
        fold it into their estimate; the base policy ignores it.
    ``retry_after_s(queued)``
        A backoff hint for a request rejected with ``queued`` ahead of
        it: the predicted seconds until the tier is likely to admit
        again, or None (no basis).  The daemon stamps it onto every
        :class:`QueueFull`/:class:`SLOUnmeetable` it raises so protocol
        front ends can emit real ``Retry-After`` headers; the base
        policy predicts nothing.
    """

    name = "fifo"

    def key(self, dr) -> tuple:
        return (dr.id,)

    def admit(self, dr, queued: int) -> None:
        return

    def note_first_token(self, wait_s: float) -> None:
        return

    def retry_after_s(self, queued: int) -> float | None:
        return None


class FIFOPolicy(AdmissionPolicy):
    """Arrival order, queue-bound backpressure only — the baseline that
    behaves exactly like the step-pumped tier's scheduler front door."""


class PriorityPolicy(AdmissionPolicy):
    """Strict priority classes: higher ``dr.priority`` drains first,
    FIFO (submit order) within a class.  No shedding beyond the bound —
    under sustained overload low-priority work waits, it is not dropped,
    so conservation still holds exactly."""

    name = "priority"

    def key(self, dr) -> tuple:
        return (-int(dr.priority), dr.id)


class DeadlineAwarePolicy(PriorityPolicy):
    """Priority ordering + shed-at-submit for unmeetable TTFT SLOs.

    Predicted wait for a candidate with ``queued`` requests ahead::

        predicted = ema_wait * (1 + queued / concurrency)

    where ``ema_wait`` is the EMA (``alpha``) of observed
    submit→first-token latencies and ``concurrency`` is the tier's
    rough parallel capacity (replicas × slots — how many of the queued
    requests are served concurrently rather than serially).  A request
    with ``ttft_slo_s`` set is rejected with :class:`SLOUnmeetable` when
    ``predicted > ttft_slo_s * slack``; requests without a TTFT SLO are
    never shed here (they fall through to the queue bound).  ``slack >
    1`` sheds late (optimistic), ``< 1`` sheds early (conservative).
    """

    name = "deadline"

    def __init__(self, *, alpha: float = 0.3, concurrency: int = 1,
                 slack: float = 1.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if slack <= 0:
            raise ValueError(f"slack must be > 0, got {slack}")
        self.alpha = float(alpha)
        self.concurrency = int(concurrency)
        self.slack = float(slack)
        self.ema_wait_s: float | None = None
        self.shed = 0          # requests this policy rejected
        self.observations = 0  # note_first_token feedback count

    def predicted_wait_s(self, queued: int) -> float | None:
        """The estimator, exposed for tests/vitals: None = no basis yet."""
        if self.ema_wait_s is None:
            return None
        return self.ema_wait_s * (1.0 + queued / self.concurrency)

    def admit(self, dr, queued: int) -> None:
        if dr.ttft_slo_s is None:
            return
        predicted = self.predicted_wait_s(queued)
        if predicted is None:
            return  # cold start: no observed latency to predict from
        if predicted > dr.ttft_slo_s * self.slack:
            self.shed += 1
            raise SLOUnmeetable(
                f"request {dr.id}: predicted TTFT {predicted:.4f}s with "
                f"{queued} ahead exceeds SLO {dr.ttft_slo_s:.4f}s "
                f"(x{self.slack:g} slack) — shed at submit")

    def note_first_token(self, wait_s: float) -> None:
        self.observations += 1
        if self.ema_wait_s is None:
            self.ema_wait_s = float(wait_s)
        else:
            self.ema_wait_s += self.alpha * (wait_s - self.ema_wait_s)

    def retry_after_s(self, queued: int) -> float | None:
        """Backoff hint = the same estimator the shed verdict used: the
        predicted wait at the CURRENT depth is how long the rejected
        caller should expect the tier to take to digest what is ahead
        of it.  None before the first observation (cold tier — nothing
        sheds then either)."""
        return self.predicted_wait_s(queued)
