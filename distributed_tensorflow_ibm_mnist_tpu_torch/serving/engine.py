"""Continuous-batching inference engine of the port (greedy, dense KV cache).

The counterpart of the JAX package's ``serving/engine.py`` for this slice.
The device side is a fixed set of shapes: a B=1 prefill per prompt bucket
(core/generate.py ``make_prefill``: the normal forward, through the flash
kernel for ``attn="flash"``), ONE batched decode step across all
``slots`` rows with per-row cursors, a slot insert and a per-slot reset.
A host loop multiplexes a stream of variable-length requests through it.

:meth:`InferenceEngine.step` is one iteration: cancel overdue rows ->
admit queued requests into free slots (bucketed prefill, row inserted into
the slot cache, first token picked) -> one decode step across ALL slots ->
retire rows on EOS or budget, zeroing their cache rows.  Freed slots
refill on the next iteration, so no request waits on another's completion.
Idle slots decode garbage into their own rows (writes are per-row and the
batch shape is fixed): wasted work on an un-full engine, never corruption.

Greedy output is token-identical to the JAX engine on the same weights
(tests/test_torch_serving.py).  Failure isolation follows the JAX engine:
a request whose own prefill or ``callback`` raises fails alone and the
loop keeps serving; a fault in the batched decode step fails every
in-flight request and re-raises.

Constructor knobs of the JAX engine that later slices port (decode-ahead
windows, speculative decoding, the prefix cache, paged KV, chunked
prefill, tp/cp, int8, disaggregated roles, chaos, tracing, telemetry)
raise ``NotImplementedError`` when set away from their defaults, and so
does a request that asks for sampling (temperature > 0).

The engine is single-threaded: submit and run from one thread.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    init_cache,
    make_decode_step,
    make_prefill,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    reset_cache_slots,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import (
    SamplingParams,
    first_pick,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    FIFOScheduler,
    Request,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import ServingStats
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter

# knob -> (default, the later slice that ports it)
_REFUSED = {
    "decode_ahead": (1, "the decode-ahead serving slice"),
    "speculative": (None, "the speculative-decoding slice"),
    "prefix_cache_bytes": (0, "the prefix-cache slice"),
    "kv_page_size": (0, "the paged-KV slice"),
    "prefill_chunk": (0, "the chunked-prefill slice"),
    "tp": (1, "the tensor-parallel serving slice"),
    "cp": (1, "the context-parallel serving slice"),
    "quant": (None, "the int8 serving slice"),
    "role": ("both", "the disaggregated serving slice"),
    "chaos": (None, "the host serving tier slice"),
    "tracer": (None, "the host serving tier slice"),
    "telemetry": (None, "the host serving tier slice"),
}


class InferenceEngine:
    """Slot-multiplexed continuous-batching greedy decoder for a causal LM.

    ``slots`` is the resident decode batch; ``max_len`` the per-slot KV
    length.  ``scheduler`` defaults to a :class:`FIFOScheduler` built from
    ``buckets=`` (or the stock ladder); given both, they must agree.
    ``params``, when given, is a ``state_dict`` loaded into ``model``
    (e.g. from convert.py ``causal_lm_state_dict``); None serves the
    model's own weights.  ``device`` (the GPU unless ``device="cpu"``)
    must be where the model lives.

    Usage::

        eng = InferenceEngine(model, slots=4, max_len=128)
        eng.submit([1, 2, 3], max_new=16)
        done = eng.run()          # drive until every request retired
        done[0].generated         # real tokens (EOS kept)
    """

    def __init__(self, model, params: dict | None = None, *, slots: int,
                 max_len: int, scheduler: FIFOScheduler | None = None,
                 buckets: tuple[int, ...] | None = None, decode_ahead: int = 1,
                 speculative: str | None = None, prefix_cache_bytes: int = 0,
                 kv_page_size: int = 0, prefill_chunk: int = 0, tp: int = 1,
                 cp: int = 1, quant: str | None = None,
                 eos_id: int | None = None, pad_id: int = 0, role: str = "both",
                 writer: MetricWriter | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 chaos=None, tracer=None, telemetry=None, device=None):
        knobs = dict(decode_ahead=decode_ahead, speculative=speculative,
                     prefix_cache_bytes=prefix_cache_bytes,
                     kv_page_size=kv_page_size, prefill_chunk=prefill_chunk,
                     tp=tp, cp=cp, quant=None if quant == "none" else quant,
                     role=role, chaos=chaos, tracer=tracer, telemetry=telemetry)
        for name, value in knobs.items():
            default, where = _REFUSED[name]
            if value != default:
                raise NotImplementedError(
                    f"InferenceEngine({name}={value!r}) is not in the PyTorch "
                    f"port yet ({where} ports it); leave it at {default!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(
                f"max_len must be >= 2 (one prompt token + one generated), "
                f"got {max_len}")
        if eos_id is not None and eos_id == pad_id:
            raise ValueError(
                f"eos_id and pad_id must differ (both {eos_id}): idle slots "
                "are fed pad_id, which must never read as a stop")
        self.device = resolve_device(device)
        mdev = model.device
        if mdev.type != self.device.type or (
                self.device.index is not None and mdev.index != self.device.index):
            raise ValueError(
                f"the model lives on {mdev} but the engine serves on "
                f"{self.device}: build the model on the engine's device")
        if params is not None:
            model.load_state_dict(params, strict=True)
        if scheduler is None:
            scheduler = FIFOScheduler(
                max_len=max_len,
                buckets=buckets if buckets is not None else
                tuple(b for b in (16, 32, 64, 128) if b <= max_len) or (max_len,),
                clock=clock)
        elif buckets is not None:
            want = tuple(sorted(set(int(b) for b in buckets)))
            if want != scheduler.buckets:
                raise ValueError(
                    f"engine buckets= {want} != scheduler buckets "
                    f"{scheduler.buckets} — the prefill runs at the "
                    "scheduler's shapes")
        if scheduler.max_len != max_len:
            raise ValueError(
                f"scheduler.max_len ({scheduler.max_len}) != engine max_len "
                f"({max_len}) — admission would pass requests the cache "
                "cannot hold")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.scheduler = scheduler
        self.buckets = scheduler.buckets
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.writer = writer
        self.clock = clock
        self.stats = ServingStats(slots)
        self._prefill = make_prefill(model, max_len)
        self._step = make_decode_step(model, max_len, ragged=True)
        self.cache = init_cache(model, slots, max_len)
        self._slot_req: list[Request | None] = [None] * slots
        self._slot_tok = np.full((slots,), self.pad_id, np.int64)
        self.completed: list[Request] = []
        self._draining = False
        self._closed = False

    # ------------------------------------------------------------------
    # request lifecycle

    def submit(self, prompt, max_new: int, deadline_s: float | None = None,
               callback: Callable | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Enqueue a request (see :meth:`FIFOScheduler.submit`; raises
        ``QueueFull`` under backpressure).  ``callback(request, token)``
        streams every generated token; if it raises, THIS request fails.
        Refused after :meth:`drain` / :meth:`close`."""
        if self._closed or self._draining:
            raise RuntimeError(
                "engine is " + ("closed" if self._closed else "draining")
                + " — no new requests")
        if sampling is not None and sampling.sampled:
            raise NotImplementedError(
                "sampled requests (temperature > 0) are not in the PyTorch "
                "port yet (the sampling serving slice ports them)")
        return self.scheduler.submit(prompt, max_new, deadline_s=deadline_s,
                                     callback=callback, sampling=sampling)

    @property
    def occupied(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def has_work(self) -> bool:
        return self.occupied > 0 or len(self.scheduler) > 0

    def _retire(self, slot: int, status: str, now: float) -> None:
        req = self._slot_req[slot]
        req.status = status
        req.finish_t = now
        self._slot_req[slot] = None
        self.completed.append(req)
        self.stats.add(req)

    def _fail(self, req: Request, exc: BaseException, now: float) -> None:
        """Move ``req`` to the terminal FAILED state (isolated casualty)."""
        req.status = "failed"
        req.error = f"{type(exc).__name__}: {exc}"
        req.finish_t = now
        self.completed.append(req)
        self.stats.add(req)

    @staticmethod
    def _notify(req: Request, tok: int) -> None:
        if req.callback is not None:
            req.callback(req, tok)

    @staticmethod
    def _insert_impl(cache: dict, row_cache: dict, slot: int) -> None:
        """Write row 0 of a B=1 prefill cache into ``slot`` of the engine
        cache, in place (every leaf is (B, ...)-leading)."""
        for name, entry in cache.items():
            for leaf, full in entry.items():
                full[slot].copy_(row_cache[name][leaf][0])

    def _done_reason(self, req: Request) -> str | None:
        if self.eos_id is not None and req.generated and req.generated[-1] == self.eos_id:
            return "done"
        if len(req.generated) >= req.max_new:
            return "done"
        return None

    def _admit(self, req: Request, slot: int, now: float) -> bool:
        """Prefill ``req`` at its bucket, land it in ``slot`` and pick its
        first token.  A failure of the request's own processing fails it
        and leaves the slot free.  Returns True when the slot's cache row
        needs a reset: a failure after the insert, or a request that
        retired at admission."""
        inserted = False
        t_p = self.clock()
        try:
            n = int(req.tokens.size)
            padded = np.full((1, req.bucket), self.pad_id, np.int64)
            padded[0, :n] = req.tokens
            row_cache, logits = self._prefill(
                torch.as_tensor(padded, device=self.device),
                torch.tensor([n], dtype=torch.int32, device=self.device))
            with torch.no_grad():
                self._insert_impl(self.cache, row_cache, slot)
            inserted = True
            tok, logp = first_pick(logits)
            first = int(tok[0])  # host sync: the first token is on the host
            req.admit_t = now
            req.generated.append(first)
            req.logprobs.append(float(logp[0]))
            req.first_token_t = self.clock()
            self.stats.prefill(req.first_token_t - t_p)
            req.status = "running"
            self._notify(req, first)
        except Exception as e:
            self._fail(req, e, self.clock())
            return inserted
        self._slot_req[slot] = req
        self._slot_tok[slot] = first
        if self._done_reason(req) is not None:
            self._retire(slot, self._done_reason(req), self.clock())
            return True
        return False

    def _admit_free_slots(self, reset_mask: np.ndarray) -> bool:
        """Fill free slots from the queue; a failed admission frees the slot
        for the next request in the same iteration.  True when anything
        landed."""
        admitted = False
        for slot in range(self.slots):
            while self._slot_req[slot] is None:
                req = self.scheduler.pop(self.clock())
                if req is None:
                    return admitted
                needs_reset = self._admit(req, slot, self.clock())
                if self._slot_req[slot] is not None:
                    admitted = True
                    reset_mask[slot] = False  # the insert overwrote the row
                elif needs_reset:
                    reset_mask[slot] = True
        return admitted

    def step(self) -> int:
        """One host-loop iteration: cancel -> admit -> decode -> retire.
        Returns the number of tokens produced by the decode step."""
        if self._closed:
            raise RuntimeError("engine is closed")
        t0 = self.clock()
        reset_mask = np.zeros((self.slots,), bool)

        # 1) deadline sweep over running rows (queued rows are swept by the
        #    scheduler at pop time)
        for slot, req in enumerate(self._slot_req):
            if req is not None and t0 > req.overdue_at:
                self._retire(slot, "cancelled", t0)
                reset_mask[slot] = True

        # 2) admit into free slots
        self._admit_free_slots(reset_mask)

        # 3) ONE decode step across ALL slots (idle rows decode garbage into
        #    their own rows).  A fault here belongs to every in-flight
        #    request: they fail and the error re-raises.
        produced = 0
        decoded = self.occupied > 0
        if decoded:
            t_d = self.clock()
            try:
                tok = torch.as_tensor(self._slot_tok, device=self.device)
                _, logits = self._step(self.cache, tok)
                nxt, logp = first_pick(logits)
                # one device->host copy (and sync) per step
                blk = torch.stack((nxt.double(), logp.double())).cpu().numpy()
            except Exception as e:
                self._fail_in_flight(e, self.clock())
                raise
            now = self.clock()
            self.stats.decode(now - t_d)
            self._slot_tok[:] = self.pad_id  # idle rows are fed pad_id
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                tok_i = int(blk[0, slot])
                self._slot_tok[slot] = tok_i
                req.generated.append(tok_i)
                req.logprobs.append(float(blk[1, slot]))
                produced += 1
                try:
                    self._notify(req, tok_i)
                except Exception as e:
                    self._slot_req[slot] = None
                    self._fail(req, e, now)
                    reset_mask[slot] = True
                    continue
                reason = self._done_reason(req)
                if reason is not None:
                    self._retire(slot, reason, now)
                    reset_mask[slot] = True

        # 4) zero retired rows so idle cursors restart from 0 and the next
        #    admission starts from a clean row
        if reset_mask.any():
            with torch.no_grad():
                reset_cache_slots(self.cache,
                                  torch.as_tensor(reset_mask, device=self.device))
        self.stats.tick(self.occupied, max(self.clock() - t0, 0.0),
                        decoded=decoded)
        return produced

    def _fail_in_flight(self, exc: BaseException, now: float) -> None:
        """Fail every running request and reset their rows."""
        mask = np.zeros((self.slots,), bool)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._slot_req[slot] = None
            req.engine_fault = True  # collateral, not the request's own fault
            self._fail(req, exc, now)
            mask[slot] = True
        if mask.any():
            with torch.no_grad():
                reset_cache_slots(self.cache, torch.as_tensor(mask, device=self.device))

    def _book_scheduler_cancels(self) -> None:
        """Queued requests the scheduler cancelled as overdue join the book."""
        for req in self.scheduler.cancelled:
            self.completed.append(req)
            self.stats.add(req)
        self.scheduler.cancelled.clear()

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drive :meth:`step` until every submitted request has retired (or
        ``max_steps`` iterations elapse) and return the completed requests
        in retirement order.  Emits the stats through ``writer`` on drain."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._book_scheduler_cancels()
        if not self.has_work and self.writer is not None:
            self.stats.emit(self.writer)
        return self.completed

    # ------------------------------------------------------------------
    # graceful shutdown

    def drain(self, max_steps: int | None = None) -> list[Request]:
        """Serve every request already accepted, admitting nothing new
        (:meth:`submit` raises from the moment drain starts)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._draining = True
        return self.run(max_steps=max_steps)

    def close(self) -> None:
        """Cancel every queued and in-flight request (``engine_fault`` set,
        partial output kept), emit the stats and refuse further use.
        Idempotent."""
        if self._closed:
            return
        self._draining = True
        now = self.clock()
        mask = np.zeros((self.slots,), bool)
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            req.engine_fault = True
            self._retire(slot, "cancelled", now)
            mask[slot] = True
        if mask.any():
            with torch.no_grad():
                reset_cache_slots(self.cache, torch.as_tensor(mask, device=self.device))
        while (req := self.scheduler.pop(now)) is not None:
            req.engine_fault = True
            req.status = "cancelled"
            req.finish_t = now
            self.completed.append(req)
            self.stats.add(req)
        self._book_scheduler_cancels()
        if self.writer is not None:
            self.stats.emit(self.writer)
        self._closed = True

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
