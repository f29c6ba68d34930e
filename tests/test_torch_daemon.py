"""The port's threaded serving tier (``serving/daemon.py``,
``serving/policies.py``) against the JAX package's, on the CPU.

* PARITY: greedy streams through the daemon (two replicas, pump,
  dispatcher, delivery and watchdog threads) equal one fault-free engine,
  which equals JAX's engine on the same converted weights; callbacks,
  ``stream()`` and the router's record agree token for token.
* CONSERVATION: under a concurrent submit hammer (producer threads, a
  small admission bound, overdue requests mixed in) ``submitted == done +
  cancelled + failed + outstanding`` holds exactly, rejections apart, and
  every delivered stream is its request's final token list.
* FAILOVER: a ``daemon-pump`` raise and a ``daemon-pump`` wedge (heartbeat
  frozen; only the watchdog can see it) each fail one replica over with
  zero drops and reference tokens.
* POLICIES: ``PriorityPolicy`` and ``DeadlineAwarePolicy`` make JAX's
  decisions (order keys, admits, sheds, predictions, retry hints) on the
  same queue states; the daemon dispatches in policy order.
* DRAIN: ``drain()`` + ``close()`` leave ``tracer.open_spans == 0`` and
  every paged KV pool at refcount zero.

No ``pytest-timeout`` is assumed: every wait, join and drain carries its
own timeout, and a module fixture closes every daemon a test built.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import DaemonRequest as JaxDaemonRequest
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import policies as jpol
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    DaemonRequest,
    DeadlineAwarePolicy,
    FIFOScheduler,
    InferenceEngine,
    PriorityPolicy,
    QueueFull,
    Router,
    ServingDaemon,
    SLOUnmeetable,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import policies as tpol
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import TraceContext, Tracer

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6], [9, 1], [3, 3, 3, 3]]
WAIT_S = 60.0  # every terminal wait: generous, never load-bearing


@pytest.fixture(scope="module")
def weights():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, params, causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)


@pytest.fixture(scope="module")
def daemons():
    """Every daemon a test builds, closed at module teardown even when
    the test failed mid-way (close joins each thread with a timeout)."""
    built: list = []
    yield built
    for d in built:
        d.close()


def _factory(sd, **kw):
    def make_engine(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2, max_len=16,
            scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu", **kw)
    return make_engine


def _reference(sd, prompts=PROMPTS, max_new=6):
    eng = _factory(sd)(0)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    eng.close()
    return [list(r.generated) for r in reqs]


def _daemon(daemons, router, **kw):
    d = ServingDaemon(router, **kw)
    daemons.append(d)
    return d


def _pools_refcount_zero(router) -> bool:
    """Every live engine's pool holds only pages the radix trie owns, and
    every trie node is unreferenced."""
    for rep in router.replicas:
        if not rep.alive or rep.engine._pool is None:
            continue
        pool, radix = rep.engine._pool, rep.engine._radix
        stack = [radix.root]
        while stack:
            node = stack.pop()
            if node.ref != 0:
                return False
            stack.extend(node.children.values())
        if pool.allocated != radix.n_blocks:
            return False
    return True


def _stream(d, dr):
    return list(d.stream(dr, timeout=5.0))


def test_daemon_streams_equal_the_reference_and_jax(weights, daemons):
    jm, params, sd = weights
    want = _reference(sd)
    jeng = JaxEngine(jm, params, slots=2, max_len=16,
                     scheduler=JaxScheduler(max_len=16, buckets=(8,)))
    jreqs = [jeng.submit(p, max_new=6) for p in PROMPTS]
    jeng.run()
    jeng.close()
    assert [list(r.generated) for r in jreqs] == want

    tracer = Tracer()
    router = Router(_factory(sd, kv_page_size=4, tracer=tracer), 2, tracer=tracer)
    d = _daemon(daemons, router, liveness_timeout_s=60.0)
    cb: dict[int, list[int]] = {}
    with d:
        drs = []
        for p in PROMPTS:
            got: list[int] = []
            dr = d.submit(p, 6, callback=lambda dr, tok, got=got: got.append(tok),
                          trace_ctx=TraceContext.mint())
            cb[dr.id] = got
            drs.append(dr)
        assert all(dr.wait(WAIT_S) for dr in drs)
        assert [dr.tokens for dr in drs] == want
        assert all(dr.status == "done" and dr.error is None for dr in drs)
        assert [cb[dr.id] for dr in drs] == want
        assert [_stream(d, dr) for dr in drs] == want
        assert [list(dr.rr.generated) for dr in drs] == want
        cons = d.conservation()
        assert cons["conserved"] and cons["submitted"] == cons["done"] == len(PROMPTS)
        assert d.drain(timeout=WAIT_S)
        with pytest.raises(RuntimeError, match="draining"):
            d.submit([1, 2], 2)
        assert _pools_refcount_zero(router)
        summary = d.summary()
    assert tracer.open_spans == 0
    assert summary["daemon"]["conserved"] and summary["n_done"] == len(PROMPTS)
    names = {e["name"] for e in tracer.events()}
    assert {"daemon_request", "request", "decode", "window"} <= names
    d.close()  # idempotent


def test_refusals_name_their_sub_slice(weights, daemons):
    _, _, sd = weights
    router = Router(_factory(sd), 1)
    # the journal and a role-typed tier are ported: what stays refused is
    # a negative delivered-mark interval, a role without the paged cache,
    # and the tp=2 reshard of a role-typed tier (ROADMAP.md item 7's title)
    with pytest.raises(ValueError, match="journal_hw_interval_s"):
        ServingDaemon(router, journal_hw_interval_s=-1)
    with pytest.raises(ValueError, match="needs the paged cache"):
        Router(_factory(sd, role="prefill"), 1, roles=["prefill"])
    with pytest.raises(NotImplementedError, match="Remaining parallelism and utilities"):
        Router(_factory(sd, role="decode", kv_page_size=8, tp=2), 1, roles=["decode"])
    d = _daemon(daemons, router, max_queue=2)   # never started: the queue fills
    d.submit([1, 2], 2)
    d.submit([3, 4], 2)
    with pytest.raises(QueueFull):
        d.submit([5, 6], 2)
    d.close()
    cons = d.conservation()
    assert cons["conserved"] and cons["rejected"] == 1 and cons["cancelled"] == 2
    with pytest.raises(ValueError):
        ServingDaemon(router, max_queue=0)


def test_concurrent_submit_hammer_conserves_exactly(weights, daemons):
    _, _, sd = weights
    router = Router(_factory(sd), 2)
    d = _daemon(daemons, router, max_queue=8, liveness_timeout_s=60.0)
    d.start()
    n_threads, per_thread = 4, 10
    lock = threading.Lock()
    drs: list = []
    rejected = [0] * n_threads

    def producer(t):
        for i in range(per_thread):
            deadline = 0.0 if i % 5 == 4 else None  # born overdue: cancelled
            try:
                dr = d.submit(PROMPTS[(t + i) % len(PROMPTS)], 3, deadline_s=deadline)
            except QueueFull:
                rejected[t] += 1
                continue
            with lock:
                drs.append(dr)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(dr.wait(WAIT_S) for dr in drs)
    assert d.drain(timeout=WAIT_S)
    cons = d.conservation()
    d.close()
    assert cons["conserved"]
    assert cons["submitted"] == len(drs) and cons["rejected"] == sum(rejected)
    assert cons["submitted"] + cons["rejected"] == n_threads * per_thread
    by_status: dict[str, int] = {}
    for dr in drs:
        by_status[dr.status] = by_status.get(dr.status, 0) + 1
    assert by_status.get("done", 0) == cons["done"] > 0
    assert by_status.get("cancelled", 0) == cons["cancelled"] > 0
    assert cons["failed"] == 0 and "failed" not in by_status
    for dr in drs:
        assert _stream(d, dr) == dr.tokens
        if dr.status == "done":
            assert dr.tokens == list(dr.rr.generated) and len(dr.tokens) == 3


@pytest.mark.parametrize("kind", ["raise", "wedge"])
def test_pump_fault_fails_over_with_zero_drops(weights, daemons, kind):
    _, _, sd = weights
    want = _reference(sd)
    inj = FaultInjector(FaultPlan(seed=3, faults=(
        FaultSpec(site="daemon-pump", kind=kind, at=(0,)),)))
    tracer = Tracer()
    router = Router(_factory(sd), 2, chaos=inj, tracer=tracer)
    router.prewarm()  # no first-use work inside the liveness window
    d = _daemon(daemons, router, liveness_timeout_s=60.0 if kind == "raise" else 1.0,
                watchdog_interval_s=0.05)
    drs = [d.submit(p, 6) for p in PROMPTS]   # work waiting before the pumps
    d.start()
    assert all(dr.wait(WAIT_S) for dr in drs)
    assert all(dr.status == "done" for dr in drs)          # zero drops
    assert [dr.tokens for dr in drs] == want
    assert [list(dr.rr.generated) for dr in drs] == want   # exactly-once
    assert router.failovers == 1
    assert d.counters["pump_faults" if kind == "raise" else "pump_wedges"] == 1
    assert [(f.site, f.event, f.kind) for f in inj.fired] == [("daemon-pump", 0, kind)]
    assert d.drain(timeout=WAIT_S)
    cons = d.conservation()
    d.close()
    assert cons["conserved"] and cons["done"] == len(PROMPTS)
    assert tracer.open_spans == 0
    instants = {e["name"] for e in tracer.events() if e["type"] == "instant"}
    assert "replica_failed" in instants
    if kind == "wedge":
        assert {"pump_wedged", "pump_wedge_detected"} <= instants


def _queue_states(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 4)), [None, 0.05, 0.5, 2.0][int(rng.integers(4))],
             int(rng.integers(0, 12)), float(rng.uniform(0.01, 1.0)))
            for _ in range(60)]


def test_policies_decide_as_jaxs_on_the_same_queue_states():
    for policies in ((tpol.FIFOPolicy(), jpol.FIFOPolicy()),
                     (PriorityPolicy(), jpol.PriorityPolicy()),
                     (DeadlineAwarePolicy(alpha=0.4, concurrency=3, slack=1.2),
                      jpol.DeadlineAwarePolicy(alpha=0.4, concurrency=3, slack=1.2))):
        verdicts = []
        for pol, dr_cls in zip(policies, (DaemonRequest, JaxDaemonRequest)):
            out = [pol.name, pol.retry_after_s(3)]
            for i, (prio, slo, queued, wait) in enumerate(_queue_states(1)):
                dr = dr_cls(i, [1, 2], 4, deadline_s=None, submit_t=0.0, callback=None,
                            priority=prio, ttft_slo_s=slo)
                out.append(pol.key(dr))
                try:
                    pol.admit(dr, queued)
                    out.append("admit")
                except (QueueFull, jpol.QueueFull) as e:  # each side's own class
                    out.append((type(e).__name__, str(e)))
                if i % 3 == 0:
                    pol.note_first_token(wait)
                out.append(pol.retry_after_s(queued))
                if hasattr(pol, "predicted_wait_s"):
                    out.append(pol.predicted_wait_s(queued))
            out.append(getattr(pol, "shed", None))
            verdicts.append(out)
        assert verdicts[0] == verdicts[1]
    assert issubclass(SLOUnmeetable, QueueFull)
    with pytest.raises(ValueError):
        DeadlineAwarePolicy(alpha=0.0)


def test_priority_daemon_dispatches_in_policy_order(weights, daemons):
    _, _, sd = weights
    router = Router(_factory(sd), 1)
    d = _daemon(daemons, router, policy=PriorityPolicy(), liveness_timeout_s=60.0)
    prios = [0, 5, 1, 5, 0, 3]
    drs = [d.submit(p, 4, priority=pr) for p, pr in zip(PROMPTS, prios)]
    d.start()
    assert all(dr.wait(WAIT_S) for dr in drs)
    by_rr = {id(dr.rr): dr for dr in drs}
    dispatched = [by_rr[id(rr)].id for rr in router.requests]
    assert dispatched == [dr.id for dr in sorted(drs, key=lambda dr: (-dr.priority, dr.id))]
    # a deadline policy with a trained estimate sheds an unmeetable SLO
    pol = DeadlineAwarePolicy(concurrency=1)
    pol.note_first_token(1.0)
    d2 = _daemon(daemons, Router(_factory(sd), 1), policy=pol)
    with pytest.raises(SLOUnmeetable) as exc:
        d2.submit([1, 2], 2, ttft_slo_s=0.01)
    assert exc.value.retry_after_s == pytest.approx(1.0)
    assert d2.conservation()["rejected_with_hint"] == 1
    assert d.drain(timeout=WAIT_S)
    d.close()
    d2.close()
