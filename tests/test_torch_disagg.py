"""The port's disaggregated prefill/decode serving (``serving/kv_handoff.py``,
the engine's ``role`` and ``admit_prefilled``, ``Router(roles=)``, the
role-typed daemon) against the JAX package's, on the CPU.

* PARITY: on converted JAX weights, a ``prefill + decode`` tier's float32
  greedy and seeded-sampled streams equal the port's monolithic paged
  engine's, the JAX monolithic engine's and the JAX ``prefill + decode``
  tier's, token for token; every request hands off exactly once; the
  prefill replicas generate no token and the decode replicas never
  prefill; chunked prefill and the int8 KV cache hand off too.
* THE PACKET: a port packet's pages (every ``pages_*`` leaf) and last
  logits row equal the JAX packet's for the same prompt within 1e-5
  (float32), and its page count and layout are JAX's.
* ALL-OR-NOTHING: a delivery refused on a dry pool (planted) returns
  False, leaves the destination's pool tensors byte-equal, its allocator
  and radix trie untouched, and the packet re-parks and lands later.
* EXACTLY-ONCE: a ``kv-handoff`` chaos hit releases the hold and
  re-dispatches; a double failover (a prefill replica with queued work,
  then a decode replica with live slots) still retires every request
  done with the reference tokens, each streamed token delivered once.
* THE TIER: a role-typed daemon serves the reference streams, conserves
  exactly and drains to 0 open spans with every pool at refcount zero;
  the per-role prewarm sites are JAX's split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import Router as JaxRouter
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxSampling
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    Router,
    SamplingParams,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import kv_handoff
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import Tracer

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11], [2, 4, 6], [9, 1], [3, 3, 3, 3, 3]]
SAMPLED = {2: dict(temperature=0.8, top_k=8, seed=11), 4: dict(temperature=0.7, seed=5)}
WAIT_S = 60.0
ATOL = 1e-5  # float32 pages and logits, port against JAX


def _sampling(i, cls):
    return cls(**SAMPLED[i]) if i in SAMPLED else None


@pytest.fixture(scope="module")
def weights():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)

    def jfactory(roles):
        def make(tid, index):
            return JaxEngine(jm, params, slots=2, max_len=16, kv_page_size=4,
                             scheduler=JaxScheduler(max_len=16, buckets=(8,), max_queue=16),
                             trace_tid=tid, role=roles[index])
        return make

    jeng = jfactory(["both"])(0, 0)
    jreqs = [jeng.submit(p, max_new=6, sampling=_sampling(i, JaxSampling))
             for i, p in enumerate(PROMPTS)]
    jeng.run()
    jeng.close()
    want = [list(r.generated) for r in jreqs]
    roles = ["prefill", "decode"]
    jr = JaxRouter(jfactory(roles), 2, roles=roles)
    rrs = [jr.submit(p, max_new=6, sampling=_sampling(i, JaxSampling))
           for i, p in enumerate(PROMPTS)]
    jr.run_until_done(max_steps=500)
    jax_tier = [list(rr.generated) for rr in rrs]
    jr.close()
    return jm, params, sd, want, jax_tier


def _engine(sd, role="both", slots=2, model=None, **kw):
    return InferenceEngine(
        model or CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=slots,
        max_len=16, kv_page_size=4,
        scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
        device="cpu", role=role, **kw)


def _factory(sd, roles, **kw):
    def make(tid, index):
        return _engine(sd, roles[index], trace_tid=tid, **kw)
    return make


def _pools_refcount_zero(router) -> bool:
    for rep in router.replicas:
        if not rep.alive or rep.engine._pool is None:
            continue
        eng, stack = rep.engine, [rep.engine._radix.root]
        while stack:
            node = stack.pop()
            if node.ref != 0:
                return False
            stack.extend(node.children.values())
        if eng._pool.allocated != eng._radix.n_blocks or eng._outbox:
            return False
    return True


def _run_tier(sd, roles, prompts=PROMPTS, streams=None, **kw):
    r = Router(_factory(sd, roles, **{k: v for k, v in kw.items() if k != "router_kw"}),
               len(roles), roles=roles, **kw.get("router_kw", {}))
    cb = (None if streams is None else
          lambda rr, tok: streams.setdefault(rr.id, []).append(int(tok)))
    rrs = [r.submit(p, max_new=6, sampling=_sampling(i, SamplingParams), callback=cb)
           for i, p in enumerate(prompts)]
    r.run_until_done(max_steps=500)
    return r, rrs


@pytest.mark.parametrize("roles", [["prefill", "decode"], ["prefill", "decode", "decode"],
                                   ["both", "decode"]], ids=["p1d1", "p1d2", "both_d1"])
def test_tier_streams_equal_monolithic_and_jax(weights, roles):
    _, _, sd, want, jax_tier = weights
    assert jax_tier == want
    eng = _engine(sd)
    reqs = [eng.submit(p, max_new=6, sampling=_sampling(i, SamplingParams))
            for i, p in enumerate(PROMPTS)]
    eng.run()
    eng.close()
    assert [list(q.generated) for q in reqs] == want
    streams: dict = {}
    r, rrs = _run_tier(sd, roles, streams=streams)
    assert [list(rr.generated) for rr in rrs] == want
    assert all(rr.status == "done" for rr in rrs)
    assert all(streams[rr.id] == list(rr.generated) for rr in rrs)
    n_pre = sum(rep.engine.handoffs_out for rep in r.replicas)
    assert r.handoffs == n_pre == sum(rep.engine.handoffs_in for rep in r.replicas)
    if roles[0] == "prefill":
        assert r.handoffs == len(PROMPTS)
    summ = r.summary()
    per_role = summ["per_role"]
    assert per_role["decode"]["tokens_generated"] + per_role.get(
        "both", {}).get("tokens_generated", 0) == sum(len(t) for t in want)
    if "prefill" in per_role:
        assert per_role["prefill"]["tokens_generated"] == 0
    assert _pools_refcount_zero(r)
    r.close()


def test_chunked_and_int8_kv_hand_off(weights):
    _, _, sd, want, _ = weights
    r, rrs = _run_tier(sd, ["prefill", "decode"], prefill_chunk=4)
    assert [list(rr.generated) for rr in rrs] == want and r.handoffs == len(PROMPTS)
    r.close()
    int8 = CausalLM(device="cpu", dtype=torch.float32, **KW).clone(kv_cache_dtype="int8")
    eng = _engine(sd, model=int8.clone())
    reqs = [eng.submit(p, max_new=6) for p in PROMPTS]
    eng.run()
    eng.close()
    want8 = [list(q.generated) for q in reqs]

    def make(tid, index):
        return _engine(sd, ("prefill", "decode")[index], model=int8.clone(), trace_tid=tid)

    r = Router(make, 2, roles=["prefill", "decode"])
    rrs = [r.submit(p, max_new=6) for p in PROMPTS]
    r.run_until_done(max_steps=500)
    assert [list(rr.generated) for rr in rrs] == want8
    keys = {e[1] for e in kv_handoff.page_layout(r.replicas[1].engine.cache)}
    assert keys == {"pages_k", "pages_v", "pages_k_scale", "pages_v_scale"}
    r.close()


def test_packet_pages_and_logits_equal_jax(weights):
    jm, params, sd, _, _ = weights
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    jsrc = JaxEngine(jm, params, slots=2, max_len=16, kv_page_size=4,
                     scheduler=JaxScheduler(max_len=16, buckets=(16,)), role="prefill")
    jsrc.submit(prompt, max_new=4)
    jsrc.step()
    (jpacket,) = list(jsrc._outbox)
    src = InferenceEngine(CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2,
                          max_len=16, kv_page_size=4,
                          scheduler=FIFOScheduler(max_len=16, buckets=(16,)),
                          device="cpu", role="prefill")
    src.submit(prompt, max_new=4)
    src.step()
    (packet,) = list(src._outbox)
    assert packet.n_pages == len(jpacket.payloads) == 3 and packet.n_tok == jpacket.n_tok
    np.testing.assert_allclose(packet.last_logits, jpacket.last_logits, atol=ATOL, rtol=0)
    for got, ref in zip(packet.payloads, jpacket.payloads):
        g = [leaf for layer in got.values() for leaf in layer.values()]
        r = jax.tree.leaves(ref)
        assert [x.shape for x in g] == [np.shape(x) for x in r]
        for x, y in zip(g, r):
            np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=0)
    assert packet.payload_bytes == packet.payload.numel() + packet.last_logits.nbytes
    assert packet.gather_s >= 0 and src._slot_alloc == [None, None]
    # the hold keeps the pages until release; release is idempotent
    held = src._pool.allocated
    assert held > 0 and packet.hold is not None
    packet.release()
    packet.release()
    assert src._pool.allocated == src._radix.n_blocks
    jpacket.release()
    src.close()
    jsrc.close()


def test_refused_delivery_leaves_the_destination_untouched(weights):
    _, _, sd, want, _ = weights
    src = _engine(sd, "prefill")
    src.submit(PROMPTS[2], max_new=6)
    src.step()
    (packet,) = list(src._outbox)
    # a decode engine whose pool is dry: 5 pages, 4 of them held by a
    # request already decoding (max_len 16 / page 4 = 4 pages a request)
    dst = InferenceEngine(CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2,
                          max_len=16, kv_page_size=4, kv_pages=5,
                          scheduler=FIFOScheduler(max_len=16, buckets=(8,)),
                          device="cpu", role="decode")
    src.submit(PROMPTS[0], max_new=12)
    src.step()
    first = src._outbox.pop()
    assert dst.admit_prefilled(first)
    first.release()
    pools = {(n, k): v.clone() for n, e in dst.cache.items() for k, v in e.items()}
    free0, blocks0 = list(dst._pool._free), dst._radix.n_blocks
    assert dst.admit_prefilled(packet) is False          # dry: nothing taken
    assert all(torch.equal(dst.cache[n][k], v) for (n, k), v in pools.items())
    assert dst._pool._free == free0 and dst._radix.n_blocks == blocks0
    assert dst._slot_req[1] is None and packet.hold is not None
    while dst.has_work:                                  # the first one retires
        dst.step()
    assert dst.admit_prefilled(packet)                   # lands now
    packet.release()
    while dst.has_work:
        dst.step()
    ref = _engine(sd)
    greedy = ref.submit(PROMPTS[2], max_new=6)
    ref.run()
    ref.close()
    assert list(packet.req.generated) == list(greedy.generated)
    # a packet of another layout is refused before anything is taken
    other = InferenceEngine(CausalLM(device="cpu", dtype=torch.float32,
                                     **KW).clone(kv_cache_dtype="int8"), None, slots=1,
                            max_len=16, kv_page_size=4, device="cpu", role="decode",
                            buckets=(8,))
    with pytest.raises(ValueError, match="layout"):
        other.admit_prefilled(packet)
    with pytest.raises(RuntimeError, match="prefill-role"):
        src.admit_prefilled(packet)
    for e in (src, dst, other):
        e.close()


def test_kv_handoff_fault_and_double_failover_exactly_once(weights):
    _, _, sd, want, _ = weights
    inj = FaultInjector(FaultPlan(seed=1, faults=(FaultSpec(site="kv-handoff", at=(0,)),)))
    streams: dict = {}
    r, rrs = _run_tier(sd, ["prefill", "decode"], streams=streams,
                       router_kw=dict(chaos=inj))
    assert [list(rr.generated) for rr in rrs] == want
    assert r.handoff_faults == 1 and sum(rr.redispatches for rr in rrs) == 1
    assert all(streams[rr.id] == list(rr.generated) for rr in rrs)
    assert _pools_refcount_zero(r)
    r.close()
    roles = ["prefill", "prefill", "decode", "decode"]
    r = Router(_factory(sd, roles), 4, roles=roles)
    streams = {}
    rrs = [r.submit(p, max_new=6, sampling=_sampling(i, SamplingParams),
                    callback=lambda rr, tok: streams.setdefault(rr.id, []).append(int(tok)))
           for i, p in enumerate(PROMPTS)]
    dead_p = next(rep for rep in r.replicas
                  if rep.role == "prefill" and len(rep.engine.scheduler))
    r._fail_replica(dead_p, RuntimeError("induced prefill kill"))
    r.step()
    dead_d = next(rep for rep in r.replicas
                  if rep.role == "decode" and rep.alive and rep.engine.occupied)
    r._fail_replica(dead_d, RuntimeError("induced decode kill"))
    r.run_until_done(max_steps=500)
    assert [list(rr.generated) for rr in rrs] == want
    assert all(rr.status == "done" for rr in rrs) and r.failovers == 2
    assert all(streams[rr.id] == list(rr.generated) for rr in rrs)
    r.close()


def test_role_typed_daemon_and_prewarm_split(weights):
    _, _, sd, want, _ = weights
    roles = ["prefill", "decode", "decode"]
    tracer = Tracer()
    router = Router(_factory(sd, roles, tracer=tracer), 3, roles=roles, tracer=tracer)
    # the prewarm runs each role's half: prefills on the prefill replica
    # only, the decode window and the first-token pick on decode replicas
    calls = {}
    for rep in router.replicas:
        for name in ("_prefill", "_window"):
            calls[rep.index, name] = 0
        for name in ("_prefill", "_window"):
            def spy(*a, _f=getattr(rep.engine, name), _k=(rep.index, name), **k):
                calls[_k] += 1
                return _f(*a, **k)
            setattr(rep.engine, name, spy)
    router.prewarm()
    assert calls[0, "_prefill"] == len(router.replicas[0].engine.buckets)
    assert calls[0, "_window"] == 0
    assert all(calls[i, "_prefill"] == 0 and calls[i, "_window"] == 1 for i in (1, 2))
    daemon = ServingDaemon(router, max_queue=64, watchdog_interval_s=0.01)
    try:
        daemon.start()
        drs = [daemon.submit(p, 6, sampling=_sampling(i, SamplingParams))
               for i, p in enumerate(PROMPTS)]
        assert all(dr.wait(WAIT_S) for dr in drs)
        assert [dr.tokens for dr in drs] == want
        assert router.handoffs == len(PROMPTS)
        assert daemon.drain(timeout=WAIT_S)
        cons = daemon.conservation()
        assert cons["conserved"] and cons["done"] == len(PROMPTS)
        assert _pools_refcount_zero(router)
        assert router.replicas[0].engine.stats.summary()["tokens_generated"] == 0
        assert router.replicas[0].engine.handoffs_out == len(PROMPTS)
        assert sum(rep.engine.handoffs_in for rep in router.replicas[1:]) == len(PROMPTS)
    finally:
        daemon.close()
    assert tracer.open_spans == 0
    names = {e["name"] for e in tracer.events()}
    assert {"gather", "install", "handoff_delivered"} <= names


def test_role_refusals_are_jaxs(weights):
    _, _, sd, _, _ = weights
    eng = _engine(sd, "decode")
    with pytest.raises(RuntimeError, match="decode-role"):
        eng.submit([1, 2], max_new=4)
    eng.close()
    with pytest.raises(ValueError, match="needs the paged cache"):
        InferenceEngine(CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=1,
                        max_len=16, device="cpu", role="prefill")
    with pytest.raises(ValueError, match="speculative"):
        _engine(sd, "prefill", speculative="ngram")
    with pytest.raises(ValueError, match="role must be"):
        _engine(sd, "router")
    with pytest.raises(ValueError, match="prefill-capable"):
        Router(_factory(sd, ["decode", "decode"]), 2, roles=["decode", "decode"])
    with pytest.raises(ValueError, match="decode-capable"):
        Router(_factory(sd, ["prefill", "prefill"]), 2, roles=["prefill", "prefill"])
    # the tp reshard leg needs tp > 1: ROADMAP.md queue 1 item 7's title
    with pytest.raises(NotImplementedError, match="Remaining parallelism and utilities"):
        Router(_factory(sd, ["prefill", "decode"], tp=2), 2, roles=["prefill", "decode"])
    # a retire may not take the last decode capacity
    r = Router(_factory(sd, ["prefill", "decode"]), 2, roles=["prefill", "decode"])
    assert r.begin_retire(1) is False and r.begin_retire(0) is False
    r.close()
