"""The port's chunked prefill and stall watchdog, held against the JAX
package (the cases of its ``tests/test_chunked_prefill.py``; its chaos
counting is left out with the port's chaos hooks).

* PARITY — chunked output token-identical to the whole-prompt engine and
  to the JAX chunked engine, greedy at chunk 2, 5 and 16 and sampled
  (logprobs at 1e-5), with the radix trie on and off; the chunk count
  exact with it off; composed with speculation and the int8 KV cache.
* LONG PROMPTS — a prompt past every bucket (up to ``max_len -
  max_new``) admits and equals the JAX chunked engine and a whole-prompt
  engine with a bucket that fits it; the submit errors with chunking off
  and on.
* PREFILLING — ``close()`` mid-chunk cancels and drains the pool;
  overcommit stalls, then serves every request; a radix hit landing on a
  chunk boundary resumes there (parity, the skipped chunks, refcounts back
  to zero).
* WATCHDOG — transient window faults are absorbed with exact output,
  also one raised after the forward wrote the cache (the retry starts
  from the cursors the window found); a fault at the readback fails the
  in-flight requests; a fault that outlasts ``stall_timeout_s`` on a fake
  clock fails them and raises ``EngineStalled``; without a watchdog the
  first fault raises.
* STATS — ``n_prefill_chunks``, ``chunk_stall_s``, ``chunk_stall_frac``,
  ``longest_prompt_admitted``: exact, None when idle, strict JSON.

Both sides run float32 on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxParams
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    EngineStalled,
    FIFOScheduler,
    InferenceEngine,
    SamplingParams,
)

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
           [3, 1, 4, 1, 5, 9, 2, 6]]
MIX = [SamplingParams(temperature=0.9, top_p=0.85, top_k=6, seed=i * 3 + 1)
       for i in range(len(PROMPTS) - 1)] + [None]
LONG = list(range(1, 16)) * 2 + list(range(1, 11))  # 40 tokens: past bucket 16


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        dtype=torch.float32)
    return jm, params, tm


def _kw(kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (8, 16))
    kw.setdefault("kv_page_size", 4)
    return kw


def _port(tm, **kw):
    return InferenceEngine(tm, device="cpu", **_kw(kw))


def _serve(eng, prompts=PROMPTS, max_new=6, sampling=None):
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=max_new,
                       sampling=None if sampling is None else sampling[i])
            for i, p in enumerate(prompts)]
    eng.run(max_steps=2000)
    return reqs


def _out(reqs):
    return [(r.status, tuple(r.generated)) for r in reqs]


@pytest.fixture(scope="module")
def jax_chunked(pair):
    """The JAX engine's chunked streams: greedy at chunk 5, the sampled mix
    at chunk 3, the long prompt at chunk 4."""
    jm, params, _ = pair
    out = {}
    for name, chunk, prompts, sampling in (
            ("greedy", 5, PROMPTS, None),
            ("sampled", 3, PROMPTS, [None if s is None else JaxParams(**s.to_dict())
                                     for s in MIX]),
            ("long", 4, [LONG, [1, 2, 3]], None)):
        eng = JaxEngine(jm, params, prefill_chunk=chunk, **_kw({}))
        reqs = _serve(eng, prompts, max_new=5 if name == "long" else 6, sampling=sampling)
        out[name] = (_out(reqs), [list(r.logprobs) for r in reqs])
        eng.close()
    return out


# ----------------------------------------------------------------------
# construction


def test_prefill_chunk_validation(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(tm, prefill_chunk=-1)
    with pytest.raises(ValueError, match="kv_page_size"):
        InferenceEngine(tm, slots=2, max_len=48, buckets=(8,), prefill_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        _port(tm, prefill_chunk=64)
    with pytest.raises(ValueError, match="prefix"):
        _port(tm, prefill_chunk=4, prefix_cache_bytes=1 << 20)
    sched = FIFOScheduler(max_len=48, buckets=(8, 16), chunked_prefill=True)
    with pytest.raises(ValueError, match="prefill_chunk"):
        InferenceEngine(tm, slots=2, max_len=48, kv_page_size=4, scheduler=sched,
                        device="cpu")


def test_scheduler_submit_error_paths():
    off = FIFOScheduler(max_len=48, buckets=(8, 16))
    with pytest.raises(ValueError, match="prefill_chunk"):
        off.submit(list(range(20)), max_new=4)
    on = FIFOScheduler(max_len=48, buckets=(8, 16), chunked_prefill=True)
    assert on.submit(list(range(40)), max_new=8).bucket == 16  # a capped label
    with pytest.raises(ValueError, match="cache length"):
        on.submit(list(range(41)), max_new=8)


# ----------------------------------------------------------------------
# parity


@pytest.mark.parametrize("chunk", [2, 5, 16])
def test_chunked_matches_whole_prompt_and_jax_greedy(pair, jax_chunked, chunk):
    _, _, tm = pair
    ref = _out(_serve(_port(tm)))
    assert ref == jax_chunked["greedy"][0]
    assert _out(_serve(_port(tm, prefill_chunk=chunk))) == ref
    eng = _port(tm, prefill_chunk=chunk, radix_cache=False)
    assert _out(_serve(eng)) == ref
    s = eng.stats.summary()
    assert s["n_prefill_chunks"] == sum(-(-len(p) // chunk) for p in PROMPTS)
    assert s["longest_prompt_admitted"] == 12 and eng._pool.allocated == 0


def test_chunked_matches_whole_prompt_and_jax_sampled(pair, jax_chunked):
    _, _, tm = pair
    ref = _serve(_port(tm), sampling=MIX)
    got = _serve(_port(tm, prefill_chunk=3), sampling=MIX)
    assert _out(got) == _out(ref) == jax_chunked["sampled"][0]
    for a, b, c in zip(got, ref, jax_chunked["sampled"][1]):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
        np.testing.assert_allclose(a.logprobs, c, atol=1e-5)


def test_chunked_composes_with_spec_and_int8_kv(pair):
    _, _, tm = pair
    kv8 = tm.clone(kv_cache_dtype="int8")
    ref = _out(_serve(_port(kv8)))
    assert _out(_serve(_port(kv8, prefill_chunk=3, speculative="ngram"))) == ref
    assert _out(_serve(_port(tm, prefill_chunk=3, speculative="ngram",
                             decode_ahead=4))) == _out(_serve(_port(tm)))


def test_long_prompt_admits_past_every_bucket(pair, jax_chunked):
    _, _, tm = pair
    eng = _port(tm, prefill_chunk=4)
    reqs = _serve(eng, [LONG, [1, 2, 3]], max_new=5)
    assert _out(reqs) == jax_chunked["long"][0]
    assert all(r.status == "done" and len(r.generated) == 5 for r in reqs)
    whole = _serve(_port(tm, buckets=(8, 16, 40)), [LONG, [1, 2, 3]], max_new=5)
    assert _out(reqs) == _out(whole)
    s = eng.stats.summary()
    assert s["longest_prompt_admitted"] == 40
    assert s["n_prefill_chunks"] == 10 + 1 - s["radix_hit_tokens"] // 4
    assert s["chunk_stall_s"] > 0.0 and 0.0 < s["chunk_stall_frac"] <= 1.0
    json.loads(json.dumps(s, allow_nan=False))


# ----------------------------------------------------------------------
# the PREFILLING state


def test_close_mid_chunking_drains_pages(pair):
    _, _, tm = pair
    eng = _port(tm, prefill_chunk=2, radix_cache=False)
    req = eng.submit(np.asarray(list(range(1, 31)), np.int32), max_new=4)
    eng.step()  # admit + the first chunk
    assert req.status == "prefilling" and eng._slot_prefill[0]["done"] == 2
    assert eng.occupied == 1 and eng._decoding == 0
    eng.close()
    assert req.status == "cancelled" and req.engine_fault
    assert eng._pool.allocated == 0


def test_chunked_overcommit_stalls_then_serves(pair):
    """A pool too small for both slots' worst case: the second admission
    parks on the dry pool, retries, and every request finishes."""
    _, _, tm = pair
    eng = _port(tm, prefill_chunk=4, radix_cache=False, max_len=32, kv_pages=9)
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=4)
            for p in ([1] * 20, [2] * 20, [3] * 5)]
    stalled = False
    while eng.has_work:
        eng.step()
        stalled |= bool(eng._stalled_ids)
    assert stalled and [r.status for r in reqs] == ["done"] * 3
    assert eng._pool.allocated == 0
    want = _serve(_port(tm, max_len=32, buckets=(8, 16, 24)),
                  [[1] * 20, [2] * 20, [3] * 5], max_new=4)
    assert _out(reqs) == _out(want)


def test_radix_hit_on_chunk_boundary_parity_and_refcounts(pair):
    _, _, tm = pair
    shared = list(range(1, 13))  # 3 whole pages
    wave = [shared + [13, 14, 15], shared + [9, 9], [5, 5, 5]]
    # one slot serializes the wave: request 1 admits after request 0's
    # donation, and its 12-token match lands on a chunk boundary
    cold_eng = _port(tm, radix_cache=False, prefill_chunk=4, slots=1)
    cold = _serve(cold_eng, wave, max_new=5)
    eng = _port(tm, radix_cache=True, prefill_chunk=4, slots=1)
    got = _serve(eng, wave, max_new=5)
    assert _out(got) == _out(cold)
    s = eng.stats.summary()
    assert s["radix_hits"] >= 1 and got[1].radix_tokens == 12
    assert s["n_prefill_chunks"] == cold_eng.stats.summary()["n_prefill_chunks"] - 3
    assert eng._pool.allocated == eng._radix.n_blocks
    stack = [eng._radix.root]
    while stack:
        node = stack.pop()
        assert node.ref == 0
        stack.extend(node.children.values())


# ----------------------------------------------------------------------
# the stall watchdog


def test_engine_stall_watchdog_transient_and_fatal(pair):
    _, _, tm = pair
    want = _out(_serve(_port(tm), [[1, 2, 3]], max_new=4))

    clock = _Clock()
    eng = _port(tm, stall_timeout_s=5.0, clock=clock)
    real, boom = eng._window, {"n": 2}

    def flaky(*a, **k):
        if boom["n"] > 0:
            boom["n"] -= 1
            raise RuntimeError("transient device fault")
        return real(*a, **k)

    eng._window = flaky
    assert _out(_serve(eng, [[1, 2, 3]], max_new=4)) == want
    assert boom["n"] == 0 and eng.heartbeat_t is not None

    clock2 = _Clock()
    eng2 = _port(tm, stall_timeout_s=5.0, clock=clock2, speculative="ngram")

    def wedged(*a, **k):
        clock2.t += 3.0
        raise RuntimeError("wedged")

    eng2._verify = wedged
    r2 = eng2.submit([1, 2, 3], max_new=4)
    with pytest.raises(EngineStalled, match="no token progress"):
        eng2.run()
    assert r2.status == "failed" and "wedged" in r2.error and r2.engine_fault
    assert eng2.occupied == 0 and eng2._pool.allocated == 0  # the engine is reusable
    eng2._verify = type(eng2)._verify.__get__(eng2)
    assert _out(_serve(eng2, [[1, 2, 3]], max_new=4)) == want

    eng3 = _port(tm)
    eng3._window = wedged
    r3 = eng3.submit([1, 2], max_new=3)
    with pytest.raises(RuntimeError, match="wedged"):
        eng3.run()
    assert r3.status == "failed"
    with pytest.raises(ValueError, match="stall_timeout_s"):
        _port(tm, stall_timeout_s=0)


@pytest.mark.parametrize("spec,page", [(False, 0), (False, 4), ("ngram", 4)],
                         ids=["dense", "paged", "spec"])
def test_engine_stall_watchdog_retry_after_cache_write(pair, spec, page):
    """A fault raised inside the window's forward, after the block wrote its
    K/V and moved its cursor, is retried from the cursors the window found:
    the streams, sampled ones too, equal a run without the fault.  A fault at
    the readback, after the whole window ran, fails the in-flight requests."""
    _, _, tm = pair
    kw = dict(kv_page_size=page, speculative=spec or None)
    prompts, mix = PROMPTS[:2], MIX[:1] + [None]
    want = _out(_serve(_port(tm, **kw), prompts, sampling=mix))

    eng = _port(tm, stall_timeout_s=5.0, clock=_Clock(), **kw)
    name = "_verify" if spec else "_window"
    real, boom = getattr(eng, name), {"n": 2}

    def late_fault(*a, **k):
        if boom["n"] == 0:
            return real(*a, **k)
        boom["n"] -= 1

        def hook(*_):
            raise RuntimeError("fault after the cache write")

        h = tm.norm_out.register_forward_hook(hook)
        try:
            return real(*a, **k)
        finally:
            h.remove()

    setattr(eng, name, late_fault)
    assert _out(_serve(eng, prompts, sampling=mix)) == want
    assert boom["n"] == 0

    eng2 = _port(tm, stall_timeout_s=5.0, clock=_Clock(), **kw)

    def bad_readback(parts):
        raise RuntimeError("readback fault")

    eng2._readback = bad_readback
    reqs = [eng2.submit(np.asarray(p, np.int32), max_new=6) for p in prompts]
    with pytest.raises(RuntimeError, match="readback fault"):
        eng2.run(max_steps=50)
    assert all(r.status == "failed" and r.engine_fault for r in reqs)
    assert eng2.occupied == 0  # the trie keeps only its donated pages
    assert eng2._pool is None or eng2._pool.allocated == eng2._radix.n_blocks


def test_chunk_stats_idle_are_null(pair):
    _, _, tm = pair
    eng = _port(tm)
    _serve(eng, [[1, 2]], max_new=2)
    s = eng.stats.summary()
    assert s["n_prefill_chunks"] == 0 and s["chunk_stall_s"] == 0.0
    assert s["chunk_stall_frac"] is None and s["longest_prompt_admitted"] is None
    json.loads(json.dumps(s, allow_nan=False))
