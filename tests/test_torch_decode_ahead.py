"""Decode-ahead windows, the prefill overlap and the prefix cache of the
port, held against the JAX package on converted weights.

* WINDOW — the port's ``make_decode_window`` equals ``k`` sequential
  decode steps and JAX's window; inactive rows emit ``pad_id``; the
  sampling-aware ``_sample_window_core`` emits JAX's tokens (logprobs
  within 1e-5) on the same cache and planes; nothing inside a window reads
  a value back to the host.
* ENGINE PARITY — greedy engine output at decode_ahead {1, 2, 4, 8},
  dense and paged with the radix trie, is token-identical to JAX's
  ``make_generator`` and to the JAX engine, and the window count drops
  with k.
* BOUNDED WASTE — EOS and budget retirement mid-window keep the port's
  own k=1 stream truncated at the stop (held against the port, not JAX's
  windowed engine: ROADMAP queue 3's standing caveat), count the overrun
  as waste, and the cursor clamps at ``max_len``.
* OVERLAP AND DEADLINES — more requests than slots prefill behind
  in-flight windows with FIFO admission and identical output; overdue
  running and overlap-prefilled requests are cancelled.
* PREFIX CACHE — a hit skips the prefill with identical output; the LRU
  is byte-bounded and refuses oversized entries; stats are strict JSON.

Both sides run float32 on the CPU with plain attention.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as tgen
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    SamplingParams,
    ServingStats,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling as ts
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import PrefixCache

jgen = importlib.import_module("distributed_tensorflow_ibm_mnist_tpu.core.generate")

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=2, heads=2)
PROMPTS = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10], [11, 12, 13, 14]]
BUDGETS = [7, 13, 5, 10]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        dtype=torch.float32)
    return jm, params, tm


def _engine(tm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (8,))
    return InferenceEngine(tm, device="cpu", **kw)


def _prefilled(tm, max_len=32):
    prompt = torch.tensor([[7, 3, 11, 2, 5], [4, 9, 0, 0, 0]])
    lens = torch.tensor([5, 2])
    cache, last = tgen.make_prefill(tm, max_len)(prompt, lens)
    return prompt, lens, cache, last


# ----------------------------------------------------------------------
# the window primitive


def test_decode_window_matches_stepwise(pair):
    jm, params, tm = pair
    k, max_len = 5, 32
    prompt, lens, cache, last = _prefilled(tm, max_len)
    tok0 = last.argmax(-1)
    step = tgen.make_decode_step(tm, max_len, ragged=True)
    tok, want = tok0, []
    for _ in range(k):
        cache, logits = step(cache, tok)
        tok = logits.argmax(-1)
        want.append(tok)
    want = torch.stack(want, 1)
    _, _, cache, _ = _prefilled(tm, max_len)
    _, blk, last_tok = tgen.make_decode_window(tm, max_len, window=k)(cache, tok0)
    assert torch.equal(blk, want) and torch.equal(last_tok, want[:, -1])
    # and JAX's window on the same prompt
    jcache, jlast = jgen.make_prefill(jm, max_len)(params, jnp.asarray(prompt.numpy()),
                                                   jnp.asarray(lens.numpy()))
    _, jblk, _ = jgen.make_decode_window(jm, max_len, window=k)(
        params, jcache, jnp.argmax(jlast, -1).astype(jnp.int32))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))


def test_decode_window_active_mask_and_validation(pair):
    _, _, tm = pair
    _, _, cache, last = _prefilled(tm, 24)
    win = tgen.make_decode_window(tm, 24, window=3, pad_id=0)
    _, blk, _ = win(cache, last.argmax(-1), active=torch.tensor([True, False]))
    assert (blk[1] == 0).all()
    with pytest.raises(ValueError, match="window"):
        tgen.make_decode_window(tm, 24, window=0)
    with pytest.raises(ValueError, match="temperature"):
        tgen.make_decode_window(tm, 24, window=2, top_k=3)
    with pytest.raises(ValueError, match="rngs"):
        tgen.make_decode_window(tm, 24, window=2, temperature=0.5)(cache, last.argmax(-1))


def test_sample_window_matches_jax_and_stays_on_device(pair, monkeypatch):
    """Mixed greedy / sampled / filtered rows over a 6-step window: tokens
    identical to JAX's ``_sample_window_core``, logprobs within 1e-5, the
    PRNG positions advanced for the active row only; and the window never
    reads a tensor back to the host (every read-back is made to raise)."""
    jm, params, tm = pair
    max_len, k = 32, 6
    prompt, lens, cache, last = _prefilled(tm, max_len)
    temps = np.asarray([0.9, 0.0], np.float32)
    topps = np.asarray([0.8, 0.0], np.float32)
    topks = np.asarray([5, 0], np.int32)
    minps = np.asarray([0.05, 0.0], np.float32)
    keys = np.stack([ts.base_key(1234), ts.base_key(7)])
    pos = np.asarray([1, 1], np.int32)
    active = np.asarray([True, True])
    tok = last.argmax(-1)

    jcache, _ = jgen.make_prefill(jm, max_len)(params, jnp.asarray(prompt.numpy()),
                                              jnp.asarray(lens.numpy()))
    _, jblk, jlp, _, jpos = jgen._sample_window_core(
        jm, params, jcache, jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(active),
        temps, topps, topks, minps, keys, pos, k, max_len, True, 0)

    for attr in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, _no_readback(attr))
    with torch.no_grad():
        out = tgen._sample_window_core(
            tm, cache, tok, torch.from_numpy(active), *map(torch.from_numpy, (
                temps, topps, topks, minps, keys.astype(np.int64), pos)),
            k, max_len, True, 0)
    monkeypatch.undo()
    _, blk, lp, last_tok, new_pos = out
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5)
    np.testing.assert_array_equal(new_pos.numpy(), np.asarray(jpos))
    assert torch.equal(last_tok, blk[:, -1])


def _no_readback(attr):
    def raise_(*a, **kw):
        raise AssertionError(f"Tensor.{attr} inside the decode window")
    return raise_


# ----------------------------------------------------------------------
# the engine across decode_ahead


def _greedy_want(jm, params):
    gen = jgen.make_generator(jm, max_len=48, max_new=max(BUDGETS))
    return [np.asarray(gen(params, jnp.asarray(p, jnp.int32)[None, :]))[0, len(p):len(p) + n]
            for p, n in zip(PROMPTS, BUDGETS)]


def test_engine_parity_across_decode_ahead(pair):
    jm, params, tm = pair
    want = _greedy_want(jm, params)
    windows = {}
    for k in (1, 2, 4, 8):
        for layout in ({}, {"kv_page_size": 8}):  # dense; paged with the radix trie
            eng = _engine(tm, decode_ahead=k, **layout)
            reqs = [eng.submit(p, max_new=n) for p, n in zip(PROMPTS, BUDGETS)]
            eng.run()
            for i, (r, w) in enumerate(zip(reqs, want)):
                assert r.status == "done"
                np.testing.assert_array_equal(r.generated, w,
                                              err_msg=f"k={k} {layout} req {i}")
        windows[k] = eng.stats.summary()["n_windows"]
    assert windows[8] < windows[4] < windows[2] < windows[1]
    # the JAX engine at k=4 emits the same streams
    jeng = JaxEngine(jm, params, slots=2, max_len=48, buckets=(8,), decode_ahead=4)
    jreqs = [jeng.submit(np.asarray(p, np.int32), max_new=n) for p, n in zip(PROMPTS, BUDGETS)]
    jeng.run()
    assert [list(r.generated) for r in jreqs] == [list(w) for w in want]


def test_eos_budget_retire_mid_window_and_waste_accounting(pair):
    _, _, tm = pair
    prompt = [3, 1, 4, 1, 5]
    base = _engine(tm)
    rb = base.submit(prompt, max_new=9)
    base.run()
    eos = next(t for t in rb.generated[3:] if t != 0)  # a mid-stream stop, not pad
    stop_at = rb.generated.index(eos)
    for k in (4, 8):
        eng = _engine(tm, decode_ahead=k, eos_id=eos)
        r = eng.submit(prompt, max_new=9)
        eng.run()
        assert r.status == "done" and r.generated == rb.generated[: stop_at + 1]
        s = eng.stats.summary()
        assert s["window_waste_steps"] > 0 and s["window_waste_frac"] > 0
    eng = _engine(tm, decode_ahead=4)
    r = eng.submit(prompt, max_new=6)  # 1 first token + 5 windowed
    eng.run()
    assert r.generated == rb.generated[:6] and len(r.logprobs) == 6
    s = eng.stats.summary()
    assert s["window_waste_steps"] == 8 - 5 and s["n_windows"] == 2


def test_cursor_clamps_at_max_len_under_window_overrun(pair):
    jm, params, tm = pair
    prompt, bucket, max_new = [2, 7, 1], 8, 6
    max_len = bucket + max_new  # no slack: the overrun runs into the clamp
    want = np.asarray(jgen.make_generator(jm, max_len=max_len, max_new=max_new)(
        params, jnp.asarray(prompt, jnp.int32)[None, :]))[0, 3:]
    eng = _engine(tm, decode_ahead=4, max_len=max_len)
    r = eng.submit(prompt, max_new=max_new)
    for _ in range(2):
        eng.step()
    assert int(eng.cache["block_0"]["index"].max()) <= max_len
    eng.run()
    np.testing.assert_array_equal(r.generated, want)


def test_deadline_expiry_mid_flight_cancels(pair):
    _, _, tm = pair
    clock = _FakeClock()
    eng = _engine(tm, decode_ahead=4, clock=clock, slots=1, max_len=64)
    eng.scheduler.clock = clock

    def tick(req, tok):
        clock.t += 3.0

    r = eng.submit([1, 2, 3], max_new=30, deadline_s=10.0, callback=tick)
    eng.run()
    assert r.status == "cancelled" and 0 < len(r.generated) < 30

    clock2 = _FakeClock()
    eng2 = _engine(tm, decode_ahead=2, clock=clock2, slots=1, max_len=64)
    eng2.scheduler.clock = clock2

    def slow(req, tok):
        clock2.t += 5.0

    long = eng2.submit([4, 5, 6], max_new=12, callback=slow)
    short = eng2.submit([7, 8], max_new=4, deadline_s=8.0)
    eng2.run()
    assert long.status == "done"
    assert short.status == "cancelled" and short.generated == []  # never landed


def test_prefill_overlap_preserves_fifo_and_output(pair):
    jm, params, tm = pair
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    gen = jgen.make_generator(jm, max_len=48, max_new=6)
    want = [np.asarray(gen(params, jnp.asarray(p, jnp.int32)[None, :]))[0, 3:9]
            for p in prompts]
    eng = _engine(tm, decode_ahead=2)
    parked = []
    real = eng._overlap_prefill

    def spy():
        real()
        parked.append(len(eng._pending))

    eng._overlap_prefill = spy
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for i, (r, w) in enumerate(zip(reqs, want)):
        assert r.status == "done"
        np.testing.assert_array_equal(r.generated, w, err_msg=f"req {i}")
    assert max(parked) >= 1  # requests really were prefilled behind windows
    admits = [r.admit_t for r in reqs]
    assert admits == sorted(admits)


# ----------------------------------------------------------------------
# the prefix cache


def test_prefix_cache_hit_skips_prefill_with_identical_output(pair):
    _, _, tm = pair
    prompt = [9, 4, 2, 6]
    for sampling in (None, SamplingParams(temperature=0.9, top_k=6, seed=3)):
        eng = _engine(tm, decode_ahead=2, prefix_cache_bytes=64 << 20)
        calls = {"n": 0}
        real = eng._dense_prefill

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        eng._dense_prefill = counting
        r1 = eng.submit(prompt, max_new=5, sampling=sampling)
        eng.run()
        r2 = eng.submit(prompt, max_new=5, sampling=sampling)
        r3 = eng.submit(prompt, max_new=3, sampling=sampling)
        eng.run()
        assert calls["n"] == 1  # both later prefills skipped
        assert r2.generated == r1.generated and r3.generated == r1.generated[:3]
        assert r2.logprobs == r1.logprobs
        s = eng.stats.summary()
        assert s["prefix_hits"] == 2 and s["prefix_misses"] == 1
        assert s["prefix_hit_rate"] == pytest.approx(2 / 3, abs=1e-4)
        cold = _engine(tm)
        rc = cold.submit(prompt, max_new=5, sampling=sampling)
        cold.run()
        assert rc.generated == r1.generated
    sched = FIFOScheduler(max_len=64, buckets=(8, 16))
    a = sched.submit(np.arange(1, 7), max_new=2)   # bucket 8
    b = sched.submit(np.arange(1, 12), max_new=2)  # bucket 16
    assert a.prefix_key != b.prefix_key


def test_prefix_cache_lru_eviction_and_refusals(pair):
    _, _, tm = pair
    row = {"k": torch.zeros(64)}  # 256 bytes an entry
    pc = PrefixCache(max_bytes=600)
    pc.put("a", row, 1)
    pc.put("b", row, 2)
    assert pc.get("a") is not None  # refresh a: b is now least recent
    pc.put("c", row, 3)             # 3 x 256 > 600: evicts b
    assert pc.get("b") is None
    assert pc.get("a") is not None and pc.get("c") is not None
    assert pc.bytes <= 600
    pc.put("huge", {"k": torch.zeros(1024)}, 4)  # 4096 bytes > the budget
    assert pc.get("huge") is None and pc.oversized == 1
    with pytest.raises(ValueError, match="max_bytes"):
        PrefixCache(max_bytes=0)
    eng = _engine(tm, prefix_cache_bytes=8)  # every row is oversized
    for p in PROMPTS[:3]:
        eng.submit(p, max_new=3)
    eng.run()
    assert eng.stats.summary()["prefix_oversized"] == 3


def test_stats_window_fields_strict_json_and_validation(pair):
    _, _, tm = pair
    eng = _engine(tm, decode_ahead=4, prefix_cache_bytes=1 << 20)
    for p in PROMPTS:
        eng.submit(p, max_new=5)
    eng.run()
    s = eng.stats.summary()
    for key in ("decode_ahead", "n_windows", "window_dispatch_s", "window_readback_s",
                "window_steps", "window_waste_steps", "window_waste_frac",
                "useful_tokens_per_window", "prefix_hits", "prefix_misses"):
        assert key in s, key
    assert s["decode_ahead"] == 4
    json.dumps(s, allow_nan=False)
    empty = ServingStats(slots=2).summary()
    assert empty["window_waste_frac"] is None and empty["prefix_hit_rate"] is None
    json.dumps(empty, allow_nan=False)
    with pytest.raises(ValueError, match="decode_ahead"):
        _engine(tm, decode_ahead=0)
    with pytest.raises(ValueError, match="prefix_cache_bytes"):
        _engine(tm, prefix_cache_bytes=-1)
