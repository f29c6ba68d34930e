"""The port's paged KV cache and radix prefix sharing, held against the
dense layout and the JAX package.

* POOL AND TRIE — ``KVPagePool`` (trash page 0, all-or-nothing, lowest id
  first) and ``pages_needed``; the radix trie driven by one operation
  sequence through JAX's ``RadixCache`` and the port's: the same matches,
  refcounts, donations and evictions.
* LAYOUT — a prefilled row inserted through a block table gathers back
  to the dense row; a decode step over the paged cache gives the dense
  step's logits exactly; the suffix extend over a shared prefix gives the
  dense prefill's last logits and K/V (float32, 1e-5); reset, gather,
  page write and table install.
* ENGINE — paged greedy output equals dense at decode_ahead {1, 4},
  with EOS / budget / deadline retirement mixed; radix sharing equals
  dense and the JAX paged radix engine on shared-prefix prompts; the pool
  drains after a run; overcommit stalls, then completes; close() fails a
  stalled request and frees its pages; constructor validation; the page
  and radix stats are strict JSON.

Both sides run float32 on the CPU with plain attention.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving import RadixCache as JaxRadix
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as tgen
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import FIFOScheduler, InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import kv_pool
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.radix_cache import RadixCache

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=64, depth=2, heads=4)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [6, 6, 6]]
SHARED = [11, 12, 13, 14, 15, 1, 2, 3]  # exactly one page of 8
SHARED_PROMPTS = [SHARED + [i] for i in range(5)] + [SHARED[:4] + [9, 9]]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        dtype=torch.float32)
    return jm, params, tm


def _engine(tm, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    return InferenceEngine(tm, device="cpu", **kw)


def _run(eng, prompts=PROMPTS, max_new=10):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    return reqs


def _outputs(reqs):
    return [(r.status, tuple(r.generated)) for r in reqs]


# ----------------------------------------------------------------------
# the pool and the trie


def test_page_pool_alloc_free():
    pool = kv_pool.KVPagePool(n_pages=6, page_size=8)
    assert pool.capacity == 5 and pool.free_count == 5 and pool.allocated == 0
    assert pool.alloc(3) == [1, 2, 3]  # ascending; the trash page never given
    assert pool.alloc(3) is None and pool.free_count == 2  # all-or-nothing
    pool.free([2])
    b = pool.alloc(3)
    assert sorted(b) == [2, 4, 5] and pool.free_count == 0
    with pytest.raises(ValueError, match="invalid page id"):
        pool.free([0])
    with pytest.raises(ValueError, match="invalid page id"):
        pool.free([6])
    pool.free([1, 3] + b)
    with pytest.raises(ValueError, match="double free"):
        pool.free([1])
    with pytest.raises(ValueError, match="trash"):
        kv_pool.KVPagePool(n_pages=1, page_size=8)


def test_pages_needed():
    assert [kv_pool.pages_needed(n, 8) for n in (1, 8, 9, 33)] == [1, 1, 2, 5]


def _trie_ops(rc):
    """One operation sequence; returns what a caller observes of it."""
    seen = []
    toks = np.arange(12, dtype=np.int32)
    path, m = rc.match(toks)
    seen.append(("match", [n.page for n in path], m))
    held, kept = rc.insert(toks, 0, {0: 5, 1: 6, 2: 7}, [])
    seen.append(("insert", [n.page for n in held], kept, rc.n_blocks))
    for probe in (toks, np.asarray([0, 1, 2, 3, 9, 9, 9, 9], np.int32), toks[:7]):
        path, m = rc.match(probe)
        seen.append(("match", [n.page for n in path], m, [n.ref for n in path]))
    prefix = rc.match(toks[:4])[0]
    rc.acquire(prefix)
    held2, kept2 = rc.insert(toks[:8], 1, {1: 9}, prefix)
    seen.append(("race", [n.page for n in held2], kept2))
    other = np.asarray([0, 1, 2, 3, 20, 21, 22, 23], np.int32)
    held3, _ = rc.insert(other, 1, {1: 11}, prefix)
    seen.append(("branch", [n.page for n in held3], rc.n_blocks))
    rc.release(held)
    freed = []
    seen.append(("evict", rc.evict(1, freed.append), list(freed)))
    rc.release(prefix)
    rc.release(held3)
    seen.append(("evict", rc.evict(9, freed.append), list(freed), rc.n_blocks))
    rc.record(True, tokens=8)
    rc.record(False)
    seen.append(("stats", rc.hits, rc.misses, rc.hit_tokens))
    return seen


def test_radix_trie_identical_to_jax():
    want = _trie_ops(JaxRadix(page_size=4))
    got = _trie_ops(RadixCache(page_size=4))
    assert got == want
    with pytest.raises(ValueError, match="unheld"):
        RadixCache(4).release([RadixCache(4).root])


# ----------------------------------------------------------------------
# the layout


def _paged_of(tm, slots, max_len, ps, n_pages):
    return kv_pool.init_paged_cache(tm, slots, max_len, ps, n_pages)


def test_insert_gather_and_paged_decode_equal_dense(pair):
    _, _, tm = pair
    max_len, ps = 32, 8
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]])
    row, _ = tgen.make_prefill(tm, max_len)(prompt)
    paged = _paged_of(tm, 2, max_len, ps, 9)
    bt = torch.tensor([4, 2, 7, 0], dtype=torch.int32)  # block 3: the trash page
    kv_pool.make_paged_insert(ps, max_len)(paged, row, bt, 1)
    e = paged["block_0"]
    assert e["index"].tolist() == [0, 11] and e["block_table"][1].tolist() == bt.tolist()
    gathered = e["pages_k"][bt.long()].reshape(max_len, *e["pages_k"].shape[2:])
    assert torch.equal(gathered[:24], row["block_0"]["k"][0, :24])
    # one decode step through each layout: the same logits, bit for bit
    dense = tgen.init_cache(tm, 2, max_len)
    InferenceEngine._insert_impl(dense, row, 1)
    tok = torch.tensor([0, 7])
    step = tgen.make_decode_step(tm, max_len)
    _, want = step(dense, tok)
    _, got = step(paged, tok)
    assert torch.equal(got[1], want[1])
    assert e["index"].tolist() == [1, 12]
    # reset, page gather / write, table install
    kv_pool.paged_reset(paged, torch.tensor([False, True]))
    assert e["block_table"][1].tolist() == [0] * 4 and e["index"][1] == 0
    payload = kv_pool.gather_page(paged, 4)
    kv_pool.page_write(paged, payload, 5)
    assert torch.equal(e["pages_v"][5], e["pages_v"][4])
    kv_pool.bt_install(paged, bt, 0, 11)
    assert e["block_table"][0].tolist() == bt.tolist() and e["index"][0] == 11
    assert kv_pool.pool_page_bytes(paged) == 2 * 2 * ps * 4 * 16 * 4  # depth, k/v
    with pytest.raises(ValueError, match="multiple of page_size"):
        kv_pool.paged_cache_shapes(tm, 2, 30, ps, 9)


def test_extend_over_a_shared_prefix_equals_dense_prefill(pair):
    """The radix landing: a prompt whose first page is resident runs only
    its suffix, as one decode-mode chunk over the block table; its last
    logits and K/V equal the dense prefill of the whole prompt."""
    _, _, tm = pair
    max_len, ps = 32, 8
    full = torch.tensor([SHARED + [4, 6, 8]])
    donor, _ = tgen.make_prefill(tm, max_len)(torch.tensor([SHARED + [1]]))
    want_cache, want_last = tgen.make_prefill(tm, max_len)(full)
    paged = _paged_of(tm, 2, max_len, ps, 9)
    kv_pool.make_paged_insert(ps, max_len)(
        paged, donor, torch.tensor([3, 1, 0, 0], dtype=torch.int32), 0)
    bt = torch.tensor([3, 5, 0, 0], dtype=torch.int32)  # page 3 shared, 5 private
    suffix = torch.tensor([[4, 6, 8, 0, 0, 0, 0, 0]])  # padded to a bucket of 8
    _, last = kv_pool.make_paged_extend(tm, max_len, ps)(paged, 1, bt, suffix, 8, 3)
    torch.testing.assert_close(last, want_last, atol=1e-5, rtol=1e-5)
    e = paged["block_0"]
    assert e["index"].tolist() == [9, 11] and e["block_table"][1].tolist() == bt.tolist()
    torch.testing.assert_close(e["pages_k"][5, :3], want_cache["block_0"]["k"][0, 8:11],
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(e["pages_k"][3], donor["block_0"]["k"][0, :8])  # never written


# ----------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("k", [1, 4])
def test_paged_greedy_matches_dense(pair, k):
    _, _, tm = pair
    want = _outputs(_run(_engine(tm, decode_ahead=k)))
    paged = _engine(tm, decode_ahead=k, kv_page_size=8, radix_cache=False)
    assert _outputs(_run(paged)) == want
    s = paged.stats.summary()
    assert s["kv_page_size"] == 8 and s["kv_pages_peak"] > 0


def test_paged_mixed_retirement_matches_dense(pair):
    _, _, tm = pair
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]

    def drive(**kw):
        clock = _FakeClock()
        # eos 7: request 3's first token (it retires at admission), and in
        # no other stream, so request 2 lives until its deadline
        eng = _engine(tm, slots=2, eos_id=7, decode_ahead=4, clock=clock, **kw)
        reqs = [eng.submit(prompts[0], max_new=12),
                eng.submit(prompts[1], max_new=3),
                eng.submit(prompts[2], max_new=12, deadline_s=2.0),
                eng.submit(prompts[3], max_new=6)]
        while eng.has_work:
            eng.step()
            clock.t += 1.0  # the deadline request dies mid-flight
        eng.run()
        return _outputs(reqs)

    want = drive()
    for kw in ({"kv_page_size": 8, "radix_cache": False}, {"kv_page_size": 8}):
        assert drive(**kw) == want, kw
    assert [st for st, _ in want] == ["done", "done", "cancelled", "done"]
    assert [len(g) for _, g in want][1::2] == [3, 1]  # budget, EOS


def test_radix_sharing_matches_dense_and_jax_engine(pair):
    jm, params, tm = pair
    want = _outputs(_run(_engine(tm, slots=2), SHARED_PROMPTS, max_new=6))
    eng = _engine(tm, slots=2, kv_page_size=8)
    reqs = _run(eng, SHARED_PROMPTS, max_new=6)
    assert _outputs(reqs) == want
    s = eng.stats.summary()
    assert s["radix_hits"] >= 3 and s["radix_hit_tokens"] == s["radix_hits"] * 8
    assert reqs[0].radix_tokens == 0 and reqs[1].radix_tokens == 8
    assert reqs[-1].radix_tokens == 0  # half a page shared: a miss
    jeng = JaxEngine(jm, params, slots=2, max_len=32, kv_page_size=8, decode_ahead=2)
    jreqs = [jeng.submit(np.asarray(p, np.int32), max_new=6) for p in SHARED_PROMPTS]
    jeng.run()
    assert [tuple(r.generated) for r in jreqs] == [g for _, g in want]
    assert jeng.stats.summary()["radix_hit_tokens"] == s["radix_hit_tokens"]


def test_radix_pool_drains_after_run(pair):
    _, _, tm = pair
    eng = _engine(tm, slots=2, kv_page_size=8)
    _run(eng)
    assert eng._pool.allocated == eng._radix.n_blocks
    eng2 = _engine(tm, slots=2, kv_page_size=8, radix_cache=False)
    _run(eng2)
    assert eng2._pool.allocated == 0


def test_overcommit_stalls_then_completes(pair):
    _, _, tm = pair
    want = _outputs(_run(_engine(tm, slots=4)))
    eng = _engine(tm, slots=4, kv_page_size=8, kv_pages=9, radix_cache=False)
    stalls = []
    real = eng._admit_free_slots

    def spy(mask):
        out = real(mask)
        stalls.append(len(eng._stalled_ids))
        return out

    eng._admit_free_slots = spy
    reqs = _run(eng)
    assert _outputs(reqs) == want and all(r.status == "done" for r in reqs)
    assert max(stalls) >= 1  # admission really stalled on the dry pool
    assert eng.stats.summary()["kv_pages_peak"] <= 8


def test_close_fails_overcommit_stalled_request_and_frees_pages(pair):
    _, _, tm = pair
    eng = _engine(tm, slots=2, max_len=16, kv_page_size=4, kv_pages=5,
                  radix_cache=False, scheduler=FIFOScheduler(max_len=16, buckets=(8,)))
    r1 = eng.submit([1, 2, 3], max_new=12)
    r2 = eng.submit([4, 5, 6], max_new=12)
    eng.step()
    assert r1.status == "running" and r2.status == "queued"
    assert len(eng._pending) == 1  # r2 parked on the dry pool
    eng.close()
    assert r1.status == "cancelled" and r1.engine_fault
    assert r2.status == "failed" and r2.engine_fault
    assert "overcommit-stalled" in (r2.error or "")
    assert eng._pool.allocated == 0 and not eng._pending
    assert {r.id for r in eng.completed} == {r1.id, r2.id}


def test_paged_constructor_validation(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="multiple of kv_page_size"):
        _engine(tm, max_len=30, kv_page_size=8)
    with pytest.raises(ValueError, match="needs the paged cache"):
        _engine(tm, radix_cache=True)
    with pytest.raises(ValueError, match="needs kv_page_size"):
        _engine(tm, kv_pages=4)
    with pytest.raises(ValueError, match="cannot hold one full-length"):
        _engine(tm, kv_page_size=8, kv_pages=3)
    windowed = get_model("causal_lm", **KW, window=4, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        _engine(windowed, kv_page_size=8)
    paged_model = get_model("causal_lm", **KW, page_size=8, dtype=torch.float32,
                            device="cpu")
    with pytest.raises(ValueError, match="kv_page_size=8"):
        _engine(paged_model)
    _engine(paged_model, kv_page_size=8).close()


def test_paged_stats_json_safe(pair):
    _, _, tm = pair
    eng = _engine(tm, slots=2, kv_page_size=8)
    _run(eng)
    s = eng.stats.summary()
    for key in ("kv_page_size", "kv_pages_total", "kv_pages_live", "kv_pages_peak",
                "kv_bytes_live", "kv_bytes_peak", "radix_hits", "radix_misses",
                "radix_hit_tokens", "radix_hit_rate"):
        assert key in s, key
    json.dumps(s, allow_nan=False)
    assert s["kv_pages_total"] == 8  # slots x max_len / ps (trash excluded)
    assert s["kv_bytes_peak"] == s["kv_pages_peak"] * eng._page_bytes
    dense = _engine(tm, slots=2)
    _run(dense)
    sd = dense.stats.summary()
    assert sd["kv_page_size"] is None and sd["kv_pages_peak"] == 0
    json.dumps(sd, allow_nan=False)
