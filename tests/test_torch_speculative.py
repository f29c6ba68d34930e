"""The port's speculative decoding, held against the JAX package.

* KEYS AND DRAFTS — ``uniform`` bit-equal to ``jax.random.uniform`` (the
  accept draw of rejection sampling); ``NgramDrafter`` equal to JAX's on
  seeded contexts and on JAX's own cases.
* VERIFY — ``make_verify_window`` against JAX's on the same prefilled
  cache and chunk (oracle, garbage and empty drafts): tokens, accepted
  counts, last tokens and rewound cursors equal, and the emitted chain the
  sequential greedy one; ``_verify_sample_core`` against JAX's on a mix of
  greedy and sampled rows: tokens, counts, last and cursors equal,
  logprobs at 1e-5; its greedy rows equal to the greedy core.
* ENGINE — spec streams token-identical to the plain k=1 stream of the
  port and to the JAX engine, dense, paged, int8 KV and paged int8; draft
  lengths 1-5 and a tight cache; retirement mid-acceptance on EOS, budget
  and deadline against the plain k=1 stream truncated there (the ground
  truth JAX's tests name: its own engine fails that test); a sampled mix
  equal to the JAX spec engine and replayed across layouts; the spec
  stats, zero / None on plain engines, strict JSON.

Both sides run float32 on the CPU.
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
from distributed_tensorflow_ibm_mnist_tpu.serving import NgramDrafter as JaxDrafter
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxParams
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as tgen
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    InferenceEngine,
    NgramDrafter,
    SamplingParams,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling as ts

jgen = importlib.import_module("distributed_tensorflow_ibm_mnist_tpu.core.generate")

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[7, 3, 11, 2, 5], [4, 9], [1, 2, 3, 1, 2, 3, 1], [6],
           [5, 5, 5, 5], [2, 8, 2, 8, 2, 8]]
MIX = [None, SamplingParams(temperature=0.8, top_p=0.9, seed=11), None,
       SamplingParams(temperature=1.2, top_k=6, seed=(1 << 40) + 3),
       SamplingParams(temperature=0.6, min_p=0.05, seed=5), None]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _jax_pair(seed=0, **over):
    jm = jax_get_model("causal_lm", **KW, **over, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW, **over,
                        dtype=torch.float32)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _jax_pair()


def _serve(eng, max_new=10, prompts=PROMPTS, sampling=None):
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=max_new,
                       sampling=None if sampling is None else sampling[i])
            for i, p in enumerate(prompts)]
    eng.run()
    eng.close()
    return [tuple(r.generated) for r in reqs]


def _port(tm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (8,))
    return InferenceEngine(tm, device="cpu", **kw)


def _jax(jm, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("buckets", (8,))
    return JaxEngine(jm, params, **kw)


# ----------------------------------------------------------------------
# the accept draw and the drafter


@pytest.mark.parametrize("shape, lo, hi", [((), 0.0, 1.0), ((33,), 0.0, 1.0),
                                           ((4, 5), -2.0, 3.0)])
def test_uniform_bits_equal_jax(shape, lo, hi):
    seeds = (0, 1, (1 << 32) + 5, (1 << 64) - 1)
    keys = torch.stack([ts.fold_in(torch.from_numpy(ts.base_key(s).astype(np.int64))[None],
                                   torch.tensor([n]))[0]
                        for s in seeds for n in (0, 1, 12345)])
    got = ts.uniform(keys, shape, lo, hi)
    assert got.shape == (len(keys), *shape) and got.dtype == torch.float32
    for row, key in zip(got, keys):
        jk = jax.random.wrap_key_data(jnp.asarray(key.numpy(), jnp.uint32))
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(row.numpy().view(np.int32), want.view(np.int32))


def test_drafter_matches_jax_on_seeded_contexts():
    rng = np.random.default_rng(0)
    for trial in range(200):
        period = int(rng.integers(1, 6))
        motif = rng.integers(0, 8, size=period)
        ctx = np.tile(motif, 12)[: int(rng.integers(1, 40))]
        ctx = np.where(rng.random(ctx.size) < 0.15, rng.integers(0, 8, ctx.size), ctx)
        kw = dict(draft_len=int(rng.integers(1, 9)), max_ngram=int(rng.integers(1, 5)),
                  max_context=int(rng.choice([0, 8, 4096])))
        kw["min_ngram"] = int(rng.integers(1, kw["max_ngram"] + 1))
        want = JaxDrafter(**kw).draft(ctx)
        got = NgramDrafter(**kw).draft(ctx)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"{trial}: {kw} {ctx}")


def test_drafter_cases_and_validation():
    d = NgramDrafter(draft_len=6)
    # a period-3 stream extends periodically past the context
    np.testing.assert_array_equal(d.draft([4, 7, 9, 4, 7, 9, 4, 7, 9]), [4, 7, 9, 4, 7, 9])
    np.testing.assert_array_equal(d.draft([1, 2, 3, 4, 5, 6, 7, 1, 2, 3]),
                                  [4, 5, 6, 7, 1, 2])
    assert d.draft([1, 2, 3, 4, 5]).size == 0 and d.draft([3]).size == 0
    assert NgramDrafter(4, max_context=4).draft([8, 9, 1, 2, 3, 4, 5]).size == 0
    for kw, match in ((dict(draft_len=0), "draft_len"),
                      (dict(draft_len=3, max_ngram=2, min_ngram=3), "ngram"),
                      (dict(draft_len=3, max_context=-1), "max_context")):
        with pytest.raises(ValueError, match=match):
            NgramDrafter(**kw)


# ----------------------------------------------------------------------
# the verify window against JAX's


BATCH = [np.asarray([7, 3, 11, 2, 5], np.int32), np.asarray([4, 9], np.int32)]


def _prefilled(jm, params, tm, max_len=64):
    batch = np.zeros((2, 8), np.int32)
    for i, p in enumerate(BATCH):
        batch[i, : p.size] = p
    lens = np.asarray([p.size for p in BATCH], np.int32)
    jcache, jlast = jgen.make_prefill(jm, max_len)(params, jnp.asarray(batch),
                                                  jnp.asarray(lens))
    tcache, tlast = tgen.make_prefill(tm, max_len)(torch.from_numpy(batch).long(),
                                                   torch.from_numpy(lens))
    return jcache, tcache, np.asarray(jnp.argmax(jlast, -1)).astype(np.int64)


def test_verify_window_matches_jax(pair):
    jm, params, tm = pair
    draft_len, k = 3, 4
    jcache, tcache, pending = _prefilled(jm, params, tm)
    # the sequential greedy chain, from the port's own stepwise decode
    _, scache, _ = _prefilled(jm, params, tm)
    step = tgen.make_decode_step(tm, 64)
    tok, chain = torch.from_numpy(pending), [pending]
    for _ in range(15):
        scache, logits = step(scache, tok)
        tok = logits.argmax(-1)
        chain.append(tok.numpy())
    chain = np.stack(chain, 1)
    jverify = jgen.make_verify_window(jm, 64, draft_len)
    tverify = tgen.make_verify_window(tm, 64, draft_len)
    rng = np.random.RandomState(0)
    drafts = {"oracle": lambda b, n: chain[b, n:n + draft_len],
              "garbage": lambda b, n: rng.randint(0, 16, size=draft_len),
              "empty": lambda b, n: np.zeros((0,), np.int64)}
    for name, draft in drafts.items():
        jcache, tcache, pending = _prefilled(jm, params, tm)
        out = [[int(pending[0])], [int(pending[1])]]
        while min(len(o) for o in out) < 12:
            chunk = np.zeros((2, k), np.int64)
            dls = np.zeros((2,), np.int64)
            chunk[:, 0] = pending
            for b in range(2):
                d = np.asarray(draft(b, len(out[b])))
                chunk[b, 1:1 + d.size] = d
                dls[b] = d.size
            jcache, jt, ja, jl = jverify(params, jcache, jnp.asarray(chunk, jnp.int32),
                                         jnp.asarray(dls, jnp.int32))
            tcache, tt, ta, tl = tverify(tcache, torch.from_numpy(chunk),
                                         torch.from_numpy(dls))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=name)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=name)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), err_msg=name)
            np.testing.assert_array_equal(tcache["block_0"]["index"].numpy(),
                                          np.asarray(jcache["block_0"]["index"]))
            for b in range(2):
                n = int(ta[b]) + 1
                out[b].extend(int(t) for t in tt[b, :n])
                pending[b] = int(tt[b, n - 1])
        for b in range(2):
            assert out[b][:12] == list(chain[b, :12]), name
    with pytest.raises(ValueError, match="chunk"):
        tverify(tcache, torch.ones((2, 3), dtype=torch.long), torch.ones(2, dtype=torch.long))
    with pytest.raises(ValueError, match="draft_len"):
        tgen.make_verify_window(tm, 32, 0)
    with pytest.raises(ValueError, match="max_len"):
        tgen.make_verify_window(tm, 0, 3)


def _planes(mix):
    temps = np.asarray([0.0 if s is None else s.temperature for s in mix], np.float32)
    topps = np.asarray([0.0 if s is None else s.top_p for s in mix], np.float32)
    topks = np.asarray([0 if s is None else s.top_k for s in mix], np.int32)
    minps = np.asarray([0.0 if s is None else s.min_p for s in mix], np.float32)
    keys = np.stack([ts.base_key(0 if s is None else s.seed) for s in mix])
    return temps, topps, topks, minps, keys


@pytest.mark.parametrize("rows", [[MIX[1], None], [MIX[3], MIX[4]]],
                         ids=["sampled+greedy", "sampled+sampled"])
def test_verify_sample_core_matches_jax(pair, rows):
    jm, params, tm = pair
    k = 5
    jcache, tcache, pending = _prefilled(jm, params, tm)
    planes = _planes(rows)
    pos = np.asarray([1, 3], np.int32)
    jverify = jax.jit(lambda *a: jgen._verify_sample_core(jm, *a, 64, 0))
    rng = np.random.RandomState(1)
    for window in range(6):
        chunk = np.zeros((2, k), np.int64)
        chunk[:, 0] = pending
        chunk[:, 1:] = rng.randint(0, 4, size=(2, k - 1))  # a small vocab head: hits
        dls = np.asarray([k - 1, window % k], np.int64)
        active = np.asarray([True, window != 2])
        jcache, jt, jlp, ja, jl = jverify(
            params, jcache, jnp.asarray(chunk, jnp.int32), jnp.asarray(dls, jnp.int32),
            jnp.asarray(active), *(jnp.asarray(p) for p in planes), jnp.asarray(pos))
        with torch.no_grad():
            tcache, tt, tlp, ta, tl = tgen._verify_sample_core(
                tm, tcache, torch.from_numpy(chunk), torch.from_numpy(dls),
                torch.from_numpy(active),
                *(torch.from_numpy(np.asarray(p)) for p in planes[:4]),
                ts.key_words(planes[4]), torch.from_numpy(pos), 64, 0)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=str(window))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
        np.testing.assert_array_equal(tcache["block_0"]["index"].numpy(),
                                      np.asarray(jcache["block_0"]["index"]))
        n = np.where(active, ta.numpy() + 1, 0)
        pos = (pos + n).astype(np.int32)
        pending = np.where(active, tl.numpy(), pending)


def test_verify_sample_greedy_rows_are_the_greedy_core(pair):
    jm, params, tm = pair
    chunk = torch.tensor([[3, 1, 2, 3, 1], [9, 9, 4, 1, 0]])
    dls = torch.tensor([4, 2])
    active = torch.tensor([True, True])
    planes = _planes([None, None])
    outs = []
    torch.set_grad_enabled(False)
    for fn in ("greedy", "sampled", "unsampled"):
        _, tcache, _ = _prefilled(jm, params, tm)
        if fn == "greedy":
            _, toks, acc, last = tgen._verify_window_core(tm, tcache, chunk, dls, active, 64, 0)
        else:
            _, toks, _, acc, last = tgen._verify_sample_core(
                tm, tcache, chunk, dls, active,
                *(torch.from_numpy(np.asarray(p)) for p in planes[:4]),
                ts.key_words(planes[4]), torch.tensor([0, 0]), 64, 0,
                sampled=fn == "sampled")
        outs.append((toks, acc, last, tcache["block_0"]["index"].clone()))
    torch.set_grad_enabled(True)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


# ----------------------------------------------------------------------
# the engine


@pytest.mark.parametrize("layout", ["dense", "paged", "int8", "paged_int8"])
def test_engine_spec_parity_across_layouts(layout):
    """Spec streams == the port's plain k=1 stream == the JAX engine's (no
    EOS here: budget retirements only)."""
    over = {"kv_cache_dtype": "int8"} if "int8" in layout else {}
    jm, params, tm = _jax_pair(**over)
    paged = dict(kv_page_size=8, kv_pages=16) if "paged" in layout else {}
    spec = _serve(_port(tm, speculative="ngram", draft_len=3, **paged))
    assert spec == _serve(_port(tm, **paged))
    assert spec == _serve(_port(tm, decode_ahead=4, **paged))
    assert spec == _serve(_jax(jm, params, speculative="ngram", draft_len=3, **paged))


def test_engine_spec_draft_lens_and_tight_cache(pair):
    _, _, tm = pair
    plain = _serve(_port(tm))
    for dl in (1, 2, 5):
        assert _serve(_port(tm, speculative="ngram", draft_len=dl)) == plain, dl
    # max_len = bucket + max_new: the last verify chunks overrun the cursor
    # clamp; the clamped writes must not touch live positions
    tight = dict(max_len=8 + 10)
    assert _serve(_port(tm, speculative="ngram", **tight)) == _serve(_port(tm, **tight))


def test_retirement_mid_acceptance_eos_budget_deadline(pair):
    """EOS inside an accepted block stops at the EOS, a budget cuts the
    block, a lapsed deadline cancels before any window: each as the plain
    k=1 stream does (the port's own, truncated there)."""
    _, _, tm = pair
    eos = _serve(_port(tm), max_new=12)[0][3]

    def run(**kw):
        clock = _FakeClock()
        eng = _port(tm, eos_id=eos, clock=clock, **kw)
        rs = [eng.submit(np.asarray(p, np.int32), max_new=12) for p in PROMPTS[:3]]
        late = eng.submit(np.asarray(PROMPTS[3], np.int32), max_new=12, deadline_s=0.5)
        tiny = eng.submit(np.asarray(PROMPTS[4], np.int32), max_new=5)
        clock.t += 5.0
        eng.run()
        return rs + [late, tiny]

    plain = run()
    spec = run(speculative="ngram", draft_len=3)
    for p, s in zip(plain, spec):
        assert (s.status, s.generated) == (p.status, p.generated)
    assert spec[0].generated[-1] == eos and len(spec[0].generated) <= 4
    assert spec[3].status == "cancelled" and spec[3].generated == []
    assert len(spec[4].generated) == 5 and spec[4].status == "done"
    assert any(len(r.generated) > 1 for r in spec[:3])


def test_sampled_spec_matches_jax_and_replays(pair):
    """Rejection-sampled streams equal the JAX spec engine's (the same key
    schedule and acceptance draws) and replay across layouts."""
    jm, params, tm = pair
    jmix = [None if s is None else JaxParams(**s.to_dict()) for s in MIX]
    got = _serve(_port(tm, speculative="ngram", draft_len=3), sampling=MIX)
    want = _serve(_jax(jm, params, speculative="ngram", draft_len=3), sampling=jmix)
    assert got == want
    assert _serve(_port(tm, speculative="ngram", draft_len=3, kv_page_size=8),
                  sampling=MIX) == got
    greedy = _serve(_port(tm))
    assert all(got[i] == greedy[i] for i, s in enumerate(MIX) if s is None)


def test_spec_stats_and_validation(pair):
    _, _, tm = pair
    eng = _port(tm, speculative="ngram", draft_len=3)
    for p in PROMPTS[:3]:
        eng.submit(np.asarray(p, np.int32), max_new=10)
    eng.run()
    s = eng.stats.summary()
    assert s["drafted_tokens"] > 0 and s["corrected_tokens"] > 0
    assert s["accept_rate"] == round(s["accepted_tokens"] / s["drafted_tokens"], 4)
    assert s["tokens_generated"] == 30
    # every emitted token is an accepted draft, a correction or a first pick
    assert s["accepted_tokens"] + s["corrected_tokens"] >= 30 - 3
    assert s["useful_tokens_per_window"] > 1.0
    json.loads(json.dumps(s, allow_nan=False))
    plain = _port(tm)
    plain.submit([1, 2], 3)
    plain.run()
    p = plain.stats.summary()
    assert (p["drafted_tokens"], p["accepted_tokens"], p["corrected_tokens"]) == (0, 0, 0)
    assert p["accept_rate"] is None
    json.loads(json.dumps(p, allow_nan=False))
    with pytest.raises(ValueError, match="speculative"):
        _port(tm, speculative="tree")
    with pytest.raises(ValueError, match="draft_len"):
        _port(tm, speculative="ngram", draft_len=0)
    _port(tm, speculative="ngram", temperature=0.7, rng=0).close()  # sampling composes
    _, _, wm = _jax_pair(window=8)
    with pytest.raises(ValueError, match="sliding-window"):
        _port(wm, speculative="ngram")
