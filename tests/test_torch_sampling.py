"""The port's sampling against the JAX package's, on the same inputs.

* KEY SCHEDULE — serving/sampling.py's Threefry-2x32 in torch integer ops:
  ``fold_in``, ``bits`` and ``split`` bit-equal to ``jax.random`` over a
  grid of seeds (0, 1, 2**32 + 5, 2**64 - 1) and indices; the Gumbel noise
  within 4 ulps of ``jax.random.gumbel`` (ulps of max(|g|, 1): near g = 0
  the float32 result's own spacing is finer than the inner log's
  rounding, in JAX as here), and ``categorical`` token-identical.
* FILTERS AND PICK — ``_filter_topk_rows``, ``_filter_topp_rows``,
  ``_filter_minp_rows``, ``_tempered_rows`` and ``_pick_rows`` against
  JAX's on the same seeded logits and planes (greedy, top-k, top-p, min-p
  and mixed rows): filtered logits equal, tokens identical, logprobs
  within 1e-6; ``_pick_rows``'s distribution passes the chi-squared gate
  of tests/test_sampling.py over 4096 draws against softmax of the
  filtered logits.
* OFFLINE — ``make_generator`` sampled with top-k / top-p on one key:
  token-identical to JAX's.
* ENGINE — on converted weights, a sampled request (temperature 0.8,
  top-p 0.9, seed 1234), a top-k / min-p one and a greedy one: streams
  token-identical to the JAX engine's at decode_ahead=1, logprobs within
  1e-5; replays identical across decode_ahead {1, 4, 8}, dense and paged
  and an engine restart; the greedy limit, raw-logit logprobs and the
  sampling stats.

Both sides run float32 on the CPU; the models use plain attention (the
flash prefill's parity is tests/test_torch_serving.py's).
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
from distributed_tensorflow_ibm_mnist_tpu.serving import SamplingParams as JaxParams
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as tgen
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    InferenceEngine,
    SamplingParams,
    ServingStats,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling as ts

jgen = importlib.import_module("distributed_tensorflow_ibm_mnist_tpu.core.generate")

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=2, heads=2)
SEEDS = (0, 1, (1 << 32) + 5, (1 << 64) - 1)
INDICES = (0, 1, 7, 12345, (1 << 31) + 3, (1 << 32) - 1)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6], [9, 1, 7]]
MIX = [SamplingParams(temperature=0.8, top_p=0.9, seed=1234),
       SamplingParams(temperature=1.1, top_k=5, min_p=0.05, seed=77),
       None,
       SamplingParams(temperature=0.8, top_p=0.9, seed=1234),
       SamplingParams(temperature=0.7, seed=(1 << 40) + 3)]

# chi-squared 99.9th-percentile critical values by dof (tests/test_sampling.py)
CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52,
            6: 22.46, 7: 24.32}


def _chi2_gate(counts, p, label):
    """Pearson chi-squared at the 99.9th percentile, merging categories
    with expected count < 5 into one bin (tests/test_sampling.py)."""
    n = counts.sum()
    assert counts[p == 0].sum() == 0, f"{label}: emitted zero-prob token"
    counts, p = counts[p > 0], p[p > 0]
    exp = n * p
    small = exp < 5.0
    if small.any():
        counts = np.concatenate([counts[~small], [counts[small].sum()]])
        exp = np.concatenate([exp[~small], [exp[small].sum()]])
    assert exp.min() >= 1.0, f"{label}: degenerate target distribution"
    chi2 = float((((counts - exp) ** 2) / exp).sum())
    dof = len(counts) - 1
    assert chi2 < CHI2_999[dof], (
        f"{label}: chi2 {chi2:.2f} >= {CHI2_999[dof]} (dof {dof}) over "
        f"{int(n)} draws — emitted distribution != target")


def _jkey(seed):
    return jax.random.wrap_key_data(jnp.asarray(ts.base_key(seed), jnp.uint32))


def _tkey(seed):
    return torch.from_numpy(ts.base_key(seed).astype(np.int64))


# ----------------------------------------------------------------------
# the key schedule


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bits_equal_jax(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    for n in INDICES:
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jk, n)), np.int64)
        got = ts.fold_in(tk[None], torch.tensor([n])).numpy()[0]
        np.testing.assert_array_equal(got, want, err_msg=f"fold_in({seed}, {n})")
    want = np.asarray(jax.random.bits(jk, (257,)), np.int64)
    np.testing.assert_array_equal(ts.random_bits(tk[None], 257).numpy()[0], want)
    want = np.asarray(jax.random.key_data(jax.random.split(jk, 5)), np.int64)
    np.testing.assert_array_equal(ts.split(tk, 5).numpy(), want)
    # a folded key's bits: the composition the pick uses
    folded = jax.random.fold_in(jk, 3)
    want = np.asarray(jax.random.bits(folded, (16,)), np.int64)
    got = ts.random_bits(ts.fold_in(tk[None], torch.tensor([3])), 16).numpy()[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_4_ulps_and_categorical_identical(seed):
    jk, tk = _jkey(seed), _tkey(seed)
    want = np.asarray(jax.random.gumbel(jk, (4096,), jnp.float32))
    got = ts.gumbel(tk[None], 4096).numpy()[0]
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert ulps.max() <= 4, ulps.max()
    # categorical: one key per row, as the engine's pick draws
    rng = np.random.default_rng(seed % 1000)
    logits = rng.normal(size=(64, 16)).astype(np.float32)
    keys = np.stack([ts.base_key(seed + i if seed + i < (1 << 64) else i)
                     for i in range(64)])
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jax.vmap(jax.random.wrap_key_data)(jnp.asarray(keys)), jnp.asarray(logits)))
    got = ts.categorical(torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_base_key_and_params_validation():
    for s in (0, 5, (1 << 31) + 9):
        np.testing.assert_array_equal(
            ts.base_key(s), np.asarray(jax.random.key_data(
                jax.random.PRNGKey(s)), np.uint32).reshape(-1)[-2:])
    np.testing.assert_array_equal(ts.base_key((1 << 63) + 3),
                                  [1 << 31, 3])
    assert ts.GREEDY == SamplingParams() and not ts.GREEDY.sampled
    with pytest.raises(ValueError, match="temperature > 0"):
        SamplingParams(temperature=0.0, min_p=0.5)
    with pytest.raises(ValueError, match="seed"):
        SamplingParams(temperature=1.0, seed=1 << 64)
    sp = SamplingParams(temperature=0.8, top_k=4, seed=9)
    assert SamplingParams.from_dict(json.loads(json.dumps(sp.to_dict()))) == sp


# ----------------------------------------------------------------------
# filters and the pick


def _planes(b):
    """Per-row (temps, topps, topks, minps): greedy, plain, top-k, top-p,
    min-p, and all four together, cycled over ``b`` rows."""
    rows = [(0.0, 0.0, 0, 0.0), (0.9, 0.0, 0, 0.0), (1.3, 0.0, 4, 0.0),
            (0.7, 0.8, 0, 0.0), (1.0, 0.0, 0, 0.2), (0.8, 0.9, 6, 0.05)]
    t, p, k, m = zip(*[rows[i % len(rows)] for i in range(b)])
    return (np.asarray(t, np.float32), np.asarray(p, np.float32),
            np.asarray(k, np.int32), np.asarray(m, np.float32))


def test_filters_equal_jax():
    rng = np.random.default_rng(0)
    raw = (rng.normal(size=(12, 16)) * 2).astype(np.float32)
    t, p, k, m = _planes(12)
    jl, tl = jnp.asarray(raw), torch.from_numpy(raw)
    pairs = [
        (jgen._filter_topk_rows(jl, jnp.asarray(k)), tgen._filter_topk_rows(tl, torch.from_numpy(k))),
        (jgen._filter_topp_rows(jl, jnp.asarray(p)), tgen._filter_topp_rows(tl, torch.from_numpy(p))),
        (jgen._filter_minp_rows(jl, jnp.asarray(m)), tgen._filter_minp_rows(tl, torch.from_numpy(m))),
        (jgen._tempered_rows(jl, *map(jnp.asarray, (t, p, k, m))),
         tgen._tempered_rows(tl, *map(torch.from_numpy, (t, p, k, m)))),
    ]
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        cut = want == np.finfo(np.float32).min
        np.testing.assert_array_equal(got == np.finfo(np.float32).min, cut)
        np.testing.assert_allclose(got[~cut], want[~cut], rtol=1e-6, atol=1e-6)
    # every filter left some rows alone and cut in others
    assert any((np.asarray(w) == np.finfo(np.float32).min).any() for w, _ in pairs)


def test_pick_rows_identical_to_jax():
    rng = np.random.default_rng(1)
    b = 48
    raw = (rng.normal(size=(b, 16)) * 1.5).astype(np.float32)
    t, p, k, m = _planes(b)
    seeds = [i * 7919 + 3 for i in range(b)]
    base = np.stack([ts.base_key(s) for s in seeds])
    pos = np.arange(b, dtype=np.int32) % 5
    jkeys = jax.vmap(jax.random.fold_in)(
        jax.vmap(jax.random.wrap_key_data)(jnp.asarray(base)), jnp.asarray(pos))
    jtok, jlogp = jgen._pick_rows(jnp.asarray(raw), *map(jnp.asarray, (t, p, k, m)),
                                  jkeys)
    ttok, tlogp = tgen._pick_rows(torch.from_numpy(raw), *map(torch.from_numpy, (t, p, k, m)),
                                  ts.fold_in(torch.from_numpy(base.astype(np.int64)),
                                             torch.from_numpy(pos)))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-6)
    # the shared first pick is the same pick at position `pos`
    ftok, _ = ts.first_pick(torch.from_numpy(raw), *map(torch.from_numpy, (t, p, k, m)),
                            torch.from_numpy(base.astype(np.int64)), torch.from_numpy(pos))
    np.testing.assert_array_equal(ftok.numpy(), np.asarray(jtok))
    # greedy rows are the argmax; sampled=False promises no sampled row
    greedy = t == 0
    np.testing.assert_array_equal(ttok.numpy()[greedy], raw.argmax(-1)[greedy])
    zero = np.zeros_like(t)
    gtok, glogp = tgen._pick_rows(torch.from_numpy(raw), *map(torch.from_numpy, (zero, p * 0, k * 0, m * 0)),
                                  None, sampled=False)
    np.testing.assert_array_equal(gtok.numpy(), raw.argmax(-1))


@pytest.mark.parametrize("temp, topp, topk, minp", [
    (1.2, 0.0, 0, 0.0), (0.9, 0.85, 0, 0.0), (1.0, 0.0, 5, 0.1)],
    ids=["plain", "nucleus", "topk-minp"])
def test_pick_distribution_chi_squared(temp, topp, topk, minp):
    """4096 draws of ``_pick_rows`` on one row of logits, each with its own
    seed's key at position 0, against softmax of the filtered logits."""
    rng = np.random.default_rng(2)
    row = torch.from_numpy(rng.normal(size=(1, 8)).astype(np.float32))
    n = 4096
    logits = row.expand(n, 8).contiguous()
    planes = (torch.full((n,), temp), torch.full((n,), topp),
              torch.full((n,), topk), torch.full((n,), minp))
    keys = ts.fold_in(torch.from_numpy(np.stack([ts.base_key(s) for s in range(n)])
                                       .astype(np.int64)), torch.zeros(n, dtype=torch.int64))
    tok, _ = tgen._pick_rows(logits, *planes, keys)
    counts = np.bincount(tok.numpy(), minlength=8).astype(np.float64)
    target = torch.softmax(tgen._tempered_rows(row, *(x[:1] for x in planes)), -1)
    _chi2_gate(counts, target.double().numpy()[0], f"t={temp} p={topp} k={topk} m={minp}")


# ----------------------------------------------------------------------
# the offline generator and the engine


@pytest.fixture(scope="module")
def pair():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        dtype=torch.float32)
    return jm, params, tm


def test_sampled_generator_identical_to_jax(pair):
    jm, params, tm = pair
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    for kw in (dict(temperature=0.9, top_k=6), dict(temperature=1.1, top_p=0.8)):
        want = np.asarray(jgen.make_generator(jm, 24, 10, **kw)(
            params, jnp.asarray(prompt), rng=jax.random.PRNGKey(11)))
        got = tgen.make_generator(tm, 24, 10, **kw)(torch.from_numpy(prompt), rng=11)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


def _serve(eng, sampling=MIX, prompts=PROMPTS, max_new=8):
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=max_new, sampling=s)
            for p, s in zip(prompts, sampling)]
    eng.run()
    eng.close()
    assert all(r.status == "done" for r in reqs)
    return [list(r.generated) for r in reqs], [list(r.logprobs) for r in reqs]


def _port(tm, **kw):
    kw.setdefault("slots", 2)
    return InferenceEngine(tm, max_len=48, buckets=(8,), device="cpu", **kw)


def test_sampled_engine_identical_to_jax_engine(pair):
    jm, params, tm = pair
    jmix = [None if s is None else JaxParams(**s.to_dict()) for s in MIX]
    want, want_lp = _serve(JaxEngine(jm, params, slots=2, max_len=48, buckets=(8,)),
                           sampling=jmix)
    got, got_lp = _serve(_port(tm))
    assert got == want
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_seeded_stream_replays_across_k_layout_restart(pair):
    _, _, tm = pair
    want, want_lp = _serve(_port(tm))
    for kw in ({"decode_ahead": 4}, {"decode_ahead": 8}, {"kv_page_size": 8},
               {"kv_page_size": 8, "decode_ahead": 4, "radix_cache": False},
               {"slots": 3}, {}):  # {} = restart
        got, lp = _serve(_port(tm, **kw))
        assert got == want, kw
        for a, b in zip(lp, want_lp):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=str(kw))
    other, _ = _serve(_port(tm), sampling=[
        SamplingParams(temperature=0.8, top_p=0.9, seed=4321)] * len(PROMPTS))
    assert other != want


def test_greedy_limit_and_raw_logprobs(pair):
    _, _, tm = pair
    greedy, greedy_lp = _serve(_port(tm), sampling=[None] * len(PROMPTS))
    v = KW["num_classes"]
    for sp in (SamplingParams(temperature=0.0, seed=123),      # seed inert
               SamplingParams(temperature=1.7, top_k=1, seed=9),
               SamplingParams(temperature=1.5, min_p=1.0, seed=5)):
        got, _ = _serve(_port(tm, decode_ahead=4), sampling=[sp] * len(PROMPTS))
        assert got == greedy, sp
    base, _ = _serve(_port(tm), sampling=[SamplingParams(temperature=0.9, seed=5)] * 5)
    full, _ = _serve(_port(tm), sampling=[
        SamplingParams(temperature=0.9, top_k=v, min_p=0.0, seed=5)] * 5)
    assert base == full
    # the first token's logprob is log_softmax of the raw prefill logits,
    # greedy and sampled alike
    padded = torch.zeros((1, 8), dtype=torch.long)
    padded[0, :3] = torch.tensor(PROMPTS[0])
    _, last = tgen.make_prefill(tm, 48)(padded, torch.tensor([3]))
    ref = torch.log_softmax(last, -1)[0]
    sampled, sampled_lp = _serve(_port(tm), sampling=MIX[:1], prompts=PROMPTS[:1])
    for toks, lps in ((greedy[0], greedy_lp[0]), (sampled[0], sampled_lp[0])):
        assert lps[0] == pytest.approx(float(ref[toks[0]]), abs=1e-6)
        assert all(lp <= 1e-6 for lp in lps)


def test_engine_sampling_defaults_and_stats(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="rng"):
        _port(tm, temperature=0.8)
    with pytest.raises(ValueError, match="temperature > 0"):
        _port(tm, top_p=0.9)
    # engine defaults = a request carrying the same params; an int seed or
    # the (2,) uint32 key data name the same default key
    want, _ = _serve(_port(tm), sampling=[SamplingParams(temperature=0.8, top_k=5, seed=42)] * 5)
    for rng in (42, ts.base_key(42)):
        got, _ = _serve(_port(tm, temperature=0.8, top_k=5, rng=rng), sampling=[None] * 5)
        assert got == want
    eng = _port(tm)
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=5, sampling=s)
            for p, s in zip(PROMPTS[:2], (SamplingParams(temperature=0.6, seed=11), None))]
    eng.run()
    s = eng.stats.summary()
    assert s["n_sampled_requests"] == 1
    assert s["mean_temperature"] == pytest.approx(0.6, abs=1e-4)
    assert s["logprob_tokens"] == sum(len(r.generated) for r in reqs)
    assert s["nll_p50"] is not None and s["nll_p50"] >= 0
    json.dumps(s, allow_nan=False)
    es = ServingStats(slots=1).summary()
    assert es["n_sampled_requests"] == 0
    assert es["mean_temperature"] is None and es["nll_p50"] is None
