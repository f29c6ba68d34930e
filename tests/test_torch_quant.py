"""The port's int8 weights and int8 KV cache, held against the JAX package.

* QUANTIZATION — ``quantize_state_dict_int8`` over the converted weights
  is BIT-equal to the converted ``quantize_params_int8`` tree (int8
  values, scales, which layers: MHA, GQA, tied head); the kernel
  quantizer on random (and all-zero) columns, float32 and bf16; idempotence,
  ``is_quantized``, a seeded quant model equal to its twin quantized, and
  the converter loading either tree.
* NUMERICS — ``Int8Linear`` against ``Int8Dense`` (float32 1e-6; bf16 to
  one output ulp, both round a float32 result once); the int8 model's
  logits against JAX's (1e-4); teacher-forced decode on the int8 KV cache,
  dense and paged, against JAX's: the caches' int8 values within one step
  (a float32 K/V on a rounding boundary flips; under 1% do), their scales
  at 1e-5, the logits at 5e-3 (one step's effect); a bf16 model's int8-KV
  drift from its native cache under JAX's 0.05; and at chip_smoke.py's
  width, that drift equal to the reference's within 0.02 (both sit about
  0.05 there).
* ENGINE — greedy streams token-identical to the JAX engine under
  ``quant="int8"``, dense and paged, and with the int8 KV cache; dense ==
  paged == decode_ahead 8 == speculative under int8, and prefix-cache hits
  replay int8 rows with their scales (counted in its bytes); the weight bytes
  equal JAX's and the f32 / int8 ratio in JAX's band; ``swap_params``
  re-quantizes a full-precision tree and clears the trie.

Both sides run float32 on the CPU unless a case says bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.models import quant as jquant
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    load_causal_lm,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import init_cache
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    Int8Linear,
    is_quantized,
    quantize_kernel_int8,
    quantize_state_dict_int8,
    weight_stream_bytes,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import kv_pool

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=64, depth=2, heads=4)
MAX_LEN = 32
# repetitive suffixes so the speculative case's drafter gets hits
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5, 4, 5], [6, 7, 8, 9],
           [2, 4, 2, 4, 2, 4]]


def _jax_pair(seed=0, **over):
    jm = jax_get_model("causal_lm", **KW, **over, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jm, params = _jax_pair()
    return jm, params, load_causal_lm(_np(params), device="cpu", **KW,
                                      dtype=torch.float32)


# ----------------------------------------------------------------------
# quantization: bit-equal to JAX's


@pytest.mark.parametrize("over", [{}, {"heads_kv": 2}, {"tie_embeddings": True}],
                         ids=["mha", "gqa", "tied"])
def test_quantized_state_dict_bit_equal_to_jax(over):
    _, params = _jax_pair(seed=1, **over)
    cfg = {**KW, **over}
    ours = quantize_state_dict_int8(causal_lm_state_dict(_np(params), cfg))
    theirs = causal_lm_state_dict(_np(jquant.quantize_params_int8(params)), cfg)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype, key
        assert torch.equal(ours[key], theirs[key]), key
    scaled = sorted(k[: -len(".scale")] for k in ours if k.endswith(".scale"))
    want = sorted(f"blocks.{i}.{n}" for i in range(KW["depth"]) for n in (
        ("q_proj", "kv_proj") if over.get("heads_kv") else ("qkv",))
        + ("proj", "dense_0", "dense_1"))
    assert scaled == want + ([] if over.get("tie_embeddings") else ["logits"])
    assert ours["embed.weight"].dtype == torch.float32
    assert is_quantized(ours) and not is_quantized(causal_lm_state_dict(_np(params), cfg))
    again = quantize_state_dict_int8(ours)  # idempotent
    assert all(torch.equal(again[k], ours[k]) for k in ours) and again.keys() == ours.keys()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kernel_bit_equal_to_jax(dtype):
    w = np.random.default_rng(3).standard_normal((64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero column quantizes to zeros, not NaN
    jw = jnp.asarray(w, getattr(jnp, dtype))
    q, s = jquant.quantize_kernel_int8(jw)
    tq, ts = quantize_kernel_int8(torch.from_numpy(np.array(jw.astype(jnp.float32))
                                                   ).to(getattr(torch, dtype)).T)
    assert torch.equal(tq.T, torch.from_numpy(np.array(q)))
    assert torch.equal(ts, torch.from_numpy(np.array(s)))
    assert int(tq[5].abs().max()) == 0 and int(tq.abs().max()) == 127


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-6), ("bfloat16", 2.0 ** -8)])
def test_int8_linear_matches_int8_dense(dtype, tol):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    q, s = jquant.quantize_kernel_int8(jnp.asarray(w))
    jd = getattr(jnp, dtype)
    want = jquant.Int8Dense(16, dtype=jd).apply(
        {"params": {"kernel": q, "scale": s, "bias": jnp.asarray(b)}}, jnp.asarray(x, jd))
    layer = Int8Linear(64, 16, dtype=getattr(torch, dtype), device="cpu")
    layer.load_state_dict({"weight": torch.from_numpy(np.array(q)).T.contiguous(),
                           "scale": torch.from_numpy(np.array(s)),
                           "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-6)


def test_seeded_quant_model_is_its_twin_quantized_and_clone():
    full = get_model("causal_lm", **KW, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    q = get_model("causal_lm", **KW, quant="int8", device="cpu",
                  generator=torch.Generator().manual_seed(5))
    want = quantize_state_dict_int8(full.state_dict())
    assert q.state_dict().keys() == want.keys()
    assert all(torch.equal(q.state_dict()[k], want[k].to(q.state_dict()[k].dtype))
               for k in want)
    clone = full.clone(quant="int8")
    tokens = torch.tensor([[1, 2, 3, 4]])
    with torch.no_grad():
        assert torch.equal(clone(tokens), q(tokens))
    assert isinstance(clone.blocks[0].qkv, Int8Linear) and clone.logits.weight.dtype == torch.int8


# ----------------------------------------------------------------------
# numerics against JAX


def test_quant_forward_matches_jax(pair):
    jm, params, _ = pair
    qparams = jquant.quantize_params_int8(params)
    tokens = np.random.default_rng(7).integers(0, 16, size=(2, 16))
    want = np.asarray(jm.clone(quant="int8").apply({"params": qparams}, jnp.asarray(tokens)))
    from_q = load_causal_lm(_np(qparams), device="cpu", **KW, quant="int8",
                            dtype=torch.float32)
    from_full = load_causal_lm(_np(params), device="cpu", **KW, quant="int8",
                               dtype=torch.float32)
    with torch.no_grad():
        got = from_q(torch.from_numpy(tokens))
        assert torch.equal(from_full(torch.from_numpy(tokens)), got)  # either tree loads
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _teacher_forced(step_fn, tokens):
    out = [step_fn(tokens[:, :8])]
    out += [step_fn(tokens[:, t:t + 1]) for t in range(8, 16)]
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("over", [{}, {"heads_kv": 2}], ids=["mha", "gqa"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_kv_teacher_forced_decode_matches_jax(over, paged):
    jm, params = _jax_pair(seed=2, **over)
    jm = jm.clone(kv_cache_dtype="int8")
    tm = load_causal_lm(_np(params), device="cpu", **KW, **over, kv_cache_dtype="int8",
                        dtype=torch.float32)
    tokens = np.random.default_rng(5).integers(0, 16, size=(2, 16))
    state = {}

    def jax_step(x):
        variables = {"params": params, **({"cache": state["c"]} if "c" in state else {})}
        logits, v = jm.apply(variables, jnp.asarray(x), decode=True, max_len=16,
                             mutable=["cache"])
        state["c"] = v["cache"]
        return np.asarray(logits)

    if paged:  # each row's 16 positions on its own pages, in reverse order
        cache = kv_pool.init_paged_cache(tm, 2, 16, 4, 9)
        for entry in cache.values():
            entry["block_table"].copy_(torch.tensor([[8, 7, 6, 5], [4, 3, 2, 1]]))
    else:
        cache = init_cache(tm, 2, 16)

    def port_step(x):
        with torch.no_grad():
            return tm(torch.from_numpy(x), cache=cache, max_len=16,
                      ragged=paged).numpy()

    want = _teacher_forced(jax_step, tokens)
    got = _teacher_forced(port_step, tokens)
    # the two sides' float32 K/V differ by reduction order, so an element
    # sitting on a rounding boundary may land one int8 step apart (about
    # amax/127 of its row, ~1e-3 in a logit); everything else is equal
    np.testing.assert_allclose(got, want, atol=5e-3)
    for name, entry in cache.items():
        j = state["c"][name]
        if paged:  # the rows' virtual spans, gathered back
            rows = entry["block_table"].long()
            entry = {leaf: entry[f"pages_{leaf}"][rows].flatten(1, 2)
                     for leaf in ("k", "v", "k_scale", "v_scale")}
        for leaf in ("k", "v"):
            assert entry[leaf].dtype == torch.int8
            diff = np.abs(entry[leaf].numpy().astype(int) - np.asarray(j[leaf]).astype(int))
            assert diff.max() <= 1 and diff.mean() < 1e-2, (name, leaf)
        for leaf in ("k_scale", "v_scale"):
            np.testing.assert_allclose(entry[leaf].numpy(), np.asarray(j[leaf]), rtol=1e-5)


def test_int8_kv_bf16_drift_bounded():
    """A bf16 model decoding teacher-forced on the int8 cache stays within
    JAX's bound (0.05) of the same model on its native cache: the
    probabilities stay float32 into the PV product."""
    _, params = _jax_pair(seed=14)
    tokens = np.random.default_rng(5).integers(0, 16, size=(2, 16))

    def run(kv):
        tm = load_causal_lm(_np(params), device="cpu", **KW, kv_cache_dtype=kv,
                            dtype=torch.bfloat16)
        cache = init_cache(tm, 2, 16)
        with torch.no_grad():
            return _teacher_forced(
                lambda x: tm(torch.from_numpy(x), cache=cache, max_len=16).numpy(), tokens)

    drift = float(np.abs(run("native") - run("int8")).max())
    assert drift < 0.05, drift


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_kv_drift_at_chip_width_matches_jax(seed):
    """At chip_smoke.py's width (vocab 256, dim 512, depth 4, 8 heads,
    bf16) on JAX's own drift protocol (2 x 16 tokens, 8 prefilled in decode
    mode), the port's int8-KV drift is the reference's on the same weights,
    to within a bf16 ulp of a logit near 2-4: the reference itself sits
    about JAX's toy bound of 0.05 there (``-s`` prints both)."""
    kw = dict(num_classes=256, dim=512, depth=4, heads=8)
    jm = jax_get_model("causal_lm", **kw, dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tokens = np.random.default_rng(5 + seed).integers(0, 256, size=(2, 16))

    def jax_run(kv):
        m, state = jm.clone(kv_cache_dtype=kv), {}

        def step(x):
            variables = {"params": params, **({"cache": state["c"]} if state else {})}
            logits, v = m.apply(variables, jnp.asarray(x), decode=True, max_len=16,
                                mutable=["cache"])
            state["c"] = v["cache"]
            return np.asarray(logits.astype(jnp.float32))
        return _teacher_forced(step, tokens)

    def port_run(kv):
        tm = load_causal_lm(_np(params), device="cpu", **kw, kv_cache_dtype=kv,
                            dtype=torch.bfloat16)
        cache = init_cache(tm, 2, 16)
        with torch.no_grad():
            return _teacher_forced(
                lambda x: tm(torch.from_numpy(x), cache=cache, max_len=16).numpy(), tokens)

    jd = float(np.abs(jax_run("native") - jax_run("int8")).max())
    pd = float(np.abs(port_run("native") - port_run("int8")).max())
    print(f"int8-KV drift at width, seed {seed}: JAX {jd}, port {pd}")
    assert abs(pd - jd) <= 0.02, (pd, jd)


# ----------------------------------------------------------------------
# the engine


def _serve(eng, prompts=PROMPTS, max_new=6):
    reqs = [eng.submit(np.asarray(p, np.int32), max_new=max_new) for p in prompts]
    eng.run()
    return [tuple(r.generated) for r in reqs]


def _engines(jm, params, tm, **kw):
    kw = dict(slots=2, max_len=MAX_LEN, buckets=(16,), **kw)
    return JaxEngine(jm, params, **kw), InferenceEngine(tm, device="cpu", **kw)


@pytest.mark.parametrize("kv, paged", [("native", False), ("native", True), ("int8", True)],
                         ids=["w8-dense", "w8-paged", "w8-kv8-paged"])
def test_engine_greedy_matches_jax_under_int8(pair, kv, paged):
    jm, params, tm = pair
    if kv == "int8":
        jm = jm.clone(kv_cache_dtype="int8")
        tm = tm.clone(kv_cache_dtype="int8")
    je, te = _engines(jm, params, tm, quant="int8",
                      **({"kv_page_size": 8} if paged else {}))
    assert _serve(te) == _serve(je)
    s = te.stats.summary()
    assert s["quant"] == "int8" and s["tokens_generated"] == 6 * len(PROMPTS)
    assert tm.quant == "none" and te.model.quant == "int8"  # served from a copy
    je.close()
    te.close()


def test_quant_layout_invariance(pair):
    """dense == paged == decode_ahead 8 == speculative, all under int8."""
    _, _, tm = pair
    serve = lambda **kw: _serve(InferenceEngine(  # noqa: E731
        tm, slots=2, max_len=MAX_LEN, buckets=(16,), device="cpu", quant="int8", **kw))
    base = serve()
    assert serve(kv_page_size=8) == base
    assert serve(decode_ahead=8) == base
    assert serve(speculative="ngram", draft_len=3) == base
    kv8 = tm.clone(kv_cache_dtype="int8")
    kv_base = _serve(InferenceEngine(kv8, slots=2, max_len=MAX_LEN, buckets=(16,),
                                     device="cpu", quant="int8"))
    assert _serve(InferenceEngine(kv8, slots=2, max_len=MAX_LEN, buckets=(16,),
                                  device="cpu", quant="int8", kv_page_size=8,
                                  speculative="ngram")) == kv_base
    # the prefix cache stores int8 rows with their scales: hits replay them
    eng = InferenceEngine(kv8, slots=2, max_len=MAX_LEN, buckets=(16,), device="cpu",
                          quant="int8", prefix_cache_bytes=1 << 20)
    assert _serve(eng, PROMPTS + PROMPTS) == kv_base + kv_base
    rows = [entry[0] for entry in eng._prefix._entries.values()]
    assert eng._prefix.hits == len(PROMPTS) and "k_scale" in rows[0]["block_0"]
    assert eng._prefix.bytes == sum(
        t.nbytes for row, logits, _ in eng._prefix._entries.values()
        for t in [logits, *(x for e in row.values() for x in e.values())])


def test_weight_and_kv_bytes(pair):
    _, params, tm = pair
    qparams = jquant.quantize_params_int8(params)
    # the port's state_dicts hold JAX's leaves byte for byte
    assert weight_stream_bytes(causal_lm_state_dict(_np(params), KW)) == \
        jquant.weight_stream_bytes(params)
    assert weight_stream_bytes(causal_lm_state_dict(_np(qparams), KW)) == \
        jquant.weight_stream_bytes(qparams)
    full = InferenceEngine(tm, slots=2, max_len=MAX_LEN, device="cpu")
    q = InferenceEngine(tm, slots=2, max_len=MAX_LEN, device="cpu", quant="int8")
    ratio = full.weight_bytes_per_chip() / q.weight_bytes_per_chip()
    assert 3.2 <= ratio <= 4.0, ratio  # JAX's band (tests/test_quant.py)
    assert q.weight_bytes_per_chip() == jquant.weight_stream_bytes(qparams)
    kv8 = InferenceEngine(tm.clone(kv_cache_dtype="int8"), slots=2, max_len=MAX_LEN,
                          device="cpu")
    # int8 payload + one float32 scale per 16-wide head row: 1/4 + 1/16
    kv_ratio = kv8.kv_bytes_per_chip() / full.kv_bytes_per_chip()
    assert 0.3 < kv_ratio < 0.33, kv_ratio
    for eng, quant in ((full, "none"), (q, "int8")):
        s = eng.stats.summary()
        assert s["quant"] == quant and s["weight_bytes_per_chip"] == eng.weight_bytes_per_chip()


def test_swap_params_requantizes(pair):
    jm, params, tm = pair
    _, params2 = _jax_pair(seed=3)
    state2 = causal_lm_state_dict(_np(params2), KW)
    want = _serve(JaxEngine(jm, params2, slots=2, max_len=MAX_LEN, buckets=(16,),
                            quant="int8"))
    eng = InferenceEngine(tm, slots=2, max_len=MAX_LEN, buckets=(16,), device="cpu",
                          quant="int8", kv_page_size=8)
    _serve(eng)
    assert eng._radix.n_blocks > 0
    eng.submit([1, 2], 2)
    with pytest.raises(RuntimeError, match="busy"):
        eng.swap_params(state2)
    eng.run()
    eng.swap_params(state2)  # full precision in: quantized at the seam
    assert eng.model.blocks[0].qkv.weight.dtype == torch.int8
    assert eng._radix.n_blocks == 0 and eng._pool.allocated == 0
    assert _serve(eng) == want
    eng.swap_params(quantize_state_dict_int8(state2))  # an int8 tree passes as it is
    assert _serve(eng) == want
