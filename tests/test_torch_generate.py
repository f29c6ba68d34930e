"""The port's core/generate.py against the JAX package's, on converted weights.

* ``make_prefill`` on a right-padded ragged batch: every block's K/V, the
  cursors and the last-position logits (atol 1e-5);
* eight ragged ``make_decode_step`` steps from that cache (logits atol
  1e-4), and ``init_cache``'s layout;
* greedy ``make_generator`` tokens identical, ragged and uniform, with and
  without ``eos_id``.

Both sides run float32 on the CPU (JAX's flash kernel in interpret mode).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as tgen

# the JAX core package exports a `generate` function under the module's name
jgen = importlib.import_module("distributed_tensorflow_ibm_mnist_tpu.core.generate")

torch.set_num_threads(1)

KW = dict(num_classes=40, dim=64, depth=2, heads=4, attn="flash")
MAX_LEN = 48


def _pair(extra=None, seed=0):
    extra = extra or {}
    jm = jax_get_model("causal_lm", **KW, **extra, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        **extra, dtype=torch.float32)
    return jm, params, tm


def _ragged_batch(seed=3):
    rng = np.random.default_rng(seed)
    lens = np.array([12, 5, 9], np.int32)
    prompt = rng.integers(1, KW["num_classes"], (3, 12)).astype(np.int32)
    for b, n in enumerate(lens):
        prompt[b, n:] = 0  # right padding
    return prompt, lens


@pytest.mark.parametrize("variant", ["mha", "gqa-window"])
def test_prefill_then_ragged_decode_match_jax(variant):
    extra = {} if variant == "mha" else {"heads_kv": 2, "window": 6}
    jm, params, tm = _pair(extra)
    prompt, lens = _ragged_batch()
    jcache, jlast = jgen.make_prefill(jm, MAX_LEN)(
        params, jnp.asarray(prompt), jnp.asarray(lens))
    tcache, tlast = tgen.make_prefill(tm, MAX_LEN)(
        torch.from_numpy(prompt), torch.from_numpy(lens))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-5)
    assert set(tcache) == set(jcache)
    for name in jcache:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tcache[name][leaf].numpy(),
                                       np.asarray(jcache[name][leaf]), atol=1e-5,
                                       err_msg=f"{name}/{leaf}")
        np.testing.assert_array_equal(tcache[name]["index"].numpy(), lens)

    jstep = jgen.make_decode_step(jm, MAX_LEN, ragged=True)
    tstep = tgen.make_decode_step(tm, MAX_LEN, ragged=True)
    rng = np.random.default_rng(4)
    for i in range(8):
        tok = rng.integers(1, KW["num_classes"], (3,)).astype(np.int32)
        jcache, jlog = jstep(params, jcache, jnp.asarray(tok))
        tcache, tlog = tstep(tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(tcache["block_0"]["index"].numpy(), lens + 8)


def test_init_cache_matches_the_jax_layout():
    jm, params, tm = _pair({"heads_kv": 2})
    jc = jgen.init_cache(jm, params, 3, MAX_LEN)
    tc = tgen.init_cache(tm, 3, MAX_LEN)
    assert set(tc) == set(jc)
    for name in jc:
        assert set(tc[name]) == set(jc[name])
        for leaf in jc[name]:
            assert tuple(tc[name][leaf].shape) == jc[name][leaf].shape
            assert not tc[name][leaf].any()
    assert tc["block_0"]["index"].dtype == torch.int32


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
@pytest.mark.parametrize("eos", [None, "seen"], ids=["no-eos", "eos"])
def test_greedy_generator_tokens_identical(ragged, eos):
    jm, params, tm = _pair()
    prompt, lens = _ragged_batch()
    kw_j, kw_t = {}, {}
    if ragged:
        kw_j["prompt_lens"], kw_t["prompt_lens"] = jnp.asarray(lens), torch.from_numpy(lens)
    eos_id = None
    if eos:
        # a token the model really emits: row 0's third greedy token
        free = tgen.make_generator(tm, MAX_LEN, 10)(torch.from_numpy(prompt), **kw_t)
        eos_id = int(free[0, int(lens[0]) + 2] if ragged else free[0, 14])
    want = np.asarray(jgen.make_generator(jm, MAX_LEN, 10, eos_id=eos_id)(
        params, jnp.asarray(prompt), **kw_j))
    got = tgen.make_generator(tm, MAX_LEN, 10, eos_id=eos_id)(
        torch.from_numpy(prompt), **kw_t)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos:
        assert (want == eos_id).any()


def test_generator_lengths_and_refusals():
    _, _, tm = _pair()
    prompt, lens = _ragged_batch()
    out, flen = tgen.make_generator(tm, MAX_LEN, 6, with_lengths=True)(
        torch.from_numpy(prompt), torch.from_numpy(lens))
    assert out.shape == (3, 18) and flen.tolist() == [6, 6, 6]
    with pytest.raises(NotImplementedError, match="sampl"):
        tgen.make_generator(tm, MAX_LEN, 6, temperature=0.7)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgen.make_generator(tm, 14, 6)(torch.from_numpy(prompt))
