"""The port's CausalLM against the JAX CausalLM on converted weights.

Full-forward logits for {MHA, GQA} x {vanilla, flash} plus windowed,
tied-head and position-free models.  Both sides run float32 (JAX's flash
kernel in Pallas interpret mode, the port's through its plain version on
the CPU); atol 1e-4 covers reduction order through two blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

torch.set_num_threads(1)

KW = dict(num_classes=48, dim=64, depth=2, heads=4)
VARIANTS = {
    "mha-vanilla": {},
    "mha-flash": {"attn": "flash"},
    "gqa-vanilla": {"heads_kv": 2},
    "gqa-flash": {"heads_kv": 2, "attn": "flash"},
    "window-flash": {"window": 4, "attn": "flash"},
    "tied-nopos": {"tie_embeddings": True, "pos": "none"},
}


def _pair(extra, seed=0):
    jm = jax_get_model("causal_lm", **KW, **extra, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        **extra, dtype=torch.float32)
    return jm, params, tm


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    jm, params, tm = _pair(VARIANTS[variant])
    tokens = np.random.default_rng(1).integers(0, KW["num_classes"], (2, 19))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_sown_kv_are_the_rotated_keys():
    """``sow_kv`` hands back each block's post-RoPE K/V: the K/V the JAX
    model sows into its intermediates on the same forward."""
    jm, params, tm = _pair({"heads_kv": 2})
    tokens = np.random.default_rng(2).integers(0, KW["num_classes"], (1, 11))
    _, state = jm.clone(sow_kv=True).apply(
        {"params": params}, jnp.asarray(tokens), mutable=["intermediates"])
    with torch.no_grad():
        _, kvs = tm(torch.from_numpy(tokens), sow_kv=True)
    for i in range(KW["depth"]):
        jk, jv = state["intermediates"][f"block_{i}"]["kv_cache"][0]
        np.testing.assert_allclose(kvs[f"block_{i}"][0].numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(kvs[f"block_{i}"][1].numpy(), np.asarray(jv), atol=1e-5)


def test_weights_come_from_the_generator_not_global_state():
    """Two models from equal seeds are equal, and building one leaves the
    global random state untouched."""
    before = torch.random.get_rng_state()
    a = get_model("causal_lm", **KW, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    b = get_model("causal_lm", **KW, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), before)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name


def test_a_user_moe_fn_runs_every_moe_block():
    """``moe_fn`` (an expert-parallel island, JAX's ``ep_fn`` contract:
    ``fn(params, tokens) -> (out, aux, stats)``) replaces each MoE block's
    local experts; here the local FFN itself, counted."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.expert_parallel import (
        expert_capacity,
        moe_ffn_local,
    )

    calls = []

    def island(params, tokens):
        calls.append(tuple(tokens.shape))
        cap = expert_capacity(tokens.shape[0], 4, 2.0)
        return moe_ffn_local(params, tokens, 4, cap)

    kw = dict(KW, moe_every=2, n_experts=4, dtype=torch.float32, device="cpu")
    a = get_model("causal_lm", **kw, generator=torch.Generator().manual_seed(1))
    b = get_model("causal_lm", **kw, moe_fn=island, generator=torch.Generator().manual_seed(1))
    tokens = torch.randint(0, KW["num_classes"], (2, 6), generator=torch.Generator())
    torch.testing.assert_close(b(tokens), a(tokens), rtol=0, atol=0)
    assert calls == [(12, KW["dim"])] * (KW["depth"] // 2)


@pytest.mark.parametrize("kw, error, slice_", [
    # int8 weights and the int8 cache are ported: bad values refused as in JAX
    ({"quant": "int4"}, ValueError, "quant must be 'none' or 'int8'"),
    ({"kv_cache_dtype": "fp8"}, ValueError, "kv_cache_dtype must be"),
    # the paged cache is ported; what JAX refuses with it, the port refuses
    ({"page_size": 8, "window": 4}, ValueError, "paged cache does not compose"),
    # learned positions are ported; the table is sized at construction
    # (their decode refusal: tests/test_torch_lm_follow_ups.py)
    ({"pos": "learned"}, ValueError, "pos='learned' needs seq_len"),
], ids=["quant", "kv-int8", "paged", "learned-pos"])
def test_later_slices_refuse_by_name(kw, error, slice_):
    with pytest.raises(error, match=slice_):
        get_model("causal_lm", **KW, **kw, device="cpu")
