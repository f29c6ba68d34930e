"""The port's flash-attention backward (K4, K5, K6a/b, K7) against JAX's.

The JAX side is ``jax.vjp`` of the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, as its own tests run them on the CPU);
the port's side is its plain backward and autograd through its
``flash_attention`` on CPU tensors, which run the plain backward whatever
route the kernels take on the card.  Each case runs at the three backward
routes: the default (fused), and the grouped and split routes forced by
setting the JAX package's routing constants and the port's copies alike,
as ``tests/test_flash_attention.py:93-207`` force them; a spy on the JAX
kernels says which route JAX took, and the port's ``bwd_route`` must name
the same one.  Inputs come from numpy seeds; float32 on both sides, so
atol 2e-5 covers reduction order only.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.ops import flash_attention as jfa
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL = 2e-5  # float32 on both sides: reduction order only

# (S, D, H, H_kv, causal, window); 13 and 37 are unpadded lengths
CASES = {
    "s13-full": (13, 32, 4, 4, False, 0),
    "s37-gqa": (37, 16, 4, 2, True, 0),
    "s37-window5": (37, 16, 4, 4, True, 5),
    "s37-gqa-full": (37, 16, 4, 2, False, 0),
}
# the grouped and split routes, each at three cases
FORCED = ["s37-gqa", "s37-window5", "s37-gqa-full"]
ROUTED = ([(c, "fused") for c in CASES]
          + [(c, r) for r in ("grouped", "split") for c in FORCED])

# each route's settings of the routing constants (JAX's and the port's);
# the grouped budget sizes one 8-row tile per group (5 groups at S=37)
ROUTE_CONSTANTS = {
    "fused": {},
    "grouped": {"_FUSED_DQ_VMEM_BUDGET": 0, "_GROUPED_DQ_VMEM_BUDGET": 8 * 16 * 8},
    "split": {"_FUSED_DQ_VMEM_BUDGET": 0, "_GROUPED_BWD": False},
}
JAX_KERNELS = {"fused": "_fused_bwd_kernel", "grouped": "_grouped_bwd_kernel",
               "split": "_dkv_kernel"}


@contextlib.contextmanager
def _constants(values: dict, mods=(jfa, fa)):
    """Set module attributes (the routing constants of both packages by
    default); restore on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod in mods for name in values]
    try:
        for mod in mods:
            for name, value in values.items():
                setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _inputs(s, d, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, s, h, d)).astype(np.float32),
            rng.normal(size=(2, s, hkv, d)).astype(np.float32),
            rng.normal(size=(2, s, hkv, d)).astype(np.float32),
            rng.normal(size=(2, s, h, d)).astype(np.float32))


@functools.cache
def _jax_grads(case: str, route: str):
    """JAX's (dq, dk, dv) under ``route``'s constants, and the route its
    kernels actually took (spied)."""
    s, d, h, hkv, causal, window = CASES[case]
    q, k, v, g = (jnp.asarray(x) for x in _inputs(s, d, h, hkv))
    ran = []
    spies = {}
    for name, attr in JAX_KERNELS.items():
        orig = getattr(jfa, attr)
        spies[attr] = functools.partial(
            lambda orig, name, *a, **kw: (ran.append(name), orig(*a, **kw))[1], orig, name)
    with _constants(ROUTE_CONSTANTS[route]), _constants(spies, mods=(jfa,)):
        _, vjp = jax.vjp(
            lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, window=window),
            q, k, v)
        grads = vjp(g)
    return tuple(np.asarray(x) for x in grads), sorted(set(ran))


def _port_inputs(case, dtype=torch.float32):
    s, d, h, hkv, _, _ = CASES[case]
    return tuple(torch.from_numpy(x).to(dtype) for x in _inputs(s, d, h, hkv))


@pytest.mark.parametrize("case, route", ROUTED, ids=[f"{c}-{r}" for c, r in ROUTED])
def test_route_names_the_route_jax_takes(case, route):
    s, d, *_ = CASES[case]
    _, ran = _jax_grads(case, route)
    with _constants(ROUTE_CONSTANTS[route]):
        got = fa.bwd_route(s, d, torch.float32)
    assert ran == [route] and got.name == route
    if route == "grouped":
        assert 2 <= got.groups <= fa._GROUPED_MAX_GROUPS
        assert got.groups * got.group_rows >= s


@pytest.mark.parametrize("case, route", ROUTED, ids=[f"{c}-{r}" for c, r in ROUTED])
def test_plain_backward_matches_jax(case, route):
    """flash_attention_bwd (the CPU path: the plain backward) and the plain
    backward itself, from the plain forward's lse and delta."""
    _, _, _, _, causal, window = CASES[case]
    q, k, v, g = _port_inputs(case)
    out, lse = fa.flash_attention_plain(q, k, v, causal, window)
    delta = (g * out).sum(-1)
    want, _ = _jax_grads(case, route)
    with _constants(ROUTE_CONSTANTS[route]):
        got = fa.flash_attention_bwd(q, k, v, g, lse, delta, causal, window)
    plain = fa.flash_attention_bwd_plain(q, k, v, g, lse, delta, causal, window)
    for name, a, p, w in zip("qkv", got, plain, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=f"d{name}")
        np.testing.assert_allclose(p.numpy(), w, atol=ATOL, err_msg=f"plain d{name}")


@pytest.mark.parametrize("case, route", ROUTED, ids=[f"{c}-{r}" for c, r in ROUTED])
def test_autograd_through_flash_attention_matches_jax(case, route):
    _, _, _, _, causal, window = CASES[case]
    q, k, v, g = _port_inputs(case)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    want, _ = _jax_grads(case, route)
    before = dict(vars(fa.flash_attention_bwd))
    with _constants(ROUTE_CONSTANTS[route]):
        out = fa.flash_attention(q, k, v, causal, window)
        got = torch.autograd.grad(out, (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=f"d{name}")
    assert dict(vars(fa.flash_attention_bwd)) == before  # no kernel on the CPU


def test_grouped_partials_sum_to_the_whole():
    """One K5 group's partials are the plain backward over its q rows, and
    the groups' partials sum to the one-walk backward."""
    q, k, v, g = _port_inputs("s37-gqa")
    out, lse = fa.flash_attention_plain(q, k, v, True)
    delta = (g * out).sum(-1)
    whole = fa.flash_attention_bwd_plain(q, k, v, g, lse, delta, True)
    parts = [fa.flash_attention_bwd_plain(q, k, v, g, lse, delta, True, q_rows=(lo, lo + 8))
             for lo in range(0, 40, 8)]
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(sum(p[i] for p in parts).numpy(), whole[i].numpy(),
                                   atol=1e-5, err_msg=f"d{name}")
    dq_rows = parts[1][0]
    assert not dq_rows[:, :8].any() and not dq_rows[:, 16:].any()


def test_bf16_backward_tracks_jax():
    """bf16 through the wrapper's CPU path (float32 math, outputs rounded to
    bf16) against JAX's bf16 kernels (bf16 products of P and dS, f32 sums,
    the GQA sum in bf16): within 3e-2 + 2% of gradients of order 1, a few
    bf16 ulps, from rounding at different places on the two sides."""
    case = "s37-gqa"
    s, d, h, hkv, causal, window = CASES[case]
    qn, kn, vn, gn = _inputs(s, d, h, hkv)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn, gn))
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal), jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jg)]
    q, k, v, g = _port_inputs(case, torch.bfloat16)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention(q, k, v, causal), (q, k, v), g)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, atol=3e-2, rtol=2e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_block_bwd_matches_jax_under_given_statistics(causal):
    """K7: the per-block backward under given (global) lse and delta, which
    are not this block's own: JAX's ``flash_block_bwd`` and the port's."""
    q, k, v, g = _inputs(13, 32, 4, 2, seed=5)
    rng = np.random.default_rng(6)
    lse = (rng.normal(size=(2, 13, 4)) + 3.0).astype(np.float32)
    delta = rng.normal(size=(2, 13, 4)).astype(np.float32)
    want = jfa.flash_block_bwd(*(jnp.asarray(x) for x in (q, k, v, g, lse, delta)),
                               causal=causal)
    got = fa.flash_block_bwd(*(torch.from_numpy(x) for x in (q, k, v, g, lse, delta)),
                             causal=causal)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, err_msg=f"d{name}")


def test_flash_block_fwd_is_the_forward_without_a_gradient():
    q, k, v, _ = _port_inputs("s13-full")
    out, lse = fa.flash_block_fwd(q, k, v, causal=True)
    want_out, want_lse = jfa.flash_block_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                             causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)
    with pytest.raises(RuntimeError, match="without a gradient"):
        fa.flash_block_fwd(q.requires_grad_(), k, v, causal=True)


@pytest.mark.parametrize("s, d, dtype, route", [
    (8192, 64, torch.bfloat16, "fused"),     # the repo's long-context LM
    (8192, 128, torch.bfloat16, "grouped"),  # its head_dim-128 sibling
    (16384, 64, torch.bfloat16, "grouped"),
    (1000, 128, torch.float32, "fused"),
    (13 * 512, 128, torch.float32, "split"),  # a prime tile count: no grouping
], ids=["lm8k", "lm8k-d128", "s16k", "s1000", "prime-tiles"])
def test_route_follows_the_jax_rule_at_real_shapes(s, d, dtype, route):
    """The shapes the JAX package routes at its own defaults: its own rule,
    evaluated without a kernel, against the port's."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    sp = s + (-s) % 8
    row = d * (4 + jnp.dtype(jdtype).itemsize)
    n_q = sp // jfa._pick_block(sp, jfa._BLOCK_Q)
    got = fa.bwd_route(s, d, dtype)
    assert got.name == route
    assert (sp * row <= jfa._FUSED_DQ_VMEM_BUDGET) == (route == "fused")
    if route == "grouped":
        assert got.groups * got.group_rows == sp and n_q % got.groups == 0
    if (s, d) == (8192, 128):
        assert (got.groups, got.group_rows) == (4, 2048)


@pytest.mark.parametrize("bad", ["g-shape", "g-dtype", "lse-shape", "delta-dtype"])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 8, 4, 16)
    g = {"g-shape": torch.zeros(1, 8, 4, 8),
         "g-dtype": torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)}.get(bad, q)
    lse = torch.zeros(1, 8, 5) if bad == "lse-shape" else torch.zeros(1, 8, 4)
    delta = torch.zeros(1, 8, 4, dtype=torch.float64 if bad == "delta-dtype" else torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, g, lse, delta, True)
