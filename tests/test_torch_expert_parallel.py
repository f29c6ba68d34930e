"""The port's mixture-of-experts FFN against the JAX package, on the CPU.

``parallel/expert_parallel.py`` of both packages on the same seeded numpy
inputs, float32:

* ``_route`` at top-1 and top-2, under ample capacity and under pressure
  (capacity 1 and a middling one): the port's per-assignment ``(expert,
  slot, keep, gate)`` laid out as JAX's one-hot ``(T, E, C)`` dispatch and
  combine tensors equals them (dispatch exactly, gates at 1e-6), and the
  aux fractions, ``dropped`` and ``z`` agree;
* ``moe_ffn_local``: outputs, the aux loss, the stats and every float32
  gradient (x, router, w1, b1, w2, b2) of a loss through all three at
  1e-5;
* JAX's own MoE tests, ported: capacity drops, the top-2 routing
  properties, choice-priority filling, the pre-weighted z-loss, capacity
  sizing and a block that trains;
* the ``MoEBlock`` module on converted weights against flax's, its flax
  initialisation scales, and that no ``(T, E, C)`` tensor is ever built;
* expert parallelism is refused by its ROADMAP item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_tensorflow_ibm_mnist_tpu.parallel import expert_parallel as jep
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import TransformerBlock
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import expert_parallel as ep

torch.set_num_threads(1)

D, H, E, T = 16, 32, 8, 64


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.3, size=s).astype(np.float32) for k, s in (
        ("router", (D, E)), ("w1", (E, D, H)), ("b1", (E, H)), ("w2", (E, H, D)),
        ("b2", (E, D)))}


def _tokens(seed=1, t=T, d=D):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _torch(tree, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _dense_layout(r: ep.Routing, n_experts: int, capacity: int):
    """The port's routing as JAX's one-hot (T, E, C) dispatch and combine."""
    t, k = r.expert.shape
    dispatch = np.zeros((t, n_experts, capacity), np.float32)
    combine = np.zeros_like(dispatch)
    for i in range(t):
        for c in range(k):
            if r.keep[i, c]:
                e, s = int(r.expert[i, c]), int(r.slot[i, c])
                dispatch[i, e, s] += 1.0
                combine[i, e, s] += float(r.gates[i, c])
    return dispatch, combine


ROUTE_CASES = [(1, T), (2, T), (1, 1), (2, 1), (1, 6), (2, 12)]


@pytest.mark.parametrize("top_k, capacity", ROUTE_CASES,
                         ids=[f"top{k}-cap{c}" for k, c in ROUTE_CASES])
def test_route_matches_jax(top_k, capacity):
    p, x = _params(), _tokens()
    jd, jc, (jft, jfp), jst = jep._route(jnp.asarray(x), jnp.asarray(p["router"]), E,
                                         capacity, top_k)
    r, (ft, fp), st = ep._route(torch.from_numpy(x), torch.from_numpy(p["router"]), E,
                                capacity, top_k)
    dispatch, combine = _dense_layout(r, E, capacity)
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    np.testing.assert_allclose(combine, np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jft), atol=1e-7)
    np.testing.assert_allclose(fp.numpy(), np.asarray(jfp), atol=1e-6)
    assert float(st["dropped"]) == pytest.approx(float(jst["dropped"]), abs=1e-7)
    np.testing.assert_allclose(float(st["z"]), float(jst["z"]), rtol=1e-5)
    if capacity < T:  # the cases under pressure do drop
        assert float(st["dropped"]) > 0.0


FFN_CASES = [(1, T), (2, T), (1, 4), (2, 6)]


@pytest.mark.parametrize("top_k, capacity", FFN_CASES,
                         ids=[f"top{k}-cap{c}" for k, c in FFN_CASES])
def test_moe_ffn_local_and_gradients_match_jax(top_k, capacity):
    """Forward and float32 gradients of ``sum(out * g) + 0.01 aux + 0.1 z``
    with respect to x and every parameter, at 1e-5."""
    p, x = _params(2), _tokens(3)
    g = np.random.default_rng(4).normal(size=(T, D)).astype(np.float32)

    def jloss(params, xx):
        out, aux, st = jep.moe_ffn_local(params, xx, E, capacity, top_k)
        return jnp.sum(out * g) + 0.01 * aux + 0.1 * st["z"], (out, aux, st)

    (jl, (jout, jaux, jst)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp, tx = _torch(p, grad=True), torch.tensor(x, requires_grad=True)
    out, aux, st = ep.moe_ffn_local(tp, tx, E, capacity, top_k)
    loss = (out * torch.from_numpy(g)).sum() + 0.01 * aux + 0.1 * st["z"]
    grads = torch.autograd.grad(loss, [tp[k] for k in p] + [tx])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert float(st["dropped"]) == pytest.approx(float(jst["dropped"]), abs=1e-7)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, got in zip(list(p) + ["x"], grads):
        want = np.asarray(jgrads[0][name] if name != "x" else jgrads[1])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, err_msg=name)


def test_bf16_tokens_route_in_float32_and_return_bf16():
    """A bf16 x meets float32 routers and experts (JAX promotes the
    product), and the output comes back in x's dtype."""
    p, x = _params(5), _tokens(6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, _, _ = ep.moe_ffn_local(_torch(p), xb, E, T, 2)
    want, _, _ = jep.moe_ffn_local(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x).astype(jnp.bfloat16), E, T, 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)


# ---------------------------------------------------- JAX's tests, ported


def test_capacity_drops_tokens():
    """With capacity 1, an expert keeps only its first-arriving token."""
    p, x = _torch(_params(4)), torch.from_numpy(_tokens(5))
    out_full, _, stats_full = ep.moe_ffn_local(p, x, E, capacity=T)
    out_tight, _, stats_tight = ep.moe_ffn_local(p, x, E, capacity=1)
    assert float(stats_full["dropped"]) == 0.0
    assert float(stats_tight["dropped"]) > 0.0
    zero_rows = int((out_tight == 0.0).all(-1).sum())
    assert zero_rows > 0
    assert not torch.allclose(out_full, out_tight)


def test_expert_capacity_sizing():
    assert ep.expert_capacity(64, 8, factor=1.0) == 8
    assert ep.expert_capacity(64, 8, factor=2.0) == 16
    assert ep.expert_capacity(4, 8) == 1  # never zero


def test_top2_routing_properties():
    """GShard top-2: each token lands in <=2 expert buffers, gates are the
    normalised top-2 router probabilities, and ample capacity drops
    nothing."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    r, _, st = ep._route(x, w, n_experts=4, capacity=32, top_k=2)
    dispatch, combine = _dense_layout(r, 4, 32)
    np.testing.assert_allclose(dispatch.sum(axis=(1, 2)), 2.0, atol=1e-6)
    np.testing.assert_allclose(combine.sum(axis=(1, 2)), 1.0, atol=1e-5)
    assert dispatch.sum(axis=0).max() <= 1.0 + 1e-6  # each (expert, slot) once
    assert float(st["dropped"]) == 0.0


def test_top2_capacity_priority():
    """Under capacity pressure, second choices are dropped before first
    choices (choice-priority filling)."""
    x = torch.ones((8, 2))
    w = torch.tensor([[3.0, 2.0, -9.0, -9.0], [3.0, 2.0, -9.0, -9.0]])
    r, _, stats = ep._route(x, w, n_experts=4, capacity=4, top_k=2)
    d, _ = _dense_layout(r, 4, 4)
    assert d[:, 0].sum() == 4.0 and d[:4, 0].sum() == 4.0
    assert d[:, 1].sum() == 4.0 and d[:4, 1].sum() == 4.0
    assert d[4:].sum() == 0.0
    np.testing.assert_allclose(float(stats["dropped"]), 0.5, atol=1e-6)


def test_z_loss_sown_and_weighted():
    """A block with ``moe_z_weight > 0`` hands the PRE-WEIGHTED router
    z-loss to the loss (added at 1.0); with 0 it hands none."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 8, D)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    kw = dict(dim=D, heads=2, use_moe=True, n_experts=4, dtype=torch.float32, device="cpu")
    block = TransformerBlock(**kw, moe_z_weight=1e-2, generator=gen)
    block0 = TransformerBlock(**kw, moe_z_weight=0.0, generator=gen)
    block0.load_state_dict(block.state_dict())
    raw = []  # the MoE FFN's own, unweighted z
    block.moe.register_forward_hook(lambda m, i, out: raw.append(out[2]["z"]))
    _, _, moe = block(x)
    _, _, moe0 = block0(x)
    st = {"z": raw[0]}
    assert float(moe["z"]) == pytest.approx(1e-2 * float(st["z"]), rel=1e-6)
    assert float(moe["z"]) > 0.0
    assert moe0["z"] is None


def test_moe_block_trains():
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 8, D)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(8).normal(size=(4, 8, D)).astype(np.float32))
    block = ep.MoEBlock(D, n_experts=4, capacity_factor=2.0, device="cpu")
    block.reset_parameters(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(40):
        out, aux, _ = block(x)
        loss = ((out - y) ** 2).mean() + 0.01 * aux
        grads = torch.autograd.grad(loss, list(block.parameters()))
        with torch.no_grad():
            for p, g in zip(block.parameters(), grads):
                p -= 0.3 * g
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------------------------------------------- the module


def test_moe_block_matches_flax_on_converted_weights():
    """The port's MoEBlock holds flax's leaves in flax's layout: output and
    aux loss equal flax's on the same weights (top-2, capacity under
    pressure at factor 1.0)."""
    x = np.random.default_rng(10).normal(size=(4, 8, D)).astype(np.float32)
    fm = jep.MoEBlock(dim=D, n_experts=E, capacity_factor=1.0, top_k=2, z_weight=1e-3)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, state = fm.apply({"params": variables["params"]}, jnp.asarray(x),
                           mutable=["losses", "zlosses", "moe_stats"])
    block = ep.MoEBlock(D, n_experts=E, capacity_factor=1.0, top_k=2, z_weight=1e-3,
                        device="cpu")
    block.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in variables["params"].items()})
    out, aux, st = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(state["losses"]["moe_aux"][0]), rtol=1e-6)
    np.testing.assert_allclose(float(st["dropped"]),
                               float(state["moe_stats"]["dropped_frac"][0]), atol=1e-7)
    np.testing.assert_allclose(1e-3 * float(st["z"]), float(state["zlosses"]["moe_z"][0]),
                               rtol=1e-5)
    assert float(st["dropped"]) > 0.0


def test_init_scales_are_flax_lecun_over_the_stacked_fan_in():
    """flax's lecun_normal counts the expert axis in a 3-D kernel's fan-in:
    std (E*D)^-1/2 for w1, (E*H)^-1/2 for w2, D^-1/2 for the router (its
    truncated normal's std is the nominal one); biases zero.  The same
    statistics on flax's own init."""
    d, e = 64, 8
    block = ep.MoEBlock(d, n_experts=e, device="cpu")
    block.reset_parameters(torch.Generator().manual_seed(1))
    flax = jep.MoEBlock(dim=d, n_experts=e).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, d)))["params"]
    for name, fan_in in (("router", d), ("w1", e * d), ("w2", e * 4 * d)):
        want = fan_in ** -0.5
        p = getattr(block, name)
        rel = 5.0 / (2 * p.numel()) ** 0.5  # 5 sigma of a sample std
        assert float(p.detach().std()) == pytest.approx(want, rel=rel), name
        assert float(np.std(np.asarray(flax[name]))) == pytest.approx(want, rel=rel), name
        assert getattr(block, name).dtype == torch.float32
    assert float(block.b1.abs().max()) == 0.0 and float(block.b2.abs().max()) == 0.0


class _Largest(TorchDispatchMode):
    """Records the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_tokens_by_experts_by_capacity_tensor_is_built():
    """Forward and backward at T=512, E=8, C=T (ample): no op of the port
    returns a tensor of T*E*C elements (JAX's dispatch and combine are
    that size); the largest is the (E, C, H) hidden activation."""
    t, d, e, h = 512, 16, 8, 32
    params = {"router": torch.randn(d, e), "w1": torch.randn(e, d, h),
              "b1": torch.zeros(e, h), "w2": torch.randn(e, h, d), "b2": torch.zeros(e, d)}
    for v in params.values():
        v.requires_grad_(True)
    x = torch.randn(t, d, requires_grad=True)
    with _Largest() as mode:
        out, aux, st = ep.moe_ffn_local(params, x, e, t, 2)
        torch.autograd.grad(out.sum() + aux + st["z"], [x, *params.values()])
    assert mode.largest == e * t * h
    assert mode.largest < t * e * t


@pytest.mark.parametrize("fn", ["make_moe_dispatch", "make_moe_dispatch_auto",
                                "moe_expert_rule"])
def test_expert_parallelism_is_refused_by_its_item(fn):
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1, item 7\.5"):
        getattr(ep, fn)(None, 8)


def test_top_k_out_of_range_is_refused_as_in_jax():
    x, w = torch.zeros(4, D), torch.zeros(D, 4)
    with pytest.raises(ValueError) as got:
        ep._route(x, w, 4, 4, top_k=5)
    with pytest.raises(ValueError) as want:
        jep._route(jnp.zeros((4, D)), jnp.zeros((D, 4)), 4, 4, top_k=5)
    assert str(got.value) == str(want.value)
