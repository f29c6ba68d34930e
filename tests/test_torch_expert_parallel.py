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
* expert parallelism on two gloo ranks (spawned once for the module,
  ``tests/torch_shard_ranks.py``) against JAX's on 2 virtual devices:
  ``make_moe_dispatch``'s outputs, aux and stats at 1e-5 and the gradients
  with respect to x and every parameter at 1e-4 (JAX's own tolerance,
  ``tests/test_expert_parallel.py:66``), top-1 and top-2, at ample
  capacity and under capacity pressure (capacity 2, where each rank drops
  other tokens than one device would); ``moe_expert_rule`` as JAX's; the
  Trainer's automatic EP on a MoE ViT: expert leaves and their moments at
  2 of 4 rows a rank, the router whole, one momentum step with a
  global-norm clip that bites, from JAX's EP trainer's own initial
  TrainState (dropout off: the ViT's default), equal to that trainer's
  step within 1e-4 (loss, every parameter and momentum trace), the drop
  metric in the epoch record, and JAX's refusals (indivisible experts,
  ``sharded_update`` with EP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_shard_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.parallel import expert_parallel as jep
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import TransformerBlock
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import expert_parallel as ep
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

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
    with torch.no_grad():  # a block's constructor leaves its weights unset
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
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


def test_top_k_out_of_range_is_refused_as_in_jax():
    x, w = torch.zeros(4, D), torch.zeros(D, 4)
    with pytest.raises(ValueError) as got:
        ep._route(x, w, 4, 4, top_k=5)
    with pytest.raises(ValueError) as want:
        jep._route(jnp.zeros((4, D)), jnp.zeros((D, 4)), 4, 4, top_k=5)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- two ranks

# name -> (top_k, capacity per (rank, expert)): T/2 tokens a rank
DISPATCH = {"ample_top1": (1, T // 2), "ample_top2": (2, T // 2),
            "pressure_top1": (1, 2), "pressure_top2": (2, 2)}
EP_CLIP = 4.0  # half the step's global norm (8.03): the clip bites
EP_TRAINER = dict(name="moe_ep", model="vit", dataset="mnist", synthetic=True,
                  n_train=64, n_test=32, batch_size=64, epochs=1, optimizer="momentum", lr=0.1,
                  grad_clip=EP_CLIP, quiet=True, seed=12, eval_batch_size=32, dp=2,
                  target_accuracy=None)
EP_MODEL = {"patch_size": 7, "dim": 16, "depth": 1, "heads": 2, "moe_every": 1,
            "n_experts": 4, "moe_capacity_factor": 8.0}
VIT_DATA_KW = {"num_classes": 10, "image_size": (28, 28), "in_channels": 1}


def _dispatch_case(name):
    top_k, capacity = DISPATCH[name]
    return {"params": _params(20 + top_k), "x": _tokens(30 + capacity), "top_k": top_k,
            "capacity": capacity}


def _jax_dispatch(case):
    """JAX's island on 2 devices: outputs, aux, stats and the gradients of
    sum(out^2) + 0.01 aux with respect to the parameters and x."""
    mesh = jax_make_mesh(dp=2)
    moe = jep.make_moe_dispatch(mesh, E, case["capacity"], top_k=case["top_k"])
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    x = jnp.asarray(case["x"])
    out, aux, stats = jax.jit(moe)(params, x)

    def loss(p, xx):
        o, a, _ = moe(p, xx)
        return jnp.sum(o ** 2) + 0.01 * a

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return out, aux, stats, {"x": gx, **gp}


@pytest.fixture(scope="module")
def jax_ep_trainer():
    """JAX's EP trainer: its initial state (numpy) and, after one epoch
    (one step), its history and parameters."""
    jt = JaxTrainer(JaxRunConfig(**EP_TRAINER, model_kwargs={**EP_MODEL,
                                                             "dtype": jnp.float32}))
    assert jt._moe_ep
    init = jax.tree.map(np.asarray, jt.state)
    jt.fit()
    return init, jt.history, jax.tree.map(np.asarray, jt.state)


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_ep_trainer):
    tmp = tmp_path_factory.mktemp("expert_parallel")
    init, _, _ = jax_ep_trainer
    cfg = dict(EP_TRAINER, model_kwargs={**EP_MODEL, "dtype": torch.float32})
    form = train_state_dict(init, RunConfig(**cfg), **VIT_DATA_KW)
    cases = {name: _dispatch_case(name) for name in DISPATCH}
    return torchrun.spawn(ranks.expert_parallel, 2, "gloo", "cpu", tmp / "store",
                          args=(cases, {"config": cfg, "form": form}), timeout=300)


def test_ranks_import_no_jax(port):
    assert all(r["forbidden"] == [] for r in port)


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_matches_jax(port, name):
    out, aux, stats, grads = _jax_dispatch(_dispatch_case(name))
    got = [r[name] for r in port]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got]), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for g in got:
        np.testing.assert_allclose(g["aux"], float(aux), rtol=1e-5)
        for k in ("dropped", "z"):
            np.testing.assert_allclose(g["stats"][k], float(stats[k]), rtol=1e-5, atol=1e-6)
    # the port's gradient convention (parallel/fsdp.py ShardPlan): a rank's
    # x gradient / N, the router's averaged, an expert row's / N
    want = {k: np.asarray(v) for k, v in grads.items()}
    np.testing.assert_allclose(np.concatenate([g["grads"]["x"] for g in got]) / 2, want["x"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((got[0]["grads"]["router"] + got[1]["grads"]["router"]) / 2,
                               want["router"], rtol=1e-4, atol=1e-4)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(np.concatenate([g["grads"][k] for g in got]) / 2, want[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    if name.startswith("pressure"):
        assert float(stats["dropped"]) > 0.0  # the pressure is real


def test_moe_expert_rule_equals_jax():
    jr, pr = jep.moe_expert_rule(), ep.moe_expert_rule()
    for path, shape in ((("block_0", "moe", "w1"), (8, 16, 64)),
                        (("block_0", "moe", "b2"), (8, 16)),
                        (("block_0", "moe", "router"), (16, 8)),
                        (("block_0", "qkv", "kernel"), (16, 48))):
        assert tuple(pr(path, jnp.zeros(shape))) == tuple(jr(path, jnp.zeros(shape)))


def test_auto_dispatch_runs_locally_on_one_rank():
    mesh1 = type("M", (), {"shape": {"data": 1}})()
    p, x = _torch(_params(3)), torch.tensor(_tokens(4))
    got = ep.make_moe_dispatch_auto(mesh1, E, capacity_factor=2.0, top_k=2)(p, x)
    want = ep.moe_ffn_local(p, x, E, ep.expert_capacity(T * 2, E, 2.0), 2)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        ep.make_moe_dispatch(type("M", (), {"shape": {"data": 3}})(), E, 4)


def test_trainer_ep_holds_its_experts_and_the_whole_router(port):
    for r in port:
        for i in range(EP_MODEL["depth"]):
            for leaf, whole in (("w1", (4, 16, 64)), ("b1", (4, 64)), ("w2", (4, 64, 16)),
                                ("b2", (4, 16))):
                name = f"blocks.{i}.moe.{leaf}"
                assert r["kinds"][name] == "expert"
                assert r["rows"][name] == (2, *whole[1:]) == r["moment_rows"][name]
            router = f"blocks.{i}.moe.router"
            assert r["kinds"][router] == "replicated" and r["rows"][router] == (16, 4)


def test_trainer_ep_step_equals_jaxs_ep_trainer(port, jax_ep_trainer):
    init, history, final = jax_ep_trainer
    cfg = RunConfig(**EP_TRAINER, model_kwargs=EP_MODEL)
    start = train_state_dict(init, cfg, **VIT_DATA_KW)
    want = train_state_dict(final, cfg, **VIT_DATA_KW)
    for r in port:
        for n, t in start["params"].items():  # each rank took its block and kept it
            np.testing.assert_array_equal(r["loaded"]["params"][n], t.numpy(), err_msg=n)
        rec = r["fit"]["history"][0]
        np.testing.assert_allclose(rec["train_loss"], history[0]["train_loss"], rtol=1e-4)
        assert "moe_dropped_frac" in rec and rec["moe_dropped_frac"] == 0.0
        for n, t in want["params"].items():
            np.testing.assert_allclose(r["fit"]["whole"]["params"][n], t.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=n)
        # the clip bites, so the momentum trace is the clipped gradient: an
        # expert block left out of the norm or the router counted twice
        # would scale every element
        assert len(r["fit"]["norms"]) == 1 and r["fit"]["norms"][0] > EP_CLIP
        for n, t in want["optimizer"]["trace"].items():
            w = t.numpy()
            np.testing.assert_allclose(r["fit"]["whole"]["trace"][n], w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"trace/{n}")


def test_trainer_ep_decodes_from_whole_experts(port):
    for r in port:
        for i in range(EP_MODEL["depth"]):
            assert r["decode_shapes"][f"blocks.{i}.moe.w1"] == (4, 16, 64)
            assert r["decode_shapes"][f"blocks.{i}.moe.b2"] == (4, 16)


def test_trainer_ep_refusals_as_jax(port):
    for r in port:
        assert r["indivisible"].startswith("ValueError") and "divisible" in r["indivisible"]
        assert r["su_with_ep"].startswith("ValueError")
        assert "sharded_update composes" in r["su_with_ep"]
