"""The port's ZeRO-3 (``parallel/fsdp.py``, ``parallel/tensor_parallel.py``'s
spec rules) against the JAX package's, on the CPU.

* SPECS: ``fsdp_rule`` / ``make_fsdp_specs`` give JAX's spec for every
  leaf of the MLP, LeNet-5, resnet20, the ViT and the causal LM (shapes
  from ``jax.eval_shape`` on JAX's side, ``convert.flax_layout`` of the
  port's model on the other), with and without ``megatron_dense_rule`` as
  ``base_rule``, at ``min_size`` 64 and 1024: tuple equality.  In the
  port's layout a (256, 10) head kernel splits its 256 and a (3, 3, 16,
  32) conv its 32, as JAX splits them.
* ONE ZeRO-3 STEP: ``make_fsdp_train_step`` on two gloo ranks (spawned
  once for the module, ``tests/torch_shard_ranks.py``) against JAX's
  ``make_fsdp_train_step`` on 2 virtual devices, 3 batches, adam, float32:
  losses within 1e-5 relative, parameters and both moments within 1e-5;
  each rank holds exactly its half of each split leaf and of its moments.
* ``Trainer(fsdp=True, dp=2)``: the MLP's epoch losses equal the port's
  dp=1 run on the same global batches within 1e-5; resnet20 runs with
  cross-replica BatchNorm (statistics equal on both ranks); the causal
  LM's ``qkv`` weight is split; fsdp at dp=1 raises as JAX raises.
* THE CLIP: the same three steps with a global-norm clip that bites on
  each, against JAX's, with and without ``sharded_update`` (fsdp blocks,
  ZeRO-1 bucket blocks and whole leaves in one norm): losses, parameters
  and both moments within 1e-5.
* fsdp + ``sharded_update``: a (256,) bias stays whole, its moments are
  held at 1/2 a rank in the ZeRO-1 buckets; with a clip that bites, two
  epochs equal the port's dp=1 run (losses, parameters, moments, 1e-5).
* CHECKPOINTS: an fsdp checkpoint (the whole, replicated form) restores
  bit-equal into a fresh fsdp run, resumes at dp=2 without fsdp and at
  dp=1; a JAX TrainState loads into an fsdp run through
  ``load_train_state`` + ``shard_train_state``, bit-equal to the
  conversion and each rank holding its block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_shard_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.core.steps import make_train_step as jax_make_train_step
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel import fsdp as jfsdp
from distributed_tensorflow_ibm_mnist_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import mlp_state_dict, train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import fsdp
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

STEP_TOL = 1e-5  # JAX's own fsdp-vs-single-device step limit (tests/test_fsdp.py:76)
MESH2 = Mesh(shape={"data": 2, "model": 1, "seq": 1, "pipe": 1}, rank=0)
# a dp=2 x tp=2 grid's rank 0 (building a plan runs no collective)
MESH2x2 = Mesh(shape={"data": 2, "model": 2, "seq": 1, "pipe": 1}, rank=0)

# model -> (keywords both registries take, JAX's init sample)
ZOO = {
    "mlp": (dict(num_classes=10, hidden=(256, 64)), jnp.zeros((1, 28, 28, 1), jnp.uint8)),
    "lenet5": (dict(num_classes=10), jnp.zeros((1, 28, 28, 1), jnp.uint8)),
    "resnet20": (dict(num_classes=10), jnp.zeros((1, 32, 32, 3))),
    "vit": (dict(num_classes=10, patch_size=7, dim=32, depth=2, heads=2),
            jnp.zeros((1, 28, 28, 1))),
    "causal_lm": (dict(num_classes=64, dim=64, depth=2, heads=4),
                  jnp.zeros((1, 8), jnp.int32)),
}
PORT_EXTRA = {"mlp": dict(in_features=784), "resnet20": dict(in_channels=3)}


@functools.cache
def _zoo(name):
    """JAX's parameter shapes (``eval_shape``) and the port's model."""
    kw, sample = ZOO[name]
    jm = jax_get_model(name, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), sample)["params"]
    return shapes, get_model(name, device="cpu", **kw, **PORT_EXTRA.get(name, {}))


def _flat(tree, is_spec):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(v) for path, v in leaves}


@pytest.mark.parametrize("min_size", [64, 1024])
@pytest.mark.parametrize("base", [None, "megatron_dense"])
@pytest.mark.parametrize("name", sorted(ZOO))
def test_fsdp_specs_equal_jax_for_every_leaf(name, base, min_size):
    shapes, model = _zoo(name)
    jbase = jtp.megatron_dense_rule() if base else None
    pbase = tp.megatron_dense_rule() if base else None
    want = jtp.make_param_specs(shapes, jfsdp.fsdp_rule(2, min_size=min_size, base_rule=jbase))
    got = tp.make_param_specs(tp.flax_shape_tree(model),
                              fsdp.fsdp_rule(2, min_size=min_size, base_rule=pbase))
    want = _flat(want, lambda x: isinstance(x, JP))
    got = _flat(got, lambda x: isinstance(x, tp.P))
    assert got == want
    assert any(v != () for v in want.values())  # something is split
    if base is None and min_size == 1024:  # the Trainer's specs, port layout
        layout = fsdp.make_fsdp_specs(model, MESH2)
        assert len(layout) == len(want) and all(
            tuple(s) == () or "data" in s for s in layout.values())


def test_head_and_conv_split_where_jax_splits_them():
    head = fsdp.make_fsdp_specs(get_model("mlp", device="cpu", hidden=(256,)), MESH2)
    assert head["logits.weight"] == tp.P(None, "data")  # flax (256, 10): P("data", None)
    assert head["dense_0.bias"] == tp.P()  # under min_size
    conv = jfsdp.fsdp_rule(2)(("c", "kernel"), jnp.zeros((3, 3, 16, 32)))
    assert tuple(conv) == (None, None, None, "data")
    _, resnet = _zoo("resnet20")
    specs = fsdp.make_fsdp_specs(resnet, MESH2)
    names = [n for n, p in resnet.named_parameters() if tuple(p.shape) == (32, 16, 3, 3)]
    assert names and all(specs[n] == tp.P("data", None, None, None) for n in names)


@pytest.mark.parametrize("case", [
    (("dense_0", "kernel"), (784, 64), 8, 64),
    (("x", "kernel"), (17, 64), 8, 64),
    (("x", "kernel"), (17, 33), 8, 64),
    (("dense_0", "bias"), (10,), 8, 64),
    (("count",), (), 8, 64),
], ids=["largest", "divisible", "none", "small", "scalar"])
def test_fsdp_rule_cases_equal_jax(case):
    path, shape, n, min_size = case
    want = jfsdp.fsdp_rule(n_shards=n, min_size=min_size)(path, jnp.zeros(shape))
    assert tuple(fsdp.fsdp_rule(n_shards=n, min_size=min_size)(path, tp.Leaf(shape))) == \
        tuple(want)


def test_fsdp_composes_with_the_tp_rule_as_jax():
    jr = jfsdp.fsdp_rule(2, min_size=64, base_rule=jtp.megatron_dense_rule())
    pr = fsdp.fsdp_rule(2, min_size=64, base_rule=tp.megatron_dense_rule())
    for path, shape in ((("dense_0", "kernel"), (784, 64)), (("dense_1", "kernel"), (64, 784)),
                        (("logits", "kernel"), (64, 10)), (("dense_0", "kernel"), (17, 64))):
        assert tuple(pr(path, tp.Leaf(shape))) == tuple(jr(path, jnp.zeros(shape)))
    # the Megatron dims beside fsdp's (item 7.7): the tp plan cuts each
    # model block, the fsdp plan cuts that block again along its data dim
    model = get_model("mlp", device="cpu", hidden=(64,))
    specs = tp.model_param_specs(model, pr)
    assert specs["dense_0.weight"] == tp.P("model", "data")  # flax's P("data", "model")
    plan = fsdp.ShardPlan.build(MESH2x2, model, specs, tp=tp.TPPlan.shard(MESH2x2, model, specs))
    got = dict(zip(plan.names, plan.masters))
    assert tuple(got["dense_0.weight"].shape) == (32, 392)  # 1/4 of (64, 784)
    assert plan.whole_shapes[plan.names.index("dense_0.weight")] == (64, 784)


def test_fsdp_opt_specs_upgrade_small_leaves_as_jax():
    shapes, _ = _zoo("mlp")
    mesh = jax_make_mesh(dp=2)
    specs = jfsdp.make_fsdp_specs(shapes, mesh)
    state = type("S", (), {"params": shapes, "opt_state": shapes})()
    want = jfsdp.make_fsdp_opt_specs(state, mesh, specs)
    model = _zoo("mlp")[1]
    port_specs = fsdp.make_fsdp_specs(tp.flax_shape_tree(model), MESH2)
    got = fsdp.make_fsdp_opt_specs(tp.flax_shape_tree(model), MESH2, port_specs)
    assert _flat(got, lambda x: isinstance(x, tp.P)) == _flat(want, lambda x: isinstance(x, JP))
    layout = fsdp.make_fsdp_opt_specs(model, MESH2, fsdp.make_fsdp_specs(model, MESH2))
    assert layout["dense_1.bias"] == tp.P("data")  # (64,): whole, its moments split


def test_specs_like_matches_by_suffix_as_jax():
    shapes, model = _zoo("mlp")
    jspecs = jfsdp.make_fsdp_specs(shapes, jax_make_mesh(dp=2))
    target = {"mu": shapes, "count": jax.ShapeDtypeStruct((), jnp.int32)}
    want = jtp.specs_like(target, shapes, jspecs)
    tree = tp.flax_shape_tree(model)
    got = tp.specs_like({"mu": tree, "count": tp.Leaf(())}, tree,
                        fsdp.make_fsdp_specs(tree, MESH2))
    assert _flat(got, lambda x: isinstance(x, tp.P)) == _flat(want, lambda x: isinstance(x, JP))


def test_tensor_parallel_proper_is_refused_by_its_item():
    # the serving half is ported whole (tests/test_torch_tp_serving.py and
    # tests/test_torch_cp_serving.py hold it against JAX's): the cp rule
    # splits a pool's pages as JAX's does; specs over data and model (fsdp
    # beside tp, item 7.7) put a ShardPlan over the tp blocks; the training
    # half's step and epoch factories need JAX's arguments
    assert tp.kv_cache_rule(2, cp=2)(("pages_k",), tp.Leaf((8, 8, 4, 16))) == (
        "cp", None, "tp", None)
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState

    model = get_model("mlp", device="cpu", hidden=(64,))
    state = TrainState(step=0, model=model, data_generator=torch.Generator(),
                       optimizer=make_optimizer(RunConfig(model="mlp"), 10,
                                                list(model.parameters())))
    specs = tp.model_param_specs(model, fsdp.fsdp_rule(2, min_size=64,
                                                       base_rule=tp.megatron_dense_rule()))
    tp.shard_train_state(MESH2x2, state, specs)
    assert isinstance(state.plan, fsdp.ShardPlan) and state.plan.tp is not None
    assert tuple(state.plan.masters[0].shape) == (32, 392)
    assert tuple(state.optimizer.mu[0].shape) == (32, 392)
    assert tp.serving_mesh(1).model_size == 1
    assert tp.tp_device_groups(2, 2, devices=range(4)) == [[0, 1], [2, 3]]
    assert tp.per_chip_bytes({"k": torch.zeros(2, 4), "index": torch.zeros(2, dtype=torch.int32)}) == 40
    for fn in (tp.make_tp_train_step, tp.make_tp_epoch_runner):
        with pytest.raises(TypeError, match="missing"):
            fn()


def test_fsdp_at_dp1_raises_as_jax():
    with pytest.raises(ValueError, match="fsdp.*dp"):
        Trainer(RunConfig(model="mlp", synthetic=True, n_train=256, n_test=64,
                          batch_size=32, dp=1, fsdp=True, quiet=True), device="cpu")


# ---------------------------------------------------------------- two ranks


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n, batch, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, 28, 28, 1)).astype(np.uint8),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


STEP_OPT = dict(optimizer="adam", lr=1e-3)
STEP_HIDDEN = (64, 64)
# the clipped steps: a (63,) bias stays replicated at any min_size, so the
# norm sums fsdp blocks, ZeRO-1 bucket blocks (su_clip) and whole leaves.
# Nesterov momentum is linear in the gradient, so the clip's scale shows in
# every parameter and trace element (Adam's first steps are near sign(g))
CLIP_HIDDEN = (64, 63)
STEP_CLIP = 0.5  # under every step's global norm (1.13 to 1.57): it bites on each
CLIP_OPT = dict(optimizer="momentum", lr=0.05, grad_clip=STEP_CLIP)
# name -> (hidden, optimizer config, min_size, sharded_update)
STEPS = {"plain": (STEP_HIDDEN, STEP_OPT, 64, False),
         "clip": (CLIP_HIDDEN, CLIP_OPT, 64, False),
         "su_clip": (CLIP_HIDDEN, CLIP_OPT, 1024, True)}


@functools.cache
def _jax_step_run(name="plain"):
    """JAX's three ZeRO-3 steps on 2 virtual devices for ``STEPS[name]``:
    the initial parameters, the losses, the final state and the specs."""
    hidden, opt, min_size, sharded_update = STEPS[name]
    model = jax_get_model("mlp", num_classes=10, hidden=hidden, dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**opt), 10)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    mesh = jax_make_mesh(dp=2)
    specs = jfsdp.make_fsdp_specs(state.params, mesh, min_size=min_size)
    opt_specs = jfsdp.make_fsdp_opt_specs(state, mesh, specs) if sharded_update else None
    init = _np(state.params)
    st = jfsdp.shard_train_state(mesh, state, specs, opt_specs=opt_specs)
    step = jfsdp.make_fsdp_train_step(model, tx, mesh, specs, state, opt_specs=opt_specs)
    losses = []
    for x, y in _batches(3, 64, seed=5):
        st, m = step(st, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        losses.append(float(m["loss"]))
    return init, losses, _np(st), specs


def _mlp_cfg(**kw):
    base = dict(model="mlp", model_kwargs={"hidden": (64,), "dtype": torch.float32},
                dataset="mnist", synthetic=True, n_train=256, n_test=64, batch_size=32,
                epochs=2, lr=2e-3, quiet=True, seed=3, eval_batch_size=64,
                target_accuracy=None)
    return {**base, **kw}


SU_CLIP = 0.5  # under every step's global norm in the "su" run (1.21 to 1.55)
TRAINERS = {
    "mlp": _mlp_cfg(dp=2, fsdp=True),
    "resnet": dict(model="resnet20", model_kwargs={"dtype": torch.float32}, synthetic=True,
                   n_train=64, n_test=32, batch_size=32, epochs=1, dp=2, fsdp=True,
                   quiet=True, eval_batch_size=32, target_accuracy=None),
    "lm": dict(model="causal_lm", model_kwargs={"dim": 32, "depth": 1, "heads": 2,
                                                "dtype": torch.float32},
               dataset="retrieval", dataset_kwargs={"vocab": 16, "seq_len": 16},
               n_train=64, n_test=32, batch_size=32, epochs=1, lr=1e-3, dp=2, fsdp=True,
               quiet=True, eval_batch_size=32, seed=3, target_accuracy=None),
    "su": _mlp_cfg(model_kwargs={"hidden": (256,), "dtype": torch.float32}, n_train=128,
                   optimizer="adam", dp=2, fsdp=True, sharded_update=True,
                   grad_clip=SU_CLIP),
    "ckpt": _mlp_cfg(epochs=1, optimizer="adam", dp=2, fsdp=True),
}


@functools.cache
def _jax_train_state():
    """A JAX MLP TrainState one adam step in, numpy leaves, its optax
    records rebuilt as ``torch_shard_ranks``' namedtuples."""
    model = jax_get_model("mlp", num_classes=10, hidden=(64,), dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**STEP_OPT), 10)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(1),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    x, y = _batches(1, 32, seed=9)[0]
    state, _ = jax.jit(jax_make_train_step(model, tx))(
        state, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    state = _np(state)

    def rebuild(node):
        if hasattr(node, "_fields"):
            cls = {("count", "mu", "nu"): ranks.ScaleByAdamState, (): ranks.EmptyState,
                   ("count",): ranks.ScaleByScheduleState}[tuple(node._fields)]
            return cls(*node)
        return tuple(rebuild(n) for n in node)

    return {"step": state.step, "params": state.params, "batch_stats": {},
            "opt_state": rebuild(state.opt_state)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    steps = {name: {"params": _jax_step_run(name)[0], "hidden": hidden, "opt": opt,
                    "min_size": min_size, "sharded_update": su,
                    "batches": _batches(3, 64, seed=5)}
             for name, (hidden, opt, min_size, su) in STEPS.items()}
    cfgs = {k: dict(v, checkpoint_dir=str(tmp / "ck")) if k == "ckpt" else v
            for k, v in TRAINERS.items()}
    jax_state = {"tree": _jax_train_state(), "config": dict(model="mlp", optimizer="adam",
                                                           lr=1e-3, batch_size=32),
                 "model_kw": {"hidden": (64,), "in_features": 784, "num_classes": 10,
                              "dtype": torch.float32}}
    out = torchrun.spawn(ranks.fsdp, 2, "gloo", "cpu", tmp / "store",
                         args=(steps, cfgs, jax_state, str(tmp)), timeout=300)
    return out, tmp


def test_ranks_import_no_jax(port):
    assert all(r["forbidden"] == [] for r in port[0])


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _opt_record(node, field):
    """The optax record holding ``field`` in an opt_state tree (behind the
    clip's empty state when there is one)."""
    if hasattr(node, field):
        return node
    found = [a for a in (_opt_record(n, field) for n in
                         (node if isinstance(node, tuple) else ())) if a is not None]
    return found[0] if found else None


def _check_steps_equal_jax(port, name):
    """Each rank's losses, whole parameters and moments (Adam's two, or
    the momentum trace) after the case's three steps against JAX's, within
    ``STEP_TOL``."""
    _, losses, jstate, _ = _jax_step_run(name)
    kw = {"hidden": STEPS[name][0], "in_features": 784}
    keys = ("trace",) if STEPS[name][1]["optimizer"] == "momentum" else ("mu", "nu")
    for r in port[0]:
        got = r["steps"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=STEP_TOL)
        for n, t in mlp_state_dict(jstate.params, kw).items():
            _close(got["whole"]["params"][n], t.numpy(), STEP_TOL, n)
        for key in keys:
            record = _opt_record(jstate.opt_state, key)
            for n, t in mlp_state_dict(getattr(record, key), kw).items():
                _close(got["whole"][key][n], t.numpy(), STEP_TOL, f"{key}/{n}")


def test_one_zero3_step_equals_jax(port):
    _check_steps_equal_jax(port, "plain")
    # JAX's layout: the (784, 64) kernel P("data", None) -> the port's
    # (64, 784) weight split along its dim 1
    jspecs = _jax_step_run("plain")[3]
    assert tuple(jspecs["dense_0"]["kernel"]) == ("data", None)
    assert port[0][0]["steps"]["plain"]["specs"]["dense_0.weight"] == (None, "data")


@pytest.mark.parametrize("name", ["clip", "su_clip"])
def test_clipped_zero3_step_equals_jax(port, name):
    """The global-norm clip under a ShardPlan against JAX's
    ``clip_by_global_norm`` under GSPMD: it bites on every step, and a
    leaf counted twice or a block left out of the cross-rank sum would
    move the moments by the clip's scale.  ``su_clip`` adds
    ``sharded_update``: ZeRO-1 bucket blocks beside fsdp and whole leaves."""
    _check_steps_equal_jax(port, name)
    for r in port[0]:
        got = r["steps"][name]
        assert len(got["norms"]) == 3 and min(got["norms"]) > STEP_CLIP
        kinds = set(got["kinds"].values())
        assert kinds == ({"fsdp", "zero1", "replicated"} if name == "su_clip"
                         else {"fsdp", "replicated"})
    assert port[0][0]["steps"][name]["norms"] == port[0][1]["steps"][name]["norms"]


def test_each_rank_holds_exactly_its_half(port):
    for rank, r in enumerate(port[0]):
        blocks, whole = r["steps"]["plain"]["blocks"], r["steps"]["plain"]["whole"]
        for n, b in blocks.items():
            full = whole["params"][n]
            if b["split"] is None:
                assert b["kind"] == "replicated" and b["master"].shape == full.shape, n
                continue
            assert b["kind"] == "fsdp" and b["master"].size * 2 == full.size, n
            want = np.array_split(full, 2, axis=b["split"])[rank]
            np.testing.assert_array_equal(b["master"], want, err_msg=n)
            np.testing.assert_array_equal(
                b["mu"], np.array_split(whole["mu"][n], 2, axis=b["split"])[rank])
        assert {b["kind"] for b in blocks.values()} == {"fsdp", "replicated"}


def test_trainer_fsdp_epochs_equal_dp1(port):
    with Trainer(RunConfig(**_mlp_cfg(dp=1)), device="cpu") as t:
        t.fit()
        want = [h["train_loss"] for h in t.history]
    for r in port[0]:
        np.testing.assert_allclose(r["mlp"]["losses"], want, rtol=1e-5)
        assert r["mlp"]["blocks"]["dense_0.weight"]["kind"] == "fsdp"


def test_resnet_fsdp_keeps_cross_replica_batchnorm(port):
    a, b = (r["resnet"] for r in port[0])
    assert a["epochs_run"] == 1 and a["cross_replica_bn"]
    for n, v in a["buffers"].items():  # global-batch statistics, the same on both
        np.testing.assert_array_equal(v, b["buffers"][n], err_msg=n)
        assert np.isfinite(v).all()
    assert any(x["kind"] == "fsdp" for x in a["blocks"].values())


def test_causal_lm_qkv_is_split(port):
    blocks = port[0][0]["lm"]["blocks"]
    assert blocks["blocks.0.qkv.weight"]["kind"] == "fsdp"
    assert np.isfinite(port[0][0]["lm"]["losses"]).all()


def test_sharded_lm_decodes_from_whole_leaves(port):
    """``_decode_params`` and ``generate`` of an fsdp run gather every leaf
    whole: the same on both ranks, and a fresh model holding those
    weights generates the same tokens."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import make_generator

    a, b = (r["lm"] for r in port[0])
    for k, v in a["decode_params"].items():
        np.testing.assert_array_equal(v, b["decode_params"][k], err_msg=k)
    np.testing.assert_array_equal(a["generated"], b["generated"])
    kw = TRAINERS["lm"]["model_kwargs"]
    model = get_model("causal_lm", num_classes=16, device="cpu", **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in a["decode_params"].items()})
    want = make_generator(model.eval(), 8, 5)(torch.tensor([[1, 2, 3]]))
    np.testing.assert_array_equal(a["generated"], want.numpy())


def test_fsdp_sharded_update_holds_small_moments_at_half(port):
    """The leaves ``min_size`` keeps whole in the module (the (256,) bias)
    are ZeRO-1 leaves: their moments live in this rank's half of their
    buckets, as plain dp's sharded update keeps them."""
    for r in port[0]:
        bias = r["su"]["blocks"]["dense_0.bias"]
        assert bias["kind"] == "zero1" and bias["master"].shape == (256,)
        z = r["su"]["zero1"]
        assert z["leaves"] == 256 + 10  # the two biases
        assert z["leaves"] <= sum(z["buckets"]) < z["leaves"] + 2 * len(z["buckets"])
        assert z["mu"] == z["shards"] == [b // 2 for b in z["buckets"]]
        assert np.isfinite(r["su"]["losses"]).all()


def test_fsdp_sharded_update_save_form_reloads_exactly(port):
    """The whole save form of an fsdp + sharded_update run (its ZeRO-1
    moments gathered from the buckets) loads back bit-equal."""
    for r in port[0]:
        for key, tensors in r["su"]["whole"].items():
            for n, v in tensors.items():
                np.testing.assert_array_equal(r["su"]["reloaded"][key][n], v, err_msg=n)


def test_trainer_fsdp_sharded_update_clipped_equals_dp1(port):
    """fsdp + sharded_update + a clip that bites, two epochs at dp=2,
    against the port's plain dp=1 run on the same global batches: epoch
    losses, parameters and Adam moments within 1e-5."""
    cfg = RunConfig(**dict(TRAINERS["su"], dp=1, fsdp=False, sharded_update=False))
    with Trainer(cfg, device="cpu") as t:
        t.fit()
        want_losses = [h["train_loss"] for h in t.history]
        form = t.state.state_dict()
    for r in port[0]:
        got = r["su"]
        assert len(got["norms"]) == 8 and min(got["norms"]) > SU_CLIP
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        for n, v in form["params"].items():
            _close(got["whole"]["params"][n], v.numpy(), 1e-5, n)
        for key in ("mu", "nu"):  # nu is ~1e-7: its limit is 1e-5 of each leaf's largest
            for n, v in form["optimizer"][key].items():
                w = v.numpy()
                np.testing.assert_allclose(got["whole"][key][n], w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(), err_msg=f"{key}/{n}")


def test_fsdp_checkpoint_round_trips_and_resumes_elsewhere(port):
    ranks_out, tmp = port
    saved = ranks_out[0]["ckpt"]["whole"]
    for r in ranks_out:
        assert r["ckpt_restored_step"] == TRAINERS["ckpt"]["n_train"] // 32
        for key, tensors in saved.items():
            for n, v in tensors.items():
                np.testing.assert_array_equal(r["ckpt_restored"][key][n], v, err_msg=n)
                np.testing.assert_array_equal(r["ckpt_dp2"][key][n], v, err_msg=n)
        assert r["ckpt_dp2_step"] == 2 * ranks_out[0]["ckpt_restored_step"]
    cfg = RunConfig(**dict(TRAINERS["ckpt"], dp=1, fsdp=False,
                           checkpoint_dir=str(tmp / "ck")))
    with Trainer(cfg, device="cpu") as t:  # resumes at dp=1
        t.restore_checkpoint(step=ranks_out[0]["ckpt_restored_step"])
        form = t.state.state_dict()
        for n, v in saved["params"].items():
            np.testing.assert_array_equal(form["params"][n].numpy(), v, err_msg=n)
        for n, v in saved["mu"].items():
            np.testing.assert_array_equal(form["optimizer"]["mu"][n].numpy(), v, err_msg=n)


def test_jax_train_state_loads_into_an_fsdp_run(port):
    tree = _jax_train_state()
    cfg = RunConfig(model="mlp", optimizer="adam", lr=1e-3, batch_size=32)
    want = train_state_dict(tree, cfg, hidden=(64,), in_features=784, num_classes=10)
    for rank, r in enumerate(port[0]):
        got = r["jax_state"]
        assert got["step"] == 1
        for n, t in want["params"].items():
            np.testing.assert_array_equal(got["whole"]["params"][n], t.numpy(), err_msg=n)
        for n, t in want["optimizer"]["nu"].items():
            np.testing.assert_array_equal(got["whole"]["nu"][n], t.numpy(), err_msg=n)
        b = got["blocks"]["dense_0.weight"]
        assert b["kind"] == "fsdp"
        np.testing.assert_array_equal(
            b["master"], np.array_split(want["params"]["dense_0.weight"].numpy(), 2,
                                        axis=b["split"])[rank])
