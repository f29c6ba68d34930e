"""The port's composed parallelism (fsdp beside tp and sp, MoE blocks beside
tp and sp, multislice beside tp, sp and pp) against the JAX package's
Trainer on the same configs, on the CPU.

The ranks are gloo processes (``tests/torch_compose_ranks.py``, one spawn of
4 and one of 2 for the module); each JAX reference Trainer is built and fit
once for the module on JAX's virtual CPU devices, and each port run starts
from that Trainer's initial state (``convert.train_state_dict``) and runs
one full-batch step an epoch on JAX's own epoch permutations, so both
sides train on the same rows of each data shard.

* FSDP BESIDE TP AND SP: the MLP at dp=2 x tp=2 (SGD with a clip that
  bites, so a leaf counted twice in the norm would move every update),
  with and without ``sharded_update``, the LM at dp=2 x tp=2 and at dp=2
  x sp=2 (Adam): per-step losses and whole parameters at JAX's tp limits.
  The leaf JAX lays out ``P("data", "model")`` holds 1/4 of its elements a
  rank, and a rank's resident bytes are half of the tp-only run's but for
  the leaves ``min_size`` keeps whole.
  A checkpoint saved at fsdp x tp resumes at tp=2 alone.
* MOE BLOCKS BESIDE TP AND SP: the top-2 MoE LM at a capacity factor where
  JAX drops (1.0) at dp=2 x tp=2 (expert parallelism over each model
  index's data group), tp=2, sp=2 and dp=2 x sp=2: losses, the dropped
  fraction and parameters against JAX's; the MoE input is bit-equal across
  each model group.  A planted fault, routing each seq rank's slice with
  rank-local capacity and slot offsets, must move the loss and the
  parameters off JAX's.
* MULTISLICE BESIDE TP, SP AND PP: on mock rank records of two nodes,
  ``make_mesh(dcn_dp=2)`` at dp=2 beside tp=2, sp=2 and pp=2 records the
  ``(dp/2, tp, sp, pp)`` x ``(2, 1, 1, 1)`` factors and node-major order,
  and no model, seq or pipe group crosses a node (JAX
  ``tests/test_mesh.py:173-200``, translated to rank records); records that
  are not node-major, and this one node's own, are refused; a dp=2 x tp=2
  run on the multislice mesh equals the flat mesh's bit for bit.
* DROPOUT UNDER SP (ROADMAP queue 3, gap 6): each seq rank keeps its share
  of the activations (within 5 binomial standard deviations of 0.9), and
  the sp=2 step losses over three seeds sit within the seeds' own spread
  of sp=1's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_compose_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import mesh as pmesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

LOSS_ADAM, LOSS_SGD = 1e-5, 1e-4  # JAX's tp limits (tests/test_tensor_parallel.py)
PARAM_ADAM, PARAM_SGD = 5e-4, 5e-5
EPOCHS = 2

SEQ = 16
LM_KW = {"dim": 32, "depth": 2, "heads": 4}
MOE_KW = {**LM_KW, "moe_every": 2, "moe_top_k": 2, "moe_capacity_factor": 1.0, "n_experts": 4}
LM_BASE = dict(model="causal_lm", dataset="retrieval",
               dataset_kwargs={"vocab": 16, "seq_len": SEQ}, n_train=16, n_test=16,
               batch_size=16, epochs=EPOCHS, quiet=True, eval_batch_size=16, seed=4,
               target_accuracy=None, eval_every=10)
LM_DATA = {"num_classes": 16, "seq_len": SEQ}
# SGD with a clip well under the step's global norm: the clip scales every
# update, so a norm that counts a 2-D leaf's blocks twice moves the params
MLP_BASE = dict(model="mlp", synthetic=True, n_train=64, n_test=32, batch_size=64,
                epochs=EPOCHS, quiet=True, seed=3, target_accuracy=None, eval_batch_size=32,
                optimizer="sgd", lr=0.5, schedule="constant", grad_clip=0.05, eval_every=10,
                model_kwargs={"hidden": (64,)})
MLP_DATA = {"num_classes": 10, "in_features": 784}

# name -> (base config, model keywords, layout keywords, world, tolerances)
FITS = {
    "fsdp_tp_mlp": (MLP_BASE, None, dict(dp=2, tp=2, fsdp=True), 4, "sgd"),
    "fsdp_tp_su_mlp": (MLP_BASE, None, dict(dp=2, tp=2, fsdp=True, sharded_update=True), 4,
                       "sgd"),
    "fsdp_tp_lm": (LM_BASE, LM_KW, dict(dp=2, tp=2, fsdp=True), 4, "adam"),
    "fsdp_sp_lm": (LM_BASE, LM_KW, dict(dp=2, sp=2, fsdp=True), 4, "adam"),
    "moe_dp2tp2": (LM_BASE, MOE_KW, dict(dp=2, tp=2), 4, "adam"),
    "moe_dp2sp2": (LM_BASE, MOE_KW, dict(dp=2, sp=2), 4, "adam"),
    "moe_tp2": (LM_BASE, MOE_KW, dict(tp=2), 2, "adam"),
    "moe_sp2": (LM_BASE, MOE_KW, dict(sp=2), 2, "adam"),
}
TOL = {"sgd": (LOSS_SGD, PARAM_SGD), "adam": (LOSS_ADAM, PARAM_ADAM)}
DROP_TOL = 1e-6  # a dropped fraction is a count over the routed assignments
DROPOUT_SEEDS = (1, 2, 3)
DROPOUT_CFG = dict(LM_BASE, model_kwargs=dict(LM_KW, dropout=0.1, dtype=torch.float32),
                   n_train=32, batch_size=16)


def _cfg(name, dtype):
    base, model_kw, layout, _, _ = FITS[name]
    mk = dict(base["model_kwargs"] if model_kw is None else model_kw, dtype=dtype)
    return dict(base, model_kwargs=mk, **layout)


def _data_kw(name):
    return MLP_DATA if FITS[name][0] is MLP_BASE else LM_DATA


def _perms(seed: int, n: int, epochs: int = EPOCHS) -> list[np.ndarray]:
    """JAX's epoch permutations (its Trainer's ``_data_rng`` folded with
    the epoch, ``core/steps.py``'s ``jax.random.permutation``)."""
    _, data_rng = jax.random.split(jax.random.PRNGKey(seed))
    return [np.asarray(jax.random.permutation(jax.random.fold_in(data_rng, e), n))
            for e in range(epochs)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_refs(eight_devices):
    """Each JAX Trainer built and fit once: its initial state (numpy), its
    per-epoch losses and dropped fractions, its final state and specs."""
    out = {}
    for name in FITS:
        jt = JaxTrainer(JaxRunConfig(**_cfg(name, jnp.float32)))
        init = _np_tree(jt.state)
        jt.fit()
        out[name] = {"init": init, "losses": [h["train_loss"] for h in jt.history],
                     "drops": [h.get("moe_dropped_frac") for h in jt.history],
                     "final": _np_tree(jt.state),
                     "specs": getattr(jt, "_tp_specs", None)}
    return out


def _fit_job(name, refs, **extra):
    cfg = _cfg(name, torch.float32)
    form = train_state_dict(refs[name]["init"], RunConfig(**cfg), **_data_kw(name))
    return {"kind": "epochs", "config": cfg, "form": form,
            "perms": _perms(cfg["seed"], cfg["n_train"]), **extra}


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_refs):
    tmp = tmp_path_factory.mktemp("composed")
    ckpt = dict(_cfg("fsdp_tp_lm", torch.float32), n_train=32, epochs=1,
                checkpoint_dir=str(tmp / "ckpt"))
    jobs = {2: {}, 4: {}}
    for name, (_, _, _, world, _) in FITS.items():
        jobs[world][name] = _fit_job(name, jax_refs, moe_inputs=name.startswith("moe_"))
    jobs[2]["moe_sp2_fault"] = _fit_job("moe_sp2", jax_refs, fault="local_routing")
    jobs[4]["tp_mlp_bytes"] = {"kind": "bytes",
                               "config": dict(_cfg("fsdp_tp_mlp", torch.float32), fsdp=False)}
    jobs[4]["ckpt_save"] = {"kind": "checkpoint", "config": ckpt}
    flat = dict(_cfg("fsdp_tp_mlp", torch.float32), fsdp=False)
    jobs[4]["multislice"] = {
        "kind": "multislice",
        "meshes": {"tp": dict(dp=2, tp=2), "sp": dict(dp=2, sp=2), "pp": dict(dp=2, pp=2)},
        "fit": {"kind": "epochs", "config": flat, "perms": _perms(5, flat["n_train"])}}
    jobs[2]["ckpt_resume_tp2"] = {"kind": "checkpoint", "resume": True,
                                  "config": dict(ckpt, dp=1, fsdp=False)}
    jobs[2]["dropout_sp2"] = {"kind": "dropout", "seeds": DROPOUT_SEEDS,
                              "config": dict(DROPOUT_CFG, sp=2),
                              "perm": np.arange(DROPOUT_CFG["n_train"])}
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, jobs[w]), timeout=600)
           for w in (4, 2)}
    out["dropout_sp1"] = {}
    for seed in DROPOUT_SEEDS:  # the single-process runs of the same seeds
        with Trainer(RunConfig(**dict(DROPOUT_CFG, seed=seed)), device="cpu") as t:
            m = t._run_epoch(t.state, t.train_images, t.train_labels,
                             perm=torch.arange(DROPOUT_CFG["n_train"]))
            out["dropout_sp1"][seed] = m["loss"].tolist()
    return out


def _want(name, refs):
    cfg = RunConfig(**_cfg(name, torch.float32))
    return {k: v.numpy() for k, v in train_state_dict(
        refs[name]["final"], cfg, **_data_kw(name))["params"].items()}


def test_ranks_import_no_jax(port):
    for w in (2, 4):
        assert all(r["forbidden"] == [] for r in port[w])


# ---------------------------------------------------------------- fsdp beside tp and sp


@pytest.mark.parametrize("name", ["fsdp_tp_mlp", "fsdp_tp_su_mlp", "fsdp_tp_lm", "fsdp_sp_lm",
                                  "moe_dp2tp2", "moe_dp2sp2", "moe_tp2", "moe_sp2"])
def test_composed_fit_equals_jaxs_trainer(port, jax_refs, name):
    world, (loss_tol, param_tol) = FITS[name][3], TOL[FITS[name][4]]
    ref, want = jax_refs[name], _want(name, jax_refs)
    for r in port[world]:
        rec = r[name]
        np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=loss_tol)
        for k, v in want.items():
            np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=param_tol, err_msg=k)
        assert rec["chips"] == world
        if name.startswith("moe_"):  # JAX's dropped fractions, and JAX really drops
            assert min(ref["drops"]) > 0.0
            np.testing.assert_allclose(rec["drops"], ref["drops"], rtol=0, atol=DROP_TOL)


def test_fsdp_tp_leaf_is_split_over_data_and_model(port, jax_refs):
    spec = jax_refs["fsdp_tp_mlp"]["specs"]["dense_0"]["kernel"]
    assert tuple(spec) == tuple(JP("data", "model"))
    for r in port[4]:
        lay = r["fsdp_tp_mlp"]["layout"]
        assert lay["kinds"]["dense_0.weight"] == "fsdp"
        assert lay["fraction"]["dense_0.weight"] == 0.25
        assert lay["fraction"]["logits.weight"] == 0.5  # the head: P("model", None), small
        # the tp blocks fsdp splits are halved; the leaves under min_size
        # stay whole (1.4% of the tp-only bytes here)
        whole = sum(b for n, b in lay["block_bytes"].items() if lay["kinds"][n] != "fsdp")
        tp_only = r["tp_mlp_bytes"]["resident_bytes"]
        assert whole < 0.02 * tp_only
        assert lay["resident_bytes"] == (tp_only - whole) // 2 + whole
        assert r["fsdp_tp_mlp"]["path_label"] == "dp2_tp2_fsdp"


def test_fsdp_tp_sharded_update_holds_small_moments_in_buckets(port):
    for r in port[4]:
        kinds = r["fsdp_tp_su_mlp"]["layout"]["kinds"]
        assert kinds["logits.bias"] == "zero1" and kinds["dense_0.weight"] == "fsdp"


def test_fsdp_tp_checkpoint_resumes_at_tp_alone(port):
    want = port[4][0]["ckpt_save"]
    for r in port[2]:
        got = r["ckpt_resume_tp2"]
        assert got["step"] == 2 * 2  # two steps an epoch, resumed after the first
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_ADAM)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=PARAM_ADAM, err_msg=k)


# ---------------------------------------------------------------- MoE blocks beside tp and sp


@pytest.mark.parametrize("name, groups", [("moe_dp2tp2", [(0, 1), (2, 3)]),
                                          ("moe_tp2", [(0, 1)])])
def test_moe_input_is_bit_equal_across_the_model_group(port, name, groups):
    world = FITS[name][3]
    for a, b in groups:
        xa, xb = port[world][a][name]["moe_inputs"], port[world][b][name]["moe_inputs"]
        assert len(xa) == len(xb) > 0
        for u, v in zip(xa, xb):
            np.testing.assert_array_equal(u, v)


def test_rank_local_routing_under_sp_is_caught(port, jax_refs):
    """The planted fault routes each seq rank's 8 tokens a row on their own
    (capacity from the slice, slots counted from the slice's start): the
    check the sound run passes fails on its losses and parameters.  (Its
    dropped fraction may equal JAX's: where each expert's overload has the
    same sign in both halves of the sequence, the counts agree, but other
    assignments are the ones dropped.)"""
    ref, want = jax_refs["moe_sp2"], _want("moe_sp2", jax_refs)
    for r in port[2]:
        rec = r["moe_sp2_fault"]
        loss_err = max(abs(a - b) / b for a, b in zip(rec["losses"], ref["losses"]))
        param_err = max(float(np.abs(rec["params"][k] - v).max()) for k, v in want.items())
        assert loss_err > LOSS_ADAM and param_err > 4 * PARAM_ADAM, (loss_err, param_err)


# ---------------------------------------------------------------- multislice


def _mock(world, per_node):
    return [pmesh.RankRecord(r, f"node-{r // per_node}", r // per_node) for r in range(world)]


@pytest.mark.parametrize("shape", [(2, 2, 1, 1), (2, 1, 2, 1), (2, 1, 1, 2), (4, 2, 1, 1),
                                   (4, 1, 2, 2)])
def test_only_the_data_axis_crosses_nodes(shape):
    """JAX's ``test_make_mesh_multislice_positive_branch`` on rank records:
    at dcn_dp=2 each node holds (dp/2) * tp * sp * pp consecutive ranks, the
    data groups span both nodes and no other group leaves its node."""
    dp, tp, sp, pp = shape
    world = dp * tp * sp * pp
    records = _mock(world, world // 2)
    assert pmesh.hybrid_mesh_shapes(dp, tp, sp, pp, 2) == ((dp // 2, tp, sp, pp), (2, 1, 1, 1))
    chosen = pmesh.pick_multislice_devices(records, 2, (dp // 2) * tp * sp * pp)
    assert [r.rank for r in chosen] == list(range(world))
    crossing = pmesh.node_crossings(chosen, dp, tp, sp, pp)
    for axis in ("model_group", "seq_group", "pipe_group"):
        assert crossing[axis] == [], axis
    assert len(crossing["data_group"]) == tp * sp * pp  # every data group crosses
    assert len(crossing["replica_group"]) == tp * pp  # and so every replica group


def test_multislice_meshes_beside_tp_sp_pp(port):
    for r in port[4]:
        ms = r["multislice"]
        for name, axis in (("tp", "model"), ("sp", "seq"), ("pp", "pipe")):
            rec = ms["meshes"][name]
            shape = {"data": 2, "model": 1, "seq": 1, "pipe": 1, axis: 2}
            assert rec["shape"] == shape and rec["dcn_dp"] == 2
            assert rec["ici"] == (1, shape["model"], shape["seq"], shape["pipe"])
            assert rec["dcn"] == (2, 1, 1, 1) and rec["order"] == (0, 1, 2, 3)
            # ranks (0, 1) on node a, (2, 3) on node b: the inner axis pairs
            # each rank with its node's other rank, the data axis across nodes
            inner = {"tp": "model_sum", "sp": "seq_sum", "pp": "pipe_sum"}[name]
            assert rec[inner] == (0 + 1 if r["rank"] < 2 else 2 + 3)
            assert rec["data_sum"] == (0 + 2 if r["rank"] % 2 == 0 else 1 + 3)
        assert ms["interleaved"].startswith("ValueError") and "node-major" in ms["interleaved"]
        assert ms["one_node"].startswith("ValueError") and "slice" in ms["one_node"]


def test_multislice_fit_equals_the_flat_mesh_bit_for_bit(port):
    for r in port[4]:
        fits = r["multislice"]["fits"]
        assert fits["dcn2"]["losses"] == fits["dcn1"]["losses"]
        for k, v in fits["dcn1"]["params"].items():
            np.testing.assert_array_equal(fits["dcn2"]["params"][k], v, err_msg=k)


# ---------------------------------------------------------------- dropout under sp


def test_each_seq_rank_keeps_its_share_under_dropout(port):
    for r in port[2]:
        for seed in DROPOUT_SEEDS:
            rec = r["dropout_sp2"][seed]
            rate = rec["kept"] / rec["seen"]
            sigma = np.sqrt(0.9 * 0.1 / rec["seen"])
            assert abs(rate - 0.9) < 5 * sigma, (seed, rate, sigma)


def test_dropout_sp2_losses_sit_within_the_seeds_spread_of_sp1s(port):
    """Each seed's masks differ between the layouts (ROADMAP divergence 35),
    so the step losses are held by statistics: the mean over the seeds of
    the sp=2 losses within three standard errors (of both layouts' spread
    across seeds) of sp=1's, step by step."""
    sp2 = np.array([port[2][0]["dropout_sp2"][s]["losses"] for s in DROPOUT_SEEDS])
    sp1 = np.array([port["dropout_sp1"][s] for s in DROPOUT_SEEDS])
    assert sp2.shape == sp1.shape == (len(DROPOUT_SEEDS), 2)
    assert all(r["dropout_sp2"][s]["losses"] == port[2][0]["dropout_sp2"][s]["losses"]
               for r in port[2][1:] for s in DROPOUT_SEEDS)
    stderr = np.sqrt((sp1.var(0, ddof=1) + sp2.var(0, ddof=1)) / len(DROPOUT_SEEDS))
    assert np.all(np.abs(sp2.mean(0) - sp1.mean(0)) <= 3 * stderr + 1e-6), (sp1, sp2)
    assert not np.array_equal(sp2, sp1)  # the masks do differ
