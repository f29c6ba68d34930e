"""The port's tensor parallelism (``parallel/tensor_parallel.py``'s model
axis, Megatron's mappings in ``parallel/collectives.py``, the models'
split forward and the Trainer at ``tp > 1``) against the JAX package's
GSPMD runs and the port's own tp=1 runs, on the CPU.

* THE MAPPINGS, on two gloo ranks (spawned once each for worlds 2 and 4,
  ``tests/torch_tp_ranks.py``): a column-parallel product gathered and
  scattered into a row-parallel one, and the same two as a Megatron pair,
  against one process's whole product: output, dx and each rank's block
  of both weight gradients within 1e-6.  A planted gather whose backward
  sums over the model group (x tp) must fail the same check.
* THE BLOCKS: every leaf's split dim is the dim JAX's ``megatron_rule(2)``
  names (spec by spec, through ``convert.flax_layout``), each block holds
  1/tp of JAX's bytes, and the fused ``qkv`` / ``kv_proj`` blocks hold the
  head-major rows ``{c * dim + r * dim / tp + j}``; the whole form gathers
  back bit-equal, and the sharded logits equal the whole model's.  The
  contiguous block JAX's spec names, planted, moves the loss.
* THE CAUSAL LM AT tp=2 (MHA and GQA, tied and untied, dropout on, one
  full-batch step an epoch): each step's loss within 1e-5 of the port's
  tp=1 run on the same seeds and the parameters within 5e-4 (JAX's own
  tp limits, adam); remat, grad_accum, fused_xent and label smoothing
  at tp=2 against tp=1 likewise; a float32 ``make_tp_train_step`` on a
  state ``convert.load_train_state`` cut from JAX's, against JAX's
  single-device step.  A tp=2 checkpoint resumes at tp=2 bit-equal to the
  uninterrupted run and at tp=1 within tolerance; greedy decode after the
  tp=2 fit gives the tp=1 fit's tokens.
* AT WORLD 4: JAX's ``test_tensor_parallel.py:100-169`` at tp=4 (the ViT
  with 2 heads on the generic attention path, ResNet-20 with SGD)
  against JAX's single-device step; the MLP Trainer at dp=2 x tp=2
  against JAX's Trainer on the same mesh (full-batch epochs, so no
  permutation can differ); ResNet-20's data-group BatchNorm at dp=2 x
  tp=2 against the port's single-process run (a planted world-group
  BatchNorm fails it); the LM at tp=2 x sp=2 (the ring on H/tp heads)
  against tp=1; stream mode refused with JAX's message; fsdp and MoE
  blocks beside tp train an epoch, multislice meets the one-node refusal
  JAX's virtual devices meet, pp on the MLP takes JAX's "pipelineable
  block stack" message; the CLI's
  ``--set tp=2`` under a world of 4 trains at dp=2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_tp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.core.steps import make_train_step as jax_make_train_step
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel import tensor_parallel as jtp
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import flax_layout, train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli, torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

MAP_TOL = 1e-6  # relative to the largest magnitude of the whole product's
LOSS_ADAM, LOSS_SGD = 1e-5, 1e-4  # JAX's tp limits (tests/test_tensor_parallel.py)
PARAM_ADAM, PARAM_SGD = 5e-4, 5e-5

SEQ = 16
LM_KW = {"dim": 32, "depth": 2, "heads": 4}
LM_BASE = dict(model="causal_lm", dataset="retrieval",
               dataset_kwargs={"vocab": 16, "seq_len": SEQ}, n_train=16, n_test=16,
               batch_size=16, epochs=3, quiet=True, eval_batch_size=16, seed=4,
               target_accuracy=None)
# the LM fits at tp=2: name -> (model keywords beyond LM_KW, config keywords)
LM_FITS = {
    "mha": ({"dropout": 0.1}, {}),
    "mha_tied": ({"dropout": 0.1, "tie_embeddings": True}, {}),
    "gqa": ({"dropout": 0.1, "heads_kv": 2}, {}),
    "gqa_tied": ({"dropout": 0.1, "heads_kv": 2, "tie_embeddings": True}, {}),
    "remat_accum_fused": ({"attn": "flash"}, {"remat": "blocks", "grad_accum": 2,
                                              "fused_xent": True}),
    "smooth_remat": ({}, {"remat": True, "label_smoothing": 0.1}),
}
PROMPT = [1, 2, 3]


def _lm_cfg(model_kw=None, dtype=torch.float32, **kw):
    return dict(LM_BASE, model_kwargs=dict(LM_KW, dtype=dtype, **(model_kw or {})), **kw)


def _img_cfg(model, model_kw, **kw):
    base = dict(model=model, synthetic=True, n_train=64, n_test=32, batch_size=64, epochs=2,
                quiet=True, seed=3, target_accuracy=None, eval_batch_size=32,
                model_kwargs=dict(model_kw, dtype=torch.float32))
    return dict(base, **kw)


def _batches(n_steps, batch, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 255, size=(batch, 28, 28, 1), dtype=np.uint8),
             rng.integers(0, 10, size=(batch,)).astype(np.int32)) for _ in range(n_steps)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_steps(name, kw, sample, opt, key, batches):
    """JAX's single-device steps from a config chain's fresh state: the
    initial state (plain numpy) and each step's loss and the params after."""
    model = jax_get_model(name, **kw)
    tx = jax_make_optimizer(JaxRunConfig(**opt), 10)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(key), sample)
    init = ranks.plain_state(_np_tree(state))
    step = jax.jit(jax_make_train_step(model, tx))
    losses = []
    for img, lab in batches:
        state, m = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lab)})
        losses.append(float(m["loss"]))
    return init, losses, (_np_tree(state.params), _np_tree(getattr(state, "batch_stats", {})))


# ---------------------------------------------------------------- JAX side

LM_STEP_OPT = dict(optimizer="adam", lr=1e-3, schedule="constant")
VIT_KW = dict(num_classes=10, patch_size=7, dim=32, depth=2, heads=2)
RESNET_KW = dict(num_classes=10)
MLP_JAX = dict(model="mlp", model_kwargs={"hidden": (128, 128), "dtype": jnp.float32},
               dataset="mnist", synthetic=True, n_train=256, n_test=64, batch_size=256,
               epochs=2, lr=2e-3, quiet=True, seed=3, eval_batch_size=64,
               target_accuracy=None)


def _lm_tokens():
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, 16, size=(8, SEQ)).astype(np.int32) for _ in range(2)]
    return [(t, np.roll(t, -1, 1)) for t in toks]


@functools.cache
def _jax_refs():
    out = {}
    lm_kw = dict(num_classes=16, **LM_KW, dtype=jnp.float32)
    out["lm"] = _jax_steps("causal_lm", lm_kw, jnp.zeros((1, SEQ), jnp.int32),
                           LM_STEP_OPT, 0, _lm_tokens())
    out["vit"] = _jax_steps("vit", dict(VIT_KW, dtype=jnp.float32),
                            jnp.zeros((1, 28, 28, 1), jnp.uint8),
                            dict(optimizer="adam", lr=1e-3, schedule="constant"), 1,
                            _batches(2, 16, 1))
    out["resnet"] = _jax_steps("resnet20", dict(RESNET_KW, dtype=jnp.float32),
                               jnp.zeros((1, 28, 28, 1), jnp.uint8),
                               dict(optimizer="sgd", lr=1e-2, schedule="constant"), 2,
                               _batches(1, 8, 2))
    jt = JaxTrainer(JaxRunConfig(name="tp", dp=2, tp=2, **MLP_JAX))
    assert jt.mesh.shape["model"] == 2
    init = _np_tree(jt.state)
    jt.fit()
    out["mlp_trainer"] = (init, [h["train_loss"] for h in jt.history],
                          _np_tree(jt.state.params))
    return out


# ---------------------------------------------------------------- the spawns


def _mapping_job(shape):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"kind": "mappings", "shape": shape, "x": f(3, 8), "wc": f(12, 8),
            "wr": f(6, 12), "c": f(3, 6)}


BLOCK_CASES = {"mha": {"num_classes": 16, **LM_KW},
               "gqa": {"num_classes": 16, **LM_KW, "heads_kv": 2}}
# SGD at 1e-2, one step, as JAX's own ResNet tp test keeps it: with
# momentum this toy ResNet amplifies float32 rounding ~30x a step
BN_CFG = _img_cfg("resnet20", {}, optimizer="sgd", lr=1e-2, n_train=16, batch_size=16,
                  epochs=1)
REFUSED = {  # at dp=2 x tp=2 (world 4); once refused beside tp, composed since item 7.7
    "fsdp": _img_cfg("mlp", {}, dp=2, tp=2, fsdp=True),
    "moe": _lm_cfg({"moe_every": 2}, dp=2, tp=2),
    "multislice": _img_cfg("mlp", {}, dp=2, tp=2, dcn_dp=2),
    "pp": _img_cfg("mlp", {}, dp=2, tp=2, pp=2),
}
STREAM = _img_cfg("mlp", {}, dp=2, tp=2, input_mode="stream")
SHARDED_UPDATE = _img_cfg("mlp", {}, dp=2, tp=2, sharded_update=True)
CLI_ARGV = ["--preset", "mnist_mlp_smoke", "--set", "n_train=64", "--set", "n_test=32",
            "--set", "epochs=1", "--set", "synthetic=True", "--set", "tp=2",
            "--set", "quiet=True"]


def _mlp_port_cfg(**kw):
    mk = dict(MLP_JAX["model_kwargs"], dtype=torch.float32)
    return dict(MLP_JAX, model_kwargs=mk, **kw)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    refs = _jax_refs()
    toks = np.random.default_rng(3).integers(0, 16, size=(2, SEQ)).astype(np.int32)
    jobs2 = {"mesh": {"kind": "mesh", "shape": (1, 2, 1)},
             "mappings": _mapping_job((1, 2, 1))}
    for name, kw in BLOCK_CASES.items():
        jobs2[f"blocks_{name}"] = {"kind": "blocks", "shape": (1, 2, 1), "kw": kw, "seed": 7,
                                   "tokens": toks}
    jobs2["blocks_contiguous"] = dict(jobs2["blocks_mha"], contiguous=True)
    for name, (mk, ck) in LM_FITS.items():
        jobs2[f"lm_{name}"] = {"kind": "fit", "config": _lm_cfg(mk, tp=2, **ck),
                               "generate": PROMPT if name == "mha" else None}
    init, _, _ = refs["lm"]
    jobs2["lm_steps"] = {"kind": "steps", "shape": (1, 2, 1), "state": init,
                         "config": _lm_cfg(**LM_STEP_OPT), "batches": _lm_tokens(),
                         "model_kw": {"num_classes": 16}}
    jobs2["resume"] = {"kind": "resume", "config": _lm_cfg(
        tp=2, n_train=32, epochs=1, checkpoint_dir=str(tmp / "ckpt"))}
    img = {"image_size": (28, 28), "in_channels": 1}
    jobs4 = {f"mesh_{'x'.join(map(str, s))}": {"kind": "mesh", "shape": s}
             for s in ((2, 2, 1), (1, 4, 1), (1, 2, 2))}
    jobs4["mappings_tp4"] = _mapping_job((1, 4, 1))
    jobs4["vit_tp4"] = {"kind": "steps", "shape": (1, 4, 1), "state": refs["vit"][0],
                        "config": _img_cfg("vit", VIT_KW, optimizer="adam", lr=1e-3,
                                           schedule="constant"),
                        "batches": _batches(2, 16, 1), "model_kw": img}
    jobs4["resnet_tp4"] = {"kind": "steps", "shape": (1, 4, 1), "state": refs["resnet"][0],
                           "config": _img_cfg("resnet20", {}, optimizer="sgd", lr=1e-2,
                                              schedule="constant"),
                           "batches": _batches(1, 8, 2), "model_kw": {"in_channels": 1}}
    mlp_init = refs["mlp_trainer"][0]
    jobs4["mlp_trainer"] = {"kind": "fit", "config": _mlp_port_cfg(dp=2, tp=2),
                            "form": train_state_dict(mlp_init, RunConfig(**_mlp_port_cfg()),
                                                     num_classes=10, in_features=784)}
    jobs4["resnet_bn"] = {"kind": "fit", "config": dict(BN_CFG, dp=2, tp=2)}
    jobs4["resnet_bn_fault"] = {"kind": "bn_fault", "config": dict(BN_CFG, dp=2, tp=2)}
    jobs4["lm_tp2_sp2"] = {"kind": "fit", "config": _lm_cfg({"attn": "flash"}, tp=2, sp=2,
                                                            epochs=2)}
    jobs4["refusals"] = {"kind": "refusals", "configs": {
        **REFUSED, "stream": STREAM, "sharded_update": SHARDED_UPDATE}}
    for name in ("fsdp", "moe"):  # composed since item 7.7: one epoch each
        jobs4[f"composed_{name}"] = {"kind": "fit", "config": REFUSED[name]}
    jobs4["cli"] = {"kind": "cli", "argv": CLI_ARGV}
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, jobs), timeout=420)
           for w, jobs in ((2, jobs2), (4, jobs4))}
    tp1 = {}
    for name, (mk, ck) in LM_FITS.items():
        job = {"config": _lm_cfg(mk, **ck), "generate": PROMPT if name == "mha" else None}
        tp1[name] = ranks._fit(job)
    tp1["lm_sp"] = ranks._fit({"config": _lm_cfg({"attn": "flash"}, epochs=2)})
    tp1["resnet_bn"] = ranks._fit({"config": BN_CFG})
    with Trainer(RunConfig(**_lm_cfg(n_train=32, epochs=1, checkpoint_dir=str(tmp / "ckpt"))),
                 device="cpu") as t:  # the tp=2 checkpoint at step 2, at tp=1
        t.restore_checkpoint(step=2)
        t.fit()
        tp1["resume"] = {"loss": t.history[-1]["train_loss"],
                         "params": ranks._whole_params(t)}
    return {"ranks": out, "tp1": tp1, "refs": refs}


def _rank0(port, world, name):
    return port["ranks"][world][0][name]


def test_ranks_import_no_jax(port):
    for world in port["ranks"].values():
        assert all(r["forbidden"] == [] for r in world)


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("world, name, shape", [
    (2, "mesh", (1, 2, 1)), (4, "mesh_2x2x1", (2, 2, 1)), (4, "mesh_1x4x1", (1, 4, 1)),
    (4, "mesh_1x2x2", (1, 2, 2))])
def test_mesh_places_rank_r_at_d_tp_plus_m_times_sp_plus_s(port, world, name, shape):
    dp, n, sp = shape
    at = lambda d, m, s: (d * n + m) * sp + s  # noqa: E731
    for r in port["ranks"][world]:
        rec = r[name]
        d, m, s = rec["data_index"], rec["model_index"], rec["seq_index"]
        assert at(d, m, s) == r["rank"]
        assert rec["replica_index"] == d * sp + s
        assert rec["model_sum"] == sum(at(d, k, s) for k in range(n))
        assert rec["data_sum"] == sum(at(k, m, s) for k in range(dp))
        assert rec["replica_sum"] == sum(at(a, m, b) for a in range(dp) for b in range(sp))
        if sp > 1:
            assert rec["seq_sum"] == sum(at(d, m, k) for k in range(sp))


# ---------------------------------------------------------------- mappings


def _whole_mapping(job):
    x, wc, wr, c = (torch.from_numpy(job[k]).requires_grad_(k != "c")
                    for k in ("x", "wc", "wr", "c"))
    z = x @ wc.T @ wr.T
    (z * c).sum().backward()
    return {"z": z.detach().numpy(), "dx": x.grad.numpy(), "dwc": wc.grad.numpy(),
            "dwr": wr.grad.numpy()}


def _mapping_errors(got_ranks, name, label, n):
    """The largest error of any output or gradient, relative to the largest
    magnitude of its whole counterpart."""
    job = _mapping_job((1, n, 1))
    want = _whole_mapping(job)
    errs = []
    for r in got_ranks:
        got = r[name][label]
        i = r["rank"] % n
        blocks = {"z": want["z"], "dx": want["dx"],
                  "dwc": np.split(want["dwc"], n, 0)[i], "dwr": np.split(want["dwr"], n, 1)[i]}
        errs += [float(np.abs(got[k] - blocks[k]).max() / np.abs(want[k]).max())
                 for k in blocks]
    return max(errs)


@pytest.mark.parametrize("world, name", [(2, "mappings"), (4, "mappings_tp4")])
@pytest.mark.parametrize("label", ["generic", "pair"])
def test_mappings_match_one_process(port, world, name, label):
    n = 2 if world == 2 else 4
    assert _mapping_errors(port["ranks"][world], name, label, n) <= MAP_TOL


@pytest.mark.parametrize("world, name", [(2, "mappings"), (4, "mappings_tp4")])
def test_a_gather_whose_backward_sums_fails_the_check(port, world, name):
    n = 2 if world == 2 else 4
    assert _mapping_errors(port["ranks"][world], name, "fault", n) > 0.5


def test_mappings_are_the_identity_without_a_model_axis():
    x = torch.randn(3, 4, requires_grad=True)
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C

    for y in (C.copy_to_model(x, None), C.reduce_from_model(x, None),
              C.scatter_to_model(x, -1, None), C.gather_from_model(x, -1, None)):
        assert y is x


# ---------------------------------------------------------------- blocks


def _jax_split_dims(kw, n):
    """Per port parameter name, the dim JAX's ``megatron_rule(n)`` splits
    over 'model', in the port's layout (None: replicated)."""
    jm = jax_get_model("causal_lm", **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    specs = jtp.make_param_specs(shapes["params"], jtp.megatron_rule(n))
    port = get_model("causal_lm", device="cpu", **kw)
    out = {}
    for name, (path, layout, _) in flax_layout(port).items():
        node = specs
        for key in path:
            node = node[key]
        assert isinstance(node, JP)
        spec = tp._port_spec(tp.P(*node), layout)
        out[name] = spec.index("model") if "model" in spec else None
    return out


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_every_leaf_splits_on_the_dim_jaxs_megatron_rule_names(port, case):
    want = _jax_split_dims(BLOCK_CASES[case], 2)
    assert any(d is not None for d in want.values())
    for r in port["ranks"][2]:
        assert r[f"blocks_{case}"]["split"] == want


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_fused_blocks_hold_this_ranks_heads_head_major(port, case):
    dim = LM_KW["dim"]
    for r in port["ranks"][2]:
        rec, i = r[f"blocks_{case}"], r["rank"]
        assert rec["pair"] == [True, True]
        kw = BLOCK_CASES[case]
        assert rec["heads"] == [(kw["heads"] // 2, kw.get("heads_kv", kw["heads"]) // 2)] * 2
        for name, block in rec["blocks"].items():
            whole = rec["whole"][name]
            assert block.nbytes * 2 == whole.nbytes  # JAX's shard's bytes
            parts = 1 if "q_proj" in name else (3 if "qkv" in name else 2)
            width = whole.shape[0] // parts
            rows = [c * width + i * width // 2 + j for c in range(parts)
                    for j in range(width // 2)]
            np.testing.assert_array_equal(block, whole[rows], err_msg=name)
        if "qkv.weight" in str(list(rec["blocks"])):
            assert rec["blocks"]["blocks.0.qkv.weight"].shape == (3 * dim // 2, dim)
        assert rec["regathered_equal"]
        np.testing.assert_allclose(rec["logits"], rec["want"], rtol=0, atol=1e-5)


def test_a_contiguous_qkv_block_moves_the_loss(port):
    for r in port["ranks"][2]:
        sound, planted = r["blocks_mha"], r["blocks_contiguous"]
        assert abs(sound["loss"] - sound["want_loss"]) < 1e-6
        assert abs(planted["loss"] - planted["want_loss"]) > 1e-3
        assert planted["regathered_equal"]  # the whole form is still right


# ---------------------------------------------------------------- the LM


@pytest.mark.parametrize("name", sorted(LM_FITS))
def test_lm_tp2_steps_match_tp1(port, name):
    want = port["tp1"][name]
    for r in port["ranks"][2]:
        rec = r[f"lm_{name}"]
        assert len(rec["losses"]) == 3 and rec["step"] == 3
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=LOSS_ADAM)
        assert rec["chips"] == 2 and rec["path_label"] == "dp1_tp2"
        assert rec["mesh"] == {"data": 1, "model": 2, "seq": 1, "pipe": 1}
        for k, v in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=PARAM_ADAM,
                                       err_msg=k)


def test_lm_greedy_decode_after_tp2_equals_tp1(port):
    want = port["tp1"]["mha"]["generated"]
    assert len(want[0]) == len(PROMPT) + 6
    for r in port["ranks"][2]:
        assert r["lm_mha"]["generated"] == want


def test_lm_tp_step_from_a_jax_state_matches_jaxs_single_device_step(port):
    _, losses, params = port["refs"]["lm"]
    rec = _rank0(port, 2, "lm_steps")
    np.testing.assert_allclose(rec["losses"], losses, rtol=LOSS_ADAM)
    from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict

    want = causal_lm_state_dict(params[0], dict(num_classes=16, **LM_KW))
    for k, v in want.items():
        np.testing.assert_allclose(rec["params"][k], v.numpy(), rtol=0, atol=PARAM_ADAM,
                                   err_msg=k)
    assert rec["shapes"]["blocks.0.qkv.weight"] == (48, 32)  # each rank holds half
    assert rec["shapes"]["blocks.0.proj.weight"] == (32, 16)


def test_tp2_checkpoint_resumes_at_tp2_bit_equal_and_at_tp1(port):
    for r in port["ranks"][2]:
        rec = r["resume"]
        assert rec["step"] == 2 * rec["spe"]
        assert rec["losses"][-1] == rec["uninterrupted"][-1]
        for k, v in rec["uninterrupted_params"].items():
            np.testing.assert_array_equal(rec["params"][k], v, err_msg=k)
    rec, one = _rank0(port, 2, "resume"), port["tp1"]["resume"]
    np.testing.assert_allclose(one["loss"], rec["losses"][-1], rtol=LOSS_ADAM)
    for k, v in rec["params"].items():
        np.testing.assert_allclose(one["params"][k], v, rtol=0, atol=PARAM_ADAM, err_msg=k)


# ---------------------------------------------------------------- world 4


@pytest.mark.parametrize("name, loss_tol, param_tol", [
    ("vit", LOSS_ADAM, PARAM_ADAM), ("resnet", LOSS_SGD, PARAM_SGD)])
def test_full_rule_at_tp4_matches_jaxs_single_device_step(port, name, loss_tol, param_tol):
    from distributed_tensorflow_ibm_mnist_tpu_torch import convert

    _, losses, params = port["refs"][name]
    for r in port["ranks"][4]:
        rec = r[f"{name}_tp4"]
        np.testing.assert_allclose(rec["losses"], losses, rtol=loss_tol)
    rec = _rank0(port, 4, f"{name}_tp4")
    if name == "vit":
        want = convert.vit_state_dict(params[0], dict(VIT_KW, image_size=(28, 28),
                                                      in_channels=1))
        # 2 heads over 4 ranks: the generic path, attention whole on every rank
        assert rec["pair"] == [False, False]
        assert rec["shapes"]["blocks.0.qkv.weight"] == (24, 32)
        assert rec["shapes"]["blocks.0.proj.weight"] == (32, 8)
        assert rec["shapes"]["patch_embed.weight"] == (8, 1, 7, 7)
        assert rec["shapes"]["logits.weight"] == (10, 8)
    else:
        want = convert.resnet_state_dict(*params, dict(
            convert.ARCHS["resnet20"], low_res=True, num_classes=10, in_channels=1))
        assert rec["shapes"]["stem.weight"] == (4, 1, 3, 3)
        assert rec["shapes"]["stage1_block0.conv1.weight"] == (8, 16, 3, 3)
        assert rec["split"]["stem_bn.weight"] is None
    for k, v in want.items():
        np.testing.assert_allclose(rec["params"][k], v.numpy(), rtol=0, atol=param_tol,
                                   err_msg=k)


def test_mlp_trainer_dp2_tp2_matches_jaxs_trainer_on_the_same_mesh(port):
    _, losses, params = port["refs"]["mlp_trainer"]
    from distributed_tensorflow_ibm_mnist_tpu_torch.convert import mlp_state_dict

    want = mlp_state_dict(params, dict(hidden=(128, 128), num_classes=10, in_features=784))
    for r in port["ranks"][4]:
        rec = r["mlp_trainer"]
        np.testing.assert_allclose(rec["losses"], losses, rtol=LOSS_ADAM)
        assert rec["chips"] == 4 and rec["path_label"] == "dp2_tp2"
        for k, v in want.items():
            np.testing.assert_allclose(rec["params"][k], v.numpy(), rtol=0, atol=PARAM_ADAM,
                                       err_msg=k)
        assert np.isfinite(rec["test_loss"]) and 0.0 <= rec["test_accuracy"] <= 1.0


def test_resnet_batchnorm_at_dp2_tp2_is_the_data_groups(port):
    want = port["tp1"]["resnet_bn"]
    for r in port["ranks"][4]:
        rec = r["resnet_bn"]
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=LOSS_SGD)
        for k, v in want["buffers"].items():
            # state like the parameters: JAX's SGD parameter limit
            np.testing.assert_allclose(rec["buffers"][k], v, rtol=0, atol=PARAM_SGD, err_msg=k)
        for k, v in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=PARAM_SGD, err_msg=k)


def test_a_world_group_batchnorm_fails_that_check(port):
    want = port["tp1"]["resnet_bn"]["params"]
    rec = _rank0(port, 4, "resnet_bn_fault")
    err = max(float(np.abs(rec["params"][k] - v).max()) for k, v in want.items())
    assert err > 20 * PARAM_SGD  # 2.9e-3 read


def test_lm_tp2_sp2_matches_tp1(port):
    want = port["tp1"]["lm_sp"]
    for r in port["ranks"][4]:
        rec = r["lm_tp2_sp2"]
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=LOSS_ADAM)
        assert rec["path_label"] == "dp1_tp2_sp2" and rec["chips"] == 4
        for k, v in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=PARAM_ADAM, err_msg=k)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_compositions_left_out_name_item_7(port, name):
    """Item 7.7 composed fsdp, MoE blocks and multislice with tp: fsdp and
    MoE build and train an epoch (the path label names the layout);
    multislice gets past its old refusal to the node check, which on this
    one node refuses it as JAX refuses it on virtual devices."""
    label = {"fsdp": "dp2_tp2_fsdp", "moe": "dp2_tp2_ep"}
    for r in port["ranks"][4]:
        got = r["refusals"][name]
        if name == "pp":  # pipeline parallelism is ported: the MLP has no block stack
            assert got == ("ValueError: pp=2 needs a model with a pipelineable block "
                           "stack (pipeline_fn/pp_stages, e.g. 'vit'); got 'mlp'"), got
            continue
        if name == "multislice":
            assert got.startswith("ValueError") and "slice" in got, got
            continue
        assert got == "no error", got
        rec = r[f"composed_{name}"]
        assert rec["path_label"] == label[name] and rec["chips"] == 4
        assert np.all(np.isfinite(rec["losses"]))


def test_stream_mode_beside_tp_is_refused_as_jax_refuses_it():
    with pytest.raises(ValueError, match="stream.*tp"):
        JaxTrainer(JaxRunConfig(model="mlp", synthetic=True, n_train=256, n_test=64,
                                batch_size=32, tp=2, input_mode="stream", quiet=True))


def test_stream_and_sharded_update_beside_tp_are_refused(port):
    for r in port["ranks"][4]:
        assert r["refusals"]["stream"] == (
            "ValueError: input_mode='stream' does not compose with tp/sp/pp/fsdp/"
            "expert parallelism; use device mode")
        assert r["refusals"]["sharded_update"].startswith(
            "ValueError: sharded_update composes with plain dp")


def test_cli_sets_tp_and_trains_at_dp_world_over_tp(port):
    for r in port["ranks"][4]:
        assert r["cli"] == {"tp": 2, "dp": 2, "rc": 0}


# ---------------------------------------------------------------- one process


def test_world_config_gives_the_data_axis_what_tp_and_sp_leave():
    cfg = cli.build_config(CLI_ARGV)
    assert cli.world_config(cfg, 4).dp == 2
    assert cli.world_config(cfg.replace(sp=2), 8).dp == 2
    assert cli.world_config(cfg.replace(tp=1), 4).dp == 4


def test_tp_without_a_process_group_names_the_launcher():
    with pytest.raises(ValueError, match="launch.torchrun"):
        Trainer(RunConfig(**_lm_cfg(tp=2)), device="cpu")


def test_head_major_order_is_each_ranks_heads_of_each_part():
    order = tp.head_major_order(12, 3, 2).tolist()
    assert order == [0, 1, 4, 5, 8, 9, 2, 3, 6, 7, 10, 11]
    assert sorted(order) == list(range(12))


def test_shard_dim_reads_data_and_model_and_refuses_pipe():
    """A spec's ``pipe`` dim (JAX's ``pipeline_block_rule``) splits over no
    axis a plan reads: a pipe rank holds its stage by the stage split, so
    the data and model plans see it as whole."""
    assert tp.shard_dim(tp.P(None, "model"), "model") == 1
    assert tp.shard_dim(tp.P(None, "model")) is None
    assert tp.shard_dim(tp.P("data", "model")) == 0
    assert tp.shard_dim(tp.P("pipe")) is None and tp.shard_dim(tp.P("pipe"), "model") is None
