"""dp x tp x sp composed in the port (2 x 2 x 2 over eight gloo ranks,
spawned once for the module, ``tests/torch_tp_ranks.py``), against the
JAX package's ``tests/test_combined_parallelism.py:25-95`` on the CPU.

* THE STEP: the ViT with Megatron-split MLPs (``megatron_dense_rule``
  over ``model``), ring attention over ``seq`` and the batch over
  ``data``, two SGD steps from a state converted from JAX's, against
  JAX's single-device step: losses within 1e-4, parameters within 5e-5
  (JAX's own limits there).  Each rank holds half of each ``dense_i``
  kernel.
* THE TRAINER: ``RunConfig(dp=2, tp=2, sp=2)`` trains the ViT end to end
  (the full Megatron rule, the head-aligned attention on one head a
  rank, the ring over its tokens, eval included) on a
  ``{"data": 2, "model": 2, "seq": 2}`` mesh; its epochs' losses equal
  the port's single-process run on the same seeds within 1e-5 (adam).
* EVERY TRAINABLE MODEL at dp=1 x tp=2 and dp=2 x tp=2 (worlds of 2 and
  4) through the Trainer against the port's one-process run: two SGD
  steps in float32 (the ResNets one), losses within 1e-4 and parameters
  within 5e-5 (JAX's SGD limits); ResNet-50 at dp=2 within twice plain
  dp=2's own distance from one process (its cross-replica BatchNorm's
  float32 sums move a step 1.6e-3 at that depth, tp or not).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.core.steps import make_train_step as jax_make_train_step
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import vit_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun

torch.set_num_threads(1)

LOSS_SGD, PARAM_SGD = 1e-4, 5e-5  # JAX's combined-parallelism limits (SGD)
LOSS_ADAM = 1e-5
VIT_KW = dict(patch_size=7, dim=32, depth=2, heads=2, num_classes=10)
SGD = dict(optimizer="sgd", lr=0.1, schedule="constant")
FIT_KW = {k: v for k, v in VIT_KW.items() if k != "num_classes"}
FIT = dict(model="vit", model_kwargs=dict(FIT_KW, dtype=torch.float32), synthetic=True,
           n_train=256, n_test=64, batch_size=64, epochs=2, lr=1e-3, quiet=True,
           eval_batch_size=64, seed=2, target_accuracy=None)

LM_ZOO = dict(model="causal_lm", dataset="retrieval",
              dataset_kwargs={"vocab": 16, "seq_len": 16},
              model_kwargs={"dim": 32, "depth": 2, "heads": 4, "dtype": torch.float32},
              batch_size=16, quiet=True, seed=4, target_accuracy=None)


def _img_cfg(model, model_kw, **kw):
    return dict(dict(model=model, synthetic=True, batch_size=16, quiet=True, seed=3,
                     target_accuracy=None, model_kwargs=dict(model_kw, dtype=torch.float32)),
                **kw)


# every trainable model through the Trainer at dp=1 x tp=2 (world 2) and dp=2
# x tp=2 (world 4) against the port's one-process run: float32, SGD at a
# constant lr, two full steps (dropout off: at dp=2 each data row draws its
# own masks); the ResNets one step at 1e-2, as JAX's own ResNet tp test:
# their BatchNorm at 8 rows a data row amplifies float32 rounding ~30x a step
ZOO = {
    "mlp": {"hidden": (64, 64)},
    "lenet5": {"dropout_rate": 0.0},
    "resnet20": {},
    "resnet50": {},
    "vit": {"patch_size": 7, "dim": 32, "depth": 2, "heads": 2},
    "causal_lm": None,
}
ZOO_STEPS = dict(optimizer="sgd", lr=0.05, schedule="constant", epochs=1, n_test=16,
                 eval_batch_size=16)


def _zoo_cfg(model, **kw):
    if ZOO[model] is None:
        return dict(LM_ZOO, **ZOO_STEPS, n_train=32, **kw)
    if model.startswith("resnet"):
        return _img_cfg(model, ZOO[model], n_train=16, **dict(ZOO_STEPS, lr=1e-2), **kw)
    return _img_cfg(model, ZOO[model], n_train=32, **ZOO_STEPS, **kw)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 255, size=(8, 28, 28, 1), dtype=np.uint8),
             rng.integers(0, 10, size=(8,)).astype(np.int32)) for _ in range(2)]


@functools.cache
def _jax_step():
    """JAX's single-device steps of its combined test: the initial state
    (plain numpy), each step's loss and the parameters after."""
    model = jax_get_model("vit", **VIT_KW, dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**SGD), 10)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    init = ranks.plain_state(jax.tree.map(np.asarray, state))
    step = jax.jit(jax_make_train_step(model, tx))
    losses = []
    for img, lab in _batches():
        state, m = step(state, {"image": jnp.asarray(img), "label": jnp.asarray(lab)})
        losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_tp_sp")
    init, _, _ = _jax_step()
    jobs = {"mesh": {"kind": "mesh", "shape": (2, 2, 2)},
            "step": {"kind": "steps", "shape": (2, 2, 2), "state": init, "specs": "dense",
                     "attn_fn": "ring", "batches": _batches(),
                     "config": dict(model="vit", model_kwargs=dict(FIT_KW,
                                                                   dtype=torch.float32), **SGD),
                     "model_kw": {"num_classes": 10, "image_size": (28, 28),
                                  "in_channels": 1}},
            "fit": {"kind": "fit", "config": dict(FIT, dp=2, tp=2, sp=2)}}
    out = torchrun.spawn(ranks.run, 8, "gloo", "cpu", tmp / "store8", args=(8, jobs),
                         timeout=420)
    zoo = {2: {f"zoo_{m}": {"kind": "fit", "config": _zoo_cfg(m, tp=2)} for m in ZOO},
           4: {f"zoo_{m}": {"kind": "fit", "config": _zoo_cfg(m, dp=2, tp=2)} for m in ZOO}}
    zoo[2]["zoo_resnet50_dp2_tp1"] = {"kind": "fit", "config": _zoo_cfg("resnet50", dp=2)}
    by_world = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                                  args=(w, jobs_w), timeout=420)
                for w, jobs_w in zoo.items()}
    one = {f"zoo_{m}": ranks._fit({"config": _zoo_cfg(m)}) for m in ZOO}
    return {"ranks": out, "one": ranks._fit({"config": FIT}), "zoo": by_world, "zoo_one": one}


def test_ranks_import_no_jax(port):
    assert all(r["forbidden"] == [] for r in port["ranks"])


def test_mesh_is_data_model_seq_in_jaxs_order(port):
    for r in port["ranks"]:
        rec = r["mesh"]
        assert (rec["data_index"] * 2 + rec["model_index"]) * 2 + rec["seq_index"] == r["rank"]


def test_dp_tp_sp_step_matches_jaxs_single_device_step(port):
    _, losses, params = _jax_step()
    want = vit_state_dict(params, dict(VIT_KW, image_size=(28, 28), in_channels=1))
    for r in port["ranks"]:
        rec = r["step"]
        np.testing.assert_allclose(rec["losses"], losses, rtol=LOSS_SGD)
        assert rec["shapes"]["blocks.0.dense_0.weight"] == (64, 32)
        assert rec["shapes"]["blocks.0.dense_1.weight"] == (32, 64)
        assert rec["shapes"]["blocks.0.qkv.weight"] == (96, 32)  # the MLP rule only
        for k, v in want.items():
            np.testing.assert_allclose(rec["params"][k], v.numpy(), rtol=0, atol=PARAM_SGD,
                                       err_msg=k)


def test_trainer_config_driven_dp_tp_sp(port):
    one = port["one"]
    for r in port["ranks"]:
        rec = r["fit"]
        assert rec["mesh"] == {"data": 2, "model": 2, "seq": 2, "pipe": 1}
        assert rec["chips"] == 8 and rec["path_label"] == "dp2_tp2_sp2"
        assert len(rec["losses"]) == 2 and 0.0 <= rec["test_accuracy"] <= 1.0
        np.testing.assert_allclose(rec["losses"], one["losses"], rtol=LOSS_ADAM)
        np.testing.assert_allclose(rec["test_loss"], one["test_loss"], rtol=LOSS_ADAM)


@pytest.mark.parametrize("world", [2, 4], ids=["dp1_tp2", "dp2_tp2"])
@pytest.mark.parametrize("model", sorted(ZOO))
def test_every_trainable_model_at_tp2_matches_one_process(port, model, world):
    want = port["zoo_one"][f"zoo_{model}"]
    for r in port["zoo"][world]:
        rec = r[f"zoo_{model}"]
        assert rec["step"] == (1 if model.startswith("resnet") else 2)
        assert rec["chips"] == world
        assert rec["path_label"] == f"dp{world // 2}_tp2"
        np.testing.assert_allclose(rec["losses"], want["losses"], rtol=LOSS_SGD)
        np.testing.assert_allclose(rec["test_loss"], want["test_loss"], rtol=LOSS_SGD)
        if model == "resnet50" and world == 4:
            # cross-replica BatchNorm's float32 sums at ResNet-50's depth move
            # the step 1.6e-3 off one process at plain dp=2 already (tp=1):
            # tp beside it stays within twice that run's own distance
            dist = _max_diff(port["zoo"][2][0]["zoo_resnet50_dp2_tp1"]["params"],
                             want["params"])
            assert _max_diff(rec["params"], want["params"]) <= 2 * dist
            continue
        for k, v in want["params"].items():
            np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=PARAM_SGD, err_msg=k)


def _max_diff(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - v).max()) for k, v in want.items())
