"""The port's data-parallel training against the JAX package's, on the CPU.

Two gloo ranks, spawned once for the module (``tests/torch_dp_ranks.py``,
which imports no JAX), run every port-side case; the JAX side runs here on
the virtual CPU devices of ``conftest.py`` over ``make_mesh(dp=2)``.

* Three ``make_dp_train_step`` steps of the MLP (sgd) and of LeNet-5
  (nesterov momentum, weight decay, no dropout) in float32 on converted
  weights: the parameters within ``rtol 2e-5, atol 2e-6`` (JAX's own limit,
  ``tests/test_data_parallel.py:59``) of JAX's dp=2 step and of the port's
  single-process step on the whole global batch, and the per-step losses
  within 1e-5;
* the data layout: ``shard_dataset`` gives rank r rows ``[r n/2, (r+1)
  n/2)`` after dropping the odd row; ``shard_eval_set`` pads 101 rows to
  102 and keeps the true count; ``Trainer(dp=2).evaluate()`` equals
  ``Trainer(dp=1).evaluate()`` within 1e-6 (accuracy) and 1e-5 (loss);
* ``Trainer.fit()`` at dp=2: every rank returns the same summary,
  ``n_chips`` is 2, only rank 0 writes records, ``steps_per_epoch`` is
  dp=1's;
* cross-replica BatchNorm: a toy ResNet (width 4, one block a stage) in
  float64 (JAX under ``jax.enable_x64``) at dp=2 with ``axis_name="data"``:
  a training forward's logits and running statistics, and one momentum +
  weight-decay step's parameters and statistics, against the port's dp=1
  run on the whole batch within 1e-9 (3e-16 measured) and against JAX's
  dp=2 run within 1e-6, the float64 step limit of
  ``tests/test_torch_resnet.py``: flax's float64 BatchNorm itself sits
  5.7e-8 off a numpy float64 normalisation (the port's: 2e-16), which
  leaves the port 1.2e-7 off JAX in the logits and 5.9e-8 in a step's
  parameters, at dp=1 as at dp=2.  The statistics are equal on both ranks.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.models import resnet as jax_resnet
from distributed_tensorflow_ibm_mnist_tpu.parallel.data_parallel import (
    make_dp_train_step as jax_dp_step,
)
from distributed_tensorflow_ibm_mnist_tpu.parallel.data_parallel import replicate as jax_replicate
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import shard_map_compat
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    lenet5_state_dict,
    load_lenet5,
    load_mlp,
    load_resnet,
    mlp_state_dict,
    resnet_state_dict,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ARCHS as PORT_ARCHS
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

DP_TOL = dict(rtol=2e-5, atol=2e-6)  # JAX's dp-vs-single-device limit
BN_TOL = 1e-9  # float64, the port's dp=2 against its dp=1
BN_JAX_TOL = 1e-6  # float64, against flax (module docstring)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n_steps, batch, seed, shape=(28, 28, 1)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, *shape)).astype(np.uint8),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n_steps)]


# name -> (JAX registry model keywords, the optimizer's RunConfig keywords)
STEP_CASES = {
    "mlp": (dict(hidden=(64,)), dict(optimizer="sgd", lr=0.1)),
    "lenet5": (dict(dropout_rate=0.0), dict(optimizer="momentum", lr=0.01,
                                            weight_decay=1e-4)),
}
BN_ARCH = dict(stage_sizes=(1, 1, 1), width=4)
BN_OPT = dict(optimizer="momentum", lr=0.1, weight_decay=1e-4)


@functools.cache
def _step_case(name):
    """The JAX model, optimizer and initial state of a step case, and its
    batches (3 global batches of 32)."""
    model_kw, opt_kw = STEP_CASES[name]
    model = jax_get_model(name, num_classes=10, dtype=jnp.float32, **model_kw)
    tx = jax_make_optimizer(JaxRunConfig(**opt_kw), 10)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    return model, tx, state, _batches(3, 32, seed=len(name))


@functools.cache
def _bn_case():
    """A toy ResNet's float64 params and statistics (BatchNorm scale, bias
    and running statistics redrawn so every normalisation does work), 8
    float64 images of 8 px and labels."""
    model = jax_resnet.ResNet(block=jax_resnet.BasicBlock, dtype=jnp.float32, **BN_ARCH)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    rng = np.random.default_rng(3)
    as64 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))

    def redraw(p, s):
        p, s = dict(p), dict(s)
        for name in s:
            if "mean" in s[name]:  # a BatchNorm
                n = s[name]["mean"].shape
                p[name] = {"scale": rng.uniform(0.5, 1.5, n), "bias": rng.normal(0, 0.2, n)}
                s[name] = {"mean": rng.normal(0, 0.2, n), "var": rng.uniform(0.5, 1.5, n)}
            else:
                p[name], s[name] = redraw(p[name], s[name])
        return p, s

    params, stats = redraw(as64(_np(variables["params"])), as64(_np(variables["batch_stats"])))
    x = rng.random((8, 8, 8, 3))
    labels = rng.integers(0, 10, 8).astype(np.int32)
    return params, stats, x, labels


ROWS = (np.arange(101 * 4, dtype=np.uint8).reshape(101, 2, 2, 1),
        np.arange(101, dtype=np.int32))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Both ranks' results of ``torch_dp_ranks.data_parallel``."""
    tmp = tmp_path_factory.mktemp("data_parallel")
    step_inputs = {}
    for name in STEP_CASES:
        _, _, state, batches = _step_case(name)
        step_inputs[name] = {"model": name, "params": _np(state.params),
                             "opt": STEP_CASES[name][1], "batches": batches}
    params, stats, x, labels = _bn_case()
    bn = {"params": params, "stats": stats, "x": x, "labels": labels, "arch": BN_ARCH,
          "opt": BN_OPT}
    out = torchrun.spawn(ranks.data_parallel, 2, "gloo", "cpu", tmp / "store",
                         args=(step_inputs, ROWS, bn, str(tmp)), timeout=300)
    out[0]["metrics"] = (tmp / "metrics.jsonl").read_text().splitlines()
    return out


def _port_state_dict(name, params):
    return (mlp_state_dict(params, {"hidden": (64,)}) if name == "mlp"
            else lenet5_state_dict(params, {}))


def _port_single_process(name):
    """The port's dp=1 step on each whole global batch."""
    _, _, state, batches = _step_case(name)
    params = _np(state.params)
    model = (load_mlp(params, device="cpu", dtype=torch.float32, hidden=(64,))
             if name == "mlp" else
             load_lenet5(params, device="cpu", dtype=torch.float32, dropout_rate=0.0))
    opt = make_optimizer(RunConfig(**STEP_CASES[name][1]), 10, list(model.parameters()))
    tstate = TrainState(step=0, model=model, optimizer=opt, data_generator=torch.Generator())
    step = steps.make_train_step(model, opt)
    losses = [float(step(tstate, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
                    ["loss"]) for x, y in batches]
    return losses, model.state_dict()


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_dp2_step_matches_jax_dp2_step(port, name, eight_devices):
    model, tx, state, batches = _step_case(name)
    mesh = jax_make_mesh(dp=2)
    step = jax_dp_step(model, tx, mesh)
    jstate = jax_replicate(mesh, jax.tree.map(jnp.copy, state))
    losses = []
    for x, y in batches:
        jstate, m = step(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
        losses.append(float(m["loss"]))
    want = _port_state_dict(name, _np(jstate.params))
    for r in range(2):
        got = port[r][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert set(got["state"]) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got["state"][key], value.numpy(), **DP_TOL,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_dp2_step_equals_the_single_process_step(port, name):
    losses, want = _port_single_process(name)
    for r in range(2):
        got = port[r][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for key, value in want.items():
            np.testing.assert_allclose(got["state"][key], value.numpy(), **DP_TOL,
                                       err_msg=f"rank {r} {key}")


def test_shard_dataset_keeps_the_row_layout(port):
    images, labels = ROWS
    for r in range(2):
        got_images, got_labels = port[r]["shard"]
        np.testing.assert_array_equal(got_images, images[50 * r:50 * (r + 1)])
        np.testing.assert_array_equal(got_labels, labels[50 * r:50 * (r + 1)])


def test_shard_eval_set_pads_and_never_drops(port):
    images, labels = ROWS
    padded = np.concatenate([images, np.zeros_like(images[:1])])
    padded_labels = np.concatenate([labels, [0]])
    for r in range(2):
        (got_images, got_labels), n_valid = port[r]["eval_shard"]
        assert n_valid == 101 and got_images.shape[0] == 51
        np.testing.assert_array_equal(got_images, padded[51 * r:51 * (r + 1)])
        np.testing.assert_array_equal(got_labels, padded_labels[51 * r:51 * (r + 1)])


def test_sharded_eval_equals_the_single_process_eval(port):
    """101 test images padded to 102 over two ranks, masked by n_valid."""
    want = Trainer(ranks._mini_cfg(dp=1), device="cpu").evaluate()
    for r in range(2):
        assert port[r]["test_rows"] == 51
        got = port[r]["evaluate"]
        assert abs(got["accuracy"] - want["accuracy"]) < 1e-6
        assert abs(got["loss"] - want["loss"]) < 1e-5


def test_fit_at_dp2_agrees_across_ranks_and_writes_once(port):
    single = Trainer(ranks._mini_cfg(dp=1), device="cpu")
    assert port[0]["fit"] == port[1]["fit"]
    assert port[0]["fit"]["epochs_run"] == 2 and np.isfinite(port[0]["fit"]["images_per_sec"])
    assert port[0]["n_chips"] == port[1]["n_chips"] == 2
    assert port[0]["steps_per_epoch"] == port[1]["steps_per_epoch"] == single.steps_per_epoch
    assert port[0]["writes_file"] and not port[1]["writes_file"]
    records = [json.loads(line) for line in port[0]["metrics"]]
    assert [r["kind"] for r in records] == ["epoch", "epoch", "summary"]
    assert records[-1]["images_per_sec_per_chip"] == port[0]["fit"]["images_per_sec_per_chip"]
    for a, b in zip(port[0]["params"], port[1]["params"]):
        np.testing.assert_array_equal(a, b)  # the replicas stay in step


# ---------------------------------------------------------------- BatchNorm


def _jax_bn_run(eight_devices):
    """JAX's dp=2 training forward and one dp=2 step, axis_name='data'."""
    params, stats, x, labels = _bn_case()
    mesh = jax_make_mesh(dp=2)
    with jax.enable_x64(True):
        model = jax_resnet.ResNet(block=jax_resnet.BasicBlock, dtype=jnp.float64,
                                  axis_name="data", **BN_ARCH)

        def forward(images):
            return model.apply({"params": params, "batch_stats": stats}, images, train=True,
                               mutable=["batch_stats"])

        logits, mutated = jax.jit(shard_map_compat(
            forward, mesh, in_specs=P("data"), out_specs=(P("data"), P())))(jnp.asarray(x))
        tx = jax_make_optimizer(JaxRunConfig(**BN_OPT), 10)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params),
                               rng=jax.random.PRNGKey(0))
        new, m = jax_dp_step(model, tx, mesh)(
            jax_replicate(mesh, jstate), {"image": jnp.asarray(x), "label": jnp.asarray(labels)})
        return (np.asarray(logits), _np(mutated["batch_stats"]), _np(new.params),
                _np(new.batch_stats), float(m["loss"]))


def _bn_state_dict(params, stats):
    return resnet_state_dict(params, stats, {**PORT_ARCHS["resnet20"], **BN_ARCH,
                                             "in_channels": 3})


def _port_bn_single_process():
    """The port's dp=1 training forward and one step on the whole batch."""
    params, stats, x, labels = _bn_case()

    def resnet():
        return load_resnet(params, stats, "resnet20", device="cpu", dtype=torch.float64,
                           in_channels=3, **BN_ARCH).double()

    model = resnet()
    logits = model(torch.from_numpy(x), train=True).detach().numpy()
    forward_state = model.state_dict()
    model = resnet()
    opt = make_optimizer(RunConfig(**BN_OPT), 10, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=opt, data_generator=torch.Generator())
    loss = float(steps.make_train_step(model, opt)(
        state, {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)})["loss"])
    return logits, forward_state, model.state_dict(), loss


def _close(got: dict, want: dict, tol, what):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


def test_cross_replica_batchnorm_matches_jax_and_dp1(port, eight_devices):
    j_logits, j_stats, j_params, j_step_stats, j_loss = _jax_bn_run(eight_devices)
    p_logits, p_forward, p_step, p_loss = _port_bn_single_process()
    params, _, _, _ = _bn_case()
    logits = np.concatenate([port[0]["bn_logits"], port[1]["bn_logits"]])
    np.testing.assert_allclose(logits, j_logits, atol=BN_JAX_TOL, rtol=0)
    np.testing.assert_allclose(logits, p_logits, atol=BN_TOL, rtol=0)
    want_forward = _bn_state_dict(params, j_stats)
    want_step = _bn_state_dict(j_params, j_step_stats)
    for r in range(2):
        got_forward = {k: v for k, v in port[r]["bn_forward_state"].items()
                       if "running" in k}
        _close(got_forward, {k: want_forward[k] for k in got_forward}, BN_JAX_TOL, "forward")
        _close(got_forward, {k: p_forward[k] for k in got_forward}, BN_TOL, "forward dp1")
        _close(port[r]["bn_step"]["state"], want_step, BN_JAX_TOL, f"rank {r} step vs JAX")
        _close(port[r]["bn_step"]["state"], p_step, BN_TOL, f"rank {r} step vs dp1")
        # the loss is float32 on every side (the models hand it float32
        # logits), and dp=2's is a mean of two rank means
        np.testing.assert_allclose(port[r]["bn_step"]["losses"], [j_loss], rtol=1e-6)
        np.testing.assert_allclose(port[r]["bn_step"]["losses"], [p_loss], rtol=1e-6)
    for key, value in port[0]["bn_step"]["state"].items():
        if "running" in key:  # equal across ranks, bit for bit
            np.testing.assert_array_equal(value, port[1]["bn_step"]["state"][key])
