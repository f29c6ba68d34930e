"""The port's ZeRO-1 sharded weight update against the JAX package's, on the CPU.

Two gloo ranks, spawned once for the module (``tests/torch_dp_ranks.py``,
which imports no JAX), run the port's side; the JAX side runs here on the
virtual CPU devices of ``conftest.py`` over ``make_mesh(dp=2)``.  The MLP
(hidden 64, float32) on converted weights, three global batches of 64,
nesterov momentum (lr 0.05) with weight decay 1e-4, three buckets over 2
shards.  (Momentum, not Adam, so that the frameworks can be held to the
limit below: Adam's first update is ``lr * sign(g)`` where ``g`` is at
rounding level, and one such element of the 50k in ``dense_0`` lands
8.7e-6 apart.)

* without a clip the sharded update (bucketed reduce-scatter, the update on
  this rank's 1/2 block, all-gather) gives the replicated update's parameters
  bit for bit (``torch.equal``): the same sums, the same elementwise math;
* with ``grad_clip=1.0`` (the clip against the norm of every rank's
  shards, all-reduced) within 1e-6: the clip's scale is computed as JAX's
  sharded step computes it, not as the replicated chain does;
* both against JAX's sharded step (``tests/test_sharded_update.py:88``
  there) within the data-parallel limit ``rtol 2e-5, atol 2e-6``;
* the optimizer state is 1/2 of the buckets on each rank;
* ``Trainer(sharded_update=True)`` trains as the replicated Trainer does
  (JAX's limit for that comparison, ``rtol 5e-4, atol 5e-5``), and its
  ``measure_throughput`` leaves the state as it found it;
* validation as JAX's: dp=1 and ``sharded_update_buckets < 1`` refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.optim import (
    init_sharded_opt_state as jax_init_sharded,
)
from distributed_tensorflow_ibm_mnist_tpu.core.optim import (
    make_sharded_update_optimizer as jax_sharded_optimizer,
)
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel.collectives import (
    ShardedUpdate as JaxShardedUpdate,
)
from distributed_tensorflow_ibm_mnist_tpu.parallel.collectives import (
    make_bucket_layout as jax_bucket_layout,
)
from distributed_tensorflow_ibm_mnist_tpu.parallel.data_parallel import (
    make_dp_train_step,
    place_sharded_update_state,
)
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_mlp, mlp_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    ShardedUpdate,
    make_bucket_layout,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

DP_TOL = dict(rtol=2e-5, atol=2e-6)
OPT = dict(optimizer="momentum", lr=0.05, weight_decay=1e-4)
CASES = {"noclip": OPT, "clip": {**OPT, "grad_clip": 1.0}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mlp():
    model = jax_get_model("mlp", num_classes=10, hidden=(64,), dtype=jnp.float32)
    return model, _np(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])


BATCHES = [(np.random.default_rng(s).integers(0, 255, (64, 28, 28, 1)).astype(np.uint8),
            np.random.default_rng(s).integers(0, 10, 64).astype(np.int32)) for s in range(3)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    store = tmp_path_factory.mktemp("sharded_update") / "store"
    return torchrun.spawn(ranks.sharded_update, 2, "gloo", "cpu", store,
                          args=(_jax_mlp()[1], CASES, BATCHES), timeout=300)


def test_sharded_update_equals_the_replicated_update_without_clip(port):
    for r in range(2):
        case = port[r]["noclip"]
        for key, value in case["replicated"].items():
            assert np.array_equal(case["sharded"][key], value), f"rank {r} {key}"
        assert case["losses"][0] == case["losses"][1]


def test_sharded_update_with_clip_matches_the_replicated_update(port):
    for r in range(2):
        case = port[r]["clip"]
        for key, value in case["replicated"].items():
            np.testing.assert_allclose(case["sharded"][key], value, rtol=0, atol=1e-6,
                                       err_msg=f"rank {r} {key}")
        np.testing.assert_allclose(*case["losses"], rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_update_matches_jax_sharded_step(port, case, eight_devices):
    """JAX's own sharded step over ``make_mesh(dp=2)``, three buckets."""
    model, params = _jax_mlp()
    cfg = JaxRunConfig(**CASES[case])
    tx, clip = jax_sharded_optimizer(cfg, 10)
    mesh = jax_make_mesh(dp=2)
    lay = jax_bucket_layout(params, n_shards=2, n_buckets=3)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=jax_init_sharded(tx, params, lay))
    state = place_sharded_update_state(mesh, state, lay)
    step = make_dp_train_step(model, tx, mesh, sharded_update=JaxShardedUpdate(lay, clip),
                              state=state)
    for x, y in BATCHES:
        state, _ = step(state, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    want = mlp_state_dict(_np(state.params), {"hidden": (64,)})
    for r in range(2):
        got = port[r][case]["sharded"]
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value.numpy(), **DP_TOL,
                                       err_msg=f"rank {r} {key}")


def test_optimizer_state_is_one_shard_per_rank(port):
    for r in range(2):
        case = port[r]["noclip"]
        assert sum(case["moment_sizes"]) == sum(case["bucket_sizes"]) // 2
        assert len(case["bucket_sizes"]) == 3
        assert sum(port[r]["moments"]) < sum(v.size for v in case["sharded"].values())


def test_config_driven_trainer_matches_the_replicated_trainer(port):
    for r in range(2):
        runs = port[r]["trainer"]
        for a, b in zip(runs["sharded"], runs["replicated"]):
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)
        assert port[r]["throughput_chips"] == 2


def test_measure_throughput_leaves_a_sharded_run_as_it_was(port):
    assert port[0]["throughput_kept_state"] and port[1]["throughput_kept_state"]


def test_spawned_ranks_import_no_jax(port):
    assert port[0]["forbidden"] == [] and port[1]["forbidden"] == []


def test_validation_as_jax(port):
    assert port[0]["buckets0"].startswith("ValueError") and "sharded_update_buckets" in \
        port[0]["buckets0"]
    with pytest.raises(ValueError, match="needs dp>1, got dp=1"):
        Trainer(ranks._mini_cfg(sharded_update=True), device="cpu")
    model = load_mlp(_jax_mlp()[1], device="cpu", dtype=torch.float32, hidden=(64,))
    params = list(model.parameters())
    opt = make_optimizer(RunConfig(**OPT), 10, params)
    with pytest.raises(ValueError, match="needs a mesh"):
        steps.make_train_step(model, opt,
                              sharded_update=ShardedUpdate(make_bucket_layout(params, 2)))
