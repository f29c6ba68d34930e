"""The port's multislice mesh (``parallel/mesh.py``: ``hybrid_mesh_shapes``,
``pick_multislice_devices``, ``make_mesh(dcn_dp=N)``) against the JAX
package's, on the CPU.

* ``hybrid_mesh_shapes`` and ``pick_multislice_devices`` are pure: the same
  requests and the same mock records (objects carrying ``slice_index``, as
  JAX's tests dress its devices, ``tests/test_mesh.py:90-173``) give JAX's
  results, and the same refusals;
* on two gloo ranks (spawned once for the module): rank records naming
  two slices build the hybrid mesh (``(1, 1, 1, 1)`` within a node, ``(2,
  1, 1, 1)`` across, node-major order), records on one slice and this one
  node's own records are refused naming the slices found, ranks that are
  not node-major are refused, and a Trainer asking for two nodes here is
  refused; ``dcn_dp`` with an explicit mesh is JAX's ``ValueError``;
* without a group: ``dcn_dp`` at dp=1 cannot divide and ``dcn_dp=0`` is
  refused, as JAX's Trainer refuses them.
"""

import pytest
import torch

import torch_shard_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.parallel import mesh as jmesh
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import mesh as pmesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("request_", [(8, 2, 1, 1, 2), (4, 1, 1, 1, 4), (6, 1, 1, 1, 3),
                                      (2, 1, 1, 1, 1)])
def test_hybrid_mesh_shapes_equal_jax(request_):
    assert pmesh.hybrid_mesh_shapes(*request_) == jmesh.hybrid_mesh_shapes(*request_)


@pytest.mark.parametrize("request_, match", [((6, 1, 1, 1, 4), "divide"),
                                             ((4, 1, 1, 1, 0), ">= 1")])
def test_hybrid_mesh_shapes_refuse_as_jax(request_, match):
    for fn in (pmesh.hybrid_mesh_shapes, jmesh.hybrid_mesh_shapes):
        with pytest.raises(ValueError, match=match):
            fn(*request_)


class _Dev:
    def __init__(self, i, slice_index):
        self.id, self.slice_index = i, slice_index


class _NoSlice:
    def __init__(self, i):
        self.id = i


def _mocked():
    # slices 0/1 alternate, two sliceless devices last: a flat prefix is wrong
    return [_Dev(i, i % 2) for i in range(6)] + [_NoSlice(6), _NoSlice(7)]


def test_pick_multislice_devices_equals_jax():
    devs = _mocked()
    for dcn, per in ((2, 3), (2, 2), (1, 3)):
        got = pmesh.pick_multislice_devices(devs, dcn, per)
        want = jmesh.pick_multislice_devices(devs, dcn, per)
        assert [d.id for d in got] == [d.id for d in want]
    assert [d.slice_index for d in pmesh.pick_multislice_devices(devs, 2, 3)] == [0, 0, 0,
                                                                                 1, 1, 1]


@pytest.mark.parametrize("dcn, per, match", [(3, 2, r"slice indices \[0, 1\]"),
                                             (2, 4, "slice")])
def test_pick_multislice_devices_refuses_as_jax(dcn, per, match):
    for fn in (pmesh.pick_multislice_devices, jmesh.pick_multislice_devices):
        with pytest.raises(ValueError, match=match):
            fn(_mocked(), dcn, per)


def test_trainer_dcn_dp_refusals_without_a_group():
    cfg = RunConfig(model="mlp", synthetic=True, n_train=64, n_test=32, batch_size=32,
                    quiet=True, dp=1, dcn_dp=2)
    with pytest.raises(ValueError, match="divide"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        Trainer(cfg.replace(dcn_dp=0), device="cpu")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multislice")
    return torchrun.spawn(ranks.multislice, 2, "gloo", "cpu", tmp / "store", timeout=120)


def test_ranks_import_no_jax(port):
    assert all(r["forbidden"] == [] for r in port)


def test_two_slices_build_the_hybrid_mesh(port):
    for rank, r in enumerate(port):
        shape, mesh_rank, dcn_dp, ici, dcn, order = r["mesh"]
        assert shape["data"] == 2 and mesh_rank == rank and dcn_dp == 2
        assert (ici, dcn) == jmesh.hybrid_mesh_shapes(2, 1, 1, 1, 2)
        assert order == (0, 1)


def test_one_slice_is_refused(port):
    for r in port:
        for key in ("one_slice", "this_node", "trainer"):
            assert r[key].startswith("ValueError") and "slice indices [0]" in r[key], key
        assert r["not_node_major"].startswith("ValueError") and "node-major" in \
            r["not_node_major"]
        assert r["explicit_mesh"].startswith("ValueError") and "ambiguous" in \
            r["explicit_mesh"]
