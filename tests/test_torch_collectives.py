"""The port's collectives and launcher against the JAX package's, on the CPU.

* Every collective of ``parallel/collectives.py`` (sum, mean, max, tiled and
  stacked all-gather, reduce-scatter on two axes, broadcast from rank 1,
  ``grad_norm_global``) on two gloo ranks spawned by
  ``launch.torchrun.spawn``, against the ``shard_map`` collectives of the
  JAX package over ``make_mesh(dp=2)`` on the same per-rank numpy arrays
  (float32, within 1e-6: a sum of two addends rounds alike in both);
* the bucket layout: for the same tensor sizes and dtypes in the same
  order, ``make_bucket_layout`` gives JAX's slots and ``bucket_sizes``
  exactly; JAX's roundtrip, balance, mixed-dtype and error cases;
* the launcher: a rank that raises fails ``spawn`` with its traceback, a
  torn result file reads as no result, a rank that outlives the limit is
  killed, a single process joins nothing,
  the mesh refuses what it cannot build, and no spawned rank imports JAX.

The ranks run in one module-scoped spawn (``tests/torch_dp_ranks.py``,
which imports no JAX); the JAX side runs in this process on the virtual
CPU devices of ``conftest.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.parallel import collectives as jax_coll
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import shard_map_compat
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import axis_mesh, make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import rank_device

torch.set_num_threads(1)

RTOL = 1e-6
XS = np.random.default_rng(0).normal(size=(2, 4, 6)).astype(np.float32)
GRADS = [[np.random.default_rng(10 + r).normal(size=s).astype(np.float32)
          for s in ((5, 3), (7,), (2, 2, 2))] for r in range(2)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Both ranks' results of ``torch_dp_ranks.collectives``."""
    store = tmp_path_factory.mktemp("collectives") / "store"
    return torchrun.spawn(ranks.collectives, 2, "gloo", "cpu", store, args=(XS, GRADS),
                          timeout=240)


def _jax_per_rank(body, *inputs):
    """``body`` under shard_map over make_mesh(dp=2), each input's leading
    axis split over 'data'; the result's leading axis re-joined, so block r
    is device r's output."""
    mesh = jax_make_mesh(dp=2)
    f = shard_map_compat(lambda *a: body(*[x[0] for x in a])[None], mesh,
                         in_specs=tuple(P("data") for _ in inputs), out_specs=P("data"))
    return np.asarray(jax.jit(f)(*inputs))


JAX_OPS = {
    "sum": lambda x: jax_coll.all_reduce_sum(x, "data"),
    "mean": lambda x: jax_coll.all_reduce_mean(x, "data"),
    "max": lambda x: jax_coll.all_reduce_max(x, "data"),
    "all_gather": lambda x: jax_coll.all_gather(x, "data"),
    "all_gather_flat": lambda x: jax_coll.all_gather(x.reshape(-1), "data"),
    "reduce_scatter": lambda x: jax_coll.reduce_scatter(x, "data"),
    "reduce_scatter_flat": lambda x: jax_coll.reduce_scatter(x.reshape(-1), "data"),
    "broadcast": lambda x: jax_coll.broadcast(x, "data", root=1),
    "broadcast_root0": lambda x: jax_coll.broadcast(x, "data", root=0),
}


@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_collective_matches_jax(port, op, eight_devices):
    want = _jax_per_rank(JAX_OPS[op], jnp.asarray(XS))
    for r in range(2):
        assert port[r][op].shape == want[r].shape, op
        np.testing.assert_allclose(port[r][op], want[r], rtol=RTOL, err_msg=f"rank {r}")


def test_grad_norm_global_matches_jax(port, eight_devices):
    stacked = [jnp.asarray(np.stack([GRADS[0][i], GRADS[1][i]])) for i in range(3)]
    want = _jax_per_rank(lambda *g: jax_coll.grad_norm_global(list(g), "data"), *stacked)
    for r in range(2):
        np.testing.assert_allclose(port[r]["grad_norm_global"][0], want[r], rtol=RTOL)
    total = np.sqrt(sum(np.square(g).sum() for gs in GRADS for g in gs))
    np.testing.assert_allclose(want[0], total, rtol=RTOL)


def test_lists_of_tensors_broadcast_objects_and_the_mesh(port):
    for r in range(2):
        a, b = port[r]["tree_sum"]
        np.testing.assert_array_equal(a, XS[0] + XS[1])
        np.testing.assert_array_equal(b, 2 * XS[0] + 2 * XS[1])
        assert port[r]["size_index"] == (2, r)
        assert port[r]["object"] == {"from": 0}
        assert port[r]["mesh"] == ({"data": 2, "model": 1, "seq": 1, "pipe": 1}, r)
        assert port[r]["mesh_dp3"].startswith("ValueError") and "world size" in port[r]["mesh_dp3"]


def test_spawned_ranks_import_no_jax(port):
    assert port[0]["forbidden"] == [] and port[1]["forbidden"] == []


# ---------------------------------------------------------------- buckets

LAYOUT_CASES = {
    "mixed-sizes": ([(10, 10), (7,), (33, 3), (5,)], ["float32"] * 4, 8, 2),
    "one-bucket": ([(10, 10), (7,), (33, 3), (5,)], ["float32"] * 4, 3, 1),
    "more-buckets-than-leaves": ([(4, 4), (3,)], ["float32"] * 2, 2, 4),
    "ties": ([(6,), (6,), (6,), (2, 3)], ["float32"] * 4, 4, 3),
    "mixed-dtypes": ([(16,), (8,), (3, 5), (9,)], ["float32", "bfloat16", "float32",
                                                   "bfloat16"], 4, 2),
    "lenet5": ([(5, 5, 1, 32), (32,), (5, 5, 32, 64), (64,), (3136, 1024), (1024,),
                (1024, 10), (10,)], ["float32"] * 8, 8, 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_bucket_layout_matches_jax(case):
    shapes, dtypes, n_shards, n_buckets = LAYOUT_CASES[case]
    tree = [jnp.zeros(s, getattr(jnp, d)) for s, d in zip(shapes, dtypes)]
    tensors = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in zip(shapes, dtypes)]
    want = jax_coll.make_bucket_layout(tree, n_shards, n_buckets)
    got = C.make_bucket_layout(tensors, n_shards, n_buckets)
    assert got.bucket_sizes == want.bucket_sizes and got.shard_sizes == want.shard_sizes
    assert [(s.bucket, s.offset, s.size, s.shape, str(s.dtype).removeprefix("torch."))
            for s in got.slots] == [(s.bucket, s.offset, s.size, s.shape, str(s.dtype))
                                    for s in want.slots]


def test_bucket_layout_roundtrip_and_balance():
    """flatten -> unflatten is the identity; buckets are padded to the
    shard count and size-balanced (JAX's ``test_sharded_update.py:53``)."""
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn(s, generator=gen) for s in ((10, 10), (7,), (33, 3), (5,))]
    lay = C.make_bucket_layout(tensors, n_shards=8, n_buckets=2)
    assert all(s % 8 == 0 for s in lay.bucket_sizes) and lay.n_buckets == 2
    assert sum(lay.bucket_sizes) >= sum(t.numel() for t in tensors)
    assert min(lay.bucket_sizes) > 0
    buckets = C.flatten_buckets(tensors, lay)
    assert tuple(b.shape[0] for b in buckets) == lay.bucket_sizes
    for a, b in zip(tensors, C.unflatten_buckets(buckets, lay)):
        assert torch.equal(a, b)
    used = sum(s.size for s in lay.slots)
    assert sum(int((b == 0).sum()) for b in buckets) >= sum(lay.bucket_sizes) - used


def test_bucket_layout_mixed_dtypes_and_errors():
    """One bucket group per dtype (``test_sharded_update.py:75`` there)."""
    tensors = [torch.ones(16), torch.ones(8, dtype=torch.bfloat16)]
    lay = C.make_bucket_layout(tensors, n_shards=4, n_buckets=2)
    assert lay.n_buckets == 2
    back = C.unflatten_buckets(C.flatten_buckets(tensors, lay), lay)
    assert back[1].dtype == torch.bfloat16 and torch.equal(back[1], tensors[1])
    with pytest.raises(ValueError, match="n_shards"):
        C.make_bucket_layout(tensors, n_shards=0)
    with pytest.raises(ValueError, match="n_buckets"):
        C.make_bucket_layout(tensors, n_shards=2, n_buckets=0)


# ---------------------------------------------------------------- launcher


def test_spawn_fails_with_the_rank_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        torchrun.spawn(ranks.raise_on_rank_1, 2, "gloo", "cpu", tmp_path / "store",
                       timeout=120)


def test_spawn_reports_a_torn_result_as_no_result(tmp_path):
    # a rank killed mid-write used to surface as the parent's EOFError
    store = tmp_path / "store"
    with pytest.raises(RuntimeError, match="rank 0: exit code 9, no result"):
        torchrun.spawn(ranks.torn_result_on_rank_0, 2, "gloo", "cpu", store,
                       args=(str(store),), timeout=120)
    assert not list(tmp_path.iterdir())


def test_spawn_kills_ranks_past_the_limit(tmp_path):
    with pytest.raises(TimeoutError, match="ran past 1"):
        torchrun.spawn(ranks.sleep_past_the_limit, 2, "gloo", "cpu", tmp_path / "store",
                       args=(60.0,), timeout=1)


def test_spawn_refuses_an_existing_store(tmp_path):
    (tmp_path / "store").write_text("")
    with pytest.raises(ValueError, match="exists already"):
        torchrun.spawn(ranks.raise_on_rank_1, 2, "gloo", "cpu", tmp_path / "store")


@pytest.fixture
def no_launcher_env(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)


def test_bootstrap_alone_joins_nothing(no_launcher_env):
    info = torchrun.bootstrap(device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1, "backend": None, "device": "cpu"}
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="rendezvous"):
        torchrun.bootstrap(device="cpu", world_size=2, rank=0)


def test_rank_device_is_local_rank_and_never_remapped(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert rank_device() == torch.device("cuda", 1)
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        rank_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        rank_device()


@pytest.mark.parametrize("kw, error, match", [
    (dict(dp=2), ValueError, "launch.torchrun"),
    (dict(tp=2), ValueError, "launch.torchrun"),  # tensor parallelism is ported: needs a group
    (dict(sp=2), ValueError, "launch.torchrun"),  # sequence parallelism is ported: needs a group
    (dict(pp=2), ValueError, "launch.torchrun"),  # pipeline parallelism is ported: needs a group
    (dict(dcn_dp=2), ValueError, "launch.torchrun"),  # multislice is ported: needs a group
    (dict(dcn_dp=0), ValueError, "dcn_dp"),
], ids=["no-group", "tp", "sp", "pp", "dcn_dp", "dcn_dp0"])
def test_make_mesh_refusals(kw, error, match):
    with pytest.raises(error, match=match):
        make_mesh(**kw)


def test_axis_name_needs_a_group_and_names_data():
    with pytest.raises(ValueError, match="launch.torchrun"):
        axis_mesh("data")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        axis_mesh("model")


def test_all_gather_and_reduce_scatter_shapes_in_one_process(tmp_path):
    """A world of one over gloo: every collective is the identity."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         world_size=1, rank=0)
    try:
        mesh = make_mesh()
        x = torch.from_numpy(XS[0])
        for fn in (C.all_reduce_sum, C.all_reduce_mean, C.all_reduce_max, C.all_gather,
                   C.reduce_scatter, C.broadcast):
            assert torch.equal(fn(x), x), fn.__name__
        assert C.all_gather(x.reshape(-1)).shape == (24,)
        assert axis_mesh("data") == mesh
    finally:
        torch.distributed.destroy_process_group()

