"""The port's pipeline parallelism (``parallel/pipeline.py``: the GPipe
schedule across pipe ranks, its pp x tp helpers, the mesh's ``pipe`` axis
and the pipeline's two exchanges in ``parallel/collectives.py``) against
the JAX package's ``make_pipeline_apply`` and helpers, on the CPU.

* THE SCHEDULE, on four gloo ranks (spawned once, ``tests/torch_pp_ranks.py``):
  JAX's ``tests/test_pipeline.py:44-104`` on the same stage parameters,
  made as numpy from a seed: pp=4 with 4 microbatches, forward within
  JAX's 1e-5 of JAX's own pipeline and of the sequential stages, and each
  rank's stage gradients within JAX's rtol 1e-4 / atol 1e-3 of JAX's
  (and exactly 0 on the other stages' slices); dp=2 x pp=2 with 3
  microbatches and the stage recomputed (``remat``), each data row's
  block of the output and the gradients summed over the data rows.
* PLANTED FAULTS that must fail those checks: the output broadcast's
  backward summing over ``pipe`` (gradients x pp), a stage hand-off one
  microbatch off (the forward); and an unequal workload (stage 0 slowed)
  that must finish, right, inside the spawn's timeout.  A forward under
  ``torch.no_grad`` (eval, init) builds no stage graph.
* PP x TP INSIDE STAGES: JAX's ``permute_qkv_head_major`` /
  ``permute_kv_shard_major`` / ``tp_stage_specs`` / ``pipeline_block_rule``
  on the same trees (exact), and ``make_tp_block_stage_fn`` through
  ``make_pipeline_apply(param_specs=...)`` at pp=2 x tp=2 over a JAX
  stacked block tree (MHA and GQA, RoPE, causal), output and every leaf's
  gradient block within 1e-5 (relative to the largest magnitude) of
  JAX's island on ``make_mesh(tp=2, pp=2)``.
* THE MESH: rank ``((d * tp + m) * sp + s) * pp + p`` at (dp, tp, pp) =
  (1, 1, 4), (2, 1, 2), (1, 2, 2), each axis group holding the ranks that
  differ in its index only, the replica group the dp ranks of one (model,
  pipe) index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel import pipeline as jpl
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.parallel.ring_attention import (
    vanilla_attention as jax_vanilla,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import pipeline as pl
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import Leaf

torch.set_num_threads(1)

DIM = 16
FWD_ATOL = 1e-5  # JAX's own limit (tests/test_pipeline.py)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3  # JAX's: accumulation order over f32 stages
TP_REL = 1e-5  # pp x tp island: relative to the largest magnitude


def _stage_params(n_stages, seed):
    rng = np.random.default_rng(seed)
    return [{"w1": rng.normal(0, 0.4, size=(DIM, DIM)).astype(np.float32),
             "b1": rng.normal(0, 0.1, size=(DIM,)).astype(np.float32),
             "w2": rng.normal(0, 0.4, size=(DIM, DIM)).astype(np.float32)}
            for _ in range(n_stages)]


def _jax_stage(p, x):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _x(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, DIM)).astype(np.float32)


# (name, dp, pp, microbatches, remat, batch_axis, rows, params seed, x seed)
CASES = {"pp4": (1, 4, 4, False, None, 8, 2, 3),
         "dp2_pp2_remat": (2, 2, 3, True, "data", 12, 4, 5)}
FAULTS = ("sum_over_pipe", "hop_one_off", "slow")


def _jax_apply(name, eight_devices):
    dp, pp, m, remat, axis, rows, ps, xs = CASES[name]
    mesh = jax_make_mesh(dp=dp, pp=pp)
    stacked = jpl.stack_stage_params([jax.tree.map(jnp.asarray, s)
                                      for s in _stage_params(pp, ps)])
    x = jnp.asarray(_x(rows, xs))
    apply = jpl.make_pipeline_apply(_jax_stage, mesh, n_microbatches=m, remat=remat,
                                    batch_axis=axis)
    y = jax.jit(apply)(stacked, x)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(apply(p, x) ** 2)))(stacked)
    seq = x
    for s in _stage_params(pp, ps):
        seq = _jax_stage(jax.tree.map(jnp.asarray, s), seq)
    return np.asarray(y), jax.tree.map(np.asarray, grads), np.asarray(seq)


# ---------------------------------------------------------------- pp x tp island

PPTP = {"mha": dict(heads=4, heads_kv=0), "gqa": dict(heads=4, heads_kv=2)}
PPTP_DIM, PPTP_SEQ, PPTP_M = 32, 8, 2


def _stacked_blocks(case):
    kw = PPTP[case]
    jm = jax_get_model("causal_lm", num_classes=16, dim=PPTP_DIM, depth=4, heads=kw["heads"],
                       heads_kv=kw["heads_kv"], pp_stages=2, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, PPTP_SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(8)  # nonzero biases, norms off (1, 0): every leaf reaches y
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(
        np.float32), params["pipe_blocks"]["stacked"])


def _jax_pptp(case):
    kw = PPTP[case]
    heads, hkv, hd = kw["heads"], kw["heads_kv"], PPTP_DIM // kw["heads"]
    mesh = jax_make_mesh(dp=1, tp=2, pp=2)
    stacked = jax.tree.map(jnp.asarray, _stacked_blocks(case))
    permuted = (jpl.permute_kv_shard_major(stacked, hkv, hd, 2) if hkv
                else jpl.permute_qkv_head_major(stacked, heads, hd))
    fn = jpl.make_tp_block_stage_fn(
        heads, hd, 2, lambda q, k, v: jax_vanilla(q, k, v, causal=True), rope=True,
        dtype=jnp.float32, heads_kv=hkv)
    island = jpl.make_pipeline_apply(fn, mesh, n_microbatches=PPTP_M,
                                     param_specs=jpl.tp_stage_specs(permuted))
    x = jnp.asarray(np.random.default_rng(9).normal(size=(4, PPTP_SEQ, PPTP_DIM))
                    .astype(np.float32))
    y = jax.jit(island)(permuted, x)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(island(p, x) ** 2)))(permuted)
    return (np.asarray(x), np.asarray(y), jax.tree.map(np.asarray, permuted),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def refs(eight_devices):
    out = {name: _jax_apply(name, eight_devices) for name in CASES}
    out.update({f"pptp_{c}": _jax_pptp(c) for c in PPTP})
    return out


@pytest.fixture(scope="module")
def port(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    jobs = {}
    for s in ((1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2)):
        jobs[f"mesh_{'x'.join(map(str, s))}"] = {"kind": "mesh", "shape": s}
    for name, (dp, pp, m, remat, axis, rows, ps, xs) in CASES.items():
        job = {"kind": "apply", "shape": (dp, 1, 1, pp), "stages": _stage_params(pp, ps),
               "x": _x(rows, xs), "m": m, "remat": remat, "batch_axis": axis}
        jobs[name] = job
        if name == "pp4":
            for fault in FAULTS:
                jobs[f"pp4_{fault}"] = dict(job, fault=fault)
            jobs["pp4_no_grad"] = dict(job, no_grad=True)
    for case, kw in PPTP.items():
        x = refs[f"pptp_{case}"][0]
        jobs[f"pptp_{case}"] = {"kind": "tp_apply", "shape": (1, 2, 1, 2), "m": PPTP_M,
                                "stacked": _stacked_blocks(case), "x": x,
                                "heads": kw["heads"], "heads_kv": kw["heads_kv"],
                                "head_dim": PPTP_DIM // kw["heads"]}
    return torchrun.spawn(ranks.run, 4, "gloo", "cpu", tmp / "store4", args=(4, jobs),
                          timeout=300)


def test_ranks_import_no_jax(port):
    assert all(r["forbidden"] == [] for r in port)


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2)])
def test_mesh_places_rank_r_with_pipe_innermost(port, shape):
    dp, tp, sp, pp = shape
    at = lambda d, m, s, p: ((d * tp + m) * sp + s) * pp + p  # noqa: E731
    for r in port:
        rec = r[f"mesh_{'x'.join(map(str, shape))}"]
        d, m, s, p = (rec[k] for k in ("data_index", "model_index", "seq_index", "pipe_index"))
        assert at(d, m, s, p) == r["rank"]
        assert rec["pipe_sum"] == sum(at(d, m, s, k) for k in range(pp))
        assert rec["data_sum"] == sum(at(k, m, s, p) for k in range(dp))
        assert rec["replica_sum"] == sum(at(k, m, s, p) for k in range(dp))
        if tp > 1:
            assert rec["model_sum"] == sum(at(d, k, s, p) for k in range(tp))


# ---------------------------------------------------------------- the schedule


def _rows(name, rec):
    dp, _, _, _, axis, rows, _, _ = CASES[name]
    per = rows // dp if axis == "data" else rows
    lo = rec["data_index"] * per if axis == "data" else 0
    return slice(lo, lo + per)


def _stage_grads(name, recs):
    """Each stage's gradient: its rank's slice, summed over the data rows
    (each row's gradient of its own block's loss)."""
    pp = CASES[name][1]
    out = {}
    for r in recs:
        p = r["pipe_index"]
        for k, g in r["grads"].items():
            for q in range(pp):
                if q != p:
                    assert not np.any(g[q]), (k, q)  # the other stages' slices
            out.setdefault(k, np.zeros_like(g))[p] += g[p]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_jaxs_pipeline_and_the_sequential_stages(port, refs, name):
    y, _, seq = refs[name]
    for r in port:
        rows = _rows(name, r[name])
        np.testing.assert_allclose(r[name]["y"], y[rows], rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(r[name]["y"], seq[rows], rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_gradients_match_jaxs(port, refs, name):
    _, grads, _ = refs[name]
    got = _stage_grads(name, [r[name] for r in port])
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bubbles_compute_nothing(port, name):
    """JAX runs every stage at every one of its M + N - 1 ticks and masks
    the bubbles out; a port stage computes its M microbatches only (and
    again in the backward under remat)."""
    _, _, m, remat, _, _, _, _ = CASES[name]
    for r in port:
        assert r[name]["stage_calls"] == m * (2 if remat else 1)


def test_hand_offs_are_point_to_point_without_the_wrap_around(port):
    """Stage p sends its M activations to p + 1 (none from the last stage:
    JAX's ring hop wraps round to stage 0, which never reads it) and its M
    input gradients to p - 1 (none from stage 0)."""
    _, pp, m, _, _, rows, _, _ = CASES["pp4"]
    mb_bytes = rows // m * DIM * 4
    for r in port:
        p = r["pp4"]["pipe_index"]
        assert r["pp4"]["bytes_sent"] == m * mb_bytes * ((p < pp - 1) + (p > 0))


def test_a_broadcast_backward_summing_over_pipe_fails_the_gradient_check(port, refs):
    _, grads, _ = refs["pp4"]
    got = _stage_grads("pp4", [r["pp4_sum_over_pipe"] for r in port])
    with pytest.raises(AssertionError):
        for k, g in grads.items():
            np.testing.assert_allclose(got[k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    assert np.allclose(got["w2"], 4 * grads["w2"], rtol=1e-3, atol=1e-3)  # x pp, exactly


def test_a_hop_one_microbatch_off_fails_the_forward_check(port, refs):
    y, _, _ = refs["pp4"]
    err = max(float(np.abs(r["pp4_hop_one_off"]["y"] - y).max()) for r in port)
    assert err > 100 * FWD_ATOL, err


def test_an_unequal_workload_finishes_right(port, refs):
    y, grads, _ = refs["pp4"]
    for r in port:
        np.testing.assert_allclose(r["pp4_slow"]["y"], y, rtol=0, atol=FWD_ATOL)
        assert r["pp4_slow"]["seconds"] >= 0.05 * 4 * 0.9  # stage 0 slept, every rank waited
    got = _stage_grads("pp4", [r["pp4_slow"] for r in port])
    for k, g in grads.items():
        np.testing.assert_allclose(got[k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_a_forward_without_a_backward_keeps_no_graph(port, refs):
    """Eval and init run the pipeline under ``torch.no_grad``: every stage
    call runs without autograd, so no microbatch's graph is held."""
    y, _, _ = refs["pp4"]
    m = CASES["pp4"][2]
    for r in port:
        rec = r["pp4_no_grad"]
        np.testing.assert_allclose(rec["y"], y, rtol=0, atol=FWD_ATOL)
        assert rec["stage_calls"] == m and rec["graph_calls"] == 0 and not rec["grad_fn"]


def test_a_batch_that_does_not_divide_is_padded_and_cut_back():
    x = torch.arange(10.0).view(5, 2)
    calls = []

    def fn(h):
        calls.append(h.shape[0])
        return h * 2
    y = pl.pad_to_microbatches(fn, x, 4)
    assert calls == [8] and torch.equal(y, x * 2)
    assert pl.pad_to_microbatches(fn, x[:4], 4).shape == (4, 2) and calls[-1] == 4


# ---------------------------------------------------------------- pp x tp helpers


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


@pytest.mark.parametrize("case", sorted(PPTP))
def test_permutes_and_stage_specs_are_jaxs(case):
    kw = PPTP[case]
    hd = PPTP_DIM // kw["heads"]
    stacked = _stacked_blocks(case)
    if kw["heads_kv"]:
        want = jpl.permute_kv_shard_major(jax.tree.map(jnp.asarray, stacked), kw["heads_kv"],
                                          hd, 2)
        got = pl.permute_kv_shard_major(_torch_tree(stacked), kw["heads_kv"], hd, 2)
    else:
        want = jpl.permute_qkv_head_major(jax.tree.map(jnp.asarray, stacked), kw["heads"], hd)
        got = pl.permute_qkv_head_major(_torch_tree(stacked), kw["heads"], hd)
    want, got = _tree_np(want), jax.tree.map(lambda t: t.numpy(), got)
    changed = 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                              jax.tree_util.tree_leaves_with_path(_tree_np(stacked))):
        changed += int(not np.array_equal(a, b))
    assert changed == 2  # the fused projection's kernel and bias only
    jspecs = jpl.tp_stage_specs(want)
    pspecs = pl.tp_stage_specs(jax.tree.map(lambda a: Leaf(a.shape), stacked))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=lambda x: x is not None
                                                and type(x).__name__ == "PartitionSpec"),
            jax.tree_util.tree_leaves_with_path(pspecs, is_leaf=lambda x: isinstance(x, tuple))):
        assert tuple(a) == tuple(b), path


def test_pipeline_block_rule_is_jaxs():
    from distributed_tensorflow_ibm_mnist_tpu.parallel.tensor_parallel import (
        make_param_specs as jax_specs,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import (
        make_param_specs,
    )

    jm = jax_get_model("vit", patch_size=7, dim=16, depth=4, heads=2, pp_stages=2,
                       dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    want = jax_specs(shapes, jpl.pipeline_block_rule())
    got = make_param_specs(jax.tree.map(lambda s: Leaf(s.shape), shapes), pl.pipeline_block_rule())
    flat_w = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")
    flat_g = jax.tree_util.tree_leaves_with_path(got, is_leaf=lambda x: isinstance(x, tuple))
    assert len(flat_w) == len(flat_g) > 0
    claimed = 0
    for (path, a), (_, b) in zip(flat_w, flat_g):
        assert tuple(a) == tuple(b), path
        claimed += int(tuple(b)[:1] == ("pipe",))
    assert claimed == 12  # every stacked block leaf, nothing else


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", sorted(PPTP))
def test_tp_block_stage_island_matches_jaxs(port, refs, case):
    _, y, permuted, grads = refs[f"pptp_{case}"]
    for r in port:
        rec = r[f"pptp_{case}"]
        assert float(np.abs(rec["y"] - y).max()) <= TP_REL * float(np.abs(y).max())
        p, m = rec["pipe_index"], rec["model_index"]
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            keys = [k.key for k in path]
            np.testing.assert_array_equal(_at(rec["permuted"], keys), _at(permuted, keys))
            spec, got, want = _at(rec["specs"], keys), _at(rec["grads"], keys)[p], g[p]
            if "model" in spec:  # this rank's model block of its stage's leaf
                d = spec.index("model") - 1
                got, want = np.split(got, 2, axis=d)[m], np.split(want, 2, axis=d)[m]
            assert float(np.abs(got - want).max()) <= TP_REL * float(np.abs(g).max()), keys


# ---------------------------------------------------------------- the converter


def test_the_stacked_tree_converts_strictly_both_ways():
    """JAX's ``pipe_blocks/stacked`` leaves, ``(n_stages, per_stage, ...)``,
    map to the port's ``pipe_blocks.stages.{s}.{i}`` (every slice consumed,
    the stacked shape checked, errors naming the path); ``flax_layout``
    maps each stage leaf back to its stacked path; the logits agree."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.convert import flax_layout, vit_state_dict
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

    kw = dict(patch_size=7, dim=16, depth=4, heads=2, pp_stages=2)
    jm = jax_get_model("vit", dtype=jnp.float32, **kw)
    params = _tree_np(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 1)))["params"])
    state = vit_state_dict(params, kw)
    assert sum(k.startswith("pipe_blocks.stages.1.1.") for k in state) == 12
    model = get_model("vit", device="cpu", dtype=torch.float32, **kw)
    model.load_state_dict(state, strict=True)
    x = np.random.default_rng(0).random((2, 28, 28, 1)).astype(np.float32)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    layout = flax_layout(model)
    assert layout["pipe_blocks.stages.1.0.qkv.weight"] == (
        ("pipe_blocks", "stacked", "qkv", "kernel"), "transpose", (16, 48))
    stacked = params["pipe_blocks"]["stacked"]
    bad = {**params, "pipe_blocks": {"stacked": {**stacked, "qkv": {
        **stacked["qkv"], "kernel": stacked["qkv"]["kernel"][:, :1]}}}}
    with pytest.raises(ValueError, match="pipe_blocks/stacked/qkv/kernel"):
        vit_state_dict(bad, kw)
    short = {**params, "pipe_blocks": {"stacked": {k: v for k, v in stacked.items()
                                                   if k != "proj"}}}
    with pytest.raises(ValueError, match="pipe_blocks/stacked/proj"):
        vit_state_dict(short, kw)
    with pytest.raises(ValueError, match="pipe_blocks"):
        vit_state_dict(params, dict(kw, pp_stages=0))
