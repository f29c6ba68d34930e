"""The port's ring attention (``parallel/ring_attention.py``: the dense and
flash inners, the ring backward over K7) and the ViT trained at sp=2,
against the JAX package's, on the CPU.

* THE RING: each case's q/k/v (and the cotangent ``w`` of the loss
  ``sum(out * w)``) are made from a numpy seed; JAX's
  ``make_ring_attention`` runs them on the virtual devices (the flash
  inner in interpret mode, as ``tests/test_ring_attention.py`` runs it)
  beside its ``vanilla_attention``; the port's runs on gloo ranks (two,
  then four: spawned once each for the module, ``tests/torch_sp_ranks.py``),
  each rank on its (B/dp, S/sp) block.  Forward within 2e-5 and dq/dk/dv
  within 5e-5 of both (JAX's own limits for its ring against vanilla,
  float32), at dp x sp 1x2, 2x2 and 1x4, causal and not, and under GQA at
  a prime per-shard length (S=14 over sp=2, JAX ``test_ring_attention.py:
  59-84``).
* THE LAYOUT: every hop carries one (B/dp, S/sp, H_kv, D) block, n - 1 a
  forward; under causal masking rank s runs s + 1 block forwards and s + 1
  block backwards (K7's plain versions counted on the CPU), every rank
  the same hops.
* THE VIT AT sp=2 (ring): per-step losses against JAX's sp=2 Trainer on the
  same ``TrainState`` (one full-batch step an epoch, so the permutation
  cannot differ) within 1e-4 and against the port's sp=1 within 1e-5; one
  step's gradients, averaged over the ranks, against ``jax.grad`` within
  1e-4 relative to each leaf's largest magnitude, and a pool whose
  backward is scaled by 1/sp or by sp (planted in the rank) misses that
  limit.  The LM under ``remat="blocks"`` at sp=2 gives the plain run's
  losses (the ring's hops rerun in the recompute).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_sp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.parallel import ring_attention as jra
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import ring_attention as ra
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 2e-5, 5e-5  # JAX's ring-vs-vanilla limits (float32)
VIT_LOSS_JAX, VIT_LOSS_SP1, VIT_GRAD = 1e-4, 1e-5, 1e-4

# name -> (dp, sp, inner, causal, (B, S, H, H_kv, D))
CASES = {
    "1x2-dense-causal": (1, 2, "dense", True, (2, 16, 4, 4, 8)),
    "1x2-dense-full": (1, 2, "dense", False, (2, 16, 4, 4, 8)),
    "1x2-flash-causal": (1, 2, "flash", True, (2, 16, 4, 4, 8)),
    "1x2-flash-full": (1, 2, "flash", False, (2, 16, 4, 4, 8)),
    "1x2-gqa-prime-dense-causal": (1, 2, "dense", True, (2, 14, 4, 2, 16)),
    "1x2-gqa-prime-dense-full": (1, 2, "dense", False, (2, 14, 4, 2, 16)),
    "1x2-gqa-prime-flash-causal": (1, 2, "flash", True, (2, 14, 4, 2, 16)),
    "2x2-dense-causal": (2, 2, "dense", True, (4, 16, 4, 4, 8)),
    "2x2-flash-causal": (2, 2, "flash", True, (4, 16, 4, 2, 8)),
    "1x4-flash-causal": (1, 4, "flash", True, (2, 32, 2, 2, 8)),
    "1x4-dense-full": (1, 4, "dense", False, (2, 32, 2, 2, 8)),
}

VIT_KW = {"patch_size": 7, "dim": 16, "depth": 1, "heads": 2}  # 16 tokens, 8 a rank
VIT_CFG = dict(name="vit_sp", model="vit", dataset="mnist", synthetic=True, n_train=32,
               n_test=32, batch_size=32, epochs=2, quiet=True, eval_batch_size=32, seed=3,
               target_accuracy=None)
VIT_DATA_KW = {"num_classes": 10, "image_size": (28, 28), "in_channels": 1}
LM_CFG = dict(name="lm_remat", model="causal_lm", dataset="retrieval",
              dataset_kwargs={"vocab": 16, "seq_len": 16}, n_train=32, n_test=16,
              batch_size=16, epochs=1, quiet=True, eval_batch_size=16, seed=2,
              model_kwargs={"dim": 32, "depth": 2, "heads": 4, "attn": "flash",
                            "dtype": torch.float32}, sp=2, dp=1)


def _case_arrays(name):
    dp, sp, inner, causal, (b, s, h, hkv, d) = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"q": mk(b, s, h, d), "k": mk(b, s, hkv, d), "v": mk(b, s, hkv, d),
            "w": mk(b, s, h, d), "dp": dp, "sp": sp, "inner": inner, "causal": causal,
            "impl": "ring"}


@functools.cache
def _jax_case(name):
    """JAX's ring and vanilla attention on the case: out, dq, dk, dv."""
    c = _case_arrays(name)
    q, k, v, w = (jnp.asarray(c[n]) for n in "qkvw")
    ring = jra.make_ring_attention(jax_make_mesh(dp=c["dp"], sp=c["sp"]),
                                   causal=c["causal"], inner=c["inner"])
    van = functools.partial(jra.vanilla_attention, causal=c["causal"])
    out = {}
    for label, fn in (("ring", ring), ("vanilla", van)):
        grads = jax.jit(jax.grad(lambda q, k, v, fn=fn: (fn(q, k, v) * w).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
        out[label] = {"out": np.asarray(jax.jit(fn)(q, k, v)),
                      **dict(zip(("dq", "dk", "dv"), map(np.asarray, grads)))}
    return out


def _vit_jax():
    """JAX's ViT trainer at dp=1 x sp=2: its initial state (numpy) and its
    epochs' train losses."""
    jt = JaxTrainer(JaxRunConfig(**VIT_CFG, dp=1, sp=2,
                                 model_kwargs={**VIT_KW, "dtype": jnp.float32}))
    assert jt.mesh.shape["seq"] == 2
    init = jax.tree.map(np.asarray, jt.state)
    jt.fit()
    return init, [h["train_loss"] for h in jt.history]


def _vit_batch():
    rng = np.random.default_rng(11)
    return {"image": rng.integers(0, 255, size=(8, 28, 28, 1), dtype=np.uint8),
            "label": rng.integers(0, 10, size=(8,)).astype(np.int32)}


def _vit_jax_grads(init):
    """``jax.grad`` of the mean cross-entropy of JAX's (single-device) ViT
    at the initial parameters on the gradient batch, in the port's names."""
    model = jax_get_model("vit", **VIT_KW, num_classes=10, dtype=jnp.float32)
    batch = _vit_batch()
    x = jnp.asarray(batch["image"], jnp.float32) / 255.0

    def loss(p):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch["label"])).mean()

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(init.params))
    cfg = RunConfig(**VIT_CFG, model_kwargs=VIT_KW)
    return train_state_dict(init.replace(params=grads), cfg, **VIT_DATA_KW)["params"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    init, jax_losses = _vit_jax()
    vit_cfg = dict(VIT_CFG, model_kwargs={**VIT_KW, "dtype": torch.float32})
    form = train_state_dict(init, RunConfig(**vit_cfg), **VIT_DATA_KW)
    jobs2 = {
        "vit_fit": {"kind": "fit", "config": dict(vit_cfg, sp=2), "form": form,
                    "spy_inputs": True},
        "vit_grads": {"kind": "grads", "config": dict(vit_cfg, sp=2), "form": form,
                      "batch": _vit_batch(), "faults": {"mean": 0.5, "twice": 2.0}},
        "lm_plain": {"kind": "fit", "config": LM_CFG},
        "lm_remat": {"kind": "fit", "config": dict(LM_CFG, remat="blocks")},
    }
    by_world = {2: {}, 4: {}}
    for name in CASES:
        c = _case_arrays(name)
        by_world[c["dp"] * c["sp"]][name] = c
    meshes = {2: {"mesh_1x2": (1, 2)}, 4: {"mesh_2x2": (2, 2), "mesh_1x4": (1, 4)}}
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, by_world[w], meshes[w], jobs2 if w == 2 else {}),
                             timeout=300)
           for w in (2, 4)}
    with Trainer(RunConfig(**vit_cfg), device="cpu") as t1:
        t1.state.load_state_dict(form)
        t1.fit()
        sp1 = [h["train_loss"] for h in t1.history]
    return {"ranks": out, "init": init, "jax_losses": jax_losses, "sp1_losses": sp1}


def test_ranks_import_no_jax(port):
    for world in port["ranks"].values():
        assert all(r["forbidden"] == [] for r in world)


def _gathered(ranks_out, name, key):
    """The global array from every rank's block of ``key``."""
    dp, sp = CASES[name][:2]
    rows = [np.concatenate([ranks_out[d * sp + s][name][key] for s in range(sp)], axis=1)
            for d in range(dp)]
    return np.concatenate(rows, axis=0)


def _world(name):
    return CASES[name][0] * CASES[name][1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_forward_matches_jax_ring_and_vanilla(port, name):
    got = _gathered(port["ranks"][_world(name)], name, "out")
    want = _jax_case(name)
    np.testing.assert_allclose(got, want["ring"]["out"], atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got, want["vanilla"]["out"], atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_grads_match_jax_ring_and_vanilla(port, name):
    want = _jax_case(name)
    for key in ("dq", "dk", "dv"):
        got = _gathered(port["ranks"][_world(name)], name, key)
        np.testing.assert_allclose(got, want["ring"][key], atol=GRAD_TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(got, want["vanilla"][key], atol=GRAD_TOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_hops_carry_one_local_block_and_the_causal_skip_keeps_them(port, name):
    """No rank holds another seq rank's tokens outside a hop: its inputs
    are its (B/dp, S/sp) block and each hop carries one (B/dp, S/sp, H_kv,
    D) K/V block; every rank makes the same hops; the flash inner runs
    s + 1 blocks a direction on seq rank s under causal masking (n
    without), none of them through the dense inner."""
    dp, sp, inner, causal, (b, s, h, hkv, d) = CASES[name]
    block = (b // dp, s // sp, hkv, d)
    for r in port["ranks"][_world(name)]:
        rec = r[name]
        assert rec["local"] == (b // dp, s // sp, h, d)
        fwd_hops = [hop for hop in rec["hops"] if len(hop) == 2 and hop[0] == block]
        assert len(fwd_hops) >= sp - 1
        assert all(all(shape == block for shape in hop) for hop in rec["hops"])
        seq_index = r["rank"] % sp
        want = (seq_index + 1 if causal else sp) if inner == "flash" else 0
        assert rec["block_fwd"] == want and rec["block_bwd"] == want
    assert len({len(r[name]["hops"]) for r in port["ranks"][_world(name)]}) == 1


@pytest.mark.parametrize("mesh", ["mesh_1x2", "mesh_2x2", "mesh_1x4"])
def test_mesh_coordinates_groups_and_ring_shift(port, mesh):
    """rank = data_index * sp + seq_index; the seq group is the data row,
    the data group the seq column; ring_shift moves a value one place up
    the row (and -1 down it), and its gradient rides back."""
    dp, sp = {"mesh_1x2": (1, 2), "mesh_2x2": (2, 2), "mesh_1x4": (1, 4)}[mesh]
    for r in port["ranks"][dp * sp]:
        rec, rank = r[mesh], r["rank"]
        d, s = divmod(rank, sp)
        assert (rec["data_index"], rec["seq_index"]) == (d, s)
        assert rec["seq_sum"] == sum(range(d * sp, (d + 1) * sp))
        assert rec["data_sum"] == sum(range(s, dp * sp, sp))
        assert rec["right"] == d * sp + (s - 1) % sp  # received from the left
        assert rec["left"] == d * sp + (s + 1) % sp
        # rank j's loss weighs what it received by j + 1: the gradient of
        # this rank's tensor is the weight of the rank it was sent to
        assert rec["shift_grad"] == [float(d * sp + (s + 1) % sp + 1)] * 2


def test_vit_sp2_losses_match_jax_sp_trainer_and_sp1(port):
    for r in port["ranks"][2]:
        got = r["vit_fit"]["losses"]
        np.testing.assert_allclose(got, port["jax_losses"], rtol=VIT_LOSS_JAX)
        np.testing.assert_allclose(got, port["sp1_losses"], rtol=VIT_LOSS_SP1)
        assert r["vit_fit"]["chips"] == 2 and r["vit_fit"]["path_label"] == "dp1_sp2"


def test_vit_sp2_attention_sees_only_its_token_slice(port):
    for r in port["ranks"][2]:
        assert r["vit_fit"]["attn_inputs"] == [((32, 8, 2, 8), (32, 8, 2, 8))]


def _worst(grads: dict, want: dict) -> float:
    """The largest error of any leaf relative to that leaf's largest magnitude."""
    return max(float(np.abs(grads[n] - t.numpy()).max() / np.abs(t.numpy()).max())
               for n, t in want.items())


def test_vit_sp2_gradients_match_jax_and_a_scaled_pool_fails(port):
    """The pool across the seq group is where a factor of sp hides: the
    head's gradient is whole on every rank while the blocks' are partial.
    The port's gradients hold at 1e-4; a pool backward scaled by 1/2 (a
    mean's) or by 2 misses it on the leaves below the pool."""
    want = _vit_jax_grads(port["init"])
    for r in port["ranks"][2]:
        rec = r["vit_grads"]
        assert _worst(rec["grads"], want) <= VIT_GRAD
        for fault in ("fault_mean", "fault_twice"):
            assert _worst(rec[fault], want) > 0.3, fault
            head = {n: t for n, t in want.items() if n.startswith("logits")}
            assert _worst(rec[fault], head) <= VIT_GRAD  # the head is above the pool


def test_block_remat_under_sp_gives_the_plain_losses(port):
    for r in port["ranks"][2]:
        np.testing.assert_allclose(r["lm_remat"]["losses"], r["lm_plain"]["losses"],
                                   rtol=1e-6)
        assert r["lm_remat"]["step"] == r["lm_plain"]["step"] == 2


# ---------------------------------------------------------------- one process


def _mesh1():
    return Mesh(shape={"data": 1, "model": 1, "seq": 1, "pipe": 1}, rank=0)


def test_ring_of_one_rank_is_one_block():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 12, 4, 8)).astype(np.float32))
               for _ in range(3))
    want = ra.vanilla_attention(q, k, v, causal=True)
    for inner in ("dense", "flash"):
        got = ra.make_ring_attention(_mesh1(), causal=True, inner=inner)(q, k, v)
        torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=0)


def test_ring_gqa_rejects_indivisible_heads():
    """H not a multiple of H_kv is a layout bug, not a fallback case (JAX
    ``test_ring_attention.py:87-94``)."""
    q = torch.zeros((1, 4, 6, 8))
    k = v = torch.zeros((1, 4, 4, 8))
    for inner in ("dense", "flash"):
        with pytest.raises(ValueError, match="multiple of k/v heads"):
            ra.make_ring_attention(_mesh1(), inner=inner)(q, k, v)


def test_make_ring_attention_refusals():
    with pytest.raises(ValueError) as got:
        ra.make_ring_attention(_mesh1(), inner="bogus")
    with pytest.raises(ValueError) as want:
        jra.make_ring_attention(jax_make_mesh(dp=1, sp=2), inner="bogus")
    assert str(got.value) == str(want.value)


def test_merge_block_matches_jax():
    rng = np.random.default_rng(6)
    m, lse = rng.normal(size=(2, 5, 3)).astype(np.float32), rng.normal(size=(2, 5, 3))
    lse = lse.astype(np.float32)
    lse[0, :2] = ra._NEG  # skipped rows
    l_run = rng.uniform(0.5, 2, size=(2, 5, 3)).astype(np.float32)
    o_run, o_blk = (rng.normal(size=(2, 5, 3, 4)).astype(np.float32) for _ in range(2))
    got = ra._merge_block(*(torch.from_numpy(x) for x in (m, l_run, o_run, o_blk, lse)))
    want = jra._merge_block(*(jnp.asarray(x) for x in (m, l_run, o_run, o_blk, lse)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert ra._NEG == jra._NEG


def test_k7_counters_count_only_kernel_launches():
    """On CPU tensors the K7 entries run the plain versions and count
    nothing; the counters sit beside K3's and K4-K6's."""
    q = torch.randn(1, 8, 2, 8)
    before = (fa.flash_block_fwd.launches, fa.flash_block_bwd.launches,
              fa.flash_attention_fwd.launches)
    out, lse = fa.flash_block_fwd(q, q, q, causal=True)
    fa.flash_block_bwd(q, q, q, out, lse, (out * out).sum(-1), causal=True)
    assert (fa.flash_block_fwd.launches, fa.flash_block_bwd.launches,
            fa.flash_attention_fwd.launches) == before
    assert torch.isfinite(lse).all()  # the diagonal block: every row sees a key
