"""The port's Trainer at ``pp > 1`` (the stage-stacked ViT and causal LM,
``parallel.pipeline.PipePlan``, pp beside dp and tp) against the JAX
package's Trainer on the same mesh and against the port's pp=1 runs, on
the CPU.

* AGAINST JAX'S TRAINER (``tests/test_pipeline.py:106-212``), from a state
  ``convert.train_state_dict`` cut from JAX's (its ``pipe_blocks/stacked``
  tree), full-batch epochs so that no permutation can differ: the ViT at
  dp=2 x pp=2 (each epoch's loss within 1e-5, the parameters within 5e-4
  after two Adam epochs: the repo's JAX limits for a parallel layout;
  the test loss over a test set whose eval remainder of one row a data
  row does not divide ``dp * microbatches``); the same run at dp=1 x pp=4
  with 2 and with 8 microbatches (the stages re-cut 4 x 1); block remat
  and stage remat (``remat=True``); the causal LM at dp=2 x pp=2.
* PP x TP INSIDE STAGES (``:214-389``): the LM at pp=2 x tp=2 (MHA
  float32, GQA float32, MHA bf16) against its pp-only run (dp=2 x pp=2,
  the same seed and global batches) within JAX's limits (float32: loss
  rtol 2e-3, parameters 2e-3; bf16: 5e-2 both), the MHA float32 run also
  against JAX's, and the GQA and bf16 runs (pp only and pp x tp) against
  JAX's dp=2 x pp=2 Trainer of their configuration from its converted
  state (float32: the limits above; bf16: 5e-2); each rank holds its
  stage's Megatron blocks (half the heads).  At world 8: the unaligned GQA stack (tp=4 over heads_kv=2)
  keeps its stage blocks whole with JAX's warning, the aligned one warns
  nothing, heads that tp does not divide take JAX's ``ValueError``.
* EXAMPLE 07(a)'s layout, dp=2 x pp=4 with 8 microbatches, through
  ``launch/cli.py``'s rank body under a world of 8.
* CHECKPOINTS: a pp=2 checkpoint resumes at pp=2 bit-equal to the
  uninterrupted run, and at pp=1 (the stacked model, one process) within
  the float32 limits.  DECODE: greedy decode after the pp=2 LM fit gives
  the pp=1 fit's tokens, through ``generate`` and through an engine
  ``InferenceEngine.from_trainer`` builds; ``on_mesh=True`` is JAX's
  ``ValueError``.
* THE REFUSALS, with JAX's messages.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pp_ranks as ranks
from torch_tp_ranks import plain_state
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    train_state_dict,
    vit_state_dict,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

LOSS, PARAM = 1e-5, 5e-4  # against JAX (and between exact layouts): the repo's limits
LOSS_F32, PARAM_F32 = 2e-3, 2e-3  # pp x tp against pp-only: JAX's own
LOSS_BF16, PARAM_BF16 = 5e-2, 5e-2

VIT_KW = {"patch_size": 7, "dim": 16, "depth": 4, "heads": 2}
VIT = dict(model="vit", dataset="mnist", synthetic=True, n_train=32, n_test=10,
           batch_size=32, epochs=2, lr=1e-3, quiet=True, seed=11, eval_batch_size=8,
           target_accuracy=None)
LM_KW = {"dim": 32, "depth": 4, "heads": 4}
GQA_KW = dict(LM_KW, heads_kv=2)
LM = dict(model="causal_lm", dataset="retrieval", dataset_kwargs={"vocab": 16, "seq_len": 16},
          n_train=16, n_test=16, batch_size=16, epochs=2, quiet=True, eval_batch_size=16,
          seed=5, target_accuracy=None)
PROMPT = [1, 2, 3]


def _cfg(base, model_kw, dtype=torch.float32, **kw):
    return dict(base, model_kwargs=dict(model_kw, dtype=dtype), **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_fit(base, model_kw, dtype=jnp.float32, **kw):
    t = JaxTrainer(JaxRunConfig(**dict(base, model_kwargs=dict(model_kw, dtype=dtype), **kw)))
    init = plain_state(_np_tree(t.state))
    t.fit()
    return {"init": init, "losses": [h["train_loss"] for h in t.history],
            "test_loss": t.history[-1]["test_loss"], "params": _np_tree(t.state.params)}


@pytest.fixture(scope="module")
def refs(eight_devices):
    return {"vit": _jax_fit(VIT, VIT_KW, dp=2, pp=2),
            "lm": _jax_fit(LM, LM_KW, dp=2, pp=2),
            "gqa": _jax_fit(LM, GQA_KW, dp=2, pp=2),
            "bf16": _jax_fit(LM, LM_KW, jnp.bfloat16, dp=2, pp=2)}


def _form(ref, base, model_kw, extra, dtype=torch.float32):
    return train_state_dict(ref["init"], RunConfig(**_cfg(base, model_kw, dtype, pp=2)),
                            **extra)


def _restack(form: dict, per: int, n_stages: int, depth: int = 4) -> dict:
    """A save form's stage leaves re-cut from ``per`` blocks a stage to
    ``n_stages`` stages (the same blocks in schedule order)."""
    per_to = depth // n_stages

    def name(k):
        m = re.fullmatch(r"pipe_blocks\.stages\.(\d+)\.(\d+)\.(.*)", k)
        if m is None:
            return k
        b = int(m[1]) * per + int(m[2])
        return f"pipe_blocks.stages.{b // per_to}.{b % per_to}.{m[3]}"

    def cut(d):
        return {name(k): v for k, v in d.items()}

    opt = dict(form["optimizer"])
    for key in ("mu", "nu", "trace"):
        if opt.get(key):
            opt[key] = cut(opt[key])
    return dict(form, params=cut(form["params"]), optimizer=opt)


VIT_EXTRA = {"num_classes": 10, "image_size": (28, 28), "in_channels": 1}
LM_EXTRA = {"num_classes": 16}
WORLD8_GQA = _cfg(LM, dict(LM_KW, heads_kv=2), dp=1, tp=4, pp=2, epochs=1)


@pytest.fixture(scope="module")
def port(refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppt")
    vit_form = _form(refs["vit"], VIT, VIT_KW, VIT_EXTRA)
    lm_form = _form(refs["lm"], LM, LM_KW, LM_EXTRA)
    gqa_form = _form(refs["gqa"], LM, GQA_KW, LM_EXTRA)
    bf16_form = _form(refs["bf16"], LM, LM_KW, LM_EXTRA, torch.bfloat16)
    vit4 = _restack(vit_form, 2, 4)
    jobs4 = {
        "vit_dp2_pp2": {"kind": "fit", "config": _cfg(VIT, VIT_KW, dp=2, pp=2), "form": vit_form},
        "vit_pp4_m2": {"kind": "fit", "config": _cfg(VIT, VIT_KW, pp=4, pp_microbatches=2),
                       "form": vit4},
        "vit_pp4_m8": {"kind": "fit", "config": _cfg(VIT, VIT_KW, pp=4, pp_microbatches=8),
                       "form": vit4},
        "vit_remat_blocks": {"kind": "fit", "form": vit_form,
                             "config": _cfg(VIT, VIT_KW, dp=2, pp=2, remat="blocks")},
        "vit_remat_stage": {"kind": "fit", "form": vit_form,
                            "config": _cfg(VIT, VIT_KW, dp=2, pp=2, remat=True)},
        "lm_dp2_pp2": {"kind": "fit", "config": _cfg(LM, LM_KW, dp=2, pp=2), "form": lm_form,
                       "generate": PROMPT},
        "lm_tp2_pp2": {"kind": "fit", "config": _cfg(LM, LM_KW, tp=2, pp=2), "form": lm_form},
        "lm_seed_dp2_pp2": {"kind": "fit", "config": _cfg(LM, LM_KW, dp=2, pp=2),
                            "generate": PROMPT},
        "gqa_dp2_pp2": {"kind": "fit", "config": _cfg(LM, GQA_KW, dp=2, pp=2),
                        "form": gqa_form},
        "gqa_tp2_pp2": {"kind": "fit", "config": _cfg(LM, GQA_KW, tp=2, pp=2),
                        "form": gqa_form},
        "bf16_dp2_pp2": {"kind": "fit", "config": _cfg(LM, LM_KW, torch.bfloat16, dp=2, pp=2),
                         "form": bf16_form},
        "bf16_tp2_pp2": {"kind": "fit", "config": _cfg(LM, LM_KW, torch.bfloat16, tp=2, pp=2),
                         "form": bf16_form},
        "resume": {"kind": "resume", "config": _cfg(LM, LM_KW, dp=2, pp=2, n_train=32, epochs=1,
                                                    checkpoint_dir=str(tmp / "ckpt"))},
        "refusals": {"kind": "refusals", "configs": {
            "batch_multiple": _cfg(dict(VIT, batch_size=30), VIT_KW, dp=2, pp=2),
            "dropout": _cfg(VIT, dict(VIT_KW, dropout=0.1), dp=2, pp=2),
            "moe": _cfg(VIT, dict(VIT_KW, moe_every=2), pp=4)}},
    }
    cli_argv = ["--set", "model='vit'", "--set", "dp=2", "--set", "pp=4",
                "--set", "pp_microbatches=8", "--set", "synthetic=True",
                "--set", "n_train=64", "--set", "n_test=32", "--set", "batch_size=32",
                "--set", "epochs=1", "--set", "quiet=True",
                "--set", "model_kwargs={'patch_size': 7, 'dim': 16, 'depth': 4, 'heads': 2}"]
    jobs8 = {
        "cli": {"kind": "cli", "argv": cli_argv},
        "gqa_unaligned": {"kind": "fit", "config": WORLD8_GQA},
        "gqa_aligned": {"kind": "fit", "config": dict(WORLD8_GQA, dp=2, tp=2)},
        "refusals": {"kind": "refusals", "configs": {"heads": _cfg(
            VIT, {"patch_size": 7, "dim": 18, "depth": 2, "heads": 3}, dp=2, tp=2, pp=2)}},
    }
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, jobs), timeout=600)
           for w, jobs in ((4, jobs4), (8, jobs8))}
    one = {"lm": ranks._fit({"config": _cfg(LM, LM_KW), "generate": PROMPT})}
    with Trainer(RunConfig(**_cfg(LM, dict(LM_KW, pp_stages=2), n_train=32, epochs=1,
                                  checkpoint_dir=str(tmp / "ckpt"))), device="cpu") as t:
        t.restore_checkpoint(step=2)  # the pp=2 checkpoint of epoch 1, at pp=1
        t.fit()
        one["resume"] = {"loss": t.history[-1]["train_loss"], "params": ranks._whole_params(t)}
    return {"ranks": out, "one": one}


def _per_rank(port, world, name):
    return [r[name] for r in port["ranks"][world]]


def test_ranks_import_no_jax(port):
    for world in port["ranks"].values():
        assert all(r["forbidden"] == [] for r in world)


def _held_stage_only(rec, pp):
    assert rec["held"] == [str(rec["pipe_index"])]
    assert all(not n.startswith("pipe_blocks") or n.startswith(
        f"pipe_blocks.stages.{rec['pipe_index']}.") for n in rec["local_shapes"])
    assert rec["mesh"]["pipe"] == pp


# ---------------------------------------------------------------- against JAX


def _close_to(rec, want_losses, want_params, loss_tol, param_tol):
    np.testing.assert_allclose(rec["losses"], want_losses, rtol=loss_tol)
    for k, v in want_params.items():
        np.testing.assert_allclose(rec["params"][k], v, rtol=0, atol=param_tol, err_msg=k)


def _vit_want(refs):
    return vit_state_dict(refs["vit"]["params"], dict(VIT_KW, pp_stages=2, **VIT_EXTRA))


@pytest.mark.parametrize("name", ["vit_dp2_pp2", "vit_remat_blocks", "vit_remat_stage"])
def test_vit_dp2_pp2_matches_jaxs_trainer(port, refs, name):
    want = {k: v.numpy() for k, v in _vit_want(refs).items()}
    for rec in _per_rank(port, 4, name):
        _close_to(rec, refs["vit"]["losses"], want, LOSS, PARAM)
        _held_stage_only(rec, 2)
        assert rec["path_label"] == "dp2_pp2" and rec["chips"] == 4
        # the eval set's remainder (one row a data row) padded through the pipeline
        np.testing.assert_allclose(rec["test_loss"], refs["vit"]["test_loss"], rtol=LOSS)


@pytest.mark.parametrize("m", [2, 8])
def test_vit_pp4_microbatch_counts_keep_the_math(port, refs, m):
    want = {k: v.numpy() for k, v in _restack({"params": _vit_want(refs), "optimizer": {}},
                                               2, 4)["params"].items()}
    for rec in _per_rank(port, 4, f"vit_pp4_m{m}"):
        _close_to(rec, refs["vit"]["losses"], want, LOSS, PARAM)
        _held_stage_only(rec, 4)
        assert rec["path_label"] == "dp1_pp4"


def test_lm_dp2_pp2_matches_jaxs_trainer(port, refs):
    want = {k: v.numpy() for k, v in causal_lm_state_dict(
        refs["lm"]["params"], dict(LM_KW, pp_stages=2, **LM_EXTRA)).items()}
    for rec in _per_rank(port, 4, "lm_dp2_pp2"):
        _close_to(rec, refs["lm"]["losses"], want, LOSS, PARAM)
        _held_stage_only(rec, 2)
        assert rec["param_count"] == sum(v.size for v in want.values())


# ---------------------------------------------------------------- pp x tp


@pytest.mark.parametrize("name, base, loss_tol, param_tol", [
    ("lm", "lm_dp2_pp2", LOSS_F32, PARAM_F32), ("gqa", "gqa_dp2_pp2", LOSS_F32, PARAM_F32),
    ("bf16", "bf16_dp2_pp2", LOSS_BF16, PARAM_BF16)])
def test_pp_x_tp_inside_stages_matches_pp_only(port, name, base, loss_tol, param_tol):
    want = _per_rank(port, 4, base)[0]
    for rec in _per_rank(port, 4, f"{name}_tp2_pp2"):
        assert rec["in_stages"] and rec["path_label"] == "dp1_tp2_pp2"
        assert not any("NOT tensor-parallel" in w for w in rec["warnings"])
        _close_to(rec, want["losses"], want["params"], loss_tol, param_tol)
        p = rec["pipe_index"]
        qkv = ("q_proj" if name == "gqa" else "qkv") + ".weight"
        whole = want["params"][f"pipe_blocks.stages.{p}.0.{qkv}"].shape
        assert rec["local_shapes"][f"pipe_blocks.stages.{p}.0.{qkv}"] == (
            whole[0] // 2, whole[1])  # this model rank's heads


def test_pp_x_tp_float32_matches_jaxs_trainer(port, refs):
    want = {k: v.numpy() for k, v in causal_lm_state_dict(
        refs["lm"]["params"], dict(LM_KW, pp_stages=2, **LM_EXTRA)).items()}
    for rec in _per_rank(port, 4, "lm_tp2_pp2"):
        _close_to(rec, refs["lm"]["losses"], want, LOSS, PARAM)


@pytest.mark.parametrize("name, ref, model_kw, loss_tol, param_tol", [
    ("gqa_dp2_pp2", "gqa", GQA_KW, LOSS, PARAM), ("gqa_tp2_pp2", "gqa", GQA_KW, LOSS, PARAM),
    ("bf16_dp2_pp2", "bf16", LM_KW, LOSS_BF16, PARAM_BF16),
    ("bf16_tp2_pp2", "bf16", LM_KW, LOSS_BF16, PARAM_BF16)])
def test_gqa_and_bf16_pp_runs_match_jaxs_trainer(port, refs, name, ref, model_kw, loss_tol,
                                                 param_tol):
    """The GQA stage blocks (``kv_proj`` cut shard-major inside ``TPPlan``
    at pp x tp) and the bf16 ones, at pp only and at pp=2 x tp=2, against
    JAX's dp=2 x pp=2 Trainer from the same converted state."""
    want = {k: v.numpy() for k, v in causal_lm_state_dict(
        refs[ref]["params"], dict(model_kw, pp_stages=2, **LM_EXTRA)).items()}
    for rec in _per_rank(port, 4, name):
        _close_to(rec, refs[ref]["losses"], want, loss_tol, param_tol)


def test_unaligned_gqa_keeps_stage_blocks_whole_with_jaxs_warning(port):
    for rec in _per_rank(port, 8, "gqa_unaligned"):
        assert not rec["in_stages"]
        assert any("NOT tensor-parallel" in w for w in rec["warnings"])
        p = rec["pipe_index"]
        assert rec["local_shapes"][f"pipe_blocks.stages.{p}.0.q_proj.weight"] == (32, 32)
        assert rec["local_shapes"]["embed.weight"] == (16, 8)  # Megatron outside the stages
    for rec in _per_rank(port, 8, "gqa_aligned"):
        assert rec["in_stages"] and not any("NOT tensor-parallel" in w for w in rec["warnings"])


def test_heads_that_tp_does_not_divide_are_refused_as_jax_refuses_them(port):
    for r in port["ranks"][8]:
        assert r["refusals"]["heads"] == ("ValueError: pp x tp inside stages needs heads (3) "
                                          "divisible by tp (2)")


# ---------------------------------------------------------------- example 07(a)


def test_cli_runs_example_07a_layout(port):
    for r in port["ranks"][8]:
        assert r["cli"] == {"pp": 4, "dp": 2, "rc": 0}


# ---------------------------------------------------------------- checkpoints, decode


def test_pp2_checkpoint_resumes_at_pp2_bit_equal_and_at_pp1(port):
    for rec in _per_rank(port, 4, "resume"):
        assert rec["step"] == 2 * rec["spe"]
        assert rec["losses"][-1] == rec["uninterrupted"][-1]
        for k, v in rec["uninterrupted_params"].items():
            np.testing.assert_array_equal(rec["params"][k], v, err_msg=k)
    rec, one = _per_rank(port, 4, "resume")[0], port["one"]["resume"]
    np.testing.assert_allclose(one["loss"], rec["losses"][-1], rtol=LOSS)
    for k, v in rec["params"].items():
        np.testing.assert_allclose(one["params"][k], v, rtol=0, atol=PARAM, err_msg=k)


def test_greedy_decode_after_a_pp2_fit_equals_pp1s(port):
    want = port["one"]["lm"]["generated"]
    assert len(want[0]) == len(PROMPT) + 6
    for rec in _per_rank(port, 4, "lm_seed_dp2_pp2"):
        assert rec["generated"] == want
        assert rec["served"] == [want[0][len(PROMPT):]]  # InferenceEngine.from_trainer
        _close_to(rec, port["one"]["lm"]["losses"], {}, LOSS, PARAM)
        # JAX asks for a sharded layout first: a dp x pp run has none
        assert rec["on_mesh"].startswith(
            "ValueError: on_mesh=True decodes in the run's GSPMD layout; this run has none")


# ---------------------------------------------------------------- refusals


def test_refusals_in_the_ranks_are_jaxs(port):
    for r in port["ranks"][4]:
        got = r["refusals"]
        assert got["batch_multiple"] == (
            "ValueError: batch_size 30 must be a multiple of dp*microbatches (2x2=4) so "
            "training always uses the pipeline island")
        for name in ("dropout", "moe"):
            assert got[name] == ("ValueError: pipeline stages need identical per-block "
                                 "programs: dropout and MoE blocks don't compose with pp_stages")


@pytest.mark.parametrize("kw, match", [
    (dict(model="lenet5"), "needs a model with a pipelineable block stack"),
    (dict(model="vit", sp=2), "fsdp do not pipeline yet"),
    (dict(model="vit", dp=2, fsdp=True), "fsdp do not pipeline yet"),
    # multislice beside pp is composed (item 7.7): without a group the mesh
    # asks for the launcher, as every mesh of the port does
    (dict(model="vit", dp=2, dcn_dp=2), "launch.torchrun"),
], ids=["no_block_stack", "sp", "fsdp", "multislice"])
def test_refusals_before_any_group(kw, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        Trainer(RunConfig(**dict(VIT, model_kwargs=dict(VIT_KW), pp=2, **kw)), device="cpu")


def test_jax_refuses_the_same_compositions(eight_devices):
    base = dict(dataset="mnist", synthetic=True, n_train=64, n_test=32, batch_size=32,
                quiet=True)
    with pytest.raises(ValueError, match="pipelineable block stack"):
        JaxTrainer(JaxRunConfig(model="lenet5", pp=2, **base))
    with pytest.raises(ValueError, match="fsdp do not pipeline yet"):
        JaxTrainer(JaxRunConfig(model="vit", pp=2, sp=2, **base))


def test_multislice_beside_pipe_names_item_7_7():
    """Item 7.7 composed multislice with pp: on rank records of two nodes
    each node holds one data row's two stages, so no pipe group crosses a
    node; without a group the mesh asks for the launcher."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import mesh as pmesh

    records = [pmesh.RankRecord(r, f"node-{r // 2}", r // 2) for r in range(4)]
    chosen = pmesh.pick_multislice_devices(records, 2, 2)
    crossing = pmesh.node_crossings(chosen, 2, pp=2)
    assert crossing["pipe_group"] == [] and crossing["data_group"] == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="launch.torchrun"):
        make_mesh(2, pp=2, dcn_dp=2)


def test_pp_without_a_process_group_names_the_launcher():
    with pytest.raises(ValueError, match="launch.torchrun"):
        Trainer(RunConfig(**_cfg(LM, LM_KW, pp=2)), device="cpu")
