"""The port's Ulysses sequence parallelism (``parallel/sequence_parallel.py``)
and the Trainer at ``sp > 1`` (``core/trainer.py``, the LM's token slice,
the refusals, checkpoints and the CLI), against the JAX package's, on the
CPU.

* ULYSSES: q/k/v and the loss cotangent from a numpy seed; JAX's
  ``make_ulysses_attention`` on the virtual devices beside its
  ``vanilla_attention`` (and its ring at 1x4); the port's on gloo ranks
  (two, then four, spawned once each for the module,
  ``tests/torch_sp_ranks.py``), each rank on its (B/dp, S/sp) block.
  Forward within 2e-5, dq/dk/dv within 5e-5 (JAX's own Ulysses limit),
  at dp x sp 1x2, 2x2 and 1x4, causal, bidirectional, GQA and with a
  sliding window passed through; the inner kernel sees (B/dp, S, H/sp, D).
  A model whose heads do not divide the axis runs the whole sequence
  through the island's unsharded inner on every rank: the plain model's
  logits.
* THE TRAINER AT sp=2: the causal LM (RoPE: the ring with its dense and
  flash inners and Ulysses with both inners; learned positions: the ring)
  from JAX's sp=2 Trainer's ``TrainState``, one full-batch step an epoch
  (so no permutation can differ): per-step losses within 1e-4 of JAX's
  sp=2 Trainer and 1e-5 of the port's sp=1 run; at dp=2 x sp=2 the same.
  Its attention sees (B/dp, S/sp, H, D) only.  A resume at sp=2 continues
  the run: its epoch's loss is the uninterrupted run's, and it decodes on
  one device from the whole weights.  Every refusal of
  JAX's sp hot-path validation reproduces JAX's type and message; fsdp
  and MoE blocks beside sp train an epoch, and multislice beside sp meets
  the one-node refusal JAX's virtual devices meet.  The CLI's ``--set sp=2 --set sp_impl=ulysses`` under a world
  of four trains at dp=2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.launch.cli import build_config as jax_build_config
from distributed_tensorflow_ibm_mnist_tpu.parallel import ring_attention as jra
from distributed_tensorflow_ibm_mnist_tpu.parallel import sequence_parallel as jsp
from distributed_tensorflow_ibm_mnist_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli, torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    vanilla_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.sequence_parallel import (
    make_ulysses_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 2e-5, 5e-5  # JAX's Ulysses-vs-vanilla limits (float32)
LOSS_JAX, LOSS_SP1 = 1e-4, 1e-5

# name -> (dp, sp, causal, window, (B, S, H, H_kv, D))
CASES = {
    "1x2-causal": (1, 2, True, 0, (2, 16, 4, 4, 8)),
    "1x2-full": (1, 2, False, 0, (2, 16, 4, 4, 8)),
    "1x2-gqa-causal": (1, 2, True, 0, (2, 16, 4, 2, 8)),
    "1x2-window4": (1, 2, True, 4, (2, 16, 4, 4, 8)),
    "2x2-causal": (2, 2, True, 0, (4, 16, 4, 4, 8)),
    "2x2-full": (2, 2, False, 0, (4, 16, 4, 4, 8)),
    "1x4-causal": (1, 4, True, 0, (1, 32, 8, 8, 4)),  # JAX's Ulysses-vs-ring shape
}

SEQ = 16
LM_KW = {"dim": 32, "depth": 2, "heads": 4}
LM_BASE = dict(model="causal_lm", dataset="retrieval",
               dataset_kwargs={"vocab": 16, "seq_len": SEQ}, n_train=16, n_test=16,
               batch_size=16, epochs=2, quiet=True, eval_batch_size=16, seed=4,
               target_accuracy=None)
# the port's runs from each JAX trainer's state: name -> (pos, attn, sp_impl)
LM_RUNS = {"ring_dense": ("rope", "vanilla", "ring"), "ring_flash": ("rope", "flash", "ring"),
           "ulysses_flash": ("rope", "flash", "ulysses"),
           "ulysses_vanilla": ("rope", "vanilla", "ulysses"),
           "learned_ring_flash": ("learned", "flash", "ring")}


def _case_arrays(name):
    dp, sp, causal, window, (b, s, h, hkv, d) = CASES[name]
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"q": mk(b, s, h, d), "k": mk(b, s, hkv, d), "v": mk(b, s, hkv, d),
            "w": mk(b, s, h, d), "dp": dp, "sp": sp, "causal": causal, "window": window,
            "impl": "ulysses", "inner": "vanilla"}


@functools.cache
def _jax_case(name):
    """JAX's Ulysses, vanilla attention and ring on the case: out, dq, dk, dv."""
    c = _case_arrays(name)
    q, k, v, w = (jnp.asarray(c[n]) for n in "qkvw")
    mesh = jax_make_mesh(dp=c["dp"], sp=c["sp"])
    fns = {"ulysses": jsp.make_ulysses_attention(mesh, causal=c["causal"], window=c["window"]),
           "vanilla": functools.partial(jra.vanilla_attention, causal=c["causal"],
                                        window=c["window"])}
    if not c["window"]:
        fns["ring"] = jra.make_ring_attention(mesh, causal=c["causal"])
    out = {}
    for label, fn in fns.items():
        grads = jax.jit(jax.grad(lambda q, k, v, fn=fn: (fn(q, k, v) * w).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
        out[label] = {"out": np.asarray(jax.jit(fn)(q, k, v)),
                      **dict(zip(("dq", "dk", "dv"), map(np.asarray, grads)))}
    return out


def _lm_cfg(pos="rope", attn="vanilla", dtype=jnp.float32, **kw):
    mk = dict(LM_KW, pos=pos, attn=attn, dtype=dtype)
    return dict(LM_BASE, model_kwargs=mk, **kw)


def _jax_lm(pos: str):
    """JAX's LM trainer at dp=1 x sp=2 (the ring, dense inner): its initial
    state (numpy) and its epochs' train losses."""
    jt = JaxTrainer(JaxRunConfig(name=f"lm_{pos}", **_lm_cfg(pos), dp=1, sp=2))
    assert jt.mesh.shape["seq"] == 2
    init = jax.tree.map(np.asarray, jt.state)
    jt.fit()
    return init, [h["train_loss"] for h in jt.history]


def _port_cfg(pos, attn, **kw):
    return _lm_cfg(pos, attn, dtype=torch.float32, **kw)


def _form(init, pos):
    return train_state_dict(init, RunConfig(**_port_cfg(pos, "vanilla")), num_classes=16,
                            seq_len=SEQ)


def _jax_error(**kw) -> str:
    try:
        JaxTrainer(JaxRunConfig(**kw))
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _lm_refused(model_kw=None, **kw):
    """The LM config of a refusal case (JAX's dtype; the rank swaps torch's in)."""
    cfg = _lm_cfg(**kw)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], **(model_kw or {}))
    return cfg


# refused configs: name -> (config, world); JAX refuses each with the same
# type and message (its sp hot-path validation)
REFUSALS = {
    "not_a_sequence_model": (dict(model="lenet5", synthetic=True, n_train=64, n_test=32,
                                  batch_size=32, sp=2, quiet=True), 2),
    "unknown_sp_impl": (dict(model="vit", synthetic=True, n_train=64, n_test=32,
                             batch_size=32, sp=2, sp_impl="bogus", quiet=True), 2),
    "window_with_ring": (_lm_refused({"window": 4}, sp=2), 2),
    "seq_not_divisible": (dict(_lm_refused(sp=2), dataset_kwargs={"vocab": 16,
                                                                  "seq_len": 15}), 2),
    "ulysses_heads_kv": (_lm_refused({"heads_kv": 1}, sp=2, sp_impl="ulysses"), 2),
    "microbatch": (_lm_refused(dp=2, sp=2, grad_accum=16), 4),
}
JAX_REFUSES = sorted(REFUSALS)
PORT_ONLY = {  # JAX composes these with sp, and so does the port (item 7.7)
    "fsdp": (_lm_refused(dp=2, sp=2, fsdp=True), 4),
    "moe": (_lm_refused({"moe_every": 2}, sp=2), 2),
    "multislice": (_lm_refused(dp=2, sp=2, dcn_dp=2), 4),
}
# sharded_update beside sp: JAX's ValueError, worded for the port's param
# specs (the port has no GSPMD), as under expert parallelism
SHARDED_UPDATE = (_lm_refused(dp=2, sp=2, sharded_update=True), 4)
STREAM = (_lm_refused(sp=2, input_mode="stream"), 2)  # JAX's words (trainer.py:458)


def _port_refusal_cfg(cfg: dict) -> dict:
    mk = dict(cfg.get("model_kwargs", {}))
    if "dtype" in mk:
        mk["dtype"] = torch.float32
    return dict(cfg, model_kwargs=mk)


CLI_ARGV = ["--set", "model=causal_lm", "--set", "dataset=retrieval",
            "--set", "model_kwargs={'dim': 16, 'depth': 1, 'heads': 4}",
            "--set", "dataset_kwargs={'vocab': 16, 'seq_len': 8}",
            "--set", "n_train=32", "--set", "n_test=16", "--set", "batch_size=8",
            "--set", "epochs=1", "--set", "sp=2", "--set", "sp_impl=ulysses",
            "--set", "quiet=True"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    jax_lm = {pos: _jax_lm(pos) for pos in ("rope", "learned")}
    forms = {pos: _form(init, pos) for pos, (init, _) in jax_lm.items()}
    jobs = {2: {}, 4: {}}
    for name, (pos, attn, impl) in LM_RUNS.items():
        jobs[2][f"lm_{name}"] = {"kind": "fit", "form": forms[pos], "spy_inputs": True,
                                 "config": _port_cfg(pos, attn, sp=2, sp_impl=impl)}
    jobs[4]["lm_2x2_ring_flash"] = {"kind": "fit", "form": forms["rope"], "spy_inputs": True,
                                    "config": _port_cfg("rope", "flash", dp=2, sp=2)}
    jobs[2]["resume"] = {"kind": "resume", "config": _port_cfg(
        "rope", "flash", sp=2, sp_impl="ulysses", n_train=32, epochs=1,
        checkpoint_dir=str(tmp / "ckpt"))}
    for world in (2, 4):
        jobs[world]["refusals"] = {"kind": "refusals", "configs": {
            name: _port_refusal_cfg(cfg) for name, (cfg, w) in {
                **REFUSALS, **PORT_ONLY, "sharded_update": SHARDED_UPDATE,
                "stream": STREAM}.items()
            if w == world}}
    for name in ("fsdp", "moe"):  # composed since item 7.7: one epoch each
        cfg, world = PORT_ONLY[name]
        jobs[world][f"composed_{name}"] = {"kind": "fit", "config": _port_refusal_cfg(cfg)}
    jobs[4]["cli"] = {"kind": "cli", "argv": CLI_ARGV}
    jobs[4]["dense_path"] = {"kind": "dense_path", "model_kw": {
        "num_classes": 16, "dim": 16, "depth": 1, "heads": 2},
        "tokens": np.random.default_rng(3).integers(0, 16, size=(2, 8)).astype(np.int32)}
    by_world = {2: {}, 4: {}}
    for name in CASES:
        c = _case_arrays(name)
        by_world[c["dp"] * c["sp"]][name] = c
    out = {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}",
                             args=(w, by_world[w], {}, jobs[w]), timeout=300)
           for w in (2, 4)}
    sp1 = {}
    for pos in ("rope", "learned"):
        with Trainer(RunConfig(**_port_cfg(pos, "flash")), device="cpu") as t:
            t.state.load_state_dict(forms[pos])
            t.fit()
            sp1[pos] = [h["train_loss"] for h in t.history]
    return {"ranks": out, "jax_lm": {p: v[1] for p, v in jax_lm.items()}, "sp1": sp1}


def test_ranks_import_no_jax(port):
    for world in port["ranks"].values():
        assert all(r["forbidden"] == [] for r in world)


def _world(name):
    return CASES[name][0] * CASES[name][1]


def _gathered(ranks_out, name, key):
    dp, sp = CASES[name][:2]
    rows = [np.concatenate([ranks_out[d * sp + s][name][key] for s in range(sp)], axis=1)
            for d in range(dp)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_forward_matches_jax(port, name):
    got = _gathered(port["ranks"][_world(name)], name, "out")
    for label, want in _jax_case(name).items():  # Ulysses, vanilla, the ring
        np.testing.assert_allclose(got, want["out"], atol=FWD_TOL, rtol=0, err_msg=label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_grads_match_jax(port, name):
    want = _jax_case(name)
    for key in ("dq", "dk", "dv"):
        got = _gathered(port["ranks"][_world(name)], name, key)
        for label, w in want.items():
            np.testing.assert_allclose(got, w[key], atol=GRAD_TOL, rtol=0,
                                       err_msg=f"{label} {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_inner_sees_the_whole_sequence_and_a_head_slice(port, name):
    dp, sp, _, _, (b, s, h, _, d) = CASES[name]
    for r in port["ranks"][_world(name)]:
        assert r[name]["local"] == (b // dp, s // sp, h, d)
        assert r[name]["inner_shapes"] == [(b // dp, s, h // sp, d)]
        assert r[name]["hops"] == [] and r[name]["block_fwd"] == 0


def test_indivisible_heads_run_the_whole_sequence_unsharded(port):
    for r in port["ranks"][4]:
        rec = r["dense_path"]
        assert rec["span"] is None
        np.testing.assert_allclose(rec["sp"], rec["plain"], rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(LM_RUNS))
def test_lm_sp2_losses_match_jax_sp_trainer_and_sp1(port, name):
    pos = LM_RUNS[name][0]
    for r in port["ranks"][2]:
        rec = r[f"lm_{name}"]
        np.testing.assert_allclose(rec["losses"], port["jax_lm"][pos], rtol=LOSS_JAX)
        np.testing.assert_allclose(rec["losses"], port["sp1"][pos], rtol=LOSS_SP1)
        assert rec["step"] == 2 and rec["chips"] == 2 and rec["path_label"] == "dp1_sp2"
        # the attention is handed this rank's 8 of the 16 positions only
        assert rec["attn_inputs"] == [((16, 8, 4, 8), (16, 8, 4, 8))]


def test_lm_dp2_sp2_losses_match_jax_and_sp1(port):
    for r in port["ranks"][4]:
        rec = r["lm_2x2_ring_flash"]
        np.testing.assert_allclose(rec["losses"], port["jax_lm"]["rope"], rtol=LOSS_JAX)
        np.testing.assert_allclose(rec["losses"], port["sp1"]["rope"], rtol=LOSS_SP1)
        assert rec["chips"] == 4 and rec["path_label"] == "dp2_sp2"
        assert rec["attn_inputs"] == [((8, 8, 4, 8), (8, 8, 4, 8))]


def test_resume_at_sp2_continues_the_run_and_decodes_on_one_device(port):
    for r in port["ranks"][2]:
        rec = r["resume"]
        assert rec["step"] == 2 * rec["spe"]
        np.testing.assert_allclose(rec["loss"], rec["uninterrupted"][1], rtol=1e-6)
        assert len(rec["generated"][0]) == 6 and rec["generated"][0][:3] == [1, 2, 3]
    assert port["ranks"][2][0]["resume"]["generated"] == port["ranks"][2][1]["resume"][
        "generated"]


@pytest.mark.parametrize("name", JAX_REFUSES)
def test_refusals_are_jaxs(port, name):
    cfg, world = REFUSALS[name]
    want = _jax_error(**cfg)
    assert want != "no error"
    for r in port["ranks"][world]:
        assert r["refusals"][name] == want


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_compositions_left_out_name_item_7(port, name):
    """Item 7.7 composed these with sp: fsdp and MoE blocks build and train
    an epoch to finite losses; multislice gets past its old refusal to the
    node check, which on this one node refuses it as JAX refuses it on
    virtual devices (a ``ValueError`` naming the slices found)."""
    world = PORT_ONLY[name][1]
    for r in port["ranks"][world]:
        got = r["refusals"][name]
        if name == "multislice":
            assert got.startswith("ValueError") and "slice" in got, got
            continue
        assert got == "no error", got
        assert np.all(np.isfinite(r[f"composed_{name}"]["losses"]))


def test_sharded_update_beside_sp_is_refused_as_jax_refuses_it(port):
    want = _jax_error(**SHARDED_UPDATE[0])
    assert want.startswith("ValueError: sharded_update composes with plain dp")
    for r in port["ranks"][4]:
        got = r["refusals"]["sharded_update"]
        assert got.split(" via ")[0] == want.split(" via ")[0]


def test_stream_mode_beside_sp_is_refused(port):
    for r in port["ranks"][2]:
        assert r["refusals"]["stream"] == (
            "ValueError: input_mode='stream' does not compose with tp/sp/pp/fsdp/"
            "expert parallelism; use device mode")


def test_cli_sets_sp_and_trains_at_dp_world_over_sp(port):
    want = jax_build_config(CLI_ARGV)
    assert (want.sp, want.sp_impl) == (2, "ulysses")
    for r in port["ranks"][4]:
        assert r["cli"] == {"sp": 2, "sp_impl": "ulysses", "dp": 2, "rc": 0}


# ---------------------------------------------------------------- one process


def test_world_config_gives_the_data_axis_what_sp_leaves():
    cfg = cli.build_config(CLI_ARGV)
    assert cli.world_config(cfg, 4).dp == 2
    assert cli.world_config(cfg.replace(sp=1), 4).dp == 4
    assert cli.world_config(cfg, 1) == cfg


def test_ulysses_of_one_rank_is_the_inner():
    mesh = Mesh(shape={"data": 1, "model": 1, "seq": 1, "pipe": 1}, rank=0)
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 12, 4, 8)).astype(np.float32))
               for _ in range(3))
    got = make_ulysses_attention(mesh, causal=True, window=3)(q, k, v)
    torch.testing.assert_close(got, vanilla_attention(q, k, v, causal=True, window=3),
                               rtol=0, atol=0)
    assert make_ulysses_attention(mesh).local_span(12, 3, 3) == (0, 12)


def test_sp_without_a_process_group_names_the_launcher():
    with pytest.raises(ValueError, match="launch.torchrun"):
        Trainer(RunConfig(**_port_cfg("rope", "vanilla", sp=2)), device="cpu")
