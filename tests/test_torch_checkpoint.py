"""Checkpoints of the port (``utils/checkpoint.py``, the Trainer's save,
restore and resume) and the carry of a JAX ``TrainState`` into the port
(``convert.load_train_state``), on the CPU at toy sizes.

* STATE CARRY: a JAX ``TrainState`` after two steps, converted, then one
  port step on the next batch equals JAX's third step: parameters,
  ``batch_stats``, the optimizer's moments and count, the step.  LeNet-5
  (dropout 0) under adam with a global-norm clip and ResNet-20 (its
  ``batch_stats`` carried) under nesterov momentum with weight decay, in
  float32, each tensor within 1e-5 of its largest magnitude (under Adam,
  a parameter element whose second moment sits at rounding level, under
  1e-6 of the tensor's largest, within 2 lr: Adam's ratio amplifies the
  frameworks' float32 rounding there).  The converter is strict: a
  missing moment, a chain of the wrong kind, counts that disagree, stray
  ``batch_stats``.
* THE FORMAT: one directory per step (``torch.load(weights_only=True)``),
  the manifest's sizes and digests, ``max_to_keep``, a same-step
  overwrite, the name-keyed form loading strictly.
* THE INTACT WALK: newest -> oldest in the JAX order: a truncated,
  deleted or bit-flipped file (manifest mismatch), an emptied step,
  a step without a manifest (unknown: still restored when it loads), a
  non-finite state, a mislabelled step; exhaustion lists every reason;
  the chaos sites ``checkpoint-write`` (torn, io) and ``checkpoint-read``.
* ASYNC SAVE: ``save(wait=False)``, one more in-place step, then the
  restore: the saved step's state, not the next one's.
* THE TRAINER: a resumed fit is bit-equal to the uninterrupted one; the
  step axis of the records continues; ``checkpoint_every`` is independent
  of ``eval_every``; a torn newest step is walked past on resume.
* DP: two gloo ranks (one spawn for the module) save at dp=2 (rank 0
  writes) and resume a dp=1 checkpoint at dp=2; here, the dp=2 checkpoint
  resumes at dp=1; a ZeRO-1 checkpoint restores bit-equal at its dp and
  raises ``ValueError`` naming both dp values at another.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_train_state, train_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import debug
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_state,
    save_state,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

import torch_dp_ranks as ranks

torch.set_num_threads(1)

CARRY_REL = 1e-5  # each tensor, relative to its largest magnitude


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- state carry

CARRY = {
    "lenet5-adam-clip": dict(model="lenet5", size=28, opt=dict(
        optimizer="adam", lr=1e-3, grad_clip=0.5),
        model_kw=dict(dropout_rate=0.0, dtype=torch.float32)),
    "resnet20-momentum-wd": dict(model="resnet20", size=16, opt=dict(
        optimizer="momentum", lr=0.05, weight_decay=1e-4),
        model_kw=dict(dtype=torch.float32, in_channels=1)),
}
JAX_MODEL_KW = {"lenet5": dict(dropout_rate=0.0, dtype=jnp.float32),
                "resnet20": dict(dtype=jnp.float32)}


def _carry_batches(size, n=3, rows=8):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (rows, size, size, 1)).astype(np.uint8),
             rng.integers(0, 10, rows).astype(np.int32)) for _ in range(n)]


def _rel(got: torch.Tensor, want, key: str, where=None) -> None:
    """Each element within CARRY_REL of the tensor's largest magnitude
    (over the elements ``where`` selects, when given)."""
    want = np.asarray(want)
    diff = np.abs(got.detach().numpy() - want)
    if where is not None:
        diff = diff[where]
    assert diff.max() <= CARRY_REL * max(np.abs(want).max(), 1e-30), (key, diff.max())


@pytest.mark.parametrize("case", sorted(CARRY))
def test_jax_state_after_two_steps_continues_in_the_port(case):
    c = CARRY[case]
    cfg = RunConfig(model=c["model"], model_kwargs=c["model_kw"], batch_size=8, **c["opt"])
    jmodel = jax_get_model(c["model"], num_classes=10, **JAX_MODEL_KW[c["model"]])
    tx = jax_make_optimizer(JaxRunConfig(**c["opt"]), 10)
    jstate = JaxTrainState.create(jmodel, tx, jax.random.PRNGKey(0),
                                  jnp.zeros((1, c["size"], c["size"], 1), jnp.uint8))
    jstep = jax.jit(jax_steps.make_train_step(jmodel, tx))
    batches = _carry_batches(c["size"])
    for x, y in batches[:2]:
        jstate, _ = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    carried = _np(jstate)
    jnext, jm = jstep(jstate, {"image": jnp.asarray(batches[2][0]),
                               "label": jnp.asarray(batches[2][1])})

    state = load_train_state(carried, cfg, device="cpu", total_steps=10)
    assert state.step == 2 and state.optimizer.count == 2
    m = steps.make_train_step(state.model, state.optimizer)(
        state, {"image": torch.from_numpy(batches[2][0]),
                "label": torch.from_numpy(batches[2][1])})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = train_state_dict(_np(jnext), cfg)
    assert state.step == want["step"] == 3 and state.optimizer.count == 3
    lr = c["opt"]["lr"]
    for key, p in state.model.named_parameters():
        if c["opt"]["optimizer"] != "adam":
            _rel(p, want["params"][key], key)
            continue
        # Adam's step is lr * mu / (sqrt(nu) + eps): where the gradients
        # have stayed at rounding level (nu under 1e-6 of the tensor's
        # largest) that ratio amplifies float32 rounding, so such elements
        # are held to 2 lr; the rest to CARRY_REL
        nu = np.asarray(want["optimizer"]["nu"][key])
        real = nu >= 1e-6 * nu.max()
        assert real.mean() > 0.5, key
        _rel(p, want["params"][key], key, where=real)
        assert np.abs(p.detach().numpy() - np.asarray(want["params"][key])).max() <= 2 * lr
    for key, b in state.model.named_buffers():
        _rel(b, want["buffers"][key], key)
    got_opt = state.optimizer.state_dict([n for n, _ in state.model.named_parameters()])
    for moment in ("mu", "nu", "trace"):
        assert got_opt[moment].keys() == want["optimizer"][moment].keys()
        for key, t in got_opt[moment].items():
            _rel(t, want["optimizer"][moment][key], f"{moment}/{key}")


def _lenet_jax_state(opt):
    jmodel = jax_get_model("lenet5", num_classes=10, dropout_rate=0.0)
    tx = jax_make_optimizer(JaxRunConfig(**opt), 10)
    return _np(JaxTrainState.create(jmodel, tx, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 28, 28, 1), jnp.uint8)))


def test_state_carry_is_strict():
    adam = _lenet_jax_state(dict(optimizer="adam"))
    with pytest.raises(ValueError, match="momentum chain keeps"):
        train_state_dict(adam, RunConfig(model="lenet5", optimizer="momentum"))
    mu = dict(adam.opt_state[0].mu)
    mu.pop("fc1")
    bad = adam.replace(opt_state=(adam.opt_state[0]._replace(mu=mu), adam.opt_state[1]))
    with pytest.raises(ValueError, match="opt_state/0/mu: missing leaves"):
        train_state_dict(bad, RunConfig(model="lenet5"))
    count = adam.opt_state[1]._replace(count=np.asarray(5, np.int32))
    with pytest.raises(ValueError, match="counts disagree"):
        train_state_dict(adam.replace(opt_state=(adam.opt_state[0], count)),
                         RunConfig(model="lenet5"))
    with pytest.raises(ValueError, match="batch_stats"):
        train_state_dict(adam.replace(batch_stats={"x": {"mean": np.zeros(2)}}),
                         RunConfig(model="lenet5"))


# ---------------------------------------------------------------- the format


def _state(seed=0, step=0, optimizer="adam"):
    model = get_model("mlp", num_classes=10, in_features=784, hidden=(16,), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(RunConfig(optimizer=optimizer), 10, list(model.parameters()))
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = TrainState(step=step, model=model, optimizer=opt, data_generator=gen)
    opt.count = step
    with torch.no_grad():
        for t in opt.mu + opt.nu:
            t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return state


def _equal_states(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    flat = lambda sd: {**{f"p/{k}": v for k, v in sd["params"].items()},  # noqa: E731
                       **{f"mu/{k}": v for k, v in sd["optimizer"]["mu"].items()},
                       **{f"nu/{k}": v for k, v in sd["optimizer"]["nu"].items()}}
    fa, fb = flat(sa), flat(sb)
    return (sa["step"] == sb["step"] and sa["optimizer"]["count"] == sb["optimizer"]["count"]
            and fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
            and torch.equal(sa["generators"]["data"], sb["generators"]["data"]))


def test_state_roundtrip_and_manifest(tmp_path):
    good = _state(seed=1, step=5)
    assert save_state(str(tmp_path / "ck"), good) == 5
    assert sorted(os.listdir(tmp_path / "ck")) == ["5", "manifest_5.json"]
    assert sorted(os.listdir(tmp_path / "ck" / "5")) == ["meta.pt", "model.pt", "optimizer.pt"]
    manifest = json.loads((tmp_path / "ck" / "manifest_5.json").read_text())
    assert manifest["step"] == 5 and manifest["tree_digest"]
    assert {f: manifest["files"][f]["size"] for f in manifest["files"]} == {
        f: os.path.getsize(tmp_path / "ck" / "5" / f) for f in os.listdir(tmp_path / "ck" / "5")}
    for name in os.listdir(tmp_path / "ck" / "5"):  # plain tensors only
        torch.load(tmp_path / "ck" / "5" / name, weights_only=True)
    target = _state(seed=2)
    assert restore_state(str(tmp_path / "ck"), target) is target
    assert _equal_states(target, good)


def test_manager_latest_missing_and_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(_state())
    for step in (1, 2, 3, 4):
        mgr.save(_state(seed=step, step=step), wait=step % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    assert not os.path.exists(tmp_path / "ck" / "manifest_1.json")
    assert all(mgr.verify_step(s) == (True, "ok") for s in (2, 3, 4))
    assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4]
    assert all(t["blocked_s"] >= 0 and t["landed_s"] >= t["blocked_s"] for t in mgr.timings)
    mgr.save(_state(seed=9, step=4), wait=True)  # same-step overwrite
    assert _equal_states(mgr.restore(_state(), step=4), _state(seed=9, step=4))
    assert mgr.verify_step(4) == (True, "ok")


def test_load_is_strict_by_name(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(_state(seed=1, step=3), wait=True)
    other = get_model("mlp", num_classes=10, in_features=784, hidden=(8,), device="cpu")
    target = TrainState(step=0, model=other, optimizer=make_optimizer(
        RunConfig(), 10, list(other.parameters())), data_generator=torch.Generator())
    with pytest.raises(ValueError, match="saved shape"):
        mgr.restore(target)
    momentum = _state(optimizer="momentum")
    with pytest.raises(ValueError, match="momentum chain"):
        mgr.restore(momentum)
    assert momentum.step == 0  # nothing was copied


def test_async_save_snapshots_the_step_it_was_given(tmp_path):
    """save(wait=False) then an in-place step at once: the checkpoint holds
    the saved step's state, not the next one's."""
    model = get_model("mlp", num_classes=10, in_features=784, hidden=(64,), device="cpu",
                      dtype=torch.float32)
    opt = make_optimizer(RunConfig(optimizer="adam", lr=0.1), 10, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=opt, data_generator=torch.Generator())
    step = steps.make_train_step(model, opt)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (32, 28, 28, 1)).astype(np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 10, 32).astype(np.int32))}
    step(state, batch)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_mu = [t.clone() for t in opt.mu]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, wait=False)
    for _ in range(3):  # in-place updates while the writer runs
        step(state, batch)
    mgr.wait()
    got = mgr.restore()
    assert got["step"] == 1 and got["optimizer"]["count"] == 1
    for k, v in want.items():
        assert torch.equal(got["params"][k], v), k
        assert not torch.equal(model.state_dict()[k], v), k
    names = [n for n, _ in model.named_parameters()]
    assert all(torch.equal(got["optimizer"]["mu"][n], t) for n, t in zip(names, want_mu))


# ---------------------------------------------------------------- the intact walk


def _largest_file(step_dir):
    return max((os.path.join(step_dir, f) for f in os.listdir(step_dir)), key=os.path.getsize)


def _corrupt(step_dir, mode):
    victim = _largest_file(step_dir)
    if mode == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    elif mode == "delete":
        os.remove(victim)
    elif mode == "flip":  # same size, other bytes: only the digest sees it
        with open(victim, "r+b") as f:
            data = bytearray(f.read())
            data[len(data) // 2] ^= 0xFF
            f.seek(0)
            f.write(data)


def _two_steps(tmp_path, chaos=None):
    mgr = CheckpointManager(str(tmp_path / "ck"), chaos=chaos)
    mgr.save(_state(seed=1, step=5), wait=True)
    mgr.save(_state(seed=2, step=10), wait=True)
    return mgr


@pytest.mark.parametrize("mode", ["truncate", "delete", "flip"])
def test_walk_passes_a_corrupt_newest_step(tmp_path, mode):
    mgr = _two_steps(tmp_path)
    _corrupt(str(tmp_path / "ck" / "10"), mode)
    assert mgr.verify_step(10) == (False, "manifest mismatch")
    restored = mgr.restore_latest_intact(_state(seed=3))
    assert restored.step == 5 and _equal_states(restored, _state(seed=1, step=5))
    assert mgr.skipped == [(10, "manifest mismatch")]


def test_walk_order_and_reasons(tmp_path):
    """Unknown ("no manifest") steps are tried; non-finite and mislabelled
    states are demoted; exhaustion lists every step's reason."""
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=10)
    mgr.save(_state(seed=1, step=5), wait=True)
    mgr.save(_state(seed=2, step=10), wait=True)
    os.remove(tmp_path / "ck" / "manifest_10.json")
    assert mgr.verify_step(10) == (False, "no manifest")
    assert mgr.restore_latest_intact(_state()).step == 10  # unknown, but it loads
    bad = _state(seed=3, step=15)
    debug.inject_nan(bad, "dense_0.weight")
    mgr.save(bad, wait=True)
    assert mgr.verify_step(15) == (True, "ok")  # the bytes are fine
    mgr.save(_state(seed=4, step=20), wait=True)
    os.rename(tmp_path / "ck" / "20", tmp_path / "ck" / "25")  # a mislabelled step
    os.rename(tmp_path / "ck" / "manifest_20.json", tmp_path / "ck" / "manifest_25.json")
    assert mgr.restore_latest_intact(_state()).step == 10
    assert mgr.skipped == [(25, "step mismatch: dir 25 != state 20"),
                           (15, "restored state non-finite")]
    for step in (10, 5):
        shutil.rmtree(tmp_path / "ck" / str(step))
        os.makedirs(tmp_path / "ck" / str(step))  # the step exists in name only
    with pytest.raises(FileNotFoundError, match="no intact checkpoint") as e:
        mgr.restore_latest_intact(_state())
    msg = str(e.value)
    assert msg.index("step 25") < msg.index("step 15") < msg.index("step 10") < msg.index(
        "step 5")
    assert "step 10: restore failed" in msg and "step 5: manifest mismatch" in msg


def test_chaos_torn_write_and_read_fault(tmp_path):
    inj = FaultInjector(FaultPlan(faults=(
        FaultSpec(site="checkpoint-write", kind="torn", at=(1,)),
        FaultSpec(site="checkpoint-write", kind="io", at=(2,)),
        FaultSpec(site="checkpoint-read", kind="io", at=(0,)),
    )))
    mgr = _two_steps(tmp_path, chaos=inj)  # event 1 tears step 10
    assert not os.path.exists(tmp_path / "ck" / "manifest_10.json")
    with pytest.raises(OSError, match="checkpoint-write"):
        mgr.save(_state(step=15))
    assert mgr.all_steps() == [5, 10]
    # read event 0 fails step 10 (torn anyway), event 1 restores step 5
    assert mgr.restore_latest_intact(_state()).step == 5
    assert mgr.skipped[0][0] == 10 and "OSError" in mgr.skipped[0][1]
    assert inj.summary()["by_site"] == {"checkpoint-write": 2, "checkpoint-read": 1}


# ---------------------------------------------------------------- the Trainer


def _cfg(tmp_path, **kw):
    base = dict(model="mlp", model_kwargs={"hidden": (32,), "dtype": torch.float32},
                synthetic=True, n_train=512, n_test=128, batch_size=64, epochs=3,
                schedule="cosine", quiet=True, checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_every=1)
    return RunConfig(**{**base, **kw})


def _fit(cfg, epochs=None, **extra):
    t = Trainer(cfg, device="cpu", **extra)
    if epochs is not None:  # run part of a schedule sized for cfg.epochs
        t.config = t.config.replace(epochs=epochs)
    summary = t.fit()
    t.close()
    return t, summary


def test_resumed_fit_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    full, _ = _fit(_cfg(tmp_path / "a"))
    _fit(_cfg(tmp_path / "b"), epochs=1)
    resumed, _ = _fit(_cfg(tmp_path / "b", resume=True), epochs=2)
    assert resumed.state.step == full.state.step == 3 * full.steps_per_epoch
    assert _equal_states(resumed.state, full.state)
    assert [r["train_loss"] for r in resumed.history] == [
        r["train_loss"] for r in full.history[1:]]


def test_resume_records_continue_the_step_axis(tmp_path):
    path = tmp_path / "m.jsonl"
    t, _ = _fit(_cfg(tmp_path, epochs=2, metrics_path=str(path)))
    _fit(_cfg(tmp_path, epochs=1, resume=True, metrics_path=str(path)))
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    spe = t.steps_per_epoch
    assert [r["step"] for r in recs if r["kind"] == "epoch"] == [spe, 2 * spe, 3 * spe]
    assert [r["step"] for r in recs if r["kind"] == "resume"] == [2 * spe]


def test_checkpoint_cadence_is_independent_of_eval_every(tmp_path):
    t, _ = _fit(_cfg(tmp_path, epochs=4, eval_every=4, checkpoint_every=2))
    spe = t.steps_per_epoch
    assert t._ckpt.all_steps() == [2 * spe, 4 * spe]
    assert [r.get("test_accuracy") is not None for r in t.history] == [False, False, False, True]


def test_resume_walks_past_a_torn_newest_step(tmp_path):
    t, _ = _fit(_cfg(tmp_path, epochs=2))
    spe = t.steps_per_epoch
    _corrupt(str(tmp_path / "ck" / str(2 * spe)), "truncate")
    t2 = Trainer(_cfg(tmp_path, epochs=1, resume=True), device="cpu")
    assert t2.restore_checkpoint() == spe
    assert t2._ckpt.skipped == [(2 * spe, "manifest mismatch")]
    with pytest.raises(Exception):
        t2.restore_checkpoint(step=2 * spe)  # an explicit step is restored as asked
    assert t2.fit()["epochs_run"] == 1 and t2.state.step == 2 * spe


# ---------------------------------------------------------------- dp


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checkpoint_dp")
    with Trainer(ranks._mini_cfg(epochs=1, checkpoint_dir=str(tmp / "dp1")), device="cpu") as t:
        t.fit()
        dp1 = {"step": t.state.step, "params": ranks._params_of(t)}
    out = torchrun.spawn(ranks.checkpoint_dp, 2, "gloo", "cpu", tmp / "store",
                         args=(str(tmp),), timeout=240)
    return tmp, dp1, out


def test_dp2_ranks_import_no_jax(dp_run):
    _, _, out = dp_run
    assert out[0]["forbidden"] == [] and out[1]["forbidden"] == []


def test_dp2_checkpoint_resumes_at_dp1_and_dp1_at_dp2(dp_run):
    tmp, dp1, out = dp_run
    r0, r1 = out
    assert sorted(os.listdir(tmp / "dp2")) == [str(r0["dp2"]["step"]),
                                               f"manifest_{r0['dp2']['step']}.json"]
    with Trainer(ranks._mini_cfg(epochs=1, checkpoint_dir=str(tmp / "dp2")),
                 device="cpu") as t:
        assert t.restore_checkpoint() == r0["dp2"]["step"]
        for k, v in ranks._params_of(t).items():
            np.testing.assert_array_equal(v, r0["dp2"]["params"][k], err_msg=k)
    for r in (r0, r1):  # every rank restored the dp=1 state, then trained on
        assert r["dp1_restored_step"] == dp1["step"]
        for k, v in r["dp1_restored"].items():
            np.testing.assert_array_equal(v, dp1["params"][k], err_msg=k)
        assert r["dp1_resumed_step"] == dp1["step"] + r0["dp2"]["step"]


def test_zero1_checkpoint_is_bound_to_its_dp(dp_run):
    tmp, _, out = dp_run
    assert all(r["zero1_shards_equal"] and r["zero1_count"] == r["zero1_step"] for r in out)
    cfg = ranks._mini_cfg(epochs=1, checkpoint_dir=str(tmp / "zero1"))
    with Trainer(cfg, device="cpu") as t:
        with pytest.raises(ValueError, match=r"dp=2.*dp=1"):
            t.restore_checkpoint()
