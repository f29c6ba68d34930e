"""The port's training path against the JAX package, on the CPU at toy sizes.

* synthetic MNIST is bit-identical for the same ``(seed, n)``;
* every schedule equals optax's at every step, and every optimizer chain
  equals optax's over 10 updates on the same numpy gradients;
* one train step of LeNet-5 (float32, no dropout) equals JAX's on the same
  batch and weights, through the plain loss and through the fused kernels'
  CPU twins;
* the slice as a whole: one epoch of the epoch runner fed JAX's own
  permutation gives JAX's per-step losses, final parameters and eval;
* the Trainer: learning, early stop, record keys, throughput leaving the
  state alone, the refusals, the CLI.

Both sides compute in float32 here; the tolerances cover reduction order.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_schedule as jax_make_schedule
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.data import synthetic as jax_synthetic
from distributed_tensorflow_ibm_mnist_tpu.launch import cli as jax_cli
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import lenet5_state_dict, load_lenet5
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer, make_schedule
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.data import load_dataset, synthetic
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import cli
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig, get_preset

torch.set_num_threads(1)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", ["synthetic_mnist", "synthetic_fashion_mnist"])
def test_synthetic_data_is_bit_identical_to_jax(name, seed):
    got = getattr(synthetic, name)(n_train=96, n_test=40, seed=seed)
    want = getattr(jax_synthetic, name)(n_train=96, n_test=40, seed=seed)
    assert set(got) == set(want)
    for key in ("train_images", "train_labels", "test_images", "test_labels"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_loader_marks_synthetic_and_refuses_the_native_renderer(monkeypatch):
    data = load_dataset("mnist", n_train=32, n_test=16, synthetic=True)
    assert data["synthetic"] is True and data["train_images"].shape == (32, 28, 28, 1)
    monkeypatch.setenv("DTM_DATA_BACKEND", "native")
    with pytest.raises(NotImplementedError, match="native"):
        synthetic.synthetic_mnist(n_train=8, n_test=8)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule, total, warmup", [
    ("constant", 10, 0), ("cosine", 10, 0), ("cosine", 0, 0),
    ("warmup_cosine", 20, 5), ("warmup_cosine", 6, 50), ("warmup_cosine", 1, 3),
    ("warmup_cosine", 12, 0),
], ids=["constant", "cosine", "cosine-total0", "warmup", "warmup-clamped",
        "warmup-total1", "warmup0"])
def test_schedule_equals_optax_at_every_step(schedule, total, warmup):
    """optax evaluates in float32, the port in float64: the gap is float32
    rounding, at most 1.2e-7 x lr (near the end of a cosine, where 1 + cos
    cancels, that is more than 1e-6 of the small value itself)."""
    kw = dict(schedule=schedule, lr=0.3, warmup_steps=warmup)
    want = jax_make_schedule(JaxRunConfig(**kw), total)
    got = make_schedule(RunConfig(**kw), total)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=2e-7 * 0.3,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["nowd", "wd"])
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "momentum"])
def test_optimizer_chain_equals_optax_over_10_updates(opt, wd, clip):
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(10)]
    kw = dict(optimizer=opt, lr=0.05, schedule="warmup_cosine", warmup_steps=3,
              weight_decay=wd, grad_clip=clip)
    tx = jax_make_optimizer(JaxRunConfig(**kw), 10)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    port = make_optimizer(RunConfig(**kw), 10, tp)
    for gs in grads:
        updates, opt_state = jax.jit(tx.update)([jnp.asarray(g) for g in gs], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        port.step([torch.from_numpy(g) for g in gs])
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- one step

BATCH = 32


def _step_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, 28, 28, 1)).astype(np.uint8),
            rng.integers(0, 10, BATCH).astype(np.int32))


def _jax_state(cfg_kw, total=10):
    model = jax_get_model("lenet5", num_classes=10, dropout_rate=0.0, dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**cfg_kw), total)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 28, 28, 1), jnp.uint8))
    return model, tx, state


def _port_state(params_np, cfg_kw, total=10):
    model = load_lenet5(params_np, device="cpu", dtype=torch.float32, dropout_rate=0.0)
    opt = make_optimizer(RunConfig(**cfg_kw), total, list(model.parameters()))
    return model, opt, TrainState(step=0, model=model, optimizer=opt,
                                  data_generator=torch.Generator())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


STEP_CASES = {
    "sgd": dict(optimizer="sgd", lr=0.05),
    "sgd-fused": dict(optimizer="sgd", lr=0.05, fused_xent=True),
    "momentum": dict(optimizer="momentum", lr=0.05),
    "momentum-fused": dict(optimizer="momentum", lr=0.05, fused_xent=True),
    "adam": dict(optimizer="adam", lr=1e-3),
    "adam-fused": dict(optimizer="adam", lr=1e-3, fused_xent=True),
    "sgd-accum2": dict(optimizer="sgd", lr=0.05, grad_accum=2),
    "sgd-smoothing": dict(optimizer="sgd", lr=0.05, label_smoothing=0.1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_lenet_train_step_matches_jax(case):
    kw = dict(STEP_CASES[case])
    step_kw = {k: kw.pop(k) for k in ("fused_xent", "grad_accum", "label_smoothing")
               if k in kw}
    images, labels = _step_batch()
    jmodel, tx, jstate = _jax_state(kw)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    new_jstate, jm = jax.jit(jax_steps.make_train_step(jmodel, tx, **step_kw))(jstate, jbatch)

    params0 = _np(jstate.params)
    model, opt, state = _port_state(params0, kw)
    m = steps.make_train_step(model, opt, **step_kw)(
        state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert state.step == 1 and opt.count == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]), atol=1e-6)

    want = lenet5_state_dict(_np(new_jstate.params), {})
    got = model.state_dict()
    if kw["optimizer"] != "adam":
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-4,
                                       err_msg=key)
        return
    # Adam's first update is lr * g / (|g| + eps) ~ lr * sign(g): an element
    # whose gradient is at rounding level may flip sign between frameworks,
    # moving by at most 2 * lr.  Elements with a real gradient agree to 1e-5.
    loss_fn = jax_steps.make_loss_fn(jmodel, **step_kw)
    jgrads = jax.grad(lambda p: loss_fn(p, {}, jbatch, jax.random.PRNGKey(0))[0])(jstate.params)
    gmag = lenet5_state_dict(_np(jgrads), {})
    lr = kw["lr"]
    for key in want:
        diff = np.abs(got[key].numpy() - want[key].numpy())
        assert diff.max() <= 2 * lr + 1e-7, key
        real = np.abs(gmag[key].numpy()) > 1e-6
        assert real.mean() > 0.5, key
        assert diff[real].max() <= 1e-5, key


# ---------------------------------------------------------------- one epoch


def test_one_epoch_on_jax_permutation_matches_jax():
    """The slice as a whole: the epoch runner (device-style gather, fused
    loss, momentum, cosine schedule) fed JAX's own permutation.  At lr 0.02
    the two runs stay within 2e-6 of each other; at 0.05 this tiny run sits
    on an unstable edge (its loss jumps at step 2) that amplifies rounding
    to 1e-4."""
    n, batch = 512, 64
    kw = dict(optimizer="momentum", lr=0.02, schedule="cosine")
    data = synthetic.synthetic_mnist(n_train=n, n_test=200, seed=0)
    jmodel, tx, jstate = _jax_state(kw, total=n // batch)
    params0 = _np(jstate.params)
    epoch_rng = jax.random.PRNGKey(42)
    run = jax.jit(jax_steps.make_epoch_runner(jmodel, tx, batch, fused_xent=True))
    new_jstate, jm = run(jstate, jnp.asarray(data["train_images"]),
                         jnp.asarray(data["train_labels"]), epoch_rng)
    jeval = jax.jit(jax_steps.make_eval_fn(jmodel, batch_size=128))(
        new_jstate, jnp.asarray(data["test_images"]), jnp.asarray(data["test_labels"]))

    model, opt, state = _port_state(params0, kw, total=n // batch)
    perm = torch.from_numpy(np.array(jax.random.permutation(epoch_rng, n)))
    m = steps.make_epoch_runner(model, opt, batch, fused_xent=True)(
        state, torch.from_numpy(data["train_images"]),
        torch.from_numpy(data["train_labels"]), perm=perm)
    assert state.step == n // batch
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-4, rtol=1e-4)
    want = lenet5_state_dict(_np(new_jstate.params), {})
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=1e-4, err_msg=key)
    ev = steps.make_eval_fn(model, 128)(torch.from_numpy(data["test_images"]),
                                        torch.from_numpy(data["test_labels"]))
    np.testing.assert_allclose(float(ev["accuracy"]), float(jeval["accuracy"]), atol=1e-6)
    np.testing.assert_allclose(float(ev["loss"]), float(jeval["loss"]), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- Trainer


def _mlp_cfg(**kw):
    base = dict(n_train=1024, n_test=256, synthetic=True, quiet=True)
    return get_preset("mnist_mlp_smoke").replace(**{**base, **kw})


def test_mlp_smoke_preset_learns():
    """mnist_mlp_smoke at 2048 training images, 3 epochs: test accuracy
    above 0.75 (0.84 measured; chance is 0.1)."""
    summary = Trainer(_mlp_cfg(n_train=2048, n_test=512), device="cpu").fit()
    assert summary["epochs_run"] == 3
    assert summary["best_test_accuracy"] >= 0.75
    assert np.isfinite(summary["images_per_sec"])


def test_early_stop_at_target_accuracy():
    summary = Trainer(_mlp_cfg(epochs=5, target_accuracy=0.5), device="cpu").fit()
    assert summary["epochs_run"] == 1
    assert summary["time_to_target_s"] is not None and summary["best_test_accuracy"] >= 0.5


def test_records_carry_the_jax_key_names(tmp_path):
    path = tmp_path / "metrics.jsonl"
    Trainer(_mlp_cfg(epochs=2, eval_every=2, metrics_path=str(path), target_accuracy=None),
            device="cpu").fit()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    epochs = [r for r in records if r["kind"] == "epoch"]
    (summary,) = [r for r in records if r["kind"] == "summary"]
    epoch_keys = {"epoch", "train_loss", "train_accuracy", "epoch_time_s",
                  "interval_epochs", "images_per_sec", "images_per_sec_per_chip"}
    assert len(epochs) == 2 and all(epoch_keys <= set(r) for r in epochs)
    assert [r["interval_epochs"] for r in epochs] == [2, 2]  # one fetch per interval
    assert "test_accuracy" not in epochs[0] and "test_loss" in epochs[1]
    assert {"name", "epochs_run", "total_time_s", "compile_overhead_s",
            "best_test_accuracy", "time_to_target_s", "target_accuracy",
            "images_per_sec", "images_per_sec_per_chip", "param_count",
            "model_tflops_per_sec_per_chip", "mfu"} <= set(summary)
    # XLA-only keys are left out, not faked; no device metric from a CPU run
    assert not {"n_compiled_programs", "compile_time_s", "compile_by_site"} & set(summary)
    assert summary["mfu"] is None and summary["model_tflops_per_sec_per_chip"] is None


def test_measure_throughput_leaves_the_state_unchanged():
    trainer = Trainer(_mlp_cfg(n_train=512), device="cpu")
    trainer.fit()
    before = trainer.state.snapshot()
    out = trainer.measure_throughput(epochs=2)
    after = trainer.state.snapshot()
    assert out["epochs"] == 2 and out["images_per_sec_per_chip"] > 0 and out["chips"] == 1
    assert out["device"] == "cpu" and np.isfinite(out["last_loss"])
    assert after["step"] == before["step"] and after["optimizer"]["count"] == before[
        "optimizer"]["count"]
    for a, b in zip(after["params"], before["params"]):
        assert torch.equal(a, b)
    for a, b in zip(after["optimizer"]["tensors"], before["optimizer"]["tensors"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(after["generators"], before["generators"]):
        assert torch.equal(a, b)


REFUSED = {
    "tp2": dict(tp=2), "sp2": dict(sp=2), "pp2": dict(pp=2),
    "fsdp": dict(fsdp=True), "dcn_dp": dict(dcn_dp=2), "stream": dict(input_mode="stream"),
    "remat": dict(remat=True), "remat_blocks": dict(remat="blocks"),
    "checkpoint_dir": dict(checkpoint_dir="ckpt"), "resume": dict(resume=True),
    "profile_dir": dict(profile_dir="prof"),
    # the image models and the causal LM train now; what they still refuse,
    # under the old ids
    "vit": dict(model="vit", model_kwargs={"moe_every": 2}),
    "causal_lm": dict(model="causal_lm", dataset="retrieval",
                      model_kwargs={"dropout": 0.1}),
    "retrieval": dict(model="causal_lm", dataset="retrieval",
                      model_kwargs={"moe_every": 2}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_knobs_raise_not_implemented(case):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        Trainer(_mlp_cfg(**REFUSED[case]), device="cpu")


# data parallelism is ported: without a process group it asks for one (the
# ids were refusal cases of the test above)
NEEDS_A_GROUP = {
    "dp2": dict(dp=2),
    "sharded_update": dict(dp=2, sharded_update=True),
    "resnet20": dict(model="resnet20", model_kwargs={"axis_name": "data"}),
}


@pytest.mark.parametrize("case", sorted(NEEDS_A_GROUP))
def test_data_parallel_without_a_process_group_names_the_launcher(case):
    with pytest.raises(ValueError, match="launch.torchrun"):
        Trainer(_mlp_cfg(**NEEDS_A_GROUP[case]), device="cpu")


@pytest.mark.parametrize("hook", ["chaos", "tracer", "telemetry"])
def test_unported_hooks_raise_not_implemented(hook):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        Trainer(_mlp_cfg(), device="cpu", **{hook: object()})


def test_unknown_model_names_the_available_ones():
    with pytest.raises(ValueError, match="lenet5"):
        Trainer(_mlp_cfg(model="nope"), device="cpu")


def test_fused_xent_with_label_smoothing_raises_the_jax_error():
    with pytest.raises(ValueError) as want:
        jax_steps.make_loss_fn(None, label_smoothing=0.1, fused_xent=True)
    with pytest.raises(ValueError) as got:
        Trainer(_mlp_cfg(fused_xent=True, label_smoothing=0.1), device="cpu")
    assert str(got.value) == str(want.value)


def test_trainer_without_device_or_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(_mlp_cfg())


def test_cli_parses_presets_and_overrides_as_jax_does(capfd, monkeypatch):
    """Presets and overrides as JAX's CLI; the multi-process flags reach
    ``launch.torchrun.bootstrap`` (a stub here); ``--virtual-devices 2``
    trains ``mnist_mlp_smoke`` on two spawned gloo ranks, with one
    ``final`` record, from rank 0."""
    argv = ["--preset", "mnist_lenet_1chip", "--set", "fused_xent=True",
            "--set", "lr=5e-4", "--set", "name=run-x", "--set", "epochs=2"]
    got, want = cli.build_config(argv), jax_cli.build_config(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fused_xent is True and got.lr == 5e-4 and got.name == "run-x"
    with pytest.raises(SystemExit):
        cli.build_config(["--set", "no_such_field=1"])
    for device in (["--device", "cuda"], []):  # the CPU only when asked for
        with pytest.raises(SystemExit):
            cli.build_config(["--virtual-devices", "2", *device])
    toy = ["--preset", "mnist_mlp_smoke", "--device", "cpu", "--set", "n_train=256",
           "--set", "n_test=64", "--set", "epochs=1", "--set", "synthetic=True"]
    joined = []

    def stub(**kw):
        joined.append(kw)
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1, "backend": "gloo", "device": "cpu"}

    monkeypatch.setattr(cli, "bootstrap", stub)
    rc = cli.main(["--coordinator", "localhost:1234", "--num-processes", "2",
                   "--process-id", "1", *toy, "--set", "quiet=True"])
    assert joined == [{"init_method": "tcp://localhost:1234", "world_size": 2, "rank": 1,
                       "device": "cpu"}]
    lines = capfd.readouterr().out.strip().splitlines()
    assert [json.loads(line)["kind"] for line in lines] == ["bootstrap", "final"]
    final = json.loads(lines[-1])
    assert rc == 0 and final["epochs_run"] == 1

    assert cli.main(["--virtual-devices", "2", *toy]) == 0
    records = [json.loads(line) for line in capfd.readouterr().out.strip().splitlines()]
    assert [r["kind"] for r in records] == ["epoch", "summary", "final"]  # rank 0's only
    assert records[-1]["epochs_run"] == 1 and records[-1]["images_per_sec_per_chip"] > 0
