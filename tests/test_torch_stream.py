"""Stream input in the port: the native library (``data/native.py``), the
chunk runner and the Trainer's stream path, on the CPU at toy sizes.

* NATIVE: the port's ctypes bindings over the repo's ``native/dtm.cpp``
  against the JAX package's ``data/native.py`` on the same inputs: the
  gather, the renderer (and ``backend="native"`` splits) and the
  Prefetcher's batch order, byte for byte; the library builds into
  ``build/host/`` under a name that carries its hash, never into
  ``native/build/``; a failed build raises with the compiler's output.
* CHUNK RUNNER: three LeNet-5 steps over one stacked chunk
  (``core.steps.make_chunk_runner``) against JAX's scanned chunk runner on
  the same weights and batches (float32, dropout 0): per-step losses
  within 1e-5, parameters within 1e-4 (as the one-step test).
* TRAINER: a stream epoch (chunk 3 with a remainder, and 1) is BIT-equal
  to the device-mode epoch on the same permutation, per-step losses and
  the final state; ``measure_throughput`` runs in stream mode and leaves
  the state alone; ``preempt_poll_every`` stops an epoch at the first
  poll boundary past a trigger, and the resumed run replays that epoch
  from its start, as JAX's does, equal bit for bit to that replay done by
  hand; a resumed stream fit without preemption equals the uninterrupted
  one.
* DP: two gloo ranks (one spawn for the module) run a stream epoch, each on
  its rows of every global batch (``make_dp_chunk_runner``): chunk 3 and
  chunk 1 agree bit for bit, and the rank-averaged losses and the
  parameters follow the dp=1 stream epoch on the same permutation to
  float32 reduction order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.data import native as jax_native
from distributed_tensorflow_ibm_mnist_tpu.data import synthetic as jax_synthetic
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import lenet5_state_dict, load_lenet5
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.data import native, synthetic
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

import torch_dp_ranks as ranks

torch.set_num_threads(1)

RENDER_KW = dict(out_hw=(28, 28), scale_range=(2.2, 3.4), rot_range=0.3,
                 shift_frac=0.12, noise_std=0.18)


# ---------------------------------------------------------------- native


def test_library_builds_into_its_own_hashed_path():
    path = native.build()
    assert path.parent.name == "host" and path.parent.parent.name == "build"
    assert path.name.startswith("libdtm-") and "native" not in path.parts[-3:]
    assert native.available()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "dtm.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/dtm.cpp"):
        native.build()
    assert not list((tmp_path / "host").glob("*.so"))


@pytest.mark.parametrize("dtype, shape", [(np.uint8, (500, 28, 28, 1)),
                                          (np.float32, (100, 17)), (np.int32, (60, 12))])
def test_gather_equals_jax_native(dtype, shape):
    rng = np.random.default_rng(0)
    src = (rng.integers(0, 255, size=shape) if dtype != np.float32
           else rng.normal(size=shape)).astype(dtype)
    idx = rng.integers(0, shape[0], size=64).astype(np.int32)
    got = native.gather(src, idx, threads=3)
    assert got.tobytes() == jax_native.gather(src, idx, threads=3).tobytes()
    out = np.empty_like(got)
    assert native.gather(src, idx, out=out) is out and out.tobytes() == got.tobytes()


def test_render_equals_jax_native_whatever_the_threads():
    templates = jax_synthetic._glyphs_to_array(jax_synthetic._DIGIT_GLYPHS)
    labels = np.arange(40, dtype=np.int32) % 10
    want = jax_native.render_affine(templates, labels, seed=7, threads=2, **RENDER_KW)
    for threads in (1, 4):
        got = native.render_affine(templates, labels, seed=7, threads=threads, **RENDER_KW)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dataset", ["mnist", "fashion_mnist", "cifar10"])
def test_native_backend_splits_equal_jax(dataset, monkeypatch):
    monkeypatch.setenv("DTM_DATA_BACKEND", "native")
    fn = {"mnist": "synthetic_mnist", "fashion_mnist": "synthetic_fashion_mnist",
          "cifar10": "synthetic_cifar10"}[dataset]
    got = getattr(synthetic, fn)(n_train=64, n_test=16, seed=3)
    want = getattr(jax_synthetic, fn)(n_train=64, n_test=16, seed=3)
    for key in ("train_images", "train_labels", "test_images", "test_labels"):
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("labels_rank", [1, 2])
def test_prefetcher_order_equals_jax(labels_rank):
    """Batches in the permutation's order, byte-equal to the JAX package's
    Prefetcher; per-position labels (rank 2) ride beside the C prefetcher
    (the JAX package gathers them in numpy)."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 255, size=(300, 8, 8, 1), dtype=np.uint8)
    shape = (300,) if labels_rank == 1 else (300, 5)
    labels = rng.integers(0, 10, size=shape).astype(np.int32)
    perm = rng.permutation(300).astype(np.int32)[:256]
    with native.Prefetcher(images, labels, 32, perm, depth=3, threads=3) as pf:
        got = list(pf)
    with jax_native.Prefetcher(images, labels, 32, perm, depth=3, threads=3) as pf:
        want = list(pf)
    assert len(got) == len(want) == 8
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.tobytes() == wi.tobytes() and gl.tobytes() == wl.tobytes()
    with native.Prefetcher(images, labels, 32, perm) as pf:  # into caller buffers
        img = np.empty((32, 8, 8, 1), np.uint8)
        lab = np.empty((32, *shape[1:]), np.int32)
        for wi, wl in want:
            assert pf.next_into(img, lab)
            assert img.tobytes() == wi.tobytes() and lab.tobytes() == wl.tobytes()
        assert not pf.next_into(img, lab)


# ---------------------------------------------------------------- chunk runner


def test_chunk_runner_matches_jax_scan():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, 16, 28, 28, 1)).astype(np.uint8)
    labels = rng.integers(0, 10, (3, 16)).astype(np.int32)
    opt = dict(optimizer="momentum", lr=0.05)
    jmodel = jax_get_model("lenet5", num_classes=10, dropout_rate=0.0, dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**opt), 10)
    jstate = JaxTrainState.create(jmodel, tx, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 28, 28, 1), jnp.uint8))
    params0 = jax.tree.map(np.asarray, jstate.params)
    new, jm = jax.jit(jax_steps.make_chunk_runner(jmodel, tx))(
        jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    model = load_lenet5(params0, device="cpu", dtype=torch.float32, dropout_rate=0.0)
    optimizer = make_optimizer(RunConfig(**opt), 10, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       data_generator=torch.Generator())
    m = steps.make_chunk_runner(model, optimizer)(
        state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert state.step == 3 and m["loss"].shape == (3,)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5, atol=1e-5)
    want = lenet5_state_dict(jax.tree.map(np.asarray, new.params), {})
    for key, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-4, err_msg=key)


# ---------------------------------------------------------------- Trainer


def _cfg(**kw):
    base = dict(model="mlp", model_kwargs={"hidden": (32,), "dtype": torch.float32},
                synthetic=True, n_train=704, n_test=128, batch_size=64, epochs=2,
                quiet=True, schedule="cosine")
    return RunConfig(**{**base, **kw})


def _state_equal(a: Trainer, b: Trainer) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.state.step == b.state.step
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.state.optimizer.mu,
                                                      b.state.optimizer.mu)))


@pytest.mark.parametrize("chunk", [3, 1])
def test_stream_epoch_is_bit_equal_to_device_mode(chunk):
    device = Trainer(_cfg(), device="cpu")
    stream = Trainer(_cfg(input_mode="stream", stream_chunk=chunk), device="cpu")
    assert stream.steps_per_epoch == device.steps_per_epoch == 11  # 3 chunks + 2
    assert isinstance(stream.train_images, np.ndarray)
    for epoch in range(2):
        want = device._epoch(device._epoch_seed(epoch))
        got = stream._epoch(stream._epoch_seed(epoch))
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["accuracy"], want["accuracy"])
    assert _state_equal(stream, device)


def test_stream_fit_and_throughput(tmp_path):
    t = Trainer(_cfg(input_mode="stream", stream_chunk=4, prefetch_depth=2), device="cpu")
    summary = t.fit()
    want = Trainer(_cfg(), device="cpu").fit()  # the same permutations, in device mode
    assert summary["epochs_run"] == 2
    assert summary["best_test_accuracy"] == want["best_test_accuracy"]
    before = t.state.snapshot()
    out = t.measure_throughput(epochs=1)
    assert out["images_per_sec_per_chip"] > 0 and np.isfinite(out["last_loss"])
    after = t.state.snapshot()
    assert after["step"] == before["step"]
    assert all(torch.equal(a, b) for a, b in zip(after["params"], before["params"]))


class _Trigger:
    """Preemption that fires once ``steps`` steps have run."""

    def __init__(self, trainer, steps):
        self._trainer, self._steps = trainer, steps

    @property
    def triggered(self):
        return self._trainer.state.step >= self._steps


def test_preemption_polls_at_step_granularity_and_resume_replays_the_epoch(tmp_path):
    cfg = _cfg(input_mode="stream", stream_chunk=2, preempt_poll_every=3,
               checkpoint_dir=str(tmp_path / "ck"))
    t = Trainer(cfg, device="cpu")
    summary = t.fit(preemption=_Trigger(t, 4))
    # polls at 4 computed steps (a chunk of 2 lands 2 at a time: the first
    # boundary past 3) find the trigger set: the epoch stops after 4 steps
    assert summary["preempted"] is True and t.state.step == 4
    stopped = t.state.step
    assert t._ckpt.all_steps() == [stopped]
    resumed = Trainer(cfg.replace(resume=True, preempt_poll_every=0), device="cpu")
    resumed.config = resumed.config.replace(epochs=1)  # the schedule stays 2 epochs long
    resumed.fit()
    # by hand: the preempted state, then epoch 0 replayed from its start
    by_hand = Trainer(cfg.replace(checkpoint_dir=None, preempt_poll_every=0), device="cpu")
    by_hand.state.load_state_dict(t._ckpt.restore(step=stopped))
    by_hand._epoch(by_hand._epoch_seed(0))
    assert resumed.state.step == stopped + t.steps_per_epoch
    assert _state_equal(resumed, by_hand)


def test_resumed_stream_fit_equals_the_uninterrupted_one(tmp_path):
    full = Trainer(_cfg(input_mode="stream", stream_chunk=3), device="cpu")
    full.fit()
    cfg = _cfg(input_mode="stream", stream_chunk=3, checkpoint_dir=str(tmp_path / "ck"))
    first = Trainer(cfg, device="cpu")
    first.config = first.config.replace(epochs=1)
    first.fit()
    first.close()
    second = Trainer(cfg.replace(resume=True), device="cpu")
    second.config = second.config.replace(epochs=1)
    second.fit()
    assert _state_equal(second, full)


# ---------------------------------------------------------------- dp


@pytest.fixture(scope="module")
def dp_stream(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_dp")
    with Trainer(ranks._mini_cfg(epochs=1, input_mode="stream", stream_chunk=3),
                 device="cpu") as t:
        m = t._epoch(t._epoch_seed(0))
        dp1 = {"loss": m["loss"].numpy(), "params": ranks._params_of(t), "step": t.state.step}
    out = torchrun.spawn(ranks.stream_dp, 2, "gloo", "cpu", tmp / "store",
                         args=(str(tmp),), timeout=240)
    return dp1, out


def test_dp2_stream_chunks_agree_and_follow_dp1(dp_stream):
    dp1, out = dp_stream
    for r in out:
        assert r["forbidden"] == []
        assert r[3]["step"] == r[1]["step"] == dp1["step"]
        np.testing.assert_array_equal(r[3]["loss"], r[1]["loss"])
        for k in r[3]["params"]:
            np.testing.assert_array_equal(r[3]["params"][k], r[1]["params"][k])
    np.testing.assert_array_equal(out[0][3]["loss"], out[1][3]["loss"])
    np.testing.assert_allclose(out[0][3]["loss"], dp1["loss"], rtol=2e-5, atol=2e-6)
    for k, v in out[0][3]["params"].items():
        np.testing.assert_allclose(v, dp1["params"][k], rtol=2e-4, atol=2e-5, err_msg=k)
