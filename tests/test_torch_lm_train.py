"""The port's causal-LM training path against the JAX package, on the CPU.

A toy LM (dim 32, depth 2, 4 heads, vocab 16, seq_len 20, float32,
``attn="flash"``) on the retrieval task, converted weights on both sides:

* one train step (Adam 1e-3) equals JAX's ``make_train_step``: loss,
  per-token accuracy and the parameters after the update;
* the slice as a whole: one epoch of the epoch runner fed JAX's own
  permutation gives JAX's per-step losses and final parameters;
* eval's per-token accuracy and loss equal JAX's ``make_eval_fn``;
* the Trainer trains ``causal_lm`` + ``retrieval`` through the flash
  ``autograd.Function`` on CPU tensors, derives the causal flag as JAX does,
  and reports ``tokens_per_sec_per_chip``;
* the analytic FLOP count.

The JAX flash kernels run in Pallas interpret mode; the port runs the
kernels' plain versions.  Float32 on both sides: the tolerances cover
reduction order, except where Adam's sign-like first update is noted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils import flops as jax_flops
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    load_causal_lm,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.data import synthetic
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import flops
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=2, heads=4, attn="flash")
SEQ, BATCH, N_TRAIN, N_TEST = 20, 8, 32, 12
OPT = dict(optimizer="adam", lr=1e-3)


@functools.cache
def _data():
    return synthetic.synthetic_retrieval(n_train=N_TRAIN, n_test=N_TEST, seed=0,
                                         vocab=KW["num_classes"], seq_len=SEQ)


def _jax_state(total):
    model = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    tx = jax_make_optimizer(JaxRunConfig(**OPT), total)
    state = JaxTrainState.create(model, tx, jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))
    return model, tx, state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(params_np, total):
    model = load_causal_lm(params_np, device="cpu", dtype=torch.float32, **KW)
    opt = make_optimizer(RunConfig(**OPT), total, list(model.parameters()))
    return model, opt, TrainState(step=0, model=model, optimizer=opt,
                                  data_generator=torch.Generator())


def _real_gradient_mask(model, batch):
    """Each parameter's gradient at the step's start, from the port (it
    equals JAX's to float32 rounding): Adam's first update is
    lr * g / (|g| + eps) ~ lr * sign(g), so an element whose gradient is at
    rounding level may move by up to 2 * lr between frameworks."""
    loss, _ = steps.make_loss_fn(model)(batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return dict(zip(names, grads))


@functools.cache
def _one_step():
    data = _data()
    tokens, labels = data["train_images"][:BATCH], data["train_labels"][:BATCH]
    jmodel, tx, jstate = _jax_state(10)
    jbatch = {"image": jnp.asarray(tokens), "label": jnp.asarray(labels)}
    new_jstate, jm = jax.jit(jax_steps.make_train_step(jmodel, tx))(jstate, jbatch)
    model, opt, state = _port_state(_np(jstate.params), 10)
    batch = {"image": torch.from_numpy(tokens), "label": torch.from_numpy(labels)}
    gmag = _real_gradient_mask(model, batch)
    m = steps.make_train_step(model, opt)(state, batch)
    return state, m, jm, model.state_dict(), causal_lm_state_dict(
        _np(new_jstate.params), KW), gmag


def test_one_step_loss_and_accuracy_match_jax():
    state, m, jm, *_ = _one_step()
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]), atol=1e-6)


def test_one_step_parameters_after_adam_match_jax():
    *_, got, want, gmag = _one_step()
    lr = OPT["lr"]
    assert set(got) == set(want)
    for key in want:
        diff = np.abs(got[key].numpy() - want[key].numpy())
        assert diff.max() <= 2 * lr + 1e-7, key
        real = np.abs(gmag[key].detach().numpy()) > 1e-6
        assert diff[real].max(initial=0.0) <= 1e-5, key


@functools.cache
def _one_epoch():
    data = _data()
    steps_per_epoch = N_TRAIN // BATCH
    jmodel, tx, jstate = _jax_state(steps_per_epoch)
    params0 = _np(jstate.params)
    epoch_rng = jax.random.PRNGKey(7)
    run = jax.jit(jax_steps.make_epoch_runner(jmodel, tx, BATCH))
    new_jstate, jm = run(jstate, jnp.asarray(data["train_images"]),
                         jnp.asarray(data["train_labels"]), epoch_rng)
    jeval = jax.jit(jax_steps.make_eval_fn(jmodel, batch_size=5))(
        new_jstate, jnp.asarray(data["test_images"]), jnp.asarray(data["test_labels"]))

    model, opt, state = _port_state(params0, steps_per_epoch)
    perm = torch.from_numpy(np.array(jax.random.permutation(epoch_rng, N_TRAIN)))
    m = steps.make_epoch_runner(model, opt, BATCH)(
        state, torch.from_numpy(data["train_images"]),
        torch.from_numpy(data["train_labels"]), perm=perm)
    ev = steps.make_eval_fn(model, 5)(torch.from_numpy(data["test_images"]),
                                      torch.from_numpy(data["test_labels"]))
    return (state.step, m, jm, model.state_dict(),
            causal_lm_state_dict(_np(new_jstate.params), KW), ev, jeval)


def test_one_epoch_on_jax_permutation_matches_jax():
    """Four Adam steps at lr 1e-3: the per-step losses agree to 1e-5; the
    median parameter element to 2e-5, and every element within the Adam
    sign bound (2 * lr per step: see ``_real_gradient_mask``)."""
    n_steps, m, jm, got, want, *_ = _one_epoch()
    assert n_steps == N_TRAIN // BATCH
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"].numpy(), np.asarray(jm["accuracy"]), atol=1e-6)
    for key in want:
        diff = np.abs(got[key].numpy() - want[key].numpy())
        assert diff.max() <= 2 * OPT["lr"] * n_steps, key
        assert np.median(diff) <= 2e-5, key


def test_eval_per_token_accuracy_and_loss_match_jax():
    """Eval over 12 sequences in batches of 5 (a ragged last batch): the
    denominator is every scored token, 12 x 20."""
    *_, ev, jeval = _one_epoch()
    np.testing.assert_allclose(float(ev["accuracy"]), float(jeval["accuracy"]), atol=1e-6)
    np.testing.assert_allclose(float(ev["loss"]), float(jeval["loss"]), rtol=1e-5, atol=1e-5)


def test_per_position_cross_entropy_matches_optax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(labels))
    got = steps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fused_xent_loss_on_token_logits_equals_the_plain_loss():
    """fused_xent flattens (B, S, V) logits into the kernels' (N, C) rows:
    the same mean as the plain per-position loss."""
    data = _data()
    model = load_causal_lm(_np(_jax_state(1)[2].params), device="cpu",
                           dtype=torch.float32, **KW)
    batch = {"image": torch.from_numpy(data["train_images"][:4]),
             "label": torch.from_numpy(data["train_labels"][:4])}
    with torch.no_grad():
        plain, _ = steps.make_loss_fn(model)(batch)
        fused, _ = steps.make_loss_fn(model, fused_xent=True)(batch)
    np.testing.assert_allclose(fused.item(), plain.item(), rtol=1e-6)


# ---------------------------------------------------------------- Trainer


def _lm_cfg(**kw):
    base = dict(model="causal_lm", dataset="retrieval",
                model_kwargs={"dim": 32, "depth": 2, "heads": 4, "attn": "flash",
                              "dtype": torch.float32},
                dataset_kwargs={"vocab": 16, "seq_len": SEQ}, n_train=64, n_test=16,
                batch_size=16, epochs=1, quiet=True, eval_batch_size=8)
    return RunConfig(**{**base, **kw})


def test_trainer_trains_the_lm_through_the_flash_autograd_function(monkeypatch):
    calls = []
    orig = fa.flash_attention_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    trainer = Trainer(_lm_cfg(epochs=2), device="cpu")
    assert trainer.causal is True and trainer.model.causal is True
    assert trainer.train_images.dtype == torch.int32
    summary = trainer.fit()
    steps_taken = trainer.state.step
    assert steps_taken == 2 * 64 // 16
    assert len(calls) == 2 * steps_taken  # depth x steps
    assert np.isfinite(summary["best_test_accuracy"])
    assert summary["tokens_per_sec_per_chip"] == pytest.approx(
        summary["images_per_sec_per_chip"] * SEQ, rel=1e-3)
    assert summary["mfu"] is None  # no device metric from a CPU run
    losses = [r["train_loss"] for r in trainer.history]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    tp = trainer.measure_throughput(epochs=1)
    assert tp["tokens_per_sec_per_chip"] > 0 and np.isfinite(tp["last_loss"])


@pytest.mark.parametrize("model_kw, config_causal, want", [
    ({}, None, True),        # the family's default
    ({}, False, False),      # an explicit config opt-out reaches the model
    ({"causal": False}, True, False),  # model_kwargs win
], ids=["default", "config-false", "kwargs-win"])
def test_causal_flag_is_derived_as_jax_derives_it(model_kw, config_causal, want):
    cfg = _lm_cfg(causal=config_causal,
                  model_kwargs={**_lm_cfg().model_kwargs, **model_kw})
    trainer = Trainer(cfg, device="cpu")
    assert trainer.causal is want and trainer.model.causal is want


def test_lm_flops_follow_the_stated_convention():
    """Per sequence: 2*12*dim^2*S per block and 2*dim*V*S for the head,
    times 3, plus the JAX package's attention_flops with backward."""
    s, dim, depth, heads, vocab = 8192, 512, 4, 8, 256
    got = flops.causal_lm_flops_per_sequence(s, dim, depth, heads, vocab)
    attn = jax_flops.attention_flops(1, s, heads, dim // heads, causal=True,
                                     with_backward=True, depth=depth)
    want = 3 * (depth * 2 * 12 * dim * dim * s + 2 * dim * vocab * s) + attn
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(1.45e12, rel=0.01)
    for args in [(2, 100, 4, 16), (1, 8192, 8, 64)]:
        for kw in [dict(causal=False), dict(causal=True), dict(causal=True, window=37),
                   dict(causal=True, with_backward=False, depth=3)]:
            assert flops.attention_flops(*args, **kw) == jax_flops.attention_flops(*args, **kw)
