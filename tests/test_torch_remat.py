"""Activation recomputation in the port (``models/remat.py``): ``remat=True``
over the whole forward, ``block_remat`` per residual, ViT or LM block.

* The port's own plain run is the exact reference: under either form the
  loss, every gradient and the BatchNorm running statistics after one
  training forward are BIT-equal to the plain forward's, on the CPU.  The
  statistics are the point: BatchNorm updates them in place, and the
  recompute runs its forward a second time (it must not move them again).
  LeNet's dropout draws from the model's own generator, which the
  recompute must replay (the gradients would differ otherwise).
* Against JAX: the gradients and ``batch_stats`` under JAX's
  ``block_remat`` (``nn.remat`` of the block class), on the same
  converted weights: ResNet-20 in float64 on both sides (its float32
  gradients differ from float64 by more than 1e-5 in JAX itself,
  tests/test_torch_resnet.py says why), the ViT and the causal LM in
  float32; each gradient tensor within 1e-5 of its largest magnitude.
  This mirrors ``tests/test_grad_accum_remat.py:63-123``.
* The Trainer: ``remat="blocks"`` reaches the model; a model without blocks
  is refused as JAX refuses it; one Trainer step under each form leaves the
  statistics bit-equal to the plain step's.
* Decode, the flash prefill and ``torch.no_grad`` run the blocks plainly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    load_causal_lm,
    load_resnet,
    load_vit,
    resnet_state_dict,
    vit_state_dict,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import recomputing
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ARCHS
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

JAX_REL = 1e-5  # each gradient tensor, relative to its largest magnitude

LM_KW = dict(num_classes=16, dim=32, depth=2, heads=4)
VIT_KW = dict(patch_size=7, dim=32, depth=2, heads=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _images(n=4, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 1)).astype(np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 16, (4, 12)).astype(np.int32)
    return t, t


# the port's models at toy size (float32), built from one generator seed
PORT_MODELS = {
    "resnet20": lambda **kw: get_model("resnet20", device="cpu", in_channels=1,
                                       dtype=torch.float32, **kw),
    "vit": lambda **kw: get_model("vit", device="cpu", image_size=(14, 14), in_channels=1,
                                  dtype=torch.float32, **VIT_KW, **kw),
    "causal_lm": lambda **kw: get_model("causal_lm", device="cpu", dtype=torch.float32,
                                        **LM_KW, **kw),
    "lenet5": lambda **kw: get_model("lenet5", device="cpu", **kw),
}
BATCHES = {"resnet20": lambda: _images(size=16), "vit": lambda: _images(size=14),
           "causal_lm": _tokens, "lenet5": lambda: _images(size=28)}


def _one_forward_backward(name: str, mode: str):
    """Loss, gradients (by name) and buffers after one training forward and
    backward of a fresh seeded model: ``mode`` "plain", "blocks" (the
    model's ``block_remat``) or "whole" (``remat=True`` in the loss)."""
    kw = {"block_remat": True} if mode == "blocks" else {}
    model = PORT_MODELS[name](generator=torch.Generator().manual_seed(0), **kw)
    gen = getattr(model, "generator", None)
    if gen is not None:
        gen.manual_seed(7)  # the dropout stream, the same for every mode
    images, labels = BATCHES[name]()
    loss, _ = steps.make_loss_fn(model, remat=mode == "whole")(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}, train=True)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return loss, grads, {k: b.clone() for k, b in model.named_buffers()}, (
        gen.get_state() if gen is not None else None)


@pytest.mark.parametrize("name, mode", [
    (name, mode) for name in ("resnet20", "vit", "causal_lm") for mode in ("blocks", "whole")
] + [("lenet5", "whole")])  # LeNet-5 has no blocks
def test_remat_is_bit_equal_to_the_plain_step(name, mode):
    loss0, grads0, bufs0, gen0 = _one_forward_backward(name, "plain")
    loss, grads, bufs, gen = _one_forward_backward(name, mode)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for key, g in grads.items():
        assert torch.equal(g, grads0[key]), key
    assert bufs.keys() == bufs0.keys()
    for key, b in bufs.items():  # the running statistics moved exactly once
        assert torch.equal(b, bufs0[key]), key
    if gen0 is not None:  # the dropout stream advanced once, as the plain step's
        assert torch.equal(gen, gen0)


def test_recompute_flag_is_set_only_inside_the_recompute():
    seen = []
    model = PORT_MODELS["resnet20"](block_remat=True)
    block = model.stage0_block0
    orig = block.forward

    def spy(x, train):
        seen.append(recomputing())
        return orig(x, train)

    block.forward = spy
    images, labels = _images()
    loss, _ = steps.make_loss_fn(model)(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    loss.backward()
    assert seen == [False, True] and not recomputing()


# ---------------------------------------------------------------- against JAX


def _rel_close(got: torch.Tensor, want: np.ndarray, key: str) -> None:
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= JAX_REL * max(np.abs(want).max(), 1e-30), (key, err)


@functools.cache
def _jax_resnet64():
    with jax.enable_x64(True):
        model = jax_get_model("resnet20", num_classes=10, dtype=jnp.float64, block_remat=True)
        variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16, 1), jnp.float64))
        return model, _np(variables["params"]), _np(variables["batch_stats"])


def test_resnet20_block_remat_gradients_and_stats_match_jax():
    model, params, stats = _jax_resnet64()
    images, labels = _images()
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    with jax.enable_x64(True):
        loss_fn = jax_steps.make_loss_fn(model)
        (jloss, (jstats, _, _)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, stats, batch, jax.random.PRNGKey(0)), has_aux=True))(params)
        jgrads, jstats = _np(jgrads), _np(jstats)
    kw = {**ARCHS["resnet20"], "in_channels": 1}
    want_grads = resnet_state_dict(jgrads, stats, kw)
    want_stats = resnet_state_dict(params, jstats, kw)
    port = load_resnet(params, stats, "resnet20", device="cpu", dtype=torch.float64,
                       in_channels=1, block_remat=True).double()
    loss, _ = steps.make_loss_fn(port)(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}, train=True)
    names, leaves = zip(*port.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)  # float32 logits
    for key, g in grads.items():
        _rel_close(g, want_grads[key].numpy(), key)
    for key, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[key].numpy(), rtol=JAX_REL,
                                   atol=1e-12, err_msg=key)


@pytest.mark.parametrize("name", ["vit", "causal_lm"])
def test_transformer_block_remat_gradients_match_jax(name):
    if name == "vit":
        jmodel = jax_get_model("vit", num_classes=10, dtype=jnp.float32, block_remat=True,
                               **VIT_KW)
        sample = jnp.zeros((1, 14, 14, 1))
        images, labels = _images(size=14)
    else:
        jmodel = jax_get_model("causal_lm", dtype=jnp.float32, block_remat=True, **LM_KW)
        sample = jnp.zeros((1, 12), jnp.int32)
        images, labels = _tokens()
    params = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0), sample)["params"])
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    loss_fn = jax_steps.make_loss_fn(jmodel)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0)), has_aux=True))(params)
    if name == "vit":
        kw = {**VIT_KW, "image_size": (14, 14), "in_channels": 1}
        want = vit_state_dict(_np(jgrads), kw)
        port = load_vit(params, device="cpu", dtype=torch.float32, block_remat=True, **kw)
    else:
        want = causal_lm_state_dict(_np(jgrads), LM_KW)
        port = load_causal_lm(params, device="cpu", dtype=torch.float32, block_remat=True,
                              **LM_KW)
    loss, _ = steps.make_loss_fn(port)(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}, train=True)
    names, leaves = zip(*port.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(grads) == set(want)
    for key, g in grads.items():
        _rel_close(g, want[key].numpy(), key)


# ---------------------------------------------------------------- Trainer


def _resnet_cfg(**kw):
    return RunConfig(model="resnet20", model_kwargs={"dtype": torch.float32},
                     dataset="fashion_mnist", synthetic=True, n_train=16, n_test=8,
                     batch_size=8, epochs=1, optimizer="momentum", lr=0.1,
                     weight_decay=1e-4, quiet=True, eval_batch_size=8, **kw)


def test_remat_blocks_config_driven():
    t = Trainer(_resnet_cfg(remat="blocks"), device="cpu")
    assert t.model.block_remat is True
    assert t.fit()["epochs_run"] == 1
    with pytest.raises(ValueError, match="blocks"):
        Trainer(RunConfig(model="mlp", synthetic=True, n_train=64, n_test=32,
                          batch_size=32, remat="blocks", quiet=True), device="cpu")
    with pytest.raises(ValueError, match="remat must be"):
        Trainer(_resnet_cfg(remat="all"), device="cpu")


@pytest.mark.parametrize("remat", [True, "blocks"])
def test_trainer_step_under_remat_moves_statistics_once(remat):
    """Two Trainer steps (grad_accum 2: the statistics thread through the
    microbatches) under remat leave parameters, momentum traces and the
    running statistics bit-equal to the plain run's."""
    runs = []
    for r in (False, remat):
        t = Trainer(_resnet_cfg(remat=r, grad_accum=2), device="cpu")
        m = t._epoch(t._epoch_seed(0))
        runs.append((m["loss"], t.model.state_dict(), t.state.optimizer.trace))
    (l0, sd0, tr0), (l1, sd1, tr1) = runs
    assert torch.equal(l0, l1)
    for key in sd0:
        assert torch.equal(sd0[key], sd1[key]), key
    assert all(torch.equal(a, b) for a, b in zip(tr0, tr1))


def test_decode_and_no_grad_run_the_blocks_plainly():
    plain = PORT_MODELS["causal_lm"](generator=torch.Generator().manual_seed(0))
    rem = plain.clone(block_remat=True)
    tokens = torch.from_numpy(_tokens()[0])
    with torch.no_grad():
        a, kv_a = plain(tokens, sow_kv=True)
        b, kv_b = rem(tokens, sow_kv=True)
        assert torch.equal(a, b) and torch.equal(plain(tokens), rem(tokens))
    for key in kv_a:
        assert all(torch.equal(x, y) for x, y in zip(kv_a[key], kv_b[key]))
