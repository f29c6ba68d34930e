"""The port's ViT against the JAX package's, on the CPU at toy sizes.

A ViT of dim 32, depth 2, 4 heads, patch 4 on 28x28 MNIST-shaped images
(S=49 tokens, no tile multiple), float32, on weights from JAX's own
``init`` converted with ``convert.load_vit``; its attention ``vanilla``
and ``flash`` (JAX's Pallas kernels in interpret mode against the port's
plain twins, which the port's CPU path runs), MHA and GQA, non-causal and
causal, and head_dim 12 (dim 48, 4 heads), which no CUDA kernel instance
covers and the plain twins take, as JAX's flash does.

* logits within 1e-4 (float32: reduction order), and in bf16 within 2e-2
  of the largest |logit|;
* the gradients of one training loss, every parameter, within 1e-5 plus
  1e-4 of each value;
* the Trainer: the causal flag reaches a ViT as a causal ``attn_fn`` (the
  JAX Trainer's injection); one epoch on the CPU with a finite loss, the
  fused cross-entropy's CPU twins and an analytic FLOP count;
* ``utils/flops.py``'s forward count of the repo's compute-bound ViT
  within 7% of XLA's cost analysis of the JAX forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from distributed_tensorflow_ibm_mnist_tpu.utils.flops import compiled_flops
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_vit, vit_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    vanilla_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import flops
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

ATOL = 1e-4  # float32 logits: reduction order
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_REL = 2e-2

BASE = dict(patch_size=4, dim=32, depth=2, heads=4, num_classes=10)
CASES = {
    "vanilla": dict(attn="vanilla"),
    "flash": dict(attn="flash"),
    "flash-gqa": dict(attn="flash", heads_kv=2),
    "flash-causal": dict(attn="flash", causal=True),
    "flash-d12": dict(attn="flash", dim=48),
    "vanilla-d12": dict(attn="vanilla", dim=48),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _kw(case):
    kw = {**BASE, **CASES[case]}
    causal = kw.pop("causal", False)
    return kw, causal


@functools.cache
def _jax_setup(case, dtype="float32"):
    """JAX model and its params (numpy) for ``case``."""
    kw, causal = _kw(case)
    if causal:  # as the JAX Trainer injects it
        kw["attn_fn"] = functools.partial(jax_flash, causal=True)
    model = jax_get_model("vit", dtype=getattr(jnp, dtype), **kw)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return model, _np(params)


def _port(case, params, dtype=torch.float32):
    kw, causal = _kw(case)
    if causal:  # the flash-causal case
        kw["attn_fn"] = functools.partial(fa.flash_attention, causal=True)
    return load_vit(params, device="cpu", dtype=dtype, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case):
    model, params = _jax_setup(case)
    images, _ = _batch()
    x = images.astype(np.float32) / 255.0
    want = np.asarray(model.apply({"params": params}, x))
    got = _port(case, params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


def test_bf16_logits_track_jax():
    _, params = _jax_setup("vanilla")
    model, _ = _jax_setup("vanilla", "bfloat16")
    x = _batch()[0].astype(np.float32) / 255.0
    want = np.asarray(model.apply({"params": params}, x))
    port = _port("vanilla", params, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port.parameters())  # as flax's
    got = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_gradients_match_jax(case):
    """The gradient of one training loss (the plain cross-entropy) with
    respect to every parameter, through either attention's backward."""
    model, params = _jax_setup(case)
    images, labels = _batch()
    loss_fn = jax_steps.make_loss_fn(model)
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: loss_fn(p, {}, jbatch, jax.random.PRNGKey(0)), has_aux=True)(params)
    kw, _ = _kw(case)
    want = vit_state_dict(_np(jgrads), kw)

    port = _port(case, params)
    loss, _ = steps.make_loss_fn(port)(
        {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}, train=True)
    names, leaves = zip(*port.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    assert set(grads) == set(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=key)


def test_converter_is_strict():
    _, params = _jax_setup("flash")
    kw, _ = _kw("flash")
    with pytest.raises(ValueError, match="missing leaves.*pos_embed"):
        vit_state_dict({k: v for k, v in params.items() if k != "pos_embed"}, kw)
    with pytest.raises(ValueError, match="pos_embed"):
        vit_state_dict({**params, "pos_embed": np.zeros((1, 50, 32), np.float32)}, kw)
    with pytest.raises(ValueError, match="block_2"):
        vit_state_dict({**params, "block_2": params["block_1"]}, kw)


@pytest.mark.parametrize("bad", [dict(moe_every=2), dict(dropout=0.1), dict(pp_stages=2),
                                 dict(block_remat=True)],
                         ids=["moe_every", "dropout", "pp_stages", "block_remat"])
def test_model_refuses_what_the_port_lacks(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        get_model("vit", device="cpu", **bad)


def test_patch_size_must_divide_the_image_as_in_jax():
    model = jax_get_model("vit", patch_size=5, dim=32, depth=1, heads=4)
    with pytest.raises(ValueError, match="not divisible by patch size 5") as want:
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    with pytest.raises(ValueError) as got:
        get_model("vit", patch_size=5, dim=32, depth=1, heads=4, device="cpu")
    assert str(got.value) == str(want.value)


def _vit_cfg(**kw):
    base = dict(model="vit", dataset="mnist", synthetic=True, quiet=True,
                n_train=256, n_test=64, batch_size=64, epochs=1,
                model_kwargs={"dim": 32, "depth": 2, "heads": 4, "patch_size": 4,
                              "attn": "flash"})
    return RunConfig(**{**base, **kw})


@pytest.mark.parametrize("attn", ["flash", "vanilla"])
def test_trainer_injects_causal_attention_as_jax_does(attn):
    """config.causal=True reaches a ViT, which has no causal knob, as a
    causal attn_fn of its own attention (JAX ``trainer.py:365-381``)."""
    cfg = _vit_cfg(causal=True, model_kwargs={**_vit_cfg().model_kwargs, "attn": attn})
    trainer = Trainer(cfg, device="cpu")
    fn = trainer.model.blocks[0].attn_fn
    assert fn.func is (fa.flash_attention if attn == "flash" else vanilla_attention)
    assert fn.keywords == {"causal": True} and trainer.causal is True
    assert Trainer(_vit_cfg(), device="cpu").model.blocks[0].attn_fn is fa.flash_attention


def test_trainer_trains_the_vit_on_the_cpu():
    """One epoch through the flash autograd function's CPU path and the
    fused cross-entropy's CPU twins: finite loss, the kernels' counters
    untouched; measure_throughput leaves the parameters bit-identical;
    the FLOP count is the analytic training count at S=49."""
    trainer = Trainer(_vit_cfg(fused_xent=True), device="cpu")
    summary = trainer.fit()
    assert np.isfinite(trainer.history[0]["train_loss"]) and summary["epochs_run"] == 1
    assert fa.flash_attention_fwd.launches == 0
    before = [p.clone() for p in trainer.model.parameters()]
    trainer.measure_throughput(epochs=1)
    assert all(torch.equal(a, b) for a, b in zip(before, trainer.model.parameters()))
    assert trainer._flops_per_image == 3 * flops.vit_forward_flops(
        (28, 28, 1), 4, 32, 2, 4, 10)
    assert trainer.model.seq_len == 49


def test_forward_flops_match_xla_cost_analysis():
    """dim 512, depth 8, 8 heads, patch 2 on 28 px (S=196), vanilla
    attention, one image: the analytic 10.50 G against XLA's 10.73 G (XLA
    also counts the norms, GELU and softmax)."""
    kw = dict(dim=512, depth=8, heads=8, patch_size=2)
    model = jax_get_model("vit", **kw)
    x = jax.ShapeDtypeStruct((1, 28, 28, 1), jnp.float32)
    variables = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x), x)
    want = compiled_flops(jax.jit(lambda v, x: model.apply(v, x)), variables, x)
    got = flops.vit_forward_flops((28, 28, 1), 2, 512, 8, 8)
    assert abs(got / want - 1) <= 0.07, (got, want)
