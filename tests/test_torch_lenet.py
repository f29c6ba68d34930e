"""The port's LeNet-5 and MLP against the JAX models on carried-across weights.

JAX parameters go through convert.py into the port; both models then see
the same NHWC uint8 -> float32 batch (made with numpy).  In float32 the
logits agree to 1e-4 (reduction order only).  In bf16 both frameworks round
activations to bf16 at different places, so the logits agree to 5e-2 and
the argmax on at least 95% of rows.  Dropout cannot match across
frameworks bit for bit: its checks here are statistical and port-only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_lenet5, load_mlp
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5, dropout
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

MODELS = {"lenet5": ({}, load_lenet5), "mlp": ({"hidden": (64, 32)}, load_mlp)}


def _batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)
            .astype(np.float32) / 255.0)


@functools.cache
def _jax_params(name, seed=0):
    kw, _ = MODELS[name]
    model = jax_get_model(name, num_classes=10, **kw)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))["params"]
    return jax.tree.map(np.asarray, params)


def _jax_logits(name, dtype, x, **extra):
    kw, _ = MODELS[name]
    model = jax_get_model(name, num_classes=10, dtype=dtype, **kw, **extra)
    return np.asarray(model.apply({"params": _jax_params(name)}, jnp.asarray(x)))


def _port(name, dtype, **extra):
    kw, load = MODELS[name]
    return load(_jax_params(name), device="cpu", num_classes=10, dtype=dtype, **kw, **extra)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f32_logits_match_jax(name):
    x = _batch()
    want = _jax_logits(name, jnp.float32, x)
    got = _port(name, torch.float32)(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32 and got.shape == (16, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_logits_match_jax(name):
    x = _batch(64, seed=1)
    want = _jax_logits(name, jnp.bfloat16, x)
    got = _port(name, torch.bfloat16)(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32  # bf16 compute, f32 logits
    assert np.abs(got.numpy() - want).max() <= 5e-2
    assert (got.numpy().argmax(1) == want.argmax(1)).mean() >= 0.95


def test_fc1_flatten_is_hwc_order():
    """fc1's output, read from both models' intermediates, agrees only if
    the pooled (B, 7, 7, 64) activation is flattened in flax's (H, W, C)
    order; the (C, H, W) order of a plain NCHW flatten gives other values."""
    x = _batch(4, seed=2)
    jmodel = jax_get_model("lenet5", num_classes=10, dtype=jnp.float32)
    _, inter = jmodel.apply({"params": _jax_params("lenet5")}, jnp.asarray(x),
                            capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["fc1"]["__call__"][0])
    port = _port("lenet5", torch.float32)
    seen = {}
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    t = torch.nn.functional.max_pool2d(torch.relu(port._conv(port.conv1, t)), 2, 2)
    pooled = torch.nn.functional.max_pool2d(torch.relu(port._conv(port.conv2, t)), 2, 2)
    for order, flat in (("hwc", pooled.permute(0, 2, 3, 1).reshape(4, -1)),
                        ("chw", pooled.reshape(4, -1))):
        seen[order] = port._dense(port.fc1, flat).detach().numpy()
    np.testing.assert_allclose(seen["hwc"], want, atol=1e-4, rtol=1e-4)
    assert np.abs(seen["chw"] - want).max() > 1e-2
    # and the model's own forward is the (H, W, C) one
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, _jax_logits("lenet5", jnp.float32, x), atol=1e-4)


def test_conv1_s2d_gives_the_same_logits():
    x = _batch(8, seed=3)
    direct = _port("lenet5", torch.float32)(torch.from_numpy(x)).detach()
    s2d = _port("lenet5", torch.float32, conv1_s2d=True)(torch.from_numpy(x)).detach()
    np.testing.assert_array_equal(s2d.numpy(), direct.numpy())
    want = _jax_logits("lenet5", jnp.float32, x, conv1_s2d=True)
    np.testing.assert_allclose(s2d.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_count_matches_jax(name):
    kw, _ = MODELS[name]
    jmodel = jax_get_model(name, num_classes=10, **kw)
    jstate = JaxTrainState.create(jmodel, optax.sgd(0.1), jax.random.PRNGKey(0),
                                  jnp.zeros((1, 28, 28, 1), jnp.uint8))
    model = get_model(name, num_classes=10, device="cpu", **kw)
    cfg = RunConfig(optimizer="sgd")
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(cfg, 1, list(model.parameters())),
                       data_generator=torch.Generator())
    assert state.param_count() == jstate.param_count()


def test_init_comes_from_the_generator():
    a = LeNet5(device="cpu", generator=torch.Generator().manual_seed(7))
    b = LeNet5(device="cpu", generator=torch.Generator().manual_seed(7))
    c = LeNet5(device="cpu", generator=torch.Generator().manual_seed(8))
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.fc1.weight, c.fc1.weight)
    # flax's lecun-normal scale: std fan_in^-1/2 after the truncation
    std = a.fc1.weight.std().item()
    assert abs(std - 3136 ** -0.5) < 0.05 * 3136 ** -0.5
    assert torch.count_nonzero(a.fc1.bias) == 0


def test_dropout_keep_fraction_scale_and_train_flag():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 1024)
    y = dropout(x, 0.5, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)  # survivors scaled by 1 / (1 - p)
    y3 = dropout(torch.ones(200, 1024), 0.25, g)
    assert abs((y3 != 0).float().mean().item() - 0.75) < 0.01
    assert torch.allclose(y3[y3 != 0], torch.tensor(1 / 0.75))

    model = LeNet5(device="cpu", dtype=torch.float32, dropout_rate=0.5)
    xb = torch.from_numpy(_batch(4))
    assert torch.equal(model(xb), model(xb))  # train=False: no dropout
    assert not torch.equal(model(xb, train=True), model(xb, train=True))


def test_dropout_masks_repeat_for_the_same_generator_seed():
    def masks(seed):
        model = LeNet5(device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed))
        xb = torch.from_numpy(_batch(4))
        return [model(xb, train=True) for _ in range(3)]

    for a, b in zip(masks(5), masks(5)):
        assert torch.equal(a, b)
    assert not torch.equal(masks(5)[0], masks(6)[0])
