"""The port's fused softmax cross-entropy (K1/K2) against the JAX kernels.

The JAX side runs ``ops/xent.py`` as ``tests/test_ops_xent.py`` runs it on
the CPU (Pallas interpret mode).  The port runs its plain twins directly
and through the autograd Function's CPU path.  Inputs come from numpy
seeds; both sides compute in float32, so 1e-5 covers reduction order only.
The CUDA kernels themselves are held against the same twins on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distributed_tensorflow_ibm_mnist_tpu.ops.xent import softmax_xent as jax_xent
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(n, c, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, c)) * 3.0).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    return logits, labels


def _jax_loss_and_grad(logits, labels):
    x, y = jnp.asarray(logits), jnp.asarray(labels)
    loss = np.asarray(jax_xent(x, y))
    grad = np.asarray(jax.grad(lambda lg: jax_xent(lg, y).mean())(x))
    return loss, grad


@pytest.mark.parametrize("n,c", [(32, 10), (37, 10), (8, 128), (100, 257)])
def test_forward_matches_jax_kernel(n, c):
    logits, labels = _inputs(n, c)
    want = np.asarray(jax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = xent.softmax_xent_plain(x, y)
    got = xent.softmax_xent(x, y)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,c", [(32, 10), (37, 10), (24, 200)])
def test_grad_of_mean_matches_jax_kernel(n, c):
    logits, labels = _inputs(n, c, seed=1)
    _, want = _jax_loss_and_grad(logits, labels)
    x = torch.from_numpy(logits).requires_grad_()
    y = torch.from_numpy(labels).long()  # int64 labels: converted by the wrapper
    xent.softmax_xent_mean(x, y).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=TOL, atol=1e-6)
    g = torch.full((n,), 1.0 / n)
    twin = xent.softmax_xent_grad_plain(torch.from_numpy(logits), y, g)
    np.testing.assert_allclose(twin.numpy(), want, rtol=TOL, atol=1e-6)


def test_bfloat16_logits():
    logits, labels = _inputs(16, 10, seed=3)
    x32 = jnp.asarray(logits).astype(jnp.bfloat16)
    want = np.asarray(jax_xent(x32, jnp.asarray(labels)))
    x = torch.from_numpy(logits).bfloat16().requires_grad_()
    y = torch.from_numpy(labels)
    loss = xent.softmax_xent(x, y)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    loss.mean().backward()
    assert x.grad.dtype == torch.bfloat16


def test_extreme_logits_stay_finite():
    x = torch.tensor([[1e4, -1e4, 0.0, 5.0]] * 8).requires_grad_()
    y = torch.zeros(8, dtype=torch.int32)
    loss = xent.softmax_xent(x, y)
    want, want_grad = _jax_loss_and_grad(x.detach().numpy(), y.numpy())
    loss.mean().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(loss.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-6)


def test_label_out_of_range_matches_jax():
    """A label outside [0, C) matches no column: loss = logsumexp and the
    gradient has no -1.  (JAX's kernel pads C to 128 with -1e30, so a label
    in [C, 128) would pick that fill there; -1 and 300 lie outside both.)"""
    logits, _ = _inputs(6, 10, seed=4)
    labels = np.array([-1, 300, 3, -5, 128, 0], np.int32)
    want, want_grad = _jax_loss_and_grad(logits, labels)
    x = torch.from_numpy(logits).requires_grad_()
    loss = xent.softmax_xent(x, torch.from_numpy(labels))
    loss.mean().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-6)
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    np.testing.assert_allclose(loss.detach().numpy()[[0, 1, 3, 4]],
                               lse.numpy()[[0, 1, 3, 4]], rtol=TOL)


@pytest.mark.parametrize("logits, labels, err", [
    (torch.zeros(4, 10, dtype=torch.float16), torch.zeros(4, dtype=torch.int32), TypeError),
    (torch.zeros(4, 10), torch.zeros(4), TypeError),                      # float labels
    (torch.zeros(4, 10, 2), torch.zeros(4, dtype=torch.int32), ValueError),  # rank 3
    (torch.zeros(4, 10), torch.zeros(4, 1, dtype=torch.int32), ValueError),  # rank-2 labels
    (torch.zeros(4, 10), torch.zeros(5, dtype=torch.int32), ValueError),     # N mismatch
    (torch.zeros(4, 10, device="meta"), torch.zeros(4, dtype=torch.int32,
                                                    device="meta"), ValueError),  # device
], ids=["fp16", "float-labels", "rank3", "rank2-labels", "n-mismatch", "meta-device"])
def test_wrapper_refuses_what_the_kernels_do_not_take(logits, labels, err):
    with pytest.raises(err):
        xent.softmax_xent(logits, labels)


def test_cpu_path_launches_nothing():
    before = (xent.softmax_xent.fwd_launches, xent.softmax_xent.bwd_launches)
    x = torch.randn(8, 10, requires_grad=True)
    xent.softmax_xent_mean(x, torch.zeros(8, dtype=torch.int32)).backward()
    assert (xent.softmax_xent.fwd_launches, xent.softmax_xent.bwd_launches) == before == (0, 0)


def test_cuda_tensor_without_a_card_raises_and_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with no card it raises,
    the plain twins are never called and nothing is counted."""
    def fail(*a, **k):
        raise AssertionError("the plain twin was called for a CUDA tensor")

    monkeypatch.setattr(xent, "softmax_xent_plain", fail)
    monkeypatch.setattr(xent, "softmax_xent_grad_plain", fail)
    with FakeTensorMode():
        x = torch.empty(8, 10, device="cuda")
        y = torch.zeros(8, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            xent.softmax_xent(x, y)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            xent.softmax_xent_bwd(x, y, torch.ones(8, device="cuda"))
    assert xent.softmax_xent.fwd_launches == xent.softmax_xent.bwd_launches == 0
