"""The port's flash-attention forward (K3) against the JAX Pallas kernel
(the backward's tests are in ``test_torch_flash_bwd.py``).

The JAX kernel runs as its own tests run it on the CPU (Pallas interpret
mode); the port runs its plain version, directly and through the wrapper's
CPU path.  Inputs come from one numpy seed; both sides compute in float32,
so the tolerance (atol 2e-5) covers reduction order only.  The CUDA kernel
itself is held against the same plain version on the card by chip_smoke.py.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.ops.flash_attention import (
    _flash_fwd,
    _lse_to_bsh,
    flash_attention as jax_flash,
    flash_block_fwd,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL = 2e-5  # float32 on both sides: reduction order only

# (S, D, H, H_kv, causal, window); 13 and 37 are unpadded lengths
CASES = [
    (13, 32, 4, 4, False, 0),
    (13, 32, 4, 4, True, 0),
    (37, 64, 4, 4, False, 0),
    (37, 64, 4, 4, True, 0),
    (37, 32, 4, 4, True, 3),
    (37, 64, 4, 2, True, 0),
    (13, 64, 4, 2, False, 0),
]
IDS = [f"s{s}-d{d}-h{h}kv{hkv}-{'causal' if c else 'full'}-w{w}"
       for s, d, h, hkv, c, w in CASES]


def _inputs(s, d, h, hkv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, s, h, d)).astype(np.float32),
            rng.normal(size=(2, s, hkv, d)).astype(np.float32),
            rng.normal(size=(2, s, hkv, d)).astype(np.float32))


@functools.cache
def _jax_reference(case):
    """JAX flash out (B, S, H, D) and lse (B, S, H) for one case."""
    s, d, h, hkv, causal, window = case
    q, k, v = (jnp.asarray(x) for x in _inputs(s, d, h, hkv))
    out = np.asarray(jax_flash(q, k, v, causal=causal, window=window))
    if window:  # flash_block_fwd is window-free; read lse from the fwd pass
        _, (*_, lse_p) = _flash_fwd(q, k, v, causal, None, window)
        lse = _lse_to_bsh(lse_p, 2, s, h)
    else:
        lse = flash_block_fwd(q, k, v, causal=causal)[1]
    return out, np.asarray(lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_jax_kernel(case):
    s, d, h, hkv, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(s, d, h, hkv))
    out, lse = fa.flash_attention_plain(q, k, v, causal, window)
    want_out, want_lse = _jax_reference(case)
    assert out.dtype == torch.float32 and lse.shape == (2, s, h)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wrapper_cpu_path_matches_jax_kernel_and_launches_nothing(case):
    s, d, h, hkv, causal, window = case
    q, k, v = (torch.from_numpy(x) for x in _inputs(s, d, h, hkv))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    only_out = fa.flash_attention(q, k, v, causal, window)
    want_out, want_lse = _jax_reference(case)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)
    np.testing.assert_array_equal(only_out.numpy(), out.numpy())
    assert fa.flash_attention_fwd.launches == before == 0


def test_bf16_cpu_path_keeps_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(13, 32, 4, 4))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32


@pytest.mark.parametrize("bad, err", [
    (dict(window=3, causal=False), ValueError),   # window needs causal
    (dict(d=12), ValueError),                      # head_dim % 8
    (dict(d=136), ValueError),                     # head_dim > 128
    (dict(hkv=3), ValueError),                     # H % H_kv
    (dict(dtype=torch.float16), TypeError),
], ids=["window-not-causal", "d12", "d136", "hkv3", "fp16"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    d, hkv = bad.get("d", 32), bad.get("hkv", 4)
    q = torch.zeros(1, 8, 4, d, dtype=bad.get("dtype", torch.float32))
    k = torch.zeros(1, 8, hkv, d, dtype=q.dtype)
    with pytest.raises(err):
        fa.flash_attention_fwd(q, k, k.clone(), bad.get("causal", True),
                               bad.get("window", 0))


def test_wrapper_refuses_inputs_that_need_a_gradient():
    """``flash_attention_fwd`` (the (out, lse) entry) has no gradient and
    refuses inputs that need one; ``flash_attention`` is differentiable,
    and its gradient equals the plain backward's from the plain lse and
    delta = rowsum(dO * O)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(13, 32, 4, 2))
    g = torch.from_numpy(np.random.default_rng(9).normal(size=q.shape).astype(np.float32))
    with pytest.raises(RuntimeError, match="without a gradient"):
        fa.flash_attention_fwd(q.clone().requires_grad_(), k, v, True)
    with torch.no_grad():
        fa.flash_attention_fwd(q.clone().requires_grad_(), k, v, True)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention(qr, kr, vr, True), (qr, kr, vr), g)
    out, lse = fa.flash_attention_plain(q, k, v, True)
    want = fa.flash_attention_bwd_plain(q, k, v, g, lse, (g * out).sum(-1), True)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-6, err_msg=f"d{name}")


def test_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    """Importing the kernel module needs no CUDA toolkit: nvcc is only
    looked up when a CUDA tensor launches the kernel."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               CUDA_PATH=str(tmp_path))
    code = (
        "import torch\n"
        "from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build\n"
        "from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa\n"
        "q = torch.zeros(1, 5, 2, 16)\n"
        "assert fa.flash_attention(q, q, q, True).shape == q.shape\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc')\n")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "no-nvcc"


def test_build_paths_follow_the_source_hash():
    """The library name carries the source hash (an edited source rebuilds)
    and lands in the ignored build directory."""
    path = _build.library_path("flash_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("flash_fwd-")
    assert _build.library_path("flash_fwd") == path
    assert "flash_fwd" in _build.sources()
