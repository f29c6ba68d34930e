"""Flash-attention forward: the port of the JAX package's Pallas kernel K3.

``flash_attention`` / ``flash_attention_fwd`` take (B, S, H, D) queries and
(B, S, H_kv, D) keys/values (H_kv divides H: grouped-query attention) in
bf16 or float32, and return the attention output in the input dtype (plus,
for ``flash_attention_fwd``, the natural-log row logsumexp as (B, S, H)
float32 — the JAX ``flash_block_fwd`` contract).  ``causal`` masks k > q;
``window`` > 0 (causal only) also masks k <= q - window.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/flash_fwd.cu`` (built by ``ops/_build.py`` at first use) or raises:
there is no fallback.  On a CPU tensor it runs :func:`flash_attention_plain`,
the same function in plain PyTorch, which the CPU tests hold against the
JAX kernel.  ``flash_attention_fwd.launches`` counts kernel launches.

The kernel is forward-only: the backward is the JAX package's K4-K6,
ported with the training path, so the wrapper refuses inputs that would
need a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = (torch.float32, torch.bfloat16)


def _check_window(causal: bool, window: int) -> None:
    if window:
        if not causal:
            raise ValueError("window > 0 is causal sliding-window attention; "
                             "pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_plain(q, k, v, causal: bool = False, window: int = 0):
    """The kernel's function in plain PyTorch: float32 math, K/V repeated
    up to H heads, masked scores at -inf.  Returns ``(out, lse)`` with
    ``out`` (B, S, H, D) in the input dtype and ``lse`` (B, S, H) float32."""
    _check_window(causal, window)
    dtype = q.dtype
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    g = h // k.shape[2]
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * d**-0.5
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, S)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vf)
    return out.to(dtype), lse.transpose(1, 2).contiguous()


def _validate(q, k, v, causal: bool, window: int) -> None:
    _check_window(causal, window)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash attention takes (B, S, H, D) tensors, got shapes "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(
            f"k/v must be (B, S, H_kv, D) matching q {tuple(q.shape)}, got "
            f"{tuple(k.shape)} / {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(
            f"q heads ({h}) must be a multiple of k/v heads ({k.shape[2]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes one dtype of {_DTYPES}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, 128], got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v must share a device, got {q.device}/{k.device}/{v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash attention is forward-only in the PyTorch port (its "
            "backward is a later slice): run it under torch.no_grad()")


@functools.cache
def _kernel():
    """The ``flash_fwd`` C entry point with its argument types declared
    (every pointer and the stream as c_void_p, strides as 64-bit ints)."""
    fn = _build.load("flash_fwd").flash_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 9
                   + [i32, i32, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, window: int):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), d**-0.5 * _LOG2E,
            int(q.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False, window: int = 0):
    """Attention forward returning ``(out, lse)``: the CUDA kernel for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors."""
    _validate(q, k, v, causal, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


flash_attention_fwd.launches = 0  # kernel launches, counted by _launch


def flash_attention(q, k, v, causal: bool = False, window: int = 0):
    """Flash attention on (B, S, H, D); the model's ``attn="flash"``."""
    return flash_attention_fwd(q, k, v, causal, window)[0]
