"""Fused softmax cross-entropy: the port of the JAX package's Pallas K1/K2.

``softmax_xent(logits, labels)`` takes (N, C) float32 or bf16 logits and
(N,) int32/int64 labels and returns the per-example loss
``logsumexp(logits[i]) - logits[i, labels[i]]`` as (N,) float32, whatever
the logits dtype.  It is differentiable: a ``torch.autograd.Function``
whose forward is K1 and whose backward is K2, ``(softmax(logits) -
onehot(labels)) * g`` in the logits dtype.  A label outside [0, C) matches
no column: its loss is the row's logsumexp and its gradient has no -1.

On CUDA tensors the forward launches ``xent_fwd`` and the backward
``xent_bwd``, hand-written kernels in ``csrc/xent.cu`` (built by
``ops/_build.py`` at first use), or raise: there is no fallback.  On CPU
tensors both run their plain PyTorch twins, :func:`softmax_xent_plain` and
:func:`softmax_xent_grad_plain`, which the CPU tests hold against the JAX
kernels.  ``softmax_xent.fwd_launches`` and ``softmax_xent.bwd_launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
_LABEL_DTYPES = (torch.int32, torch.int64)


def _onehot(labels: torch.Tensor, c: int) -> torch.Tensor:
    """(N, C) bool, all False on a row whose label is outside [0, C)."""
    cols = torch.arange(c, device=labels.device)
    return cols[None, :] == labels[:, None]


def softmax_xent_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """K1's function in plain PyTorch: (N,) float32 losses."""
    x = logits.float()
    picked = torch.where(_onehot(labels, x.shape[1]), x, 0.0).sum(-1)
    return torch.logsumexp(x, dim=-1) - picked


def softmax_xent_grad_plain(logits: torch.Tensor, labels: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """K2's function in plain PyTorch: ``(softmax - onehot) * g[:, None]``
    computed in float32, returned in the logits dtype."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _onehot(labels, logits.shape[1]).float()
    return ((probs - onehot) * g.float()[:, None]).to(logits.dtype)


def _validate(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Check what the kernels take; returns the labels as int32."""
    if logits.ndim != 2 or labels.ndim != 1:
        raise ValueError(
            f"softmax_xent takes (N, C) logits and (N,) labels, got shapes "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"{labels.shape[0]} labels for {logits.shape[0]} rows of logits")
    if logits.shape[1] < 1:
        raise ValueError("softmax_xent needs at least one class")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits must be one of {_DTYPES}, got {logits.dtype}")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"labels must be one of {_LABEL_DTYPES}, got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError(
            f"logits and labels must share a device, got {logits.device}/{labels.device}")
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(f"softmax_xent runs on cuda or cpu, not {logits.device}")
    if logits.device.type == "cuda":
        if logits.stride(1) != 1:
            raise ValueError(f"logits rows must be contiguous (strides {logits.stride()})")
        if labels.stride(0) != 1:
            raise ValueError(f"labels must be contiguous (stride {labels.stride()})")
    return labels.to(torch.int32)  # int64 -> int32; no copy when already int32


@functools.cache
def _kernels():
    """The ``xent_fwd`` / ``xent_bwd`` C entry points, argument types
    declared (pointers and the stream as c_void_p, strides 64-bit)."""
    lib = _build.load("xent")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.xent_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i64, i32, ptr]
    lib.xent_bwd.argtypes = [ptr, ptr, ptr, i64, ptr, i32, i32, i64, i32, ptr]
    lib.xent_fwd.restype = lib.xent_bwd.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "softmax_xent was given a CUDA tensor but no CUDA device is available")
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors, the plain twin on CPU tensors."""
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    stream = _stream(logits)
    n, c = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    if n == 0:
        return loss
    rc = _kernels().xent_fwd(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), n, c,
        logits.stride(0), int(logits.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"xent_fwd kernel launch failed: CUDA error {rc}")
    softmax_xent.fwd_launches += 1
    return loss


def _bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors, the plain twin on CPU tensors.  ``g`` may be the
    stride-0 expansion autograd passes for a mean: the kernel reads it
    through its stride, so no copy is made."""
    if logits.device.type == "cpu":
        return softmax_xent_grad_plain(logits, labels, g)
    stream = _stream(logits)
    if g.dtype != torch.float32:
        g = g.float()
    n, c = logits.shape
    dx = torch.empty((n, c), dtype=logits.dtype, device=logits.device)
    if n == 0:
        return dx
    rc = _kernels().xent_bwd(
        logits.data_ptr(), labels.data_ptr(), g.data_ptr(), g.stride(0),
        dx.data_ptr(), n, c, logits.stride(0),
        int(logits.dtype == torch.bfloat16), stream)
    if rc:
        raise RuntimeError(f"xent_bwd kernel launch failed: CUDA error {rc}")
    softmax_xent.bwd_launches += 1
    return dx


class _SoftmaxXent(torch.autograd.Function):
    """Forward K1, backward K2; labels get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return _fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return _bwd(logits, labels, g), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy, (N, C) x (N,) int -> (N,) float32."""
    labels = _validate(logits, labels)
    return _SoftmaxXent.apply(logits, labels)


softmax_xent.fwd_launches = 0  # K1 launches, counted by _fwd
softmax_xent.bwd_launches = 0  # K2 launches, counted by _bwd


def softmax_xent_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean fused cross-entropy: the train loss under ``fused_xent``."""
    return softmax_xent(logits, labels).mean()


def softmax_xent_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """K2 alone (what the autograd backward runs): the logits gradient for
    upstream per-example gradients ``g`` (N,)."""
    labels = _validate(logits, labels)
    if g.shape != (logits.shape[0],):
        raise ValueError(f"g must be ({logits.shape[0]},), got {tuple(g.shape)}")
    if g.device != logits.device:
        raise ValueError(f"g must be on {logits.device}, got {g.device}")
    return _bwd(logits, labels, g)
