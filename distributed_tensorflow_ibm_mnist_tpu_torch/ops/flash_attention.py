"""Flash attention, forward and backward: the port of the JAX package's
Pallas kernels K3 (forward), K4, K5, K6a and K6b (backward) and the K7
entries ``flash_block_fwd`` / ``flash_block_bwd``.

``flash_attention`` / ``flash_attention_fwd`` take (B, S, H, D) queries and
(B, S, H_kv, D) keys/values (H_kv divides H: grouped-query attention) in
bf16 or float32, and return the attention output in the input dtype (plus,
for ``flash_attention_fwd``, the natural-log row logsumexp as (B, S, H)
float32 — the JAX ``flash_block_fwd`` contract).  ``causal`` masks k > q;
``window`` > 0 (causal only) also masks k <= q - window.

``flash_attention`` is differentiable (``_Flash``, a
``torch.autograd.Function``): its backward computes ``delta = rowsum(dO *
O)`` in float32 and calls :func:`flash_attention_bwd`, which picks one of the
JAX package's three backward routes by the JAX rule
(``ops/flash_attention.py:719-761`` there), so the same shape takes the same
route as on the TPU:

* ``fused`` (K4) — one walk computes dQ, dK and dV;
* ``grouped`` (K5) — the fused walk over G q-row groups, with float32
  per-group dK/dV partials summed here and rounded once;
* ``split`` (K6a then K6b) — dK/dV over q-tiles, then dQ over k-tiles.

The gates (``_FUSED_DQ_VMEM_BUDGET``, ``_GROUPED_DQ_VMEM_BUDGET``,
``_GROUPED_BWD``, ``_GROUPED_MAX_GROUPS``, and the ``_BLOCK_Q`` / ``_BLOCK_K``
tiles they are counted in) are copies of the TPU's VMEM limits under the JAX
names, kept for routing only: they say nothing about the card, whose CUDA
tiles (64 x 64) are the kernels' own.  Picking routes for Hopper is later
work.  Under GQA dK/dV come out per q head and are summed per kv head here,
as the JAX wrapper does.

On CUDA tensors the wrappers launch the hand-written Hopper kernels in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (built by ``ops/_build.py``
at first use) or raise: there is no fallback.  bf16 inputs take the
tensor-core designs: K3, K4, K5 and K6a as mma.sync on cp.async-fed tiles,
K6b as wgmma on TMA-fed tiles (each bf16 view must be 16-byte aligned);
float32 inputs take the scalar CUDA-core designs.  The kernels take a
head_dim that is a multiple of 8 in [8, 128] and raise for any other
(:func:`check_kernel_head_dim`).  On CPU tensors they run the
same functions in plain PyTorch (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`), which the CPU tests hold against the JAX
kernels.  Launch counters, plain integers counted where a kernel launches:
``flash_attention_fwd.launches`` and ``flash_attention_bwd.fused_launches``,
``.grouped_launches``, ``.dkv_launches``, ``.dq_launches``; the K7 entries
count their calls that launched those kernels in
``flash_block_fwd.launches`` and ``flash_block_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build

_LOG2E = 1.4426950408889634
_DTYPES = (torch.float32, torch.bfloat16)

# The JAX package's backward routing constants (its ops/flash_attention.py
# :75-122), copied under the same names.  They are the TPU's tiles and VMEM
# budgets and are used here ONLY to pick the route a shape takes.
_BLOCK_Q = 512
_BLOCK_K = 1024
_FUSED_DQ_VMEM_BUDGET = 4 * 1024 * 1024
_GROUPED_BWD = True
_GROUPED_DQ_VMEM_BUDGET = int(2.5 * 1024 * 1024)
_GROUPED_MAX_GROUPS = 8


def _check_window(causal: bool, window: int) -> None:
    if window:
        if not causal:
            raise ValueError("window > 0 is causal sliding-window attention; "
                             "pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _live_mask(s: int, causal: bool, window: int, device) -> torch.Tensor | None:
    """(S, S) bool mask of live (q, k) pairs; None when every pair is live."""
    if not causal:
        return None
    pos = torch.arange(s, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def _repeat_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H, D): kv head j serves q heads j*g..j*g+g-1."""
    g = h // x.shape[2]
    return x.repeat_interleave(g, dim=2) if g > 1 else x


def flash_attention_plain(q, k, v, causal: bool = False, window: int = 0):
    """The kernel's function in plain PyTorch: float32 math, K/V repeated
    up to H heads, masked scores at -inf.  Returns ``(out, lse)`` with
    ``out`` (B, S, H, D) in the input dtype and ``lse`` (B, S, H) float32."""
    _check_window(causal, window)
    dtype = q.dtype
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), _repeat_kv(k.float(), h), _repeat_kv(v.float(), h)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * d**-0.5
    mask = _live_mask(s, causal, window, q.device)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, S)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vf)
    return out.to(dtype), lse.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, g, lse, delta, causal: bool = False,
                              window: int = 0, q_rows: tuple[int, int] | None = None):
    """The backward kernels' function in plain PyTorch, all float32.

    ``lse`` and ``delta`` are (B, S, H) float32 row statistics (``delta =
    rowsum(dO * O)``).  ``p = exp(s * scale - lse)`` masked, ``dp = dO V^T``,
    ``ds = p * (dp - delta) * scale``; returns ``(dq, dk, dv)`` float32 with
    dk/dv summed per kv head, (B, S, H_kv, D).  ``q_rows=(lo, hi)`` keeps
    only q rows lo..hi-1: their dQ rows and their share of dK/dV (one K5
    group's partials)."""
    _check_window(causal, window)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d**-0.5
    qf, gf = q.float(), g.float()
    kf, vf = _repeat_kv(k.float(), h), _repeat_kv(v.float(), h)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(scores - lse.float().transpose(1, 2)[..., None])
    mask = _live_mask(s, causal, window, q.device)
    if q_rows is not None:
        rows = torch.arange(s, device=q.device)
        in_rows = ((rows >= q_rows[0]) & (rows < q_rows[1]))[:, None]
        mask = in_rows if mask is None else mask & in_rows
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta.float().transpose(1, 2)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    if hkv != h:
        dk = dk.view(b, s, hkv, h // hkv, d).sum(3)
        dv = dv.view(b, s, hkv, h // hkv, d).sum(3)
    return dq, dk, dv


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
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v must share a device, got {q.device}/{k.device}/{v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def check_kernel_head_dim(d: int) -> None:
    """Raise ``ValueError`` for a head_dim that no CUDA kernel instance
    covers: one that is not a multiple of 8, or is above 128.  The plain
    versions take any head_dim, as JAX's flash does (it pads only the
    sequence); every CUDA launcher calls this first, so it runs without a
    GPU too."""
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(
            f"the CUDA flash kernels take a head_dim that is a multiple of 8 "
            f"in [8, 128], got {d}; only CPU tensors (the plain versions) take "
            f"any head_dim")


def _check_last_dim(**tensors) -> None:
    """Every kernel reads rows through their strides: the last dim must be
    contiguous.  The bf16 kernels also copy 16-byte chunks with cp.async
    or TMA, so each base pointer and each batch/seq/head stride (of a dim
    longer than 1) must be 16-byte aligned; a misaligned view raises (no
    copy is made behind its back)."""
    for name, t in tensors.items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st * 2 % 16 for st, n in
                                         zip(t.stride()[:3], t.shape[:3]) if n > 1)):
            raise ValueError(
                f"{name} must be 16-byte aligned for the bf16 kernels' cp.async "
                f"and TMA copies: data_ptr % 16 = {t.data_ptr() % 16}, strides "
                f"{t.stride()}")


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# The ctypes argument types of every C entry in csrc/flash_fwd.cu and
# csrc/flash_bwd.cu, in declaration order: every pointer and the stream as
# c_void_p, strides as 64-bit ints (tests/test_torch_build.py holds each
# list against its C declaration).
ARGTYPES = {
    "flash_fwd": [_PTR] * 5 + [_I32] * 5 + [_I64] * 9 + [_I32, _I32, _F32, _I32, _PTR],
    "flash_bwd_fused": ([_PTR] * 9 + [_I32] * 5 + [_STRIDES] + [_I32] * 4
                        + [_F32, _I32, _PTR]),
    "flash_bwd_dkv": [_PTR] * 8 + [_I32] * 5 + [_STRIDES] + [_I32] * 2 + [_F32, _I32, _PTR],
    "flash_bwd_dq": [_PTR] * 7 + [_I32] * 5 + [_STRIDES] + [_I32] * 2 + [_F32, _I32, _PTR],
}


@functools.cache
def _kernel():
    """The ``flash_fwd`` C entry point with its argument types declared."""
    return _build.entry("flash_fwd", "flash_fwd", ARGTYPES)


def _launch(q, k, v, causal: bool, window: int):
    check_kernel_head_dim(q.shape[3])
    _check_last_dim(q=q, k=k, v=v)
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
    tensors, :func:`flash_attention_plain` for CPU tensors.  Not
    differentiable (the JAX ``flash_block_fwd`` contract): inputs that need
    a gradient are refused; :func:`flash_attention` is the differentiable
    call."""
    _validate(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd returns (out, lse) without a gradient: call "
            "flash_attention for a differentiable result, or run this under "
            "torch.no_grad()")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    return flash_attention_plain(q, k, v, causal, window)


flash_attention_fwd.launches = 0  # kernel launches, counted by _launch


# ---------------------------------------------------------------- backward


class Route(NamedTuple):
    """A backward route: ``name`` is ``"fused"`` (K4), ``"grouped"`` (K5)
    or ``"split"`` (K6a + K6b); ``groups`` q-row groups of ``group_rows``
    rows (one group of every row unless grouped)."""

    name: str
    groups: int
    group_rows: int


def _pick_block(n: int, target: int) -> int:
    """The JAX package's tile pick: the largest power-of-two tile <= target
    dividing n (n itself when no tile of 8 or more divides it)."""
    b = 8
    while b * 2 <= target and n % (b * 2) == 0:
        b *= 2
    return b if n % b == 0 else n


def bwd_route(s: int, d: int, dtype: torch.dtype) -> Route:
    """The route the JAX package's ``_bwd_calls`` takes for sequence length
    ``s``, head_dim ``d`` and ``dtype`` (its ``:719-761``): fused when dQ's
    padded row fits ``_FUSED_DQ_VMEM_BUDGET``; else grouped when
    ``_GROUPED_BWD`` and the group sizing gives 2 to
    ``_GROUPED_MAX_GROUPS`` groups; else split.  TPU VMEM gates, used for
    routing only (module docstring)."""
    sp = s + (-s) % 8
    row_bytes = d * (4 + torch.empty((), dtype=dtype).element_size())
    block_q = _pick_block(sp, _BLOCK_Q)
    n_q = sp // block_q
    if sp * row_bytes <= _FUSED_DQ_VMEM_BUDGET:
        return Route("fused", 1, s)
    n_qg = min(n_q, max(1, (_GROUPED_DQ_VMEM_BUDGET // row_bytes) // block_q))
    while n_q % n_qg:
        n_qg -= 1
    if _GROUPED_BWD and 2 <= n_q // n_qg <= _GROUPED_MAX_GROUPS:
        return Route("grouped", n_q // n_qg, n_qg * block_q)
    return Route("split", 1, s)


@functools.cache
def _bwd_kernels():
    """The three ``flash_bwd`` C entry points with their argument types."""
    return tuple(_build.entry("flash_bwd", name, ARGTYPES)
                 for name in ("flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq"))


def _bwd_args(q, k, v, g, lse, delta, causal: bool, window: int) -> tuple:
    """The leading arguments every ``flash_bwd`` entry shares: the six
    input pointers, then (after the outputs) the shape, the 12 strides, the
    masks, and the scale and dtype flag."""
    check_kernel_head_dim(q.shape[3])
    _check_last_dim(q=q, k=k, v=v, g=g)
    b, s, h, d = q.shape
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *g.stride()[:3])
    return (ins, (b, s, h, k.shape[2], d, strides, int(causal), int(window)),
            (d**-0.5, int(q.dtype == torch.bfloat16)))


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _launch_fused(q, k, v, g, lse, delta, causal: bool, window: int, route: Route):
    """K4 (one group) or K5 (``route.groups`` groups): ``(dq, dk, dv)`` with
    dq in the input dtype and dk/dv per q head: (B, S, H, D) in the input
    dtype for K4, float32 partials (G, B, S, H, D) for K5."""
    ins, mid, tail = _bwd_args(q, k, v, g, lse, delta, causal, window)
    b, s, h, d = q.shape
    grouped = route.groups > 1
    dq = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((route.groups, b, s, h, d) if grouped else (b, s, h, d),
                     dtype=torch.float32 if grouped else q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    rc = _bwd_kernels()[0](*ins, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *mid,
                           route.group_rows, route.groups, *tail, _stream(q.device))
    _raise_on(rc, "flash_bwd_fused")
    if grouped:
        flash_attention_bwd.grouped_launches += 1
    else:
        flash_attention_bwd.fused_launches += 1
    return dq.to(q.dtype), dk, dv


def _launch_dkv(q, k, v, g, lse, delta, causal: bool, window: int):
    """K6a: ``(dk, dv)`` per q head, (B, S, H, D) in the input dtype."""
    ins, mid, tail = _bwd_args(q, k, v, g, lse, delta, causal, window)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    rc = _bwd_kernels()[1](*ins, dk.data_ptr(), dv.data_ptr(), *mid, *tail,
                           _stream(q.device))
    _raise_on(rc, "flash_bwd_dkv")
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def _launch_dq(q, k, v, g, lse, delta, causal: bool, window: int):
    """K6b: dq, (B, S, H, D) in the input dtype."""
    ins, mid, tail = _bwd_args(q, k, v, g, lse, delta, causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _bwd_kernels()[2](*ins, dq.data_ptr(), *mid, *tail, _stream(q.device))
    _raise_on(rc, "flash_bwd_dq")
    flash_attention_bwd.dq_launches += 1
    return dq


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _bwd_calls(q, k, v, g, lse, delta, causal: bool, window: int = 0):
    """dQ, dK, dV from (B, S, H) float32 ``lse``/``delta``: on CUDA tensors
    the kernels of the route :func:`bwd_route` picks, on CPU tensors
    :func:`flash_attention_bwd_plain`.  Outputs in the inputs' dtypes;
    dk/dv (B, S, H_kv, D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if q.device.type == "cuda":
        route = bwd_route(s, d, q.dtype)
        args = (q, k, v, g, lse, delta, causal, window)
        if route.name == "split":
            dk, dv = _launch_dkv(*args)
            dq = _launch_dq(*args)
        else:
            dq, dk, dv = _launch_fused(*args, route)
            if route.name == "grouped":  # float32 partials, rounded once below
                dk, dv = dk.sum(0), dv.sum(0)
        if hkv != h:  # per q head -> per kv head
            dk = dk.view(b, s, hkv, h // hkv, d).sum(3)
            dv = dv.view(b, s, hkv, h // hkv, d).sum(3)
    else:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, g, lse, delta, causal, window)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _validate_bwd(q, k, v, g, lse, delta, causal: bool, window: int) -> None:
    _validate(q, k, v, causal, window)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"dO must match q {tuple(q.shape)} {q.dtype} on {q.device}, got "
            f"{tuple(g.shape)} {g.dtype} on {g.device}")
    stats = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != stats or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"{name} must be (B, S, H) = {tuple(stats)} float32 on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_bwd(q, k, v, g, lse, delta, causal: bool = False, window: int = 0):
    """The flash backward from the forward's inputs, the output gradient
    ``g`` (dO) and the (B, S, H) float32 row statistics: ``(dq, dk, dv)`` in
    the inputs' dtypes.  The route is :func:`bwd_route`'s."""
    _validate_bwd(q, k, v, g, lse, delta, causal, window)
    lse, delta = lse.contiguous(), delta.contiguous()
    return _bwd_calls(q, k, v, g, lse, delta, causal, window)


# kernel launches, counted where each kernel launches
flash_attention_bwd.fused_launches = 0     # K4
flash_attention_bwd.grouped_launches = 0   # K5
flash_attention_bwd.dkv_launches = 0       # K6a
flash_attention_bwd.dq_launches = 0        # K6b


class _Flash(torch.autograd.Function):
    """Flash attention with its flash backward: forward through K3 (saving
    q, k, v, out and lse), backward through :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if g.stride(-1) != 1:  # e.g. the stride-0 gradient of a sum
            g = g.contiguous()
        # delta_i = rowsum(dO_i * O_i) in float32: a plain op, as JAX leaves
        # it to XLA
        delta = (g.float() * out.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, g, lse, delta, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, window: int = 0):
    """Flash attention on (B, S, H, D); the model's ``attn="flash"``.
    Differentiable in q, k and v."""
    return _Flash.apply(q, k, v, causal, window)


def flash_block_fwd(q, k, v, causal: bool = False):
    """The ring's block forward (K7, JAX ``flash_block_fwd``): ``(out,
    lse)`` of one (B, S, H, D) block with lse (B, S, H) float32, through K3
    on CUDA tensors (counted in ``flash_block_fwd.launches`` beside K3's
    own count) and :func:`flash_attention_plain` on CPU tensors.  Not
    differentiable, as JAX's: the ring writes its own backward from
    :func:`flash_block_bwd`.  Under the ring's three static cases
    (diagonal with ``causal``, fully visible without) every q row sees at
    least one key, so every lse row is finite."""
    out = flash_attention_fwd(q, k, v, causal)
    if q.device.type == "cuda":
        flash_block_fwd.launches += 1
    return out


def flash_block_bwd(q, k, v, g, lse, delta, causal: bool = False):
    """The ring's per-block backward (K7, JAX ``flash_block_bwd``) under
    GLOBAL row statistics: ``lse``/``delta`` (B, S, H) float32 of the full
    (ring-merged) softmax, so ``p = exp(s - lse)`` is this block's share of
    it; returns this block's ``(dq, dk, dv)`` in the inputs' dtypes.  On
    CUDA tensors the kernels of :func:`bwd_route` at the block's length
    (counted in ``flash_block_bwd.launches`` beside theirs), on CPU tensors
    :func:`flash_attention_bwd_plain`."""
    out = flash_attention_bwd(q, k, v, g, lse, delta, causal)
    if q.device.type == "cuda":
        flash_block_bwd.launches += 1
    return out


flash_block_fwd.launches = 0  # K7 forward entries that launched K3
flash_block_bwd.launches = 0  # K7 backward entries that launched K4-K6
