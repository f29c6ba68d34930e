"""Pre-norm transformer block of the port, with its dense KV-cache decode.

The counterpart of the JAX package's ``models/transformer.py`` for the
causal-LM serving path: ``apply_rope``, ``reset_cache_slots``,
``_attend_cached`` (native-dtype caches), ``_resolve_attn`` and
``TransformerBlock`` (MHA through one ``qkv`` projection, GQA through
``q_proj``/``kv_proj``), with the normal forward and the dense decode
attention, ragged or uniform, with or without a sliding window.

Numerics follow flax's: LayerNorm statistics in float32 with epsilon 1e-6
and the E[x^2] - E[x]^2 variance; GELU is the tanh approximation; compute
runs in ``dtype`` (bf16 by default) and norms in float32.  Projection
outputs keep the flax column order (``qkv`` as [3][heads][head_dim],
``kv_proj`` as [2][heads_kv][head_dim]), so converted weights need only a
transpose (convert.py).

The decode cache is a dict ``{"k", "v", "index"}`` per block, shaped like
the flax ``cache`` collection: k/v (B, max_len, H_kv, D) in ``dtype`` and a
(B,) int32 cursor.  Unlike flax, decode updates it IN PLACE (one cache per
engine, no copy per step) and returns nothing for it.

Not ported yet, each raising ``NotImplementedError`` that names what ports
it: MoE blocks and dropout (ROADMAP.md queue 1, 'Causal-LM training
follow-ups'), int8 weights, the int8 KV cache and the paged cache (serving
slices).  ``StackedBlocks`` (pipeline training) is not ported.  Training
runs this forward under autograd: ``attn="flash"`` differentiates through
the flash kernels' ``torch.autograd.Function``, ``"vanilla"`` through plain
PyTorch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    vanilla_attention,
)


def apply_rope(x: torch.Tensor, theta: float = 10000.0, offset=0) -> torch.Tensor:
    """Rotary position embedding on (B, S, H, D) queries/keys (D even).

    Pairs dimension d with d + D/2 (a half split, not interleaved) and
    rotates each pair by pos * theta^(-2d/D); angles in float32.  ``offset``
    shifts the positions: an int or 0-dim tensor for the whole batch, or a
    (B,) tensor giving each row its own absolute position (ragged decode).
    """
    b, s, h, d = x.shape
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    dev = x.device
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=dev) / half)
    off = torch.as_tensor(offset, device=dev).to(torch.float32)
    steps = torch.arange(s, dtype=torch.float32, device=dev)
    if off.ndim == 0:
        ang = (off + steps)[:, None] * freqs[None, :]  # (S, half)
        cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    else:
        ang = (off[:, None] + steps[None, :])[..., None] * freqs  # (B, S, half)
        cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def reset_cache_slots(cache: dict, slot_mask: torch.Tensor) -> dict:
    """Zero, in place, the K/V and cursor of every batch row where the (B,)
    bool ``slot_mask`` is True — the serving engine's per-slot reset."""
    for entry in cache.values():
        for leaf in entry.values():
            leaf[slot_mask] = 0
    return cache


def _attend_cached(q, kc, vc, mask, dtype):
    """Score (B, S, H, D) queries against a (B, L, H_kv, D) cache span with
    a (B|1, S, L) bool mask: float32 scores and softmax, masked at -1e30,
    probabilities in ``dtype`` into the PV product.  GQA queries score a
    grouped einsum against the H_kv-sized cache with no repeat."""
    b, s, h, d = q.shape
    hkv = kc.shape[2]
    scale = d**-0.5
    qf, kf = q.float(), kc.float()
    if hkv != h:
        qg = qf.reshape(b, s, hkv, h // hkv, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        scores = torch.where(mask[:, None, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(dtype), vc).reshape(b, s, h, d)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        scores = torch.where(mask[:, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype), vc)
    return out.to(dtype)


def _resolve_attn(attn_fn: Callable | None, attn: str) -> Callable:
    """``attn_fn`` (an explicit callable) wins; else by name: ``"vanilla"``
    (plain PyTorch) or ``"flash"`` (the CUDA kernel)."""
    if attn_fn is not None:
        return attn_fn
    if attn == "flash":
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention
    if attn == "vanilla":
        return vanilla_attention
    raise ValueError(f"unknown attn {attn!r}; use 'vanilla' or 'flash'")


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics: float32 statistics (E[x^2] - E[x]^2,
    clipped at 0), epsilon 1e-6, float32 scale/bias, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


LM_FOLLOW_UPS = "ROADMAP.md queue 1, 'Causal-LM training follow-ups',"


def _not_in_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet ({where} ports it)")


class TransformerBlock(nn.Module):
    """Pre-norm block: LayerNorm -> attention -> proj (+res) -> LayerNorm ->
    MLP (+res).  ``forward(x)`` runs the normal (prefill) forward and
    returns ``(x, (k, v))`` with the post-RoPE K/V the decode cache stores;
    ``forward(x, cache=entry, max_len=L)`` runs decode attention against
    the block's cache entry, updated in place, and returns ``(x, None)``."""

    def __init__(self, dim: int, heads: int, heads_kv: int = 0, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_fn: Callable | None = None,
                 attn: str = "vanilla", use_moe: bool = False, rope: bool = False,
                 window: int = 0, kv_cache_dtype: str = "native",
                 page_size: int = 0, quant: str = "none",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if use_moe:
            raise _not_in_slice("a MoE block", LM_FOLLOW_UPS)
        if quant != "none":
            raise _not_in_slice(f"quant={quant!r}", "the int8 serving slice")
        if kv_cache_dtype != "native":
            raise _not_in_slice(f"kv_cache_dtype={kv_cache_dtype!r}",
                                "the int8 serving slice")
        if page_size:
            raise _not_in_slice("the paged KV cache", "the paged-KV serving slice")
        if dropout > 0.0:
            raise _not_in_slice("dropout in a transformer block", LM_FOLLOW_UPS)
        hkv = heads_kv or heads
        if heads % hkv:
            raise ValueError(f"heads ({heads}) must be a multiple of heads_kv ({hkv})")
        self.dim, self.heads, self.heads_kv = dim, heads, hkv
        self.head_dim = dim // heads
        self.rope, self.window, self.dtype = rope, window, dtype
        self.attn_fn = _resolve_attn(attn_fn, attn)
        kw = dict(dtype=dtype, device=device)
        self.norm_attn = LayerNorm(dim, dtype, device=device)
        if hkv == heads:
            self.qkv = nn.Linear(dim, 3 * dim, **kw)
        else:
            self.q_proj = nn.Linear(dim, dim, **kw)
            self.kv_proj = nn.Linear(dim, 2 * hkv * self.head_dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.norm_mlp = LayerNorm(dim, dtype, device=device)
        self.dense_0 = nn.Linear(dim, mlp_ratio * dim, **kw)
        self.dense_1 = nn.Linear(mlp_ratio * dim, dim, **kw)

    def forward(self, x, cache: dict | None = None, max_len: int = 0,
                ragged: bool = False):
        b, s, _ = x.shape
        hd = self.head_dim
        h = self.norm_attn(x)
        if self.heads_kv == self.heads:
            qkv = self.qkv(h).view(b, s, 3, self.heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self.q_proj(h).view(b, s, self.heads, hd)
            kv = self.kv_proj(h).view(b, s, 2, self.heads_kv, hd)
            k, v = kv[:, :, 0], kv[:, :, 1]
        kv_out = None
        if cache is not None:
            o = self._decode_attention(q, k, v, cache, max_len, ragged)
        else:
            if self.rope:
                q, k = apply_rope(q), apply_rope(k)
            kv_out = (k, v)
            o = self.attn_fn(q, k, v)
        x = x + self.proj(o.reshape(b, s, self.dim))
        h = self.norm_mlp(x)
        h = self.dense_1(F.gelu(self.dense_0(h), approximate="tanh"))
        return x + h, kv_out

    def _decode_attention(self, q, k, v, cache: dict, max_len: int,
                          ragged: bool = False):
        """Incremental attention over the dense cache: write this call's K/V
        at each row's cursor, advance the cursor (saturating at max_len),
        and attend each query over its row's filled prefix — or, with a
        window, over the live W-span gathered from the cache.

        ``ragged`` selects per-row cursors (each row at its own position)
        over one shared cursor (row 0's, for lockstep batches).  Write
        positions clamp at max_len - 1, so an idle row that ran off its
        cache writes garbage into its own last slot only."""
        if max_len <= 0:
            raise ValueError("decode needs max_len > 0 (the KV-cache size)")
        b, s = q.shape[:2]
        dev = q.device
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        steps = torch.arange(s, device=dev)
        if ragged:
            if self.rope:
                q = apply_rope(q, offset=idx)
                k = apply_rope(k, offset=idx)
            rows = torch.arange(b, device=dev)[:, None]
            pos = (idx[:, None] + steps).clamp(max=max_len - 1)  # (B, S)
            ck[rows, pos] = k.to(ck.dtype)
            cv[rows, pos] = v.to(cv.dtype)
            q_pos = idx[:, None] + steps  # (B, S) absolute positions
        else:
            idx0 = idx[0]  # one cursor for every row
            if self.rope:
                q = apply_rope(q, offset=idx0)
                k = apply_rope(k, offset=idx0)
            pos = idx0.clamp(max=max_len - s) + steps  # the clamped slice write
            ck[:, pos] = k.to(ck.dtype)
            cv[:, pos] = v.to(cv.dtype)
            q_pos = (idx0 + steps)[None]  # (1, S)
        if self.window:
            start = (idx - self.window + 1).clamp(min=0)  # span start, pre-write cursor
        idx.copy_((idx + s).clamp(max=max_len))

        k_pos = torch.arange(max_len, device=dev)[None]  # (1, max_len)
        kc, vc = ck, cv
        if self.window and (self.window + s - 1) < max_len:
            # gather only the live span: queries [cursor, cursor+s) attend
            # at most positions (cursor+s-1-W, cursor+s)
            span = torch.arange(self.window + s - 1, device=dev)
            if ragged:
                k_pos = start[:, None] + span  # (B, span)
                g = k_pos.clamp(max=max_len - 1)
                rows = torch.arange(b, device=dev)[:, None]
                kc, vc = ck[rows, g], cv[rows, g]
            else:
                k_pos = (start[0] + span)[None]  # (1, span)
                g = k_pos[0].clamp(max=max_len - 1)
                kc, vc = ck[:, g], cv[:, g]
        mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B|1, S, L)
        if self.window:
            mask &= k_pos[:, None, :] > q_pos[:, :, None] - self.window
        return _attend_cached(q, kc, vc, mask, self.dtype)
