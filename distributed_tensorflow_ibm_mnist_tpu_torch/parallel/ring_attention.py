"""Plain attention of the port (the JAX package's ``vanilla_attention``).

Only the reference paths of ``parallel/ring_attention.py`` are ported in
this slice: ``vanilla_attention`` (the model's ``attn="vanilla"``) and the
GQA head expansion it uses.  The ring itself, sequence sharding over
devices, is a later slice.
"""

from __future__ import annotations

import torch


def _expand_kv_groups(q, k, v):
    """Grouped-query attention in the reference path: K/V with H_kv < H
    heads are repeated up to H (q head h reads kv head h // (H / H_kv))."""
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2]:
            raise ValueError(
                f"q heads ({q.shape[2]}) must be a multiple of k/v heads "
                f"({k.shape[2]})")
        g = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def vanilla_attention(q, k, v, causal: bool = False, window: int = 0):
    """Plain softmax attention on (B, S, H, D), float32 math, masked scores
    at -inf, output in the input dtype.  ``window`` > 0 restricts each
    position to its last ``window`` keys (causal only)."""
    if window:
        if not causal:
            raise ValueError("window > 0 is causal sliding-window attention; "
                             "pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    dtype = q.dtype
    k, v = _expand_kv_groups(q, k, v)
    q, k, v = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        s_q, s_k = scores.shape[-2:]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril()
        if window:
            mask &= torch.ones_like(mask).triu(-(window - 1))
        scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.to(dtype)
