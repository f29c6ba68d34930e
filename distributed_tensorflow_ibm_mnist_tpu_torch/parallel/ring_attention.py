"""Ring-attention sequence parallelism over the mesh's ``seq`` axis.

The counterpart of the JAX package's ``parallel/ring_attention.py``:
attention over a sequence sharded across the ranks of a data row, each
rank's queries resident while the K/V blocks rotate around the ring
(:func:`~.collectives.ring_shift`, one neighbour hop a step), the softmax
accumulated online, so no rank holds the full S x S scores or another
rank's K/V outside a hop: memory is O(S_local).

Layout.  JAX's callable is a ``shard_map`` island called on the GLOBAL
(B, S, H, D) activations; here every rank runs its own process and holds
only its (B/dp, S/sp, ...) slice of every activation, so the callable
:func:`make_ring_attention` returns (a :class:`SeqParallelAttention`)
takes this rank's (B_local, S_local, H, D) shards, as JAX's island body
sees them.  The model decides the layout: it asks
:meth:`SeqParallelAttention.local_span` for its slice of a sequence, keeps
only those tokens and calls the callable; where the sequence does not
divide the ring (JAX's dense path for shapes that do not divide the mesh,
``ring_attention.py:313-328`` there) it keeps the whole sequence on every
rank and calls :meth:`SeqParallelAttention.dense`, the same inner kernel
unsharded.

Two inners, as in JAX:

* ``"dense"`` (:func:`_ring_attention_local`): float32 einsum block
  updates with -inf masking, K/V riding at their H_kv width in the grouped
  (B, S, H_kv, G, D) form, never expanded; differentiated by autograd
  through the differentiable hops;
* ``"flash"``: n K7 block forwards (``ops.flash_attention.flash_block_fwd``
  over K3) and n - 1 hops, the normalised blocks merged by their lse
  (:func:`_merge_block`), with a hand-written ring backward
  (:class:`_RingFlash`): dq accumulates locally, each block's dk/dv ride
  the ring with it and land home after n hops, every block backward
  (``flash_block_bwd``: K4-K6 by ``bwd_route`` at S_local) under the
  GLOBAL lse and ``delta = rowsum(dO * O)``.  Under causal masking each
  hop is one of three static cases: diagonal (hop 0), fully visible
  (``seq_index >= hop``) or fully masked, which launches no block but
  still sends and receives, so every rank's sequence of collectives is the
  same.  Rank ``s`` of the ring runs ``s + 1`` block forwards and ``s +
  1`` block backwards a call.

``vanilla_attention`` (the model's ``attn="vanilla"``) and its GQA head
expansion are the ground truth both are held against.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import ring_shift
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30  # the empty accumulator's max, as ops/flash_attention's sentinel
_INNERS = ("dense", "flash")


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


def _ring_attention_local(q, k, v, group, n: int, my: int, causal: bool):
    """The dense inner on this rank's (B, S_local, H, D) shards of a ring of
    ``n`` ranks, this one at place ``my`` along ``group``.  float32 math;
    scores grouped (q as (B, S, H_kv, G, D)) against K/V at H_kv width."""
    dtype = q.dtype
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of k/v heads ({k.shape[2]})")
    grp = q.shape[2] // k.shape[2]
    q, k, v = q.float(), k.float(), v.float()
    b, s_local, h, d = q.shape
    hkv = k.shape[2]
    scale = d**-0.5
    qg = q.reshape(b, s_local, hkv, grp, d)
    ar = torch.arange(s_local, device=q.device)
    q_pos = my * s_local + ar  # global query positions

    def block_update(k_blk, v_blk, src, m, l, o):
        # grouped scores (B, H_kv, G, S_q, S_k); G == 1 is the MHA case
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk) * scale
        if causal:
            k_pos = src * s_local + ar
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, scores.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(scores - m_safe[..., None])  # masked -> exp(-inf) = 0
        corr = torch.exp(m - m_safe)  # first block: exp(-inf) = 0
        l_new = l * corr + p.sum(-1)
        o_new = (o * corr.permute(0, 3, 1, 2)[..., None]
                 + torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk))
        return m_new, l_new, o_new

    m = torch.full((b, hkv, grp, s_local), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, grp, s_local), device=q.device)
    o = torch.zeros((b, s_local, hkv, grp, d), device=q.device)
    k_blk, v_blk = k, v
    for r in range(n):  # after r hops this rank holds the block born on my - r
        m, l, o = block_update(k_blk, v_blk, (my - r) % n, m, l, o)
        if r < n - 1:
            k_blk, v_blk = ring_shift([k_blk, v_blk], group)
    l_safe = torch.where(l == 0.0, 1.0, l)  # fully masked rows -> 0 output
    out = o / l_safe.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s_local, h, d).to(dtype)


def _merge_block(m_run, l_run, o_run, out_blk, lse_blk):
    """Online-softmax merge of one NORMALISED flash block into the running
    (max, weight sum, output numerator) accumulators, (B, S, H[, D]):
    ``out_blk * exp(lse_blk - m_new)`` is the block's rescaled numerator
    (out = acc / l and lse = m + log l, so l cancels).  A block of lse
    ``_NEG`` adds nothing once a real block has landed."""
    m_new = torch.maximum(m_run, lse_blk)
    corr = torch.exp(m_run - m_new)
    w_blk = torch.exp(lse_blk - m_new)
    l_new = l_run * corr + w_blk
    o_new = o_run * corr[..., None] + out_blk.float() * w_blk[..., None]
    return m_new, l_new, o_new


def _live(causal: bool, r: int, my: int) -> bool:
    """Whether hop ``r``'s block has an unmasked (q, k) pair on rank ``my``:
    always without ``causal``; under it the diagonal (r = 0) and the blocks
    born before this rank's (my >= r)."""
    return not causal or my >= r


def _ring_flash_fwd_loop(q, k, v, group, n: int, my: int, causal: bool):
    """n K7 block forwards (fewer under causal masking) and n - 1 hops ->
    ``(out, global lse)``.  A masked hop merges nothing: its ``_NEG`` block
    would leave the accumulators as they are, since hop 0's diagonal block
    has always landed first."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.ops.flash_attention import (
        flash_block_fwd,
    )

    b, s_local, h, d = q.shape
    m_run = torch.full((b, s_local, h), _NEG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, s_local, h), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for r in range(n):
        if _live(causal, r, my):
            out_blk, lse_blk = flash_block_fwd(q, k_blk, v_blk, causal=causal and r == 0)
            m_run, l_run, o_run = _merge_block(m_run, l_run, o_run, out_blk, lse_blk)
        if r < n - 1:  # the hop runs on every rank, live block or not
            k_blk, v_blk = ring_shift([k_blk, v_blk], group)
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    out = (o_run / l_safe[..., None]).to(q.dtype)
    return out, m_run + torch.log(l_safe)


def _ring_flash_bwd(q, k, v, out, lse, g, group, n: int, my: int, causal: bool):
    """The ring backward: dq accumulates here; each K/V block's (dk, dv)
    rides the ring WITH the block and, after n hops, is home."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.ops.flash_attention import (
        flash_block_bwd,
    )

    # delta_i = rowsum(dO_i * O_i) in float32: a plain op, as JAX leaves it to XLA
    delta = (g.float() * out.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_blk, v_blk = k, v
    for r in range(n):
        if _live(causal, r, my):
            dq_c, dk_c, dv_c = flash_block_bwd(q, k_blk, v_blk, g, lse, delta,
                                               causal=causal and r == 0)
            dq += dq_c.float()
            dk_blk += dk_c.float()
            dv_blk += dv_c.float()
        if n == 1:
            break
        if r < n - 1:  # the block and its gradients move on
            k_blk, v_blk, dk_blk, dv_blk = ring_shift([k_blk, v_blk, dk_blk, dv_blk], group)
        else:  # the last hop takes the gradients home; the block is done
            dk_blk, dv_blk = ring_shift([dk_blk, dv_blk], group)
    return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring with its ring backward (JAX's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, n: int, my: int, causal: bool):
        out, lse = _ring_flash_fwd_loop(q, k, v, group, n, my, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, my, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, g.contiguous(), *ctx.ring)
        return dq, dk, dv, None, None, None, None


class SeqParallelAttention:
    """A sequence-parallel attention callable: ``attn(q, k, v)`` on this
    rank's (B_local, S_local, H, D) shards of a sequence sharded over the
    mesh's seq axis (module docstring).  ``local_span(s, heads, heads_kv)``
    is this rank's token slice ``(lo, hi)`` of a length-``s`` sequence, or
    None where the shapes do not divide the axis (the model then keeps the
    whole sequence and calls ``dense``, the same inner kernel unsharded)."""

    def __init__(self, mesh: Mesh, fn: Callable, dense: Callable, split_heads: bool):
        self.mesh = mesh
        self._fn, self.dense = fn, dense
        self._split_heads = split_heads  # Ulysses re-shards heads over the axis

    def local_span(self, s: int, heads: int = 0,
                   heads_kv: int = 0) -> tuple[int, int] | None:
        n, i = self.mesh.seq_size, self.mesh.seq_index
        if s % n or (self._split_heads and (heads % n or (heads_kv or heads) % n)):
            return None
        return i * (s // n), (i + 1) * (s // n)

    def __call__(self, q, k, v):
        return self._fn(q, k, v)


def make_ring_attention(mesh: Mesh, causal: bool = False,
                        inner: str = "dense") -> SeqParallelAttention:
    """``attn(q, k, v)`` with the sequence sharded over the mesh's seq axis
    (its ``seq_group``), on this rank's (B_local, S_local, H, D) shards.
    ``inner``: ``"dense"`` (float32 einsum block updates) or ``"flash"``
    (K7 blocks, lse-merged, with the ring backward).  With a seq axis of
    one rank it degrades to exactly one block."""
    if inner not in _INNERS:
        raise ValueError(f"unknown ring inner {inner!r}; use 'dense' or 'flash'")
    group, n, my = mesh.seq_group, mesh.seq_size, mesh.seq_index
    if inner == "flash":
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        def fn(q, k, v):
            return _RingFlash.apply(q, k, v, group, n, my, causal)

        def dense(q, k, v):
            return flash_attention(q, k, v, causal=causal)
    else:
        def fn(q, k, v):
            return _ring_attention_local(q, k, v, group, n, my, causal)

        def dense(q, k, v):
            return vanilla_attention(q, k, v, causal=causal)
    return SeqParallelAttention(mesh, fn, dense, split_heads=False)
