"""Pre-norm transformer block of the port, with its dense KV-cache decode.

The counterpart of the JAX package's ``models/transformer.py`` for the
causal-LM serving path: ``apply_rope``, ``reset_cache_slots``,
``quantize_kv_int8``, ``_attend_cached`` (native or int8 caches),
``_resolve_attn`` and
``TransformerBlock`` (MHA through one ``qkv`` projection, GQA through
``q_proj``/``kv_proj``), with the normal forward and the dense decode
attention, ragged or uniform, with or without a sliding window; and the
``VisionTransformer`` over those blocks (no RoPE).

A block with ``use_moe`` runs the MoE FFN (parallel/expert_parallel.py
``MoEBlock``, float32, under the name ``moe``) in place of
``dense_0``/``dense_1``, in training and in decode: it routes each call's
tokens, capacity sized for them; a call that holds a seq group's slice of
each sequence (sequence parallelism, a context-parallel prefill) routes
the whole sequences, gathered over the group.  Under tp every model rank
runs the MoE block whole on the whole activation.  ``dropout`` (flax's ``nn.Dropout``)
sits on the attention projection's output and on the MLP/MoE output,
only when ``train``, its masks drawn from the model's ``generator``.  A
block returns ``(x, kv, moe)``, ``moe`` its aux, pre-weighted z and
dropped fraction (None for a dense block); :func:`run_blocks` sums them
over a stack, as JAX's loss function reduces the sown collections.

Numerics follow flax's: LayerNorm statistics in float32 with epsilon 1e-6
and the E[x^2] - E[x]^2 variance; GELU is the tanh approximation; compute
runs in ``dtype`` (bf16 by default) and norms in float32.  Projection
outputs keep the flax column order (``qkv`` as [3][heads][head_dim],
``kv_proj`` as [2][heads_kv][head_dim]), so converted weights need only a
transpose (convert.py).

The decode cache is a dict ``{"k", "v", "index"}`` per block, shaped like
the flax ``cache`` collection: k/v (B, max_len, H_kv, D) in ``dtype`` and a
(B,) int32 cursor.  Unlike flax, decode updates it IN PLACE (one cache per
engine, no copy per step) and returns nothing for it.  With
``kv_cache_dtype="int8"`` k/v are int8 with per-(position, head) float32
``k_scale``/``v_scale`` (B, max_len, H_kv) leaves (``quantize_kv_int8``);
the paged cache (serving/kv_pool.py) carries ``pages_k_scale`` /
``pages_v_scale`` beside its pools.  ``quant="int8"`` makes every
projection an ``Int8Linear`` (models/quant.py).

Sequence parallelism (``attn_fn`` a ``parallel.ring_attention.
SeqParallelAttention``: the ring or Ulysses): the models keep only this
rank's slice of the tokens (:func:`seq_shard`), their positions offset by
the slice's start (RoPE's ``offset``, the learned table sliced), and the
blocks attend through the callable; the ViT's token mean-pool sums across
the seq group (a differentiable all-reduce: its backward is the sum
too).  Where the sequence does not divide the axis the whole sequence
stays on every rank and the blocks call the callable's ``dense`` inner.

Tensor parallelism (``parallel.tensor_parallel.TPPlan`` cuts a built
model to a model rank's blocks and marks it): where tp divides a block's
heads and heads_kv, its attention and MLP are Megatron's pairs, one
``copy_to_model`` in and one all-reduce out each, the attention on this
rank's ``tp_heads`` (and ``tp_heads_kv``) heads of a head-major ``qkv`` /
``kv_proj`` block; any other split layer takes the generic path
(``tensor_parallel.linear``: a column's output gathered, a row's input
scattered and its output reduced), so the attention then runs on every
head on every model rank.  The patch conv's output channels are gathered,
and the ``logits`` head is a row split.

Pipeline stages (``pp_stages``, the ViT and the causal LM): the block
stack is a :class:`StackedBlocks`, ``pipe_blocks.stages.{s}.{i}`` (JAX's
one ``pipe_blocks/stacked`` tree with ``(n_stages, per_stage, ...)``
leaves; ``convert.py`` maps the two), and the model's ``pipeline_fn`` (the
Trainer's, ``parallel/pipeline.py``) runs it; a pipe rank keeps its own
stage only (``StackedBlocks.keep_stage``).  ``moe_fn`` (the models'
keyword, ``parallel.expert_parallel.make_moe_dispatch_auto`` or a user's
island) runs every MoE block through it.  ``block_remat`` (the ViT, the causal LM)
recomputes each block in the backward (``models/remat.py``), its dropout
masks replayed and its MoE terms taken from the forward.  Training
runs this forward under autograd: ``attn="flash"`` differentiates through
the flash kernels' ``torch.autograd.Function``, ``"vanilla"`` through plain
PyTorch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F

from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import (
    _resolve_generator,
    dropout,
    init_lecun_,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import Int8Linear
from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import remat
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_sum,
    copy_to_model,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.expert_parallel import MoEBlock
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    _NEG,
    SeqParallelAttention,
    _merge_block,
    vanilla_attention,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import (
    column,
    layer_mesh,
    linear as tp_linear,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device


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


def quantize_kv_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8 quantization of (..., D) K or V:
    ``scale = max(max|x|, 1e-8) / 127`` over D in float32, ``round(x /
    scale)`` (half to even) as int8.  Returns ``(int8 x, float32 scale)``
    with the scale one rank lower."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def reset_cache_slots(cache: dict, slot_mask: torch.Tensor) -> dict:
    """Zero, in place, the K/V (and int8 scales) and cursor of every batch
    row where the (B,) bool ``slot_mask`` is True — the serving engine's
    per-slot reset."""
    for entry in cache.values():
        for leaf in entry.values():
            leaf[slot_mask] = 0
    return cache


def _attend_cached(q, kc, vc, mask, dtype, ksc=None, vsc=None, with_lse: bool = False):
    """Score (B, S, H, D) queries against a (B, L, H_kv, D) cache span with
    a (B|1, S, L) bool mask: float32 scores and softmax, masked at -1e30,
    probabilities in ``dtype`` into the PV product.  GQA queries score a
    grouped einsum against the H_kv-sized cache with no repeat.

    An int8 cache passes its (B, L, H_kv) ``ksc``/``vsc`` scales: the
    scores take ``k_scale`` per (q, k) pair, the probabilities fold in
    ``v_scale`` and stay float32 into the PV product, as JAX's do (its
    einsum promotes them; torch's would not, so the cache is cast).

    ``with_lse``: ``(out, lse)`` instead, ``out`` uncast and ``lse`` the
    (B, S, H) float32 log-sum-exp of the masked scores (a context-parallel
    rank's partial, :func:`merge_cp_partials`)."""
    b, s, h, d = q.shape
    hkv = kc.shape[2]
    quant = ksc is not None
    scale = d**-0.5
    qf, kf = q.float(), kc.float()
    vop = vc.float() if quant else vc
    if hkv != h:
        qg = qf.reshape(b, s, hkv, h // hkv, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        if quant:
            scores = scores * ksc.permute(0, 2, 1)[:, :, None, None, :]
        scores = torch.where(mask[:, None, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        if quant:
            p = p * vsc.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bhgqk,bkhd->bqhgd", p if quant else p.to(dtype),
                           vop).reshape(b, s, h, d)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if quant:
            scores = scores * ksc.permute(0, 2, 1)[:, :, None, :]
        scores = torch.where(mask[:, None], scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        if quant:
            p = p * vsc.permute(0, 2, 1)[:, :, None, :]
        out = torch.einsum("bhqk,bkhd->bqhd", p if quant else p.to(dtype), vop)
    if with_lse:
        lse = torch.logsumexp(scores, dim=-1)  # (B, H_kv, G, S) or (B, H, S)
        return out, lse.reshape(b, h, s).transpose(1, 2) if hkv != h else lse.transpose(1, 2)
    return out.to(dtype)


def write_held(pool: torch.Tensor, page: torch.Tensor, off: torch.Tensor, x: torch.Tensor,
               lo: int) -> None:
    """``pool[page - lo, off] = x`` for the entries whose ``page`` lies in
    ``lo .. lo + len(pool) - 1`` (the pages a context-parallel rank holds),
    every other entry leaving the pool as it was, with no host sync: each
    such entry is sent to the first held entry's slot with that entry's
    value (where none is held, every entry to one slot with the value it
    holds), so entries that share a slot all carry the same value.
    ``page`` and ``off`` share a shape; ``x`` is that shape then the pool's
    trailing dims."""
    n = pool.shape[0]
    held = ((page >= lo) & (page < lo + n)).flatten()
    page, off = (page - lo).clamp(0, n - 1).flatten(), off.flatten()
    x = x.reshape(held.shape[0], *pool.shape[2:]).to(pool.dtype)
    first = held.int().argmax().view(1)  # the first held entry, or entry 0
    fill = torch.where(held[first].view(1, *[1] * (x.dim() - 1)), x[first],
                       pool[page[first], off[first]])
    pool[torch.where(held, page, page[first]), torch.where(held, off, off[first])] = (
        torch.where(held.view(-1, *[1] * (x.dim() - 1)), x, fill))


def merge_cp_partials(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The decode attention of a context-parallel engine: every rank of the
    cp ``group`` attended over the positions whose pages it holds, giving
    a partial ``out`` (B, S, H, D) and its ``lse`` (B, S, H); the partials
    of every rank merge in rank order by the ring's online-softmax merge
    (``ring_attention._merge_block``), in float32, so every rank of the
    group ends with the same output.  A rank that holds none of a row's
    positions gives lse -1e30 there, which the merge weighs at 0."""
    outs = all_gather(out.float().contiguous()[None], group)
    lses = all_gather(lse.float().contiguous()[None], group)
    m = torch.full(lse.shape, _NEG, dtype=torch.float32, device=lse.device)
    l = torch.zeros(lse.shape, dtype=torch.float32, device=lse.device)
    o = torch.zeros(out.shape, dtype=torch.float32, device=out.device)
    for r in range(outs.shape[0]):
        m, l, o = _merge_block(m, l, o, outs[r], lses[r])
    return o / l[..., None]


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


def is_moe_block(i: int, moe_every: int) -> bool:
    """Block ``i`` of a stack is a MoE block every ``moe_every`` blocks
    (JAX's ``(i + 1) % moe_every == 0``)."""
    return moe_every > 0 and (i + 1) % moe_every == 0


def check_moe_knobs(pp_stages: int, depth: int, dropout: float, moe_every: int) -> None:
    """What JAX's models refuse with dropout and MoE, in its words."""
    if pp_stages > 0:
        if depth % pp_stages:
            raise ValueError(f"depth {depth} not divisible by pp_stages {pp_stages}")
        if dropout > 0.0 or moe_every > 0:
            raise ValueError(
                "pipeline stages need identical per-block programs: "
                "dropout and MoE blocks don't compose with pp_stages")


def check_quant_knobs(quant: str, kv_cache_dtype: str) -> None:
    """The values JAX's model takes for ``quant`` and ``kv_cache_dtype``."""
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
    if kv_cache_dtype not in ("native", "int8"):
        raise ValueError(
            f"kv_cache_dtype must be 'native' or 'int8', got {kv_cache_dtype!r}")


class TransformerBlock(nn.Module):
    """Pre-norm block: LayerNorm -> attention -> proj (+dropout, +res) ->
    LayerNorm -> MLP or MoE (+dropout, +res).  ``forward(x)`` runs the
    normal (prefill) forward and returns ``(x, (k, v), moe)`` with the
    post-RoPE K/V the decode cache stores; ``forward(x, cache=entry,
    max_len=L)`` runs decode attention against the block's cache entry,
    updated in place, and returns ``(x, None, moe)``.  ``moe`` is None for
    a dense block, else ``{"aux", "z", "dropped"}`` (``z`` pre-weighted by
    ``moe_z_weight``, None when that is 0).  ``train=True`` turns dropout
    on.  The projections are stored in ``param_dtype`` (``dtype`` when
    None, as a serving model keeps them; training keeps float32 masters,
    as flax does) and cast to ``dtype`` for each product; the MoE leaves
    are float32 always."""

    def __init__(self, dim: int, heads: int, heads_kv: int = 0, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_fn: Callable | None = None,
                 attn: str = "vanilla", use_moe: bool = False, n_experts: int = 8,
                 moe_capacity_factor: float = 2.0, moe_top_k: int = 1,
                 moe_z_weight: float = 0.0, moe_fn: Callable | None = None,
                 rope: bool = False,
                 window: int = 0, kv_cache_dtype: str = "native",
                 page_size: int = 0, quant: str = "none",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_quant_knobs(quant, kv_cache_dtype)
        if page_size < 0:
            raise ValueError(f"page_size must be >= 0, got {page_size}")
        if page_size and window:
            raise ValueError(
                "the paged cache does not compose with sliding-window "
                "attention (window > 0) — the windowed span gather assumes a "
                "dense contiguous cache row")
        if dropout > 0.0 and generator is None:
            raise ValueError("dropout > 0 draws its masks from the model's generator; "
                             "pass generator=")
        hkv = heads_kv or heads
        if heads % hkv:
            raise ValueError(f"heads ({heads}) must be a multiple of heads_kv ({hkv})")
        self.dim, self.heads, self.heads_kv = dim, heads, hkv
        self.head_dim = dim // heads
        self.rope, self.window, self.dtype = rope, window, dtype
        self.page_size = page_size
        self.kv_cache_dtype = kv_cache_dtype
        self.attn_fn = _resolve_attn(attn_fn, attn)
        self.dropout, self.generator = dropout, generator
        # the model axis (parallel.tensor_parallel.TPPlan.shard sets these):
        # its mesh, the heads this rank attends over, and whether the
        # attention and the MLP run as Megatron pairs
        self.tp_mesh = None
        self.tp_heads, self.tp_heads_kv = heads, hkv
        self.tp_attn_pair = self.tp_mlp_pair = False
        # a context-parallel serving engine's mesh (its cp group): the paged
        # pool then holds this cp row's pages only, and decode attention
        # merges the rows' partials (serving/engine.py sets it)
        self.cp_mesh = None

        def linear(fan_in, fan_out):
            if quant == "int8":
                return Int8Linear(fan_in, fan_out, dtype=dtype, device=device)
            return nn.Linear(fan_in, fan_out, dtype=param_dtype or dtype, device=device)

        self.norm_attn = LayerNorm(dim, dtype, device=device)
        if hkv == heads:
            self.qkv = linear(dim, 3 * dim)
        else:
            self.q_proj = linear(dim, dim)
            self.kv_proj = linear(dim, 2 * hkv * self.head_dim)
        self.proj = linear(dim, dim)
        self.norm_mlp = LayerNorm(dim, dtype, device=device)
        self.moe = None
        if use_moe:  # the MoE FFN in place of dense_0/dense_1 (float32)
            self.moe = MoEBlock(dim, n_experts=n_experts, hidden_mult=mlp_ratio,
                                capacity_factor=moe_capacity_factor, top_k=moe_top_k,
                                z_weight=moe_z_weight, ep_fn=moe_fn, device=device)
        else:
            self.dense_0 = linear(dim, mlp_ratio * dim)
            self.dense_1 = linear(mlp_ratio * dim, dim)

    def _dense(self, layer: nn.Module, x, pair: bool = False):
        """``layer`` in the compute dtype (a no-op cast when the parameters
        are already in it); an ``Int8Linear`` computes its own way.  A split
        layer runs its generic path, or with ``pair`` its half of a Megatron
        pair (``x`` already past ``copy_to_model`` for a column, this rank's
        slice for a row)."""
        if isinstance(layer, Int8Linear):
            return layer(x, entered=pair, local=pair)
        return tp_linear(x, layer, self.dtype, entered=pair, local=pair)

    def _dropout(self, x, train: bool):
        """flax's ``nn.Dropout``: active only when ``train``."""
        if not train or self.dropout <= 0.0:
            return x
        return dropout(x, self.dropout, self.generator)

    def forward(self, x, cache: dict | None = None, max_len: int = 0,
                ragged: bool = False, train: bool = False,
                attn: Callable | None = None, offset: int = 0):
        """``attn`` overrides the block's attention callable for this call
        and ``offset`` is the first position of ``x`` in its sequence
        (RoPE's offset): the sequence-parallel forward's slice."""
        b, s, _ = x.shape
        hd = self.head_dim
        heads, heads_kv = self.tp_heads, self.tp_heads_kv  # this rank's
        h = self.norm_attn(x)
        pair = self.tp_attn_pair
        if pair:  # the column half's entry: its backward sums the partials
            h = copy_to_model(h, self.tp_mesh)
        if self.heads_kv == self.heads:
            qkv = self._dense(self.qkv, h, pair).view(b, s, 3, heads, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self._dense(self.q_proj, h, pair).view(b, s, heads, hd)
            kv = self._dense(self.kv_proj, h, pair).view(b, s, 2, heads_kv, hd)
            k, v = kv[:, :, 0], kv[:, :, 1]
        kv_out = None
        if cache is not None and "block_table" in cache:
            o = self._paged_decode_attention(q, k, v, cache, max_len)
        elif cache is not None:
            if self.page_size:
                raise ValueError(
                    f"this block decodes paged (page_size={self.page_size}) "
                    "but was given a dense cache")
            o = self._decode_attention(q, k, v, cache, max_len, ragged)
        else:
            if self.rope:
                q, k = apply_rope(q, offset=offset), apply_rope(k, offset=offset)
            kv_out = (k, v)
            o = (attn or self.attn_fn)(q, k, v)
        x = x + self._dropout(self._dense(self.proj, o.reshape(b, s, heads * hd), pair),
                              train)
        h = self.norm_mlp(x)
        moe = None
        if self.moe is not None:
            # routed per call over this call's B * S tokens (a decode step's
            # B tokens too), capacity sized for them, as JAX's block does;
            # a sequence-parallel call's slices are routed as whole sequences
            h, aux, stats = self.moe(h, seq_group=self._seq_group(attn, cache))
            moe = {"aux": aux, "dropped": stats["dropped"],
                   "z": self.moe.z_weight * stats["z"] if self.moe.z_weight > 0.0 else None}
        else:
            pair = self.tp_mlp_pair
            if pair:
                h = copy_to_model(h, self.tp_mesh)
            h = self._dense(self.dense_1, F.gelu(self._dense(self.dense_0, h, pair),
                                                 approximate="tanh"), pair)
        return x + self._dropout(h, train), kv_out, moe

    def _seq_group(self, attn: Callable | None, cache: dict | None):
        """The seq group whose slices of each sequence this call's tokens
        are (a sequence-parallel forward or a context-parallel prefill:
        the call's attention is a ``SeqParallelAttention`` over more than
        one rank), else None."""
        island = attn or self.attn_fn
        if cache is not None or not isinstance(island, SeqParallelAttention):
            return None
        return island.mesh.seq_group if island.mesh.seq_size > 1 else None

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
        self._check_cache_layout("k_scale" in cache)
        b, s = q.shape[:2]
        dev = q.device
        idx = cache["index"]
        # the cache leaves in the order K/V are written and read: k, v and,
        # for an int8 cache, their scales
        names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else ("k", "v")
        steps = torch.arange(s, device=dev)
        if ragged:
            if self.rope:
                q = apply_rope(q, offset=idx)
                k = apply_rope(k, offset=idx)
            rows = torch.arange(b, device=dev)[:, None]
            pos = (idx[:, None] + steps).clamp(max=max_len - 1)  # (B, S)
            for name, x in zip(names, self._cache_values(k, v)):
                cache[name][rows, pos] = x.to(cache[name].dtype)
            q_pos = idx[:, None] + steps  # (B, S) absolute positions
        else:
            idx0 = idx[0]  # one cursor for every row
            if self.rope:
                q = apply_rope(q, offset=idx0)
                k = apply_rope(k, offset=idx0)
            pos = idx0.clamp(max=max_len - s) + steps  # the clamped slice write
            for name, x in zip(names, self._cache_values(k, v)):
                cache[name][:, pos] = x.to(cache[name].dtype)
            q_pos = (idx0 + steps)[None]  # (1, S)
        if self.window:
            start = (idx - self.window + 1).clamp(min=0)  # span start, pre-write cursor
        idx.copy_((idx + s).clamp(max=max_len))

        k_pos = torch.arange(max_len, device=dev)[None]  # (1, max_len)
        span_of = [cache[name] for name in names]
        if self.window and (self.window + s - 1) < max_len:
            # gather only the live span: queries [cursor, cursor+s) attend
            # at most positions (cursor+s-1-W, cursor+s)
            span = torch.arange(self.window + s - 1, device=dev)
            if ragged:
                k_pos = start[:, None] + span  # (B, span)
                g = k_pos.clamp(max=max_len - 1)
                rows = torch.arange(b, device=dev)[:, None]
                span_of = [x[rows, g] for x in span_of]
            else:
                k_pos = (start[0] + span)[None]  # (1, span)
                g = k_pos[0].clamp(max=max_len - 1)
                span_of = [x[:, g] for x in span_of]
        mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B|1, S, L)
        if self.window:
            mask &= k_pos[:, None, :] > q_pos[:, :, None] - self.window
        return _attend_cached(q, *span_of[:2], mask, self.dtype, *span_of[2:])

    def _cache_values(self, k, v) -> tuple:
        """What the cache stores for this call's K/V: ``(k, v)``, or for an
        int8 cache ``(k_q, v_q, k_scale, v_scale)``."""
        if self.kv_cache_dtype != "int8":
            return k, v
        (kq, ks), (vq, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
        return kq, vq, ks, vs

    def _paged_decode_attention(self, q, k, v, cache: dict, max_len: int):
        """Decode attention over the PAGED cache (serving/kv_pool.py): K/V
        live in a pooled ``(n_pages, page_size, H_kv, D)`` slab per layer
        and each row's ``(max_len / page_size,)`` block-table row maps its
        virtual positions to pool pages, so read-only pages can be shared
        between rows (the radix prefix cache).

        Writes scatter each new position to ``(block_table[pos // ps],
        pos % ps)``, clamped at max_len - 1 like the dense path; reads
        gather ``pool[block_table]`` back to (B, max_len, H_kv, D) and run
        the dense tail (same mask, same reduction shapes), which keeps
        paged output token-identical to dense.  Per-row cursors always
        (the ``ragged`` case).  Unallocated table entries point at the
        trash page 0, whose garbage no live row's mask exposes.  An int8
        pool's ``pages_k_scale``/``pages_v_scale`` are written and gathered
        beside it.  Under context parallelism (``cp_mesh``) the pool holds
        this cp row's pages only: a write lands on the rank that holds its
        page, each rank attends over the positions it holds, and the
        partials merge across the cp group (:func:`merge_cp_partials`), so
        no rank reads another rank's pages."""
        if max_len <= 0:
            raise ValueError("decode needs max_len > 0 (the KV-cache size)")
        bt, idx = cache["block_table"], cache["index"]
        ps = cache["pages_k"].shape[1]
        if max_len % ps:
            raise ValueError(
                f"paged decode needs max_len ({max_len}) to be a multiple of "
                f"page_size ({ps})")
        if self.window:
            raise ValueError(
                "paged decode does not compose with sliding-window attention "
                "(window > 0) — the windowed span gather assumes a dense "
                "contiguous cache row")
        self._check_cache_layout("pages_k_scale" in cache)
        names = (("pages_k", "pages_v", "pages_k_scale", "pages_v_scale")
                 if "pages_k_scale" in cache else ("pages_k", "pages_v"))
        b, s = q.shape[:2]
        steps = torch.arange(s, device=q.device)
        if self.rope:
            q = apply_rope(q, offset=idx)
            k = apply_rope(k, offset=idx)
        pos = (idx[:, None] + steps).clamp(max=max_len - 1)  # (B, S) writes
        page = bt.gather(1, (pos // ps).long()).long()
        off = (pos % ps).long()
        rows = bt.long()
        cp = self.cp_mesh if self.cp_mesh is not None and self.cp_mesh.seq_size > 1 else None
        if cp is not None:
            # this cp row holds pages [lo, lo + n_local): writes to them land
            # here, reads of the others are masked out of this rank's partial
            n_local = cache["pages_k"].shape[0]
            lo = cp.seq_index * n_local
            for name, x in zip(names, self._cache_values(k, v)):
                write_held(cache[name], page, off, x, lo)
            held = ((rows >= lo) & (rows < lo + n_local)).repeat_interleave(ps, dim=1)
            rows = (rows - lo).clamp(0, n_local - 1)
        else:
            for name, x in zip(names, self._cache_values(k, v)):
                cache[name][page, off] = x.to(cache[name].dtype)
        q_pos = idx[:, None] + steps  # unclamped, as the dense path's
        idx.copy_((idx + s).clamp(max=max_len))
        # gather each row's virtual span: (n_pages, ps, ...)[bt] -> (B, max_len, ...)
        span_of = [cache[name][rows].reshape(b, max_len, *cache[name].shape[2:])
                   for name in names]
        k_pos = torch.arange(max_len, device=q.device)[None]
        mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (B, S, max_len)
        if cp is None:
            return _attend_cached(q, *span_of[:2], mask, self.dtype, *span_of[2:])
        out, lse = _attend_cached(q, *span_of[:2], mask & held[:, None, :], self.dtype,
                                  *span_of[2:], with_lse=True)
        return merge_cp_partials(out, lse, cp.seq_group).to(self.dtype)

    def _check_cache_layout(self, int8_cache: bool) -> None:
        if int8_cache != (self.kv_cache_dtype == "int8"):
            raise ValueError(
                f"this block caches K/V as {self.kv_cache_dtype!r} but was given "
                f"{'an int8' if int8_cache else 'a native'} cache")


def _block_out(block: TransformerBlock, x: torch.Tensor, train: bool,
               attn: Callable | None = None, offset: int = 0):
    """A block's output and its MoE terms, without its K/V: the remat
    region of a block (the MoE terms leave it as outputs, so the loss
    takes them from the forward and the recompute only rebuilds)."""
    out, _, moe = block(x, train=train, attn=attn, offset=offset)
    return out, moe


def attention_heads(model) -> tuple[int, int]:
    """The (heads, heads_kv) a model's blocks hand their attention on this
    rank: H/tp of each on the head-aligned tensor-parallel path, all of
    them otherwise."""
    held = model_blocks(model)
    block = held[0] if held else None
    if block is None:
        return model.heads, model.heads_kv
    return block.tp_heads, block.tp_heads_kv


def seq_shard(attn_fn, s: int, heads: int, heads_kv: int):
    """The sequence-parallel layout of a length-``s`` forward through
    ``attn_fn``: ``(span, attn)`` with ``span`` this rank's token slice
    ``(lo, hi)`` (None: the whole sequence) and ``attn`` the blocks'
    callable for the call (None: their own).  Not sequence parallel: the
    whole sequence, the blocks' own; sharded: the slice, the callable;
    indivisible: the whole sequence through the callable's ``dense``."""
    if not isinstance(attn_fn, SeqParallelAttention):
        return None, None
    span = attn_fn.local_span(s, heads, heads_kv)
    return span, (None if span is not None else attn_fn.dense)


def model_blocks(model) -> list:
    """The transformer blocks a model holds, in order: its ``blocks``, or
    the blocks of the pipeline stages it holds."""
    stacked = getattr(model, "pipe_blocks", None)
    return list(model.blocks) if stacked is None else stacked.held_blocks()


class StackedBlocks(nn.Module):
    """The block stack of a pipelined model: ``n_stages`` stages of
    ``per_stage`` blocks each, ``stages.{s}.{i}`` (JAX's ``StackedBlocks``,
    whose one ``stacked`` tree holds the same leaves with ``(n_stages,
    per_stage, ...)`` dims).  ``forward(x)`` with no ``pipeline_fn`` runs
    every block in order (the plain stack: the unstacked model's values);
    with one, ``pipeline_fn(stage_fn, params, x)`` (the Trainer's,
    ``parallel/pipeline.py``) runs the schedule, ``stage_fn(params, h)``
    being this rank's stage and ``params`` its parameters.  After
    :meth:`keep_stage` the module holds one stage's blocks.  No dropout, no
    MoE (JAX's equal-program contract)."""

    def __init__(self, dim: int, heads: int, n_stages: int, per_stage: int,
                 heads_kv: int = 0, mlp_ratio: int = 4, attn_fn: Callable | None = None,
                 attn: str = "vanilla", pipeline_fn: Callable | None = None,
                 block_remat: bool = False, rope: bool = False, window: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_stages, self.per_stage = n_stages, per_stage
        self.pipeline_fn, self.block_remat, self.generator = pipeline_fn, block_remat, generator
        self.stage: int | None = None  # the one stage held (None: every stage)
        self.stages = nn.ModuleList(
            nn.ModuleList(
                TransformerBlock(dim=dim, heads=heads, heads_kv=heads_kv,
                                 mlp_ratio=mlp_ratio, attn_fn=attn_fn, attn=attn, rope=rope,
                                 window=window, dtype=dtype, param_dtype=param_dtype,
                                 device=device, generator=generator)
                for _ in range(per_stage))
            for _ in range(n_stages))

    def keep_stage(self, stage: int) -> None:
        """Drop every stage's blocks but ``stage``'s (its names stay
        ``stages.{stage}.{i}``)."""
        if not 0 <= stage < self.n_stages:
            raise ValueError(f"stage {stage} out of {self.n_stages}")
        for s in range(self.n_stages):
            if s != stage:
                self.stages[s] = nn.ModuleList()
        self.stage = stage

    def held_blocks(self) -> list:
        """The blocks this module holds, in schedule order."""
        return [b for stage in self.stages for b in stage]

    def _run(self, blocks, h: torch.Tensor) -> torch.Tensor:
        return run_blocks(blocks, h, False, self.block_remat, self.generator)[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pipeline_fn is None:
            if self.stage is not None:
                raise ValueError("this stack holds one pipeline stage: it runs under a "
                                 "pipeline_fn (parallel/pipeline.py)")
            return self._run(self.held_blocks(), x)
        if self.stage is None:
            raise ValueError("a pipelined stack runs one stage a rank: keep_stage() first")
        blocks = self.stages[self.stage]
        return self.pipeline_fn(lambda params, h: self._run(blocks, h),
                                list(blocks.parameters()), x)


def run_blocks(blocks, x: torch.Tensor, train: bool, remat_blocks: bool,
               generator: torch.Generator | None, attn: Callable | None = None,
               offset: int = 0):
    """The training/eval forward through ``blocks``: ``(x, moe)`` with
    ``moe`` None for a dense stack, else ``{"aux": sum of the blocks'
    load-balancing losses, "z": sum of their pre-weighted z-losses (0
    when none is weighted), "dropped": mean dropped fraction over the MoE
    blocks}`` (JAX's ``losses`` / ``zlosses`` / ``moe_stats``
    collections as the loss function reduces them).  ``remat_blocks``
    recomputes each block in the backward, its dropout masks replayed
    from ``generator``.  ``attn`` / ``offset``: the sequence-parallel
    call's (:func:`seq_shard`; ``TransformerBlock.forward``)."""
    terms = []
    for block in blocks:
        if remat_blocks:
            x, moe = remat(_block_out, block, x, train, attn, offset,
                           generators=[generator])
        else:
            x, moe = _block_out(block, x, train, attn, offset)
        if moe is not None:
            terms.append(moe)
    if not terms:
        return x, None
    zs = [t["z"] for t in terms if t["z"] is not None]
    return x, {"aux": torch.stack([t["aux"] for t in terms]).sum(),
               "z": torch.stack(zs).sum() if zs else x.new_zeros((), dtype=torch.float32),
               "dropped": torch.stack([t["dropped"] for t in terms]).mean()}


class VisionTransformer(nn.Module):
    """Patch ViT over (B, H, W, C) NHWC images in [0, 1]: a stride-p VALID
    conv (with bias) patchifies into (B, S, dim) tokens, plus ``pos_embed``
    (1, S, dim); ``depth`` pre-norm blocks without RoPE (``block_{i}`` in
    flax, ``blocks.{i}`` here); ``norm_out``, the mean over tokens, and the
    ``logits`` head, float32.  The counterpart of the JAX package's
    ``VisionTransformer``.

    flax reads the image size from the first input; here ``image_size``
    (H, W) and ``in_channels`` fix it at construction, and an image of
    another size is refused.  Parameters are float32 (compute in ``dtype``);
    initialisation from ``generator`` as flax's: LeCun truncated-normal
    kernels, zero biases, LayerNorm (1, 0), ``pos_embed`` normal(0.02).
    ``block_remat=True`` recomputes each block's activations in the
    backward (``models/remat.py``; flax's ``nn.remat`` of the block).
    ``moe_every=k`` makes every k-th block a MoE block (JAX's ``(i + 1) %
    k == 0``) with the ``n_experts``/``moe_*`` knobs; ``dropout`` draws
    its masks from ``self.generator`` (the init generator), as LeNet-5's.
    ``moe_fn`` runs the MoE blocks through an expert-parallel island.
    ``pp_stages > 0`` stacks the blocks as ``pipe_blocks``
    (:class:`StackedBlocks`, run by ``pipeline_fn`` when given; ``blocks``
    is then empty), initialised as the plain stack would be; dropout or MoE
    with ``pp_stages`` is JAX's ``ValueError``."""

    def __init__(self, patch_size: int = 4, dim: int = 128, depth: int = 4,
                 heads: int = 4, heads_kv: int = 0, mlp_ratio: int = 4,
                 num_classes: int = 10, dropout: float = 0.0,
                 attn_fn: Callable | None = None, attn: str = "vanilla",
                 moe_every: int = 0, n_experts: int = 8,
                 moe_capacity_factor: float = 2.0, moe_top_k: int = 1,
                 moe_z_weight: float = 0.0, moe_fn: Callable | None = None,
                 pp_stages: int = 0, pipeline_fn: Callable | None = None,
                 block_remat: bool = False, image_size: tuple[int, int] = (28, 28),
                 in_channels: int = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        check_moe_knobs(pp_stages, depth, dropout, moe_every)
        self.block_remat = block_remat
        p = patch_size
        h, w = image_size
        self._check_image(h, w, p)
        device = resolve_device(device)
        self.patch_size, self.image_size, self.dim = p, (h, w), dim
        self.seq_len = (h // p) * (w // p)
        self.heads, self.heads_kv = heads, heads_kv or heads
        self.attn_fn = attn_fn
        self.dtype = dtype
        meta = torch.device("meta")  # shapes first; values from `generator`
        self.patch_embed = nn.Conv2d(in_channels, dim, p, p, device=meta)
        self.pos_embed = nn.Parameter(torch.empty(1, self.seq_len, dim, device=meta))
        gen = _resolve_generator(generator, device)
        self.generator = gen  # the dropout masks' source
        self.blocks = nn.ModuleList(
            TransformerBlock(dim=dim, heads=heads, heads_kv=heads_kv,
                             mlp_ratio=mlp_ratio, dropout=dropout, attn_fn=attn_fn,
                             attn=attn, use_moe=is_moe_block(i, moe_every),
                             n_experts=n_experts, moe_capacity_factor=moe_capacity_factor,
                             moe_top_k=moe_top_k, moe_z_weight=moe_z_weight,
                             moe_fn=moe_fn, dtype=dtype, param_dtype=torch.float32,
                             device=meta,
                             generator=gen)
            for i in range(0 if pp_stages > 0 else depth))
        if pp_stages > 0:  # the stage-stacked form of the same blocks
            self.pipe_blocks = StackedBlocks(
                dim=dim, heads=heads, n_stages=pp_stages, per_stage=depth // pp_stages,
                heads_kv=heads_kv, mlp_ratio=mlp_ratio, attn_fn=attn_fn, attn=attn,
                pipeline_fn=pipeline_fn, block_remat=block_remat, dtype=dtype,
                param_dtype=torch.float32, device=meta, generator=gen)
        self.norm_out = LayerNorm(dim, dtype, device=meta)
        self.logits = nn.Linear(dim, num_classes, device=meta)
        self.to_empty(device=device)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    init_lecun_(m, gen)
                elif isinstance(m, MoEBlock):
                    m.reset_parameters(gen)
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=gen,
                                             device=gen.device) * 0.02)

    @staticmethod
    def _check_image(h: int, w: int, p: int) -> None:
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch size {p}")

    @property
    def has_moe(self) -> bool:
        return any(block.moe is not None for block in self.blocks)

    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, S, p * p * C) raw patches in token (row, col)
        order, each flattened (p, p, C) as the conv kernel's (O, p, p, C)."""
        b, h, w, c = x.shape
        p = self.patch_size
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, self.seq_len, p * p * c)

    def seq_span(self, s: int) -> tuple[int, int] | None:
        """This rank's token slice of a length-``s`` sequence under
        sequence parallelism (None: the whole sequence)."""
        return seq_shard(self.attn_fn, s, *attention_heads(self))[0]

    def forward(self, x: torch.Tensor, train: bool = False, with_moe: bool = False):
        """(B, H, W, C) NHWC images in [0, 1] -> (B, num_classes) float32
        logits; ``with_moe=True`` returns ``(logits, moe)``, the MoE terms
        of :func:`run_blocks` (None for a dense model).  ``train`` turns
        dropout on."""
        b, h, w, _ = x.shape
        self._check_image(h, w, self.patch_size)
        if (h, w) != self.image_size:
            raise ValueError(f"this ViT was built for {self.image_size[0]}x"
                             f"{self.image_size[1]} images, got {h}x{w}")
        dt = self.dtype
        pe = self.patch_embed
        span, attn = seq_shard(self.attn_fn, self.seq_len, *attention_heads(self))
        # the stride-p conv as a product over flattened patches: this rank's
        # token slice only under sequence parallelism, every token otherwise;
        # split on its output channels, this rank's channels, gathered
        lo, hi = (0, self.seq_len) if span is None else span
        w_pe = pe.weight.to(dt).permute(0, 2, 3, 1).reshape(pe.weight.shape[0], -1)
        patches = self._patches(x.to(dt))[:, lo:hi]
        mesh = layer_mesh(pe)
        if mesh is None:
            x = F.linear(patches, w_pe, pe.bias.to(dt))
        else:
            x = column(patches, lambda t: F.linear(t, w_pe), mesh, pe.bias.to(dt))
        x = x + self.pos_embed[:, lo:hi].to(dt)
        if hasattr(self, "pipe_blocks"):
            x, moe = self.pipe_blocks(x), None
        else:
            x, moe = run_blocks(self.blocks, x, train, self.block_remat, self.generator,
                                attn=attn, offset=lo)
        acc = torch.promote_types(dt, torch.float32)
        if span is None:
            x = self.norm_out(x).mean(1, dtype=acc)
        else:  # the mean over every rank's tokens: a sum across the seq group
            x = all_reduce_sum(self.norm_out(x).sum(1, dtype=acc),
                               group=self.attn_fn.mesh.seq_group) / self.seq_len
        x = x.to(dt)  # a float32 mean, as jnp.mean of bf16 takes it
        logits = tp_linear(x, self.logits, dt).float()
        return (logits, moe) if with_moe else logits
