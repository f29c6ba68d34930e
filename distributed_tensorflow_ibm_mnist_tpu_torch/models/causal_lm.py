"""Decoder-only causal language model of the port.

The counterpart of the JAX package's ``models/causal_lm.py``: token
embedding -> pre-norm causal blocks (models/transformer.py) -> LayerNorm ->
per-position vocab head, logits in float32.  Positions are rotary
(``pos="rope"``, the default), absent (``pos="none"``) or a learned
``(1, seq_len, dim)`` table (``pos="learned"``: normal(0.02), added in
``dtype``; flax sizes it from the first input, the port from ``seq_len``
at construction, and another length is refused); the head is its own
``logits`` projection or, with ``tie_embeddings``, ``x @ embed^T``.
``moe_every=k`` makes every k-th block a MoE block (parallel/
expert_parallel.py; ``moe_fn`` runs them expert-parallel), ``dropout``
drops in every block when ``train``.

Calls:

* ``model(tokens)`` — (B, S) int tokens -> (B, S, V) float32 logits;
  ``model(tokens, train=True)`` turns dropout on; ``with_moe=True`` also
  returns the MoE terms (``transformer.run_blocks``: aux, z, dropped; None
  for a dense model), which the loss adds; differentiable through either
  attention;
* ``model(tokens, sow_kv=True)`` — also returns ``{"block_i": (k, v)}``,
  each block's post-RoPE K/V from the normal forward (the port's form of
  flax's ``sow_kv``: the flash prefill builds the decode cache from it);
* ``model(tokens, cache=cache, max_len=L, ragged=...)`` — decode against
  the dense cache (core/generate.py ``init_cache``) or the paged one
  (serving/kv_pool.py ``init_paged_cache``), updated in place.

``attn_fn`` (the Trainer's sequence-parallel island, JAX's
``attn_fn``: ``parallel.ring_attention.make_ring_attention`` or
``parallel.sequence_parallel.make_ulysses_attention``, bringing its own
causal flag) replaces the model's own attention in the normal forward.
The model then keeps only this rank's slice of the tokens
(``transformer.seq_shard``): RoPE's positions start at the slice's first
position, the learned table is sliced, and the logits are (B, S_local, V),
this rank's positions only (``seq_span(S)`` names them); a sequence that
does not divide the seq axis runs whole through the island's ``dense``.

Under tensor parallelism (``parallel.tensor_parallel.TPPlan``) the
embedding is split on its features (looked up a block a rank, then
gathered), the head is a row split over ``dim`` (the tied head too), and
the blocks run Megatron's pairs (models/transformer.py).

``pp_stages > 0`` stacks the blocks for pipeline parallelism
(``pipe_blocks``, ``transformer.StackedBlocks``, run by ``pipeline_fn``
when given; initialised as the plain stack would be), as JAX's model
does; it refuses what JAX's refuses beside it: ``quant`` (at
construction here) and decode (the cache paths and the ``sow_kv``
prefill: ``Trainer.generate`` decodes a pp run from its unstacked
weights).

``block_remat=True`` recomputes each block's activations in the backward
(``models/remat.py``), as the JAX model's ``nn.remat`` blocks do; decode,
the ``sow_kv`` prefill and ``torch.no_grad`` run the blocks plainly.

``quant="int8"`` stores every block projection and the untied head as
``Int8Linear`` (models/quant.py); ``kv_cache_dtype="int8"`` decodes
against an int8 cache with per-(position, head) scales.  ``clone(**kw)``
is the same model with some constructor keywords changed and the weights
carried over (quantized on the way to ``quant="int8"``), as flax's
``Module.clone``.

Weights are created on ``device`` (the GPU unless ``device="cpu"``) and
initialised from ``generator`` (a ``torch.Generator``; a fresh one seeded
0 when None), never from the global random state; the same generator, kept
as ``model.generator``, draws the dropout masks.  They are stored in
``param_dtype`` (``dtype`` when None, the serving layout) and cast to
``dtype`` per use: the Trainer builds float32 masters, as flax keeps
them.  The MoE leaves are float32 in every model.  Load the JAX package's
trained parameters with convert.py ``load_causal_lm``.

Decode with ``pos="learned"`` (the cache paths, the ``sow_kv`` prefill,
core/generate.py's ``make_*`` functions, the engine, ``Trainer.generate``) raises
JAX's ``ValueError`` (:data:`LEARNED_POS_DECODE`).
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    Int8Linear,
    quantize_kernel_int8,
    quantize_state_dict_int8,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import _resolve_generator
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    LayerNorm,
    StackedBlocks,
    TransformerBlock,
    _resolve_attn,
    attention_heads,
    check_moe_knobs,
    check_quant_knobs,
    is_moe_block,
    run_blocks,
    seq_shard,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device

# JAX's refusal of decode for a learned position table, word for word
LEARNED_POS_DECODE = (
    "decode mode needs position-free params: pos='learned' bakes "
    "the trained length into a (1, S, dim) table that cannot "
    "address incremental positions — use pos='rope' (the default)")
# JAX's refusals beside pipeline stages, word for word
PP_QUANT = (
    "quant composes with the plain block stack only: pp_stages "
    "stacks params (n_stages, per_stage, ...) for the training "
    "pipeline, which the int8 kernel/scale layout does not "
    "cover — decode already unstacks pp weights (core/trainer."
    "_decode_param_tree), so quantize the unstacked tree")
PP_DECODE = (
    "decode mode runs the plain block stack, not stage-stacked "
    "params — Trainer.generate unstacks pp-trained weights into "
    "this layout for you (core/trainer._decode_param_tree)")


def check_decodable(model) -> None:
    """Raise JAX's ``ValueError`` for a model whose positions cannot
    decode incrementally (``pos="learned"``)."""
    if getattr(model, "pos", "rope") == "learned":
        raise ValueError(LEARNED_POS_DECODE)


class CausalLM(nn.Module):
    """Embed -> pre-norm causal blocks -> per-position vocab head."""

    def __init__(self, num_classes: int = 64, dim: int = 128, depth: int = 2,
                 heads: int = 4, heads_kv: int = 0, window: int = 0,
                 mlp_ratio: int = 4, dropout: float = 0.0, attn_fn=None,
                 attn: str = "vanilla",
                 causal: bool = True, pos: str = "rope", seq_len: int = 0,
                 tie_embeddings: bool = False, moe_every: int = 0, n_experts: int = 8,
                 moe_capacity_factor: float = 2.0, moe_top_k: int = 1,
                 moe_z_weight: float = 0.0, moe_fn=None,
                 kv_cache_dtype: str = "native", page_size: int = 0,
                 quant: str = "none", pp_stages: int = 0, pipeline_fn=None,
                 block_remat: bool = False, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if pos not in ("rope", "learned", "none"):
            raise ValueError(
                f"unknown pos {pos!r}; use 'rope', 'learned' or 'none'")
        if pos == "learned" and seq_len < 1:
            raise ValueError(
                "pos='learned' needs seq_len: the (1, S, dim) table is sized at "
                "construction (flax sizes it from the first input)")
        check_moe_knobs(pp_stages, depth, dropout, moe_every)
        check_quant_knobs(quant, kv_cache_dtype)
        if quant != "none" and pp_stages > 0:
            raise ValueError(PP_QUANT)
        device = resolve_device(device)
        self._config = dict(
            num_classes=num_classes, dim=dim, depth=depth, heads=heads,
            heads_kv=heads_kv, window=window, mlp_ratio=mlp_ratio, dropout=dropout,
            attn_fn=attn_fn, attn=attn, causal=causal, pos=pos, seq_len=seq_len,
            tie_embeddings=tie_embeddings, moe_every=moe_every, n_experts=n_experts,
            moe_capacity_factor=moe_capacity_factor, moe_top_k=moe_top_k,
            moe_z_weight=moe_z_weight, kv_cache_dtype=kv_cache_dtype,
            page_size=page_size, quant=quant, pp_stages=pp_stages, pipeline_fn=pipeline_fn,
            block_remat=block_remat, dtype=dtype, param_dtype=param_dtype)
        self.block_remat = block_remat
        self.quant, self.kv_cache_dtype = quant, kv_cache_dtype
        self.num_classes, self.dim, self.depth = num_classes, dim, depth
        self.heads, self.heads_kv = heads, heads_kv or heads
        self.head_dim = dim // heads
        self.window, self.causal, self.attn = window, causal, attn
        self.pos, self.seq_len = pos, seq_len
        self.tie_embeddings, self.dtype = tie_embeddings, dtype
        self.page_size = page_size  # > 0: the blocks decode the paged cache only
        self.generator = _resolve_generator(generator, device)  # init, then dropout
        store = param_dtype or dtype  # the projections' and embedding's storage
        if attn_fn is None:  # the model's own kernel; an island brings its own flag
            attn_fn = partial(_resolve_attn(None, attn), causal=causal, window=window)
        self.attn_fn = attn_fn
        meta = torch.device("meta")  # shapes first; values from `generator`
        self.embed = nn.Embedding(num_classes, dim, dtype=store, device=meta)
        self.pos_embed = (nn.Parameter(torch.empty(1, seq_len, dim, dtype=store, device=meta))
                          if pos == "learned" else None)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim=dim, heads=heads, heads_kv=heads_kv,
                             mlp_ratio=mlp_ratio, dropout=dropout,
                             attn_fn=attn_fn, use_moe=is_moe_block(i, moe_every),
                             n_experts=n_experts, moe_capacity_factor=moe_capacity_factor,
                             moe_top_k=moe_top_k, moe_z_weight=moe_z_weight, moe_fn=moe_fn,
                             rope=pos == "rope", window=window,
                             kv_cache_dtype=kv_cache_dtype, page_size=page_size,
                             quant=quant, dtype=dtype, param_dtype=param_dtype,
                             device=meta, generator=self.generator)
            for i in range(0 if pp_stages > 0 else depth))
        self.pp_stages = pp_stages
        if pp_stages > 0:  # the stage-stacked form of the same blocks
            self.pipe_blocks = StackedBlocks(
                dim=dim, heads=heads, n_stages=pp_stages, per_stage=depth // pp_stages,
                heads_kv=heads_kv, mlp_ratio=mlp_ratio, attn_fn=attn_fn,
                pipeline_fn=pipeline_fn, block_remat=block_remat, rope=pos == "rope",
                window=window, dtype=dtype, param_dtype=param_dtype, device=meta,
                generator=self.generator)
        self.norm_out = LayerNorm(dim, dtype, device=meta)
        if tie_embeddings:
            self.logits = None
        elif quant == "int8":
            self.logits = Int8Linear(dim, num_classes, dtype=dtype, device=meta)
        else:
            self.logits = nn.Linear(dim, num_classes, dtype=store, device=meta)
        self.to_empty(device=device)
        self.reset_parameters(self.generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def has_moe(self) -> bool:
        return any(block.moe is not None for block in self.blocks)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Initialise every weight from ``generator``: projections and the
        embedding normal with std fan_in^-1/2, biases 0, norms (1, 0); the
        MoE leaves as flax's ``MoEBlock`` (``MoEBlock.reset_parameters``)
        and ``pos_embed`` normal(0.02), each where it stands in the
        parameter order.  An ``Int8Linear`` takes the draw its
        full-precision twin would (in ``dtype``), quantized, so a quant
        model equals its seed's twin quantized."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        moe_done = set()
        for name, p in self.named_parameters():
            if ".moe." in name:
                path = name.rsplit(".", 1)[0]
                if path not in moe_done:
                    self.get_submodule(path).reset_parameters(generator)
                    moe_done.add(path)
            elif name == "pos_embed":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
            elif name.endswith("bias"):
                p.zero_()
            elif ".norm_" in name or name.startswith("norm_"):
                p.fill_(1.0)
            else:
                std = p.shape[-1] ** -0.5
                w = torch.randn(p.shape, generator=generator,
                                device=generator.device) * std
                if p.dtype == torch.int8:
                    layer = self.get_submodule(name.rsplit(".", 1)[0])
                    q, layer.scale[:] = quantize_kernel_int8(w.to(self.dtype))
                    p.copy_(q)
                else:
                    p.copy_(w)

    def clone(self, **over) -> "CausalLM":
        """This model with the constructor keywords ``over`` changed, on the
        same device, holding these weights: quantized
        (``quantize_state_dict_int8``) when ``over`` asks for
        ``quant="int8"``.  The weights must fit the new configuration."""
        cfg = {**self._config, **over}
        model = CausalLM(**cfg, device=self.device)
        state = self.state_dict()
        if cfg["quant"] == "int8":
            state = quantize_state_dict_int8(state)
        model.load_state_dict(state, strict=True)
        return model.train(self.training)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                cache: dict | None = None, max_len: int = 0, ragged: bool = False,
                sow_kv: bool = False, with_moe: bool = False, attn_fn=None):
        """``attn_fn``, when given, is this call's attention island in place
        of the model's own (a context-parallel engine's ring prefill: the
        K/V and logits it returns are this rank's token slice's)."""
        if cache is not None or sow_kv:
            check_decodable(self)
            if self.pp_stages > 0:
                raise ValueError(PP_DECODE)
        s = tokens.shape[1]
        span = attn = None
        if cache is None and (attn_fn is not None or not sow_kv):
            span, attn = seq_shard(self.attn_fn if attn_fn is None else attn_fn, s,
                                   *attention_heads(self))
            if attn_fn is not None and (span is not None or attn is None):
                attn = attn_fn
        lo, hi = span if span is not None else (0, s)
        x = tp.embedding(tokens[:, lo:hi].long(), self.embed, self.dtype)
        if self.pos_embed is not None:
            if s != self.seq_len:
                raise ValueError(
                    f"this LM's learned positions were built for seq_len="
                    f"{self.seq_len}, got sequences of {s}")
            x = x + self.pos_embed[:, lo:hi].to(self.dtype)
        if cache is None and not sow_kv:
            if self.pp_stages > 0:
                x, moe = self.pipe_blocks(x), None
            else:
                x, moe = run_blocks(self.blocks, x, train, self.block_remat, self.generator,
                                    attn=attn, offset=lo)
            logits = self._head(x)
            return (logits, moe) if with_moe else logits
        kvs = {}
        for i, block in enumerate(self.blocks):
            entry = None if cache is None else cache[f"block_{i}"]
            x, kv, _ = block(x, cache=entry, max_len=max_len, ragged=ragged, train=train,
                             attn=attn, offset=lo)
            if sow_kv:
                kvs[f"block_{i}"] = kv
        logits = self._head(x)
        return (logits, kvs) if sow_kv else logits

    def seq_span(self, s: int) -> tuple[int, int] | None:
        """This rank's positions ``(lo, hi)`` of a length-``s`` forward's
        logits under sequence parallelism (None: all of them)."""
        return seq_shard(self.attn_fn, s, *attention_heads(self))[0]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and vocab head: (B, S, dim) -> float32 logits."""
        x = self.norm_out(x)
        if self.tie_embeddings:
            x = tp.tied_head(x, self.embed, self.dtype)  # logits = x @ embed^T, shared
        elif isinstance(self.logits, Int8Linear):
            x = self.logits(x)
        else:  # the weights cast per use (a no-op when stored in dtype)
            x = tp.linear(x, self.logits, self.dtype)
        return x.float()
