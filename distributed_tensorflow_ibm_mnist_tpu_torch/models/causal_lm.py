"""Decoder-only causal language model of the port.

The counterpart of the JAX package's ``models/causal_lm.py``: token
embedding -> pre-norm causal blocks (models/transformer.py) -> LayerNorm ->
per-position vocab head, logits in float32.  Positions are rotary
(``pos="rope"``, the default) or absent (``pos="none"``); the head is its
own ``logits`` projection or, with ``tie_embeddings``, ``x @ embed^T``.

Calls:

* ``model(tokens)`` — (B, S) int tokens -> (B, S, V) float32 logits;
* ``model(tokens, sow_kv=True)`` — also returns ``{"block_i": (k, v)}``,
  each block's post-RoPE K/V from the normal forward (the port's form of
  flax's ``sow_kv``: the flash prefill builds the decode cache from it);
* ``model(tokens, cache=cache, max_len=L, ragged=...)`` — decode against
  the dense cache (core/generate.py ``init_cache``), updated in place.

Weights are created on ``device`` (the GPU unless ``device="cpu"``) and
initialised from ``generator`` (a ``torch.Generator``; a fresh one seeded
0 when None), never from the global random state.  Load the JAX package's
trained parameters with convert.py ``load_causal_lm``.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    LayerNorm,
    TransformerBlock,
    _not_in_slice,
    _resolve_attn,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device


class CausalLM(nn.Module):
    """Embed -> pre-norm causal blocks -> per-position vocab head."""

    def __init__(self, num_classes: int = 64, dim: int = 128, depth: int = 2,
                 heads: int = 4, heads_kv: int = 0, window: int = 0,
                 mlp_ratio: int = 4, dropout: float = 0.0, attn: str = "vanilla",
                 causal: bool = True, pos: str = "rope",
                 tie_embeddings: bool = False, moe_every: int = 0,
                 kv_cache_dtype: str = "native", page_size: int = 0,
                 quant: str = "none", dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if pos == "learned":
            raise _not_in_slice("pos='learned'", "the training slice")
        if pos not in ("rope", "none"):
            raise ValueError(f"unknown pos {pos!r}; use 'rope' or 'none'")
        if moe_every:
            raise _not_in_slice("a MoE model", "the MoE serving slice")
        device = resolve_device(device)
        self.num_classes, self.dim, self.depth = num_classes, dim, depth
        self.heads, self.heads_kv = heads, heads_kv or heads
        self.head_dim = dim // heads
        self.window, self.causal, self.attn = window, causal, attn
        self.tie_embeddings, self.dtype = tie_embeddings, dtype
        attn_fn = partial(_resolve_attn(None, attn), causal=causal, window=window)
        meta = torch.device("meta")  # shapes first; values from `generator`
        self.embed = nn.Embedding(num_classes, dim, dtype=dtype, device=meta)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim=dim, heads=heads, heads_kv=heads_kv,
                             mlp_ratio=mlp_ratio, dropout=dropout,
                             attn_fn=attn_fn, rope=pos == "rope", window=window,
                             kv_cache_dtype=kv_cache_dtype, page_size=page_size,
                             quant=quant, dtype=dtype, device=meta)
            for _ in range(depth))
        self.norm_out = LayerNorm(dim, dtype, device=meta)
        self.logits = (None if tie_embeddings
                       else nn.Linear(dim, num_classes, dtype=dtype, device=meta))
        self.to_empty(device=device)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Initialise every weight from ``generator``: projections and the
        embedding normal with std fan_in^-1/2, biases 0, norms (1, 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm_" in name or name.startswith("norm_"):
                p.fill_(1.0)
            else:
                std = p.shape[-1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * std)

    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                max_len: int = 0, ragged: bool = False, sow_kv: bool = False):
        x = self.embed(tokens.long())
        kvs = {}
        for i, block in enumerate(self.blocks):
            entry = None if cache is None else cache[f"block_{i}"]
            x, kv = block(x, cache=entry, max_len=max_len, ragged=ragged)
            if sow_kv:
                kvs[f"block_{i}"] = kv
        x = self.norm_out(x)
        if self.tie_embeddings:
            x = x @ self.embed.weight.T  # logits = x @ embed^T, weights shared
        else:
            x = self.logits(x)
        logits = x.float()
        return (logits, kvs) if sow_kv else logits
