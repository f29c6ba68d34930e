"""Decoder-only causal language model of the port.

The counterpart of the JAX package's ``models/causal_lm.py``: token
embedding -> pre-norm causal blocks (models/transformer.py) -> LayerNorm ->
per-position vocab head, logits in float32.  Positions are rotary
(``pos="rope"``, the default) or absent (``pos="none"``); the head is its
own ``logits`` projection or, with ``tie_embeddings``, ``x @ embed^T``.

Calls:

* ``model(tokens)`` — (B, S) int tokens -> (B, S, V) float32 logits;
  ``model(tokens, train=True)`` is the same forward (the training step
  passes ``train``; with dropout 0 it changes nothing), differentiable
  through either attention;
* ``model(tokens, sow_kv=True)`` — also returns ``{"block_i": (k, v)}``,
  each block's post-RoPE K/V from the normal forward (the port's form of
  flax's ``sow_kv``: the flash prefill builds the decode cache from it);
* ``model(tokens, cache=cache, max_len=L, ragged=...)`` — decode against
  the dense cache (core/generate.py ``init_cache``) or the paged one
  (serving/kv_pool.py ``init_paged_cache``), updated in place.

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
0 when None), never from the global random state.  Load the JAX package's
trained parameters with convert.py ``load_causal_lm``.
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
from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import remat
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    LM_FOLLOW_UPS,
    LayerNorm,
    TransformerBlock,
    _block_out,
    _not_in_slice,
    _resolve_attn,
    check_quant_knobs,
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
                 quant: str = "none", block_remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if pos == "learned":
            raise _not_in_slice("pos='learned'", LM_FOLLOW_UPS)
        if pos not in ("rope", "none"):
            raise ValueError(f"unknown pos {pos!r}; use 'rope' or 'none'")
        if moe_every:
            raise _not_in_slice("a MoE model", LM_FOLLOW_UPS)
        check_quant_knobs(quant, kv_cache_dtype)
        device = resolve_device(device)
        self._config = dict(
            num_classes=num_classes, dim=dim, depth=depth, heads=heads,
            heads_kv=heads_kv, window=window, mlp_ratio=mlp_ratio, dropout=dropout,
            attn=attn, causal=causal, pos=pos, tie_embeddings=tie_embeddings,
            moe_every=moe_every, kv_cache_dtype=kv_cache_dtype, page_size=page_size,
            quant=quant, block_remat=block_remat, dtype=dtype)
        self.block_remat = block_remat
        self.quant, self.kv_cache_dtype = quant, kv_cache_dtype
        self.num_classes, self.dim, self.depth = num_classes, dim, depth
        self.heads, self.heads_kv = heads, heads_kv or heads
        self.head_dim = dim // heads
        self.window, self.causal, self.attn = window, causal, attn
        self.tie_embeddings, self.dtype = tie_embeddings, dtype
        self.page_size = page_size  # > 0: the blocks decode the paged cache only
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
        if tie_embeddings:
            self.logits = None
        elif quant == "int8":
            self.logits = Int8Linear(dim, num_classes, dtype=dtype, device=meta)
        else:
            self.logits = nn.Linear(dim, num_classes, dtype=dtype, device=meta)
        self.to_empty(device=device)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Initialise every weight from ``generator``: projections and the
        embedding normal with std fan_in^-1/2, biases 0, norms (1, 0).  An
        ``Int8Linear`` takes the draw its full-precision twin would (in
        ``dtype``), quantized, so a quant model equals its seed's twin
        quantized."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
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
                sow_kv: bool = False):
        x = self.embed(tokens.long())
        kvs = {}
        if self.block_remat and cache is None and not sow_kv:
            for block in self.blocks:
                x = remat(_block_out, block, x)
            return self._head(x)
        for i, block in enumerate(self.blocks):
            entry = None if cache is None else cache[f"block_{i}"]
            x, kv = block(x, cache=entry, max_len=max_len, ragged=ragged)
            if sow_kv:
                kvs[f"block_{i}"] = kv
        logits = self._head(x)
        return (logits, kvs) if sow_kv else logits

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and vocab head: (B, S, dim) -> float32 logits."""
        x = self.norm_out(x)
        if self.tie_embeddings:
            x = x @ self.embed.weight.T  # logits = x @ embed^T, weights shared
        else:
            x = self.logits(x)
        return x.float()
