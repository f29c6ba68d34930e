"""Carry the JAX package's causal-LM parameters into the port.

:func:`causal_lm_state_dict` turns a flax ``params`` tree whose leaves the
caller has already made numpy (``jax.tree.map(np.asarray, params)``) into a
``state_dict`` for :class:`~.models.causal_lm.CausalLM`; this module never
sees JAX.  :func:`load_causal_lm` builds the port's model and loads it.

The mapping, per leaf:

* ``Dense`` kernels are stored (in, out) by flax and (out, in) by
  ``nn.Linear``: transposed.  The output columns keep their order, which
  the port's blocks reshape exactly as flax does (``qkv`` as
  [3][heads][head_dim], ``kv_proj`` as [2][heads_kv][head_dim]).
* ``LayerNorm`` ``scale``/``bias`` -> ``weight``/``bias``.
* ``Embed`` ``embedding`` -> ``embed.weight``; a tied head reads it too.

The conversion is strict: every leaf of the tree is consumed, no expected
leaf may be missing, and every shape must match the configuration; any
breach raises ``ValueError`` naming the leaf's path.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM


def _full_cfg(cfg: Mapping) -> dict:
    """``cfg`` with CausalLM's defaults filled in."""
    full = {k: p.default for k, p in inspect.signature(CausalLM).parameters.items()}
    full.update(cfg)
    return full


def _expected_leaves(cfg: Mapping) -> dict[tuple[str, ...], tuple[str, tuple, bool]]:
    """flax leaf path -> (state_dict key, flax shape, transpose?)."""
    c = _full_cfg(cfg)
    vocab, dim, heads = c["num_classes"], c["dim"], c["heads"]
    hkv = c["heads_kv"] or heads
    hd = dim // heads
    out: dict[tuple[str, ...], tuple[str, tuple, bool]] = {
        ("embed", "embedding"): ("embed.weight", (vocab, dim), False)}

    def dense(path, key, fan_in, fan_out):
        out[path + ("kernel",)] = (f"{key}.weight", (fan_in, fan_out), True)
        out[path + ("bias",)] = (f"{key}.bias", (fan_out,), False)

    def norm(path, key):
        out[path + ("scale",)] = (f"{key}.weight", (dim,), False)
        out[path + ("bias",)] = (f"{key}.bias", (dim,), False)

    for i in range(c["depth"]):
        p, k = (f"block_{i}",), f"blocks.{i}"
        norm(p + ("norm_attn",), f"{k}.norm_attn")
        if hkv == heads:
            dense(p + ("qkv",), f"{k}.qkv", dim, 3 * dim)
        else:
            dense(p + ("q_proj",), f"{k}.q_proj", dim, dim)
            dense(p + ("kv_proj",), f"{k}.kv_proj", dim, 2 * hkv * hd)
        dense(p + ("proj",), f"{k}.proj", dim, dim)
        norm(p + ("norm_mlp",), f"{k}.norm_mlp")
        dense(p + ("dense_0",), f"{k}.dense_0", dim, c["mlp_ratio"] * dim)
        dense(p + ("dense_1",), f"{k}.dense_1", c["mlp_ratio"] * dim, dim)
    norm(("norm_out",), "norm_out")
    if not c["tie_embeddings"]:
        dense(("logits",), "logits", dim, vocab)
    return out


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path)
        else:
            yield path, sub


def causal_lm_state_dict(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax CausalLM ``params`` (numpy leaves) -> the port's ``state_dict``
    (float32 tensors on the CPU).  ``cfg`` holds the model's constructor
    keywords (``num_classes``, ``dim``, ``depth``, ``heads``,
    ``heads_kv``, ``mlp_ratio``, ``tie_embeddings``; defaults as
    CausalLM's)."""
    expected = _expected_leaves(cfg)
    state: dict[str, torch.Tensor] = {}
    seen = set()
    for path, leaf in _leaves(params):
        name = "/".join(path)
        if path not in expected:
            raise ValueError(f"unexpected leaf {name!r} for this configuration")
        key, shape, transpose = expected[path]
        arr = np.asarray(leaf, np.float32)
        if arr.shape != shape:
            raise ValueError(
                f"leaf {name!r} has shape {arr.shape}, expected {shape}")
        t = torch.from_numpy(arr.copy())
        state[key] = t.T.contiguous() if transpose else t
        seen.add(path)
    missing = ["/".join(p) for p in expected if p not in seen]
    if missing:
        raise ValueError(f"missing leaves: {missing}")
    return state


def load_causal_lm(params_np: Mapping, device=None, **model_kw) -> CausalLM:
    """The port's CausalLM on ``device`` (the GPU unless ``device="cpu"``)
    holding the JAX parameters ``params_np`` (numpy leaves); ``model_kw``
    are the constructor keywords the JAX model was built with."""
    model = CausalLM(device=device, **model_kw)
    model.load_state_dict(causal_lm_state_dict(params_np, model_kw), strict=True)
    return model.eval()
