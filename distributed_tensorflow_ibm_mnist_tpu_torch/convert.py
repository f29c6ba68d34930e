"""Carry the JAX package's parameters into the port.

:func:`causal_lm_state_dict`, :func:`lenet5_state_dict` and
:func:`mlp_state_dict` turn a flax ``params`` tree whose leaves the caller
has already made numpy (``jax.tree.map(np.asarray, params)``) into a
``state_dict`` for the port's model; this module never sees JAX.
``load_causal_lm`` / ``load_lenet5`` / ``load_mlp`` build the port's model
and load it.

The mapping, per leaf:

* ``Dense`` kernels are stored (in, out) by flax and (out, in) by
  ``nn.Linear``: transposed.  The output columns keep their order, which
  the port's blocks reshape exactly as flax does (``qkv`` as
  [3][heads][head_dim], ``kv_proj`` as [2][heads_kv][head_dim]).
* ``Conv`` kernels are stored HWIO by flax and OIHW by ``nn.Conv2d``:
  ``permute(3, 2, 0, 1)``.
* LeNet's ``fc1`` reads the pooled activation flattened in flax's (H, W, C)
  order: the port's model flattens in that order too (models/lenet.py), so
  its kernel is only transposed, never row-permuted.
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
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5
from distributed_tensorflow_ibm_mnist_tpu_torch.models.mlp import MLP

_KEEP, _TRANSPOSE, _HWIO = "keep", "transpose", "hwio"  # leaf layout changes


def _full_cfg(cls, cfg: Mapping) -> dict:
    """``cfg`` with ``cls``'s constructor defaults filled in."""
    full = {k: p.default for k, p in inspect.signature(cls).parameters.items()}
    full.update(cfg)
    return full


Expected = dict[tuple[str, ...], tuple[str, tuple, str]]


def _dense(out: Expected, path: tuple[str, ...], key: str, fan_in: int, fan_out: int):
    out[path + ("kernel",)] = (f"{key}.weight", (fan_in, fan_out), _TRANSPOSE)
    out[path + ("bias",)] = (f"{key}.bias", (fan_out,), _KEEP)


def _expected_leaves(cfg: Mapping) -> Expected:
    """CausalLM: flax leaf path -> (state_dict key, flax shape, layout change)."""
    c = _full_cfg(CausalLM, cfg)
    vocab, dim, heads = c["num_classes"], c["dim"], c["heads"]
    hkv = c["heads_kv"] or heads
    hd = dim // heads
    out: Expected = {("embed", "embedding"): ("embed.weight", (vocab, dim), _KEEP)}

    def norm(path, key):
        out[path + ("scale",)] = (f"{key}.weight", (dim,), _KEEP)
        out[path + ("bias",)] = (f"{key}.bias", (dim,), _KEEP)

    for i in range(c["depth"]):
        p, k = (f"block_{i}",), f"blocks.{i}"
        norm(p + ("norm_attn",), f"{k}.norm_attn")
        if hkv == heads:
            _dense(out, p + ("qkv",), f"{k}.qkv", dim, 3 * dim)
        else:
            _dense(out, p + ("q_proj",), f"{k}.q_proj", dim, dim)
            _dense(out, p + ("kv_proj",), f"{k}.kv_proj", dim, 2 * hkv * hd)
        _dense(out, p + ("proj",), f"{k}.proj", dim, dim)
        norm(p + ("norm_mlp",), f"{k}.norm_mlp")
        _dense(out, p + ("dense_0",), f"{k}.dense_0", dim, c["mlp_ratio"] * dim)
        _dense(out, p + ("dense_1",), f"{k}.dense_1", c["mlp_ratio"] * dim, dim)
    norm(("norm_out",), "norm_out")
    if not c["tie_embeddings"]:
        _dense(out, ("logits",), "logits", dim, vocab)
    return out


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path)
        else:
            yield path, sub


def _lenet5_leaves(cfg: Mapping) -> Expected:
    c = _full_cfg(LeNet5, cfg)
    out: Expected = {}
    for name, cin, cout in (("conv1", 1, 32), ("conv2", 32, 64)):
        out[(name, "kernel")] = (f"{name}.weight", (5, 5, cin, cout), _HWIO)
        out[(name, "bias")] = (f"{name}.bias", (cout,), _KEEP)
    _dense(out, ("fc1",), "fc1", 7 * 7 * 64, 1024)
    _dense(out, ("logits",), "logits", 1024, c["num_classes"])
    return out


def _mlp_leaves(cfg: Mapping) -> Expected:
    c = _full_cfg(MLP, cfg)
    widths = (c["in_features"],) + tuple(c["hidden"])
    out: Expected = {}
    for i in range(len(widths) - 1):
        _dense(out, (f"dense_{i}",), f"dense_{i}", widths[i], widths[i + 1])
    _dense(out, ("logits",), "logits", widths[-1], c["num_classes"])
    return out


def _convert(params: Mapping, expected: Expected) -> dict[str, torch.Tensor]:
    """Strict conversion against the ``expected`` leaf table."""
    state: dict[str, torch.Tensor] = {}
    seen = set()
    for path, leaf in _leaves(params):
        name = "/".join(path)
        if path not in expected:
            raise ValueError(f"unexpected leaf {name!r} for this configuration")
        key, shape, layout = expected[path]
        arr = np.asarray(leaf, np.float32)
        if arr.shape != shape:
            raise ValueError(
                f"leaf {name!r} has shape {arr.shape}, expected {shape}")
        t = torch.from_numpy(arr.copy())
        if layout == _TRANSPOSE:
            t = t.T
        elif layout == _HWIO:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        state[key] = t.contiguous()
        seen.add(path)
    missing = ["/".join(p) for p in expected if p not in seen]
    if missing:
        raise ValueError(f"missing leaves: {missing}")
    return state


def causal_lm_state_dict(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax CausalLM ``params`` (numpy leaves) -> the port's ``state_dict``
    (float32 tensors on the CPU).  ``cfg`` holds the model's constructor
    keywords (``num_classes``, ``dim``, ``depth``, ``heads``,
    ``heads_kv``, ``mlp_ratio``, ``tie_embeddings``; defaults as
    CausalLM's)."""
    return _convert(params, _expected_leaves(cfg))


def lenet5_state_dict(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax LeNet5 ``params`` (numpy leaves) -> the port's ``state_dict``;
    ``cfg`` holds ``num_classes`` (default 10)."""
    return _convert(params, _lenet5_leaves(cfg))


def mlp_state_dict(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax MLP ``params`` (numpy leaves) -> the port's ``state_dict``;
    ``cfg`` holds ``hidden``, ``num_classes`` and ``in_features``."""
    return _convert(params, _mlp_leaves(cfg))


def load_causal_lm(params_np: Mapping, device=None, **model_kw) -> CausalLM:
    """The port's CausalLM on ``device`` (the GPU unless ``device="cpu"``)
    holding the JAX parameters ``params_np`` (numpy leaves); ``model_kw``
    are the constructor keywords the JAX model was built with."""
    model = CausalLM(device=device, **model_kw)
    model.load_state_dict(causal_lm_state_dict(params_np, model_kw), strict=True)
    return model.eval()


def load_lenet5(params_np: Mapping, device=None, **model_kw) -> LeNet5:
    """The port's LeNet5 on ``device`` (the GPU unless ``device="cpu"``)
    holding the JAX parameters ``params_np`` (numpy leaves)."""
    model = LeNet5(device=device, **model_kw)
    model.load_state_dict(lenet5_state_dict(params_np, model_kw), strict=True)
    return model.eval()


def load_mlp(params_np: Mapping, device=None, **model_kw) -> MLP:
    """The port's MLP on ``device`` holding the JAX parameters ``params_np``."""
    model = MLP(device=device, **model_kw)
    model.load_state_dict(mlp_state_dict(params_np, model_kw), strict=True)
    return model.eval()
