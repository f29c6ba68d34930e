"""Carry the JAX package's parameters into the port.

:func:`causal_lm_state_dict`, :func:`lenet5_state_dict` and
:func:`mlp_state_dict` turn a flax ``params`` tree whose leaves the caller
has already made numpy (``jax.tree.map(np.asarray, params)``) into a
``state_dict`` for the port's model; this module never sees JAX.
``load_causal_lm`` / ``load_lenet5`` / ``load_mlp`` build the port's model
and load it.  :func:`resnet_state_dict` also takes the flax
``batch_stats`` tree (``load_resnet``), and :func:`vit_state_dict` maps
the ViT (``load_vit``).

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
* ``BatchNorm`` ``scale``/``bias`` -> ``weight``/``bias``, and its
  ``batch_stats`` ``mean``/``var`` -> the ``running_mean``/``running_var``
  buffers.
* The ViT's ``pos_embed`` is kept as it is; its ``block_{i}`` map as the
  causal LM's blocks do.

Leaves come out float32 (float64 leaves stay float64).  The conversion
is strict: every leaf of the tree is consumed, no expected
leaf may be missing, and every shape must match the configuration; any
breach raises ``ValueError`` naming the leaf's path.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5
from distributed_tensorflow_ibm_mnist_tpu_torch.models.mlp import MLP
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ARCHS, BatchNorm, ResNet
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import VisionTransformer

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


def _norm(out: Expected, path: tuple[str, ...], key: str, n: int):
    out[path + ("scale",)] = (f"{key}.weight", (n,), _KEEP)
    out[path + ("bias",)] = (f"{key}.bias", (n,), _KEEP)


def _blocks(out: Expected, c: Mapping) -> None:
    """The pre-norm blocks ``block_{i}`` -> ``blocks.{i}`` (CausalLM, ViT)."""
    dim, heads = c["dim"], c["heads"]
    hkv = c["heads_kv"] or heads
    hd = dim // heads
    for i in range(c["depth"]):
        p, k = (f"block_{i}",), f"blocks.{i}"
        _norm(out, p + ("norm_attn",), f"{k}.norm_attn", dim)
        if hkv == heads:
            _dense(out, p + ("qkv",), f"{k}.qkv", dim, 3 * dim)
        else:
            _dense(out, p + ("q_proj",), f"{k}.q_proj", dim, dim)
            _dense(out, p + ("kv_proj",), f"{k}.kv_proj", dim, 2 * hkv * hd)
        _dense(out, p + ("proj",), f"{k}.proj", dim, dim)
        _norm(out, p + ("norm_mlp",), f"{k}.norm_mlp", dim)
        _dense(out, p + ("dense_0",), f"{k}.dense_0", dim, c["mlp_ratio"] * dim)
        _dense(out, p + ("dense_1",), f"{k}.dense_1", c["mlp_ratio"] * dim, dim)


def _expected_leaves(cfg: Mapping) -> Expected:
    """CausalLM: flax leaf path -> (state_dict key, flax shape, layout change)."""
    c = _full_cfg(CausalLM, cfg)
    vocab, dim = c["num_classes"], c["dim"]
    out: Expected = {("embed", "embedding"): ("embed.weight", (vocab, dim), _KEEP)}
    _blocks(out, c)
    _norm(out, ("norm_out",), "norm_out", dim)
    if not c["tie_embeddings"]:
        _dense(out, ("logits",), "logits", dim, vocab)
    return out


def _vit_leaves(cfg: Mapping) -> Expected:
    c = _full_cfg(VisionTransformer, cfg)
    p, dim = c["patch_size"], c["dim"]
    h, w = c["image_size"]
    out: Expected = {
        ("patch_embed", "kernel"): ("patch_embed.weight", (p, p, c["in_channels"], dim),
                                    _HWIO),
        ("patch_embed", "bias"): ("patch_embed.bias", (dim,), _KEEP),
        ("pos_embed",): ("pos_embed", (1, (h // p) * (w // p), dim), _KEEP),
    }
    _blocks(out, c)
    _norm(out, ("norm_out",), "norm_out", dim)
    _dense(out, ("logits",), "logits", dim, c["num_classes"])
    return out


def _resnet_leaves(cfg: Mapping) -> tuple[Expected, Expected]:
    """ResNet: the ``params`` and the ``batch_stats`` leaf tables, read off
    the port's own model built on the meta device (shapes only): its
    module names are the flax paths, so the architecture lives in
    models/resnet.py alone, and the flax trees stay the independent side."""
    arch = {k: v for k, v in cfg.items() if k not in ("device", "generator", "axis_name")}
    model = ResNet(**arch, device="meta")
    params: Expected = {}
    stats: Expected = {}
    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            params[path + ("kernel",)] = (f"{name}.weight", (kh, kw, i, o), _HWIO)
        elif isinstance(m, nn.Linear):
            _dense(params, path, name, m.in_features, m.out_features)
        elif isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            _norm(params, path, name, n)
            stats[path + ("mean",)] = (f"{name}.running_mean", (n,), _KEEP)
            stats[path + ("var",)] = (f"{name}.running_var", (n,), _KEEP)
    return params, stats


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
        arr = np.asarray(leaf)
        arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32)
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


def resnet_state_dict(params: Mapping, batch_stats: Mapping,
                      cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` (numpy leaves) -> the
    port's ``state_dict``, the BatchNorm buffers included; strict over both
    trees (a path in an error names its tree).  ``cfg`` holds ``ResNet``'s
    keywords (``stage_sizes``, ``block``, ``width``, ``low_res``,
    ``num_classes``, ``in_channels``; ``ARCHS`` has the registry's)."""
    expected_params, expected_stats = _resnet_leaves(cfg)
    expected = {("params", *p): v for p, v in expected_params.items()}
    expected.update({("batch_stats", *p): v for p, v in expected_stats.items()})
    return _convert({"params": params, "batch_stats": batch_stats}, expected)


def vit_state_dict(params: Mapping, cfg: Mapping) -> dict[str, torch.Tensor]:
    """flax VisionTransformer ``params`` (numpy leaves) -> the port's
    ``state_dict``; ``cfg`` holds the model's keywords (``patch_size``,
    ``dim``, ``depth``, ``heads``, ``heads_kv``, ``mlp_ratio``,
    ``num_classes``, ``image_size``, ``in_channels``; defaults as
    VisionTransformer's)."""
    return _convert(params, _vit_leaves(cfg))


def load_resnet(params_np: Mapping, batch_stats_np: Mapping, arch: str,
                device=None, **model_kw) -> ResNet:
    """The port's ResNet on ``device`` (the GPU unless ``device="cpu"``)
    holding the JAX parameters and batch statistics (numpy leaves).
    ``arch`` names a registry architecture (``"resnet20"``, ``"resnet50"``)
    whose ``ResNet`` keywords ``model_kw`` extends or overrides."""
    kw = {**ARCHS[arch], **model_kw}
    model = ResNet(device=device, **kw)
    model.load_state_dict(resnet_state_dict(params_np, batch_stats_np, kw), strict=True)
    return model.eval()


def load_vit(params_np: Mapping, device=None, **model_kw) -> VisionTransformer:
    """The port's VisionTransformer on ``device`` holding the JAX
    parameters ``params_np`` (numpy leaves)."""
    model = VisionTransformer(device=device, **model_kw)
    model.load_state_dict(vit_state_dict(params_np, model_kw), strict=True)
    return model.eval()


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
