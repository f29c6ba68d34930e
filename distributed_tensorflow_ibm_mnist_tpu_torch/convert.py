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
* The ViT's ``pos_embed`` (and a causal LM's with ``pos="learned"``) is
  kept as it is; the ViT's ``block_{i}`` map as the causal LM's blocks do.
* A MoE block's ``moe/{router,w1,b1,w2,b2}`` are stored in the same layout
  on both sides (parallel/expert_parallel.py): kept as they are, float32,
  and never quantized.
* A pipelined model's (``pp_stages > 0``) ``pipe_blocks/stacked`` tree
  holds every block's leaf in one ``(n_stages, per_stage, ...)`` array;
  slice ``[s, i]`` maps, as a ``block_{i}`` leaf does, to the port's
  ``pipe_blocks.stages.{s}.{i}`` (models/transformer.py
  ``StackedBlocks``), every slice consumed and the stacked shape checked.

A causal LM tree that ``quantize_params_int8`` has quantized (int8
``kernel`` and a ``scale`` sibling under each projection) converts to the
int8 model's ``state_dict``: the int8 weight transposed, ``<module>.scale``
as it is.  ``load_causal_lm`` loads such a tree, or quantizes a full one,
into a ``quant="int8"`` model.

:func:`train_state_dict` / :func:`load_train_state` carry a whole JAX
``TrainState`` (parameters, ``batch_stats``, the optax state's moments and
counts, the step) into the port's ``TrainState``: how a run checkpointed by
the JAX package continues in the port.

Leaves come out float32 (float64 leaves stay float64, int8 stay int8).  The conversion
is strict: every leaf of the tree is consumed, no expected
leaf may be missing, and every shape must match the configuration; any
breach raises ``ValueError`` naming the leaf's path.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import LeNet5
from distributed_tensorflow_ibm_mnist_tpu_torch.models.mlp import MLP
from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    is_quantized,
    quantize_state_dict_int8,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ARCHS, BatchNorm, ResNet
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    VisionTransformer,
    is_moe_block,
)

_KEEP, _TRANSPOSE, _HWIO = "keep", "transpose", "hwio"  # leaf layout changes


def _full_cfg(cls, cfg: Mapping) -> dict:
    """``cfg`` with ``cls``'s constructor defaults filled in."""
    full = {k: p.default for k, p in inspect.signature(cls).parameters.items()}
    full.update(cfg)
    return full


Expected = dict[tuple[str, ...], tuple[str, tuple, str]]


def _dense(out: Expected, path: tuple[str, ...], key: str, fan_in: int, fan_out: int,
           scale: bool = False):
    out[path + ("kernel",)] = (f"{key}.weight", (fan_in, fan_out), _TRANSPOSE)
    out[path + ("bias",)] = (f"{key}.bias", (fan_out,), _KEEP)
    if scale:  # an int8 kernel's per-output-channel scale
        out[path + ("scale",)] = (f"{key}.scale", (fan_out,), _KEEP)


def _norm(out: Expected, path: tuple[str, ...], key: str, n: int):
    out[path + ("scale",)] = (f"{key}.weight", (n,), _KEEP)
    out[path + ("bias",)] = (f"{key}.bias", (n,), _KEEP)


_STACKED = "{s}.{i}"  # the stage and block of a stacked leaf's port key


def _blocks(out: Expected, c: Mapping, scale: bool = False) -> None:
    """The pre-norm blocks ``block_{i}`` -> ``blocks.{i}`` (CausalLM, ViT);
    ``scale``: the projections are int8 with scales.  With ``pp_stages``
    the stacked tree: one ``pipe_blocks/stacked`` entry a leaf, its port
    key a template over :data:`_STACKED` and its shape the stacked one."""
    dim, heads = c["dim"], c["heads"]
    hkv = c["heads_kv"] or heads
    hd = dim // heads
    n_stages = c.get("pp_stages", 0)
    if n_stages:
        block: Expected = {}
        _block(block, (), "", 0, c, dim, hkv, hd, scale)  # keys ".norm_attn.weight", ...
        lead = (n_stages, c["depth"] // n_stages)
        for path, (key, shape, layout) in block.items():
            out[("pipe_blocks", "stacked") + path] = (
                "pipe_blocks.stages." + _STACKED + key, lead + shape, layout)
        return
    for i in range(c["depth"]):
        _block(out, (f"block_{i}",), f"blocks.{i}", i, c, dim, hkv, hd, scale)


def _block(out: Expected, p: tuple, k: str, i: int, c: Mapping, dim: int, hkv: int,
           hd: int, scale: bool) -> None:
    """One pre-norm block's leaves under flax path ``p`` and port key ``k``."""
    heads = c["heads"]
    _norm(out, p + ("norm_attn",), f"{k}.norm_attn", dim)
    if hkv == heads:
        _dense(out, p + ("qkv",), f"{k}.qkv", dim, 3 * dim, scale)
    else:
        _dense(out, p + ("q_proj",), f"{k}.q_proj", dim, dim, scale)
        _dense(out, p + ("kv_proj",), f"{k}.kv_proj", dim, 2 * hkv * hd, scale)
    _dense(out, p + ("proj",), f"{k}.proj", dim, dim, scale)
    _norm(out, p + ("norm_mlp",), f"{k}.norm_mlp", dim)
    hidden = c["mlp_ratio"] * dim
    if is_moe_block(i, c["moe_every"]):  # float32, never quantized
        e = c["n_experts"]
        for leaf, shape in (("router", (dim, e)), ("w1", (e, dim, hidden)),
                            ("b1", (e, hidden)), ("w2", (e, hidden, dim)),
                            ("b2", (e, dim))):
            out[p + ("moe", leaf)] = (f"{k}.moe.{leaf}", shape, _KEEP)
    else:
        _dense(out, p + ("dense_0",), f"{k}.dense_0", dim, hidden, scale)
        _dense(out, p + ("dense_1",), f"{k}.dense_1", hidden, dim, scale)


def _expected_leaves(cfg: Mapping, quantized: bool = False) -> Expected:
    """CausalLM: flax leaf path -> (state_dict key, flax shape, layout
    change); ``quantized``: the tree of ``quantize_params_int8``."""
    c = _full_cfg(CausalLM, cfg)
    vocab, dim = c["num_classes"], c["dim"]
    out: Expected = {("embed", "embedding"): ("embed.weight", (vocab, dim), _KEEP)}
    if c["pos"] == "learned":
        out[("pos_embed",)] = ("pos_embed", (1, c["seq_len"], dim), _KEEP)
    _blocks(out, c, quantized)
    _norm(out, ("norm_out",), "norm_out", dim)
    if not c["tie_embeddings"]:
        _dense(out, ("logits",), "logits", dim, vocab, quantized)
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


def _port_tensor(arr: np.ndarray, layout: str) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    if layout == _TRANSPOSE:
        t = t.T
    elif layout == _HWIO:
        t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    return t.contiguous()


def _convert(params: Mapping, expected: Expected) -> dict[str, torch.Tensor]:
    """Strict conversion against the ``expected`` leaf table (a stacked
    leaf's key template gives one tensor a ``[s, i]`` slice)."""
    state: dict[str, torch.Tensor] = {}
    seen = set()
    for path, leaf in _leaves(params):
        name = "/".join(path)
        if path not in expected:
            raise ValueError(f"unexpected leaf {name!r} for this configuration")
        key, shape, layout = expected[path]
        arr = np.asarray(leaf)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32)
        if arr.shape != shape:
            raise ValueError(
                f"leaf {name!r} has shape {arr.shape}, expected {shape}")
        if _STACKED in key:
            for s in range(shape[0]):
                for i in range(shape[1]):
                    state[key.replace(_STACKED, f"{s}.{i}")] = _port_tensor(arr[s, i], layout)
        else:
            state[key] = _port_tensor(arr, layout)
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
    CausalLM's).  A quantized tree gives the int8 model's ``state_dict``."""
    return _convert(params, _expected_leaves(cfg, is_quantized(params)))


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
    are the constructor keywords the JAX model was built with.  A
    ``quant="int8"`` model takes a quantized tree, or a full one that is
    quantized here."""
    model = CausalLM(device=device, **model_kw)
    state = causal_lm_state_dict(params_np, model_kw)
    if model.quant == "int8":
        state = quantize_state_dict_int8(state)
    model.load_state_dict(state, strict=True)
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


def _flax_shape(shape: tuple, layout: str) -> tuple:
    """The flax shape of a port tensor of ``shape`` under ``layout``."""
    if layout == _TRANSPOSE:
        return tuple(reversed(shape))
    if layout == _HWIO:  # OIHW -> HWIO
        o, i, h, w = shape
        return (h, w, i, o)
    return tuple(shape)


def flax_layout(model: nn.Module) -> dict[str, tuple[tuple[str, ...], str, tuple]]:
    """``{parameter name: (flax path, layout change, flax shape)}`` for a
    port model, read off its modules: the inverse of the tables above
    (``blocks.{i}`` is flax's ``block_{i}``, a stage block's
    ``pipe_blocks.stages.{s}.{i}`` the ``[s, i]`` slice of flax's
    ``pipe_blocks/stacked``, its flax shape the slice's; a ``Linear`` weight is a
    transposed ``kernel``, a ``Conv2d`` weight an HWIO ``kernel``, a norm's
    weight its ``scale``, an ``Embedding``'s its ``embedding``; an
    ``Int8Linear``'s int8 weight a transposed ``kernel`` and its scale
    buffer the ``scale`` leaf beside it, as JAX's quantized tree holds
    them; the MoE leaves and loose parameters keep their names and
    layouts).  The spec rules (parallel/tensor_parallel.py) decide on these
    paths and shapes."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import Int8Linear
    from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import LayerNorm

    out = {}
    for mod_name, mod in model.named_modules():
        parts = mod_name.split(".") if mod_name else []
        path: list[str] = []
        i = 0
        while i < len(parts):  # blocks.{i} -> block_{i}
            if parts[i] == "blocks" and i + 1 < len(parts):
                path.append(f"block_{parts[i + 1]}")
                i += 2
            elif parts[i] == "pipe_blocks":  # pipe_blocks.stages.{s}.{i}
                path += ["pipe_blocks", "stacked"]
                i += 4
            else:
                path.append(parts[i])
                i += 1
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            layout, flax_leaf = _KEEP, leaf
            if leaf == "weight":
                if isinstance(mod, (nn.Linear, Int8Linear)):
                    layout, flax_leaf = _TRANSPOSE, "kernel"
                elif isinstance(mod, nn.Conv2d):
                    layout, flax_leaf = _HWIO, "kernel"
                elif isinstance(mod, (LayerNorm, BatchNorm)):
                    flax_leaf = "scale"
                elif isinstance(mod, nn.Embedding):
                    flax_leaf = "embedding"
            out[name] = (tuple(path) + (flax_leaf,), layout,
                         _flax_shape(tuple(p.shape), layout))
        if isinstance(mod, Int8Linear):
            out[f"{mod_name}.scale"] = (tuple(path) + ("scale",), _KEEP,
                                        tuple(mod.scale.shape))
    return out


# ---------------------------------------------------------------- train state

def _field(tree: Any, name: str):
    """``tree.name`` or ``tree[name]``: a flax TrainState or a mapping."""
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _params_table(config, model_kw: Mapping):
    """``convert(params_tree, batch_stats_tree) -> state_dict`` for the
    run's model family."""
    name = config.model
    if name in ARCHS:
        arch = {**ARCHS[name], **model_kw}
        return lambda p, s: resnet_state_dict(p, s, arch)
    convert = {"lenet5": lenet5_state_dict, "mlp": mlp_state_dict,
               "vit": vit_state_dict, "causal_lm": causal_lm_state_dict}.get(name)
    if convert is None:
        raise ValueError(f"no train-state conversion for model {name!r}")
    return lambda p, s: convert(p, model_kw)


def _opt_nodes(tree: Any, path: str):
    """The optax state's nodes: ``(path, namedtuple)`` for each state
    record, walking the chain's tuples."""
    if hasattr(tree, "_fields"):
        yield path, tree
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _opt_nodes(sub, f"{path}/{i}")
    elif isinstance(tree, Mapping):
        for k, sub in tree.items():
            yield from _opt_nodes(sub, f"{path}/{k}")
    else:
        raise ValueError(f"{path}: unexpected optimizer-state leaf {type(tree).__name__}")


def _run_model_kw(config, model_kw: Mapping) -> dict:
    """The model keywords of a run: ``config.model_kwargs``, ``model_kw``,
    and, at pp > 1, ``pp_stages`` (as JAX's Trainer sets it)."""
    kw = {**config.model_kwargs, **model_kw}
    if config.pp > 1:
        kw.setdefault("pp_stages", config.pp)
    return kw


def train_state_dict(jax_state_np: Any, config, **model_kw) -> dict:
    """A JAX ``TrainState`` with numpy leaves (the tree the JAX package's
    ``restore_state`` returns, ``jax.tree.map(np.asarray, state)``) -> the
    port's save form (``core.state.TrainState.state_dict``'s keys:
    ``step``, ``params``, ``buffers``, ``optimizer``; no generator states,
    JAX's key has no counterpart), for ``TrainState.load_state_dict``.

    ``config`` is the run's ``RunConfig``; ``model_kw`` the model keywords
    the run's model was built with beyond ``config.model_kwargs`` (the
    Trainer derives ``num_classes``, ``in_features``, ``in_channels`` and
    ``image_size`` from the data).  The optax state is read record by
    record: ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) for adam and
    adamw, ``TraceState`` (``trace``) for momentum, the schedule's
    ``ScaleByScheduleState`` (``count``), and empty records (the clip, the
    decayed weights).  Strict: every leaf is consumed, the moments map
    like the parameters (transposed, HWIO -> OIHW), the counts must agree,
    the records must be the config's chain's, and every error names its
    path.  A JAX pp run's tree (``config.pp > 1``) is the stacked one, its
    ``pp_stages`` the run's pp unless ``model_kw`` says otherwise."""
    kw = _run_model_kw(config, model_kw)
    convert = _params_table(config, kw)
    params = _field(jax_state_np, "params")
    stats = _field(jax_state_np, "batch_stats") or {}
    if config.model not in ARCHS and stats:
        raise ValueError(f"batch_stats: {config.model} has no BatchNorm statistics")
    state = convert(params, stats)
    buffers = {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}
    names = [k for k in state if k not in buffers]
    moments: dict[str, dict] = {"mu": {}, "nu": {}, "trace": {}}
    counts: list[tuple[str, int]] = []
    for path, node in _opt_nodes(_field(jax_state_np, "opt_state"), "opt_state"):
        fields = set(node._fields)
        if fields == {"count", "mu", "nu"}:
            keys = ("mu", "nu")
        elif fields == {"trace"}:
            keys = ("trace",)
        elif fields == {"count"}:
            keys = ()
        elif not fields:
            continue
        else:
            raise ValueError(f"{path}: unknown optimizer state {type(node).__name__}"
                             f" with fields {sorted(fields)}")
        if "count" in fields:
            counts.append((path, int(np.asarray(node.count))))
        for key in keys:
            if moments[key]:
                raise ValueError(f"{path}: a second {key} in one chain")
            try:
                m = convert(getattr(node, key), stats)
            except ValueError as e:
                raise ValueError(f"{path}/{key}: {e}") from None
            moments[key] = {n: m[n] for n in names}
    want = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "momentum": ("trace",),
            "sgd": ()}[config.optimizer]
    have = tuple(k for k in ("mu", "nu", "trace") if moments[k])
    if have != want:
        raise ValueError(f"opt_state holds {list(have) or 'no moments'}; a "
                         f"{config.optimizer} chain keeps {list(want) or 'none'}")
    if len({c for _, c in counts}) > 1:
        raise ValueError(f"opt_state counts disagree: {counts}")
    return {"step": int(np.asarray(_field(jax_state_np, "step"))),
            "params": {n: state[n] for n in names}, "buffers": buffers,
            "optimizer": {"count": counts[0][1] if counts else 0, **moments}}


def load_train_state(jax_state_np: Any, config, device=None, total_steps: int | None = None,
                     mesh=None, **model_kw):
    """A JAX ``TrainState`` (numpy leaves) as the port's ``TrainState``:
    the run's model on ``device`` (the GPU unless ``device="cpu"``) holding
    the JAX parameters and batch statistics, ``config``'s optimizer over
    them holding the JAX optimizer's count and moments, and the step
    (:func:`train_state_dict` has the mapping and its checks).
    ``total_steps``: the schedule's length, as the Trainer computes it
    (``steps_per_epoch * epochs``); by default ``n_train // batch_size *
    epochs`` of ``config``.  This is how a run checkpointed by the JAX
    package continues in the port: the JAX package restores its orbax
    checkpoint (``utils.checkpoint.restore_state``), the port converts it.
    A causal LM is built with float32 masters (``param_dtype``, as the
    Trainer builds it), so JAX's float32 parameters and moments arrive
    unrounded; a learned position table needs ``seq_len`` among the
    model keywords.  ``mesh`` with a model axis of more than one rank
    (``parallel.mesh.make_mesh(tp=N)``): the whole leaves land first, then
    each rank keeps its blocks of the leaves ``megatron_rule(N)`` splits
    (``parallel.tensor_parallel.shard_train_state``).  With a pipe axis
    (``config.pp > 1``, the stacked model) each rank keeps its stage and,
    under tp, its Megatron blocks inside it where tp divides the heads
    (``parallel.pipeline.shard_train_state``)."""
    import torch as _torch

    from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)  # raises without a GPU unless asked for the CPU
    form = train_state_dict(jax_state_np, config, **model_kw)
    if total_steps is None:
        if not config.n_train:
            raise ValueError("total_steps is needed when config.n_train is not set")
        total_steps = config.n_train // config.batch_size * config.epochs
    kw = _run_model_kw(config, model_kw)
    if config.model == "causal_lm":  # float32 masters, as the Trainer builds it
        kw.setdefault("param_dtype", _torch.float32)
    model = get_model(config.model, device=device, **kw)
    optimizer = make_optimizer(config, total_steps, list(model.parameters()))
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       data_generator=_torch.Generator(device=device))
    state.load_state_dict(form)
    if mesh is not None and mesh.pipe_size > 1:
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import pipeline

        n = mesh.model_size
        specs = pipeline.stage_param_specs(
            model, n, pipeline.tp_in_stages(model.heads, model.heads_kv, n))
        pipeline.shard_train_state(mesh, state, specs)
    elif mesh is not None and mesh.model_size > 1:
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp

        specs = tp.model_param_specs(model, tp.megatron_rule(mesh.model_size))
        tp.shard_train_state(mesh, state, specs)
    return state
