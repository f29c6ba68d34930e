"""FLOPs accounting + MFU (model FLOPs utilization) for the port.

The JAX package takes a training epoch's FLOPs from XLA's cost analysis of
the compiled program.  PyTorch runs eagerly and has no compiled program to
ask, so the port counts analytically from the layer shapes: 2 FLOPs per
multiply-accumulate of every convolution and dense layer (SAME convolutions
counted at every output position), forward only, times 3 for a training
step (forward + two backward products).  Pooling, activations, dropout,
BatchNorm, the residual adds, the loss and the optimizer are left out.
The ResNets are counted the same way by ``FlopCounterMode`` over the
model's own forward on the meta device, so the architecture lives in
``models/resnet.py`` alone.  The two counts therefore differ a little:
XLA's includes the elementwise work, this one does not.  The causal
LM is counted per sequence (:func:`causal_lm_flops_per_sequence`): its
dense layers as above plus attention's matmuls by the JAX package's own
:func:`attention_flops` convention, which the JAX Trainer adds to XLA's
count for flash runs.  A MoE block (the LM's or the ViT's) counts its
router and its expert FFN on the routed assignments only, the useful work
(``_mlp_macs_per_token``), so a MoE run's MFU is the share of the peak
spent on that work, not on the capacity padding.  Norms, RoPE, softmax, the embedding gather and the
loss are left out.

MFU's denominator is the card's dense bf16 peak, looked up by the name
``torch.cuda.get_device_name`` reports (longest matching entry), or
``$DTM_PEAK_TFLOPS``.  Off the table, and on the CPU, MFU is None.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

# dense bf16 tensor-core peak TFLOP/s per card, NVIDIA data sheets (SXM)
_PEAK_TFLOPS_BF16: dict[str, float] = {
    "NVIDIA H100": 989.0,
}


def lenet5_flops_per_image(num_classes: int = 10) -> float:
    """LeNet-5 on a (28, 28, 1) image: conv 5x5 1->32 at 28x28, conv 5x5
    32->64 at 14x14, dense 3136->1024, dense 1024->num_classes."""
    macs = (28 * 28 * 32 * 5 * 5 * 1
            + 14 * 14 * 64 * 5 * 5 * 32
            + 7 * 7 * 64 * 1024
            + 1024 * num_classes)
    return 2.0 * macs * 3


def mlp_flops_per_image(hidden: Sequence[int] = (256,), num_classes: int = 10,
                        in_features: int = 784) -> float:
    """The MLP's dense layers: in -> hidden... -> num_classes."""
    widths = (in_features, *hidden, num_classes)
    macs = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2.0 * macs * 3


def attention_flops(
    batch: int, seq: int, heads: int, head_dim: int, *,
    causal: bool = False, with_backward: bool = True, depth: int = 1,
    window: int = 0,
) -> float:
    """Analytic matmul FLOPs of multi-head attention (the JAX package's
    ``utils/flops.py:78-121``, copied without its ring's ``cp``): forward is
    the QK^T and PV matmuls (4*B*S^2*H*D), backward counted at 2x forward,
    causal attention halved (S^2/2, the scaling-literature convention,
    which halves the diagonal too); a causal sliding ``window`` caps each
    query at ``min(q+1, W)`` keys in the same half-diagonal convention,
    ``S*W - W^2/2`` pairs.  The flash backward executes more than this (it
    recomputes the scores), so an MFU built on it is conservative."""
    if causal and window:
        w = min(window, seq)
        pairs = seq * w - w * w / 2.0
        f = 4.0 * batch * pairs * heads * head_dim * depth
    else:
        f = 4.0 * batch * seq * seq * heads * head_dim * depth
        if causal:
            f /= 2.0
    if with_backward:
        f *= 3.0
    return f


def _mlp_macs_per_token(dim: int, depth: int, mlp_ratio: int, moe_every: int,
                        n_experts: int, moe_top_k: int) -> float:
    """Multiply-accumulates per token of every block's FFN: the dense MLP
    (``2 * mlp_ratio * dim^2``), or in a MoE block (every ``moe_every``-th)
    the router (``dim * n_experts``) plus the expert FFN once per routed
    assignment (``moe_top_k`` x the dense MLP's).  That is the useful
    work: the capacity buffers' padding (empty slots run the FFN too) and
    JAX's one-hot dispatch/combine einsums are not counted."""
    n_moe = sum(1 for i in range(depth) if moe_every > 0 and (i + 1) % moe_every == 0)
    mlp = 2 * mlp_ratio * dim * dim
    return (depth - n_moe) * mlp + n_moe * (dim * n_experts + moe_top_k * mlp)


def causal_lm_flops_per_sequence(seq: int, dim: int, depth: int, heads: int,
                                 vocab: int, heads_kv: int = 0, mlp_ratio: int = 4,
                                 causal: bool = True, window: int = 0,
                                 moe_every: int = 0, n_experts: int = 8,
                                 moe_top_k: int = 1) -> float:
    """Analytic FLOPs of one training sequence of the causal LM.

    Per block and token, 2 FLOPs per weight of the q/k/v projections, the
    output projection and the MLP: ``2 * 12 * dim^2`` for MHA at
    ``mlp_ratio`` 4 (a MoE block's FFN as :func:`_mlp_macs_per_token`
    counts it); plus the vocab head, ``2 * dim * vocab``; times 3 for
    training; plus :func:`attention_flops` with its backward.  At the
    repo's long-context LM (S=8192, dim 512, depth 4, 8 heads, vocab 256,
    causal) that is ~1.45 TFLOP per sequence.  XLA's count of the same step
    differs by the elementwise work this one leaves out."""
    hd = dim // heads
    hkv = heads_kv or heads
    per_token = (depth * (dim * (dim + 2 * hkv * hd) + dim * dim)
                 + _mlp_macs_per_token(dim, depth, mlp_ratio, moe_every, n_experts,
                                       moe_top_k)
                 + dim * vocab)
    dense = 2.0 * per_token * seq * 3
    return dense + attention_flops(1, seq, heads, hd, causal=causal,
                                   with_backward=True, depth=depth, window=window)


def ring_hop_bytes(seq_local: int, heads_kv: int, head_dim: int, *, batch: int = 1,
                   dtype_bytes: int = 4, depth: int = 1) -> int:
    """Bytes ONE rank sends per ring hop of a context-parallel prefill (JAX's
    ``utils/flops.py:174``): the rotating K and V blocks at their grouped
    ``H_kv`` width, ``2 * B * S_local * H_kv * D * dtype_bytes`` a layer;
    a prefill makes ``cp - 1`` hops a layer.  The ``ring_hop`` spans of a
    cp engine's prefill carry it."""
    if seq_local < 0 or heads_kv < 1 or head_dim < 1:
        raise ValueError(
            f"bad ring hop shape: seq_local={seq_local}, "
            f"heads_kv={heads_kv}, head_dim={head_dim}")
    return int(2 * batch * seq_local * heads_kv * head_dim * dtype_bytes * depth)


def resnet_forward_flops(model: str, image_shape: Sequence[int], num_classes: int = 10,
                         **model_kw) -> float:
    """Forward FLOPs of one image through the registry ResNet ``model``
    (``"resnet20"``, ``"resnet50"``; ``model_kw`` such as ``low_res``):
    the model itself runs on the meta device (shapes only) under
    ``FlopCounterMode``, which counts every convolution (stem, blocks,
    projections) at every output position over its full window and the
    dense head; BatchNorm, relu, the residual adds and the pools are left
    out.  ResNet-20 at 28 px: 62.0 MFLOP; ResNet-50 (low-res stem) at 32
    px: 2.596 GFLOP."""
    h, w, c = image_shape
    arch = {k: v for k, v in model_kw.items() if k not in ("device", "generator")}
    arch.setdefault("in_channels", c)
    net = get_model(model, num_classes=num_classes, device="meta", **arch)
    with FlopCounterMode(display=False) as counter:
        net(torch.empty(1, h, w, c, device="meta"))
    return float(counter.get_total_flops())


def vit_forward_flops(image_shape: Sequence[int], patch_size: int, dim: int,
                      depth: int, heads: int, num_classes: int = 10,
                      heads_kv: int = 0, mlp_ratio: int = 4,
                      causal: bool = False, moe_every: int = 0, n_experts: int = 8,
                      moe_top_k: int = 1) -> float:
    """Forward FLOPs of one image through the ViT: the patch embedding (a
    stride-p conv), per token and block 2 FLOPs per weight of the q/k/v
    projections, the output projection and the MLP (a MoE block's FFN as
    :func:`_mlp_macs_per_token` counts it), attention's forward
    matmuls by :func:`attention_flops`' convention, and the head; norms,
    GELU, softmax and the token mean are left out.  dim 512, depth 8, 8
    heads, patch 2 on 28 px (S=196): 10.50 GFLOP."""
    h, w, c = image_shape
    p = patch_size
    seq = (h // p) * (w // p)
    hd = dim // heads
    hkv = heads_kv or heads
    per_token = (depth * (dim * (dim + 2 * hkv * hd) + dim * dim)
                 + _mlp_macs_per_token(dim, depth, mlp_ratio, moe_every, n_experts,
                                       moe_top_k))
    return (2.0 * seq * dim * p * p * c + 2.0 * seq * per_token
            + attention_flops(1, seq, heads, hd, causal=causal, with_backward=False,
                              depth=depth)
            + 2.0 * dim * num_classes)


def _moe_kw(kw: dict) -> dict:
    return {"moe_every": kw.get("moe_every", 0), "n_experts": kw.get("n_experts", 8),
            "moe_top_k": kw.get("moe_top_k", 1)}


def model_flops_per_image(model: str, model_kwargs: dict, num_classes: int,
                          in_features: int, seq_len: int | None = None,
                          causal: bool = True,
                          image_shape: Sequence[int] | None = None) -> float:
    """Analytic FLOPs of one training example (an image, or for the
    causal LM one sequence of ``seq_len`` tokens) for a registry model
    name; ``model_kwargs`` holds the causal LM's and the ViT's full
    architecture, ``image_shape`` the (H, W, C) of an image.  A training
    step counts 3x the forward (forward and two backward products; the
    attention's backward at 2x its forward by the same convention)."""
    if model == "lenet5":
        return lenet5_flops_per_image(num_classes)
    if model == "mlp":
        return mlp_flops_per_image(model_kwargs.get("hidden", (256,)), num_classes,
                                   in_features)
    kw = model_kwargs
    if model == "causal_lm":
        return causal_lm_flops_per_sequence(
            seq_len, kw["dim"], kw["depth"], kw["heads"], num_classes,
            heads_kv=kw.get("heads_kv", 0), mlp_ratio=kw.get("mlp_ratio", 4),
            causal=causal, window=kw.get("window", 0), **_moe_kw(kw))
    if model in ("resnet20", "resnet50"):
        return 3 * resnet_forward_flops(model, image_shape, num_classes, **kw)
    if model == "vit":
        return 3 * vit_forward_flops(
            image_shape, kw["patch_size"], kw["dim"], kw["depth"], kw["heads"],
            num_classes, heads_kv=kw.get("heads_kv", 0), mlp_ratio=kw.get("mlp_ratio", 4),
            causal=causal, **_moe_kw(kw))
    raise ValueError(f"no FLOP count for model {model!r}")


def device_peak_tflops(device_name: str | None) -> float | None:
    """Peak dense bf16 TFLOP/s for a card name (``$DTM_PEAK_TFLOPS``
    wins); None off the table, and None without a card (``device_name``
    None: the CPU has no peak to hold a run against)."""
    if not device_name:
        return None
    env = os.environ.get("DTM_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    best = None
    for prefix, peak in _PEAK_TFLOPS_BF16.items():
        if device_name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peak)
    return best[1] if best else None


def mfu(flops_per_sec_per_chip: float | None, device_name: str | None) -> float | None:
    """flops/sec/chip -> fraction of the card's bf16 peak (None off-table)."""
    if not flops_per_sec_per_chip:
        return None
    peak = device_peak_tflops(device_name)
    if not peak:
        return None
    return flops_per_sec_per_chip / (peak * 1e12)
