"""LeNet-class MNIST CNN of the port: conv32 -> pool -> conv64 -> pool ->
fc1024 + dropout -> fc(num_classes).

The counterpart of the JAX package's ``models/lenet.py``.  Its input is the
JAX model's NHWC ``(B, 28, 28, 1)`` float batch in [0, 1].  Compute runs in
``dtype`` (bf16 by default): the input and every weight and bias are cast
to it before use, as flax's ``dtype=`` does, while the parameters stay
float32 and the logits come back float32.  The 5x5 convolutions are SAME
(``padding=2``), the pools 2x2 with stride 2.

Flatten order.  flax flattens the pooled ``(B, 7, 7, 64)`` NHWC activation
in (H, W, C) order, while an NCHW tensor flattens in (C, H, W) order.  This
model flattens after ``permute(0, 2, 3, 1)``, in (H, W, C) order, so fc1's
3136 input rows keep flax's order and convert.py only transposes the
kernel.

``conv1_s2d=True`` is accepted and computes the direct conv1: in the JAX
package it is an exact re-expression of the same function for the TPU's
matrix unit (``test_lenet_conv1_s2d_matches_direct`` pins the two equal),
with the same parameters.

Weights are created on ``device`` (the GPU unless ``device="cpu"``) from
``generator`` (a ``torch.Generator`` on that device; a fresh one seeded 0
when None), flax's initialisers: kernels truncated-normal LeCun
(std fan_in^-1/2 / 0.8796, cut at two std), biases zero.  Dropout draws its
keep mask from the same generator, with flax's semantics: ``x * keep /
(1 - p)``, only when ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose std is divided by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def _resolve_generator(generator: torch.Generator | None,
                       device: torch.device) -> torch.Generator:
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(
            f"generator is on {generator.device}, the model on {device}: "
            "dropout masks are drawn on the model's device")
    return generator


@torch.no_grad()
def init_lecun_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init on every parameter of ``module``: weights
    truncated-normal LeCun over their fan-in, biases zero."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        fan_in = p[0].numel()  # (out, in, kh, kw) or (out, in)
        std = fan_in ** -0.5 / _TRUNC_STD
        w = torch.empty(p.shape, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        p.copy_(w)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training: keep with probability ``1 - rate``
    (mask drawn from ``generator``), scale survivors by ``1 / (1 - rate)``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class LeNet5(nn.Module):
    """conv32 -> pool -> conv64 -> pool -> fc1024 + dropout -> fc(num_classes)."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 conv1_s2d: bool = False, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.dropout_rate = num_classes, dropout_rate
        self.conv1_s2d, self.dtype = conv1_s2d, dtype
        meta = torch.device("meta")  # shapes first; values from `generator`
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2, device=meta)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2, device=meta)
        self.fc1 = nn.Linear(7 * 7 * 64, 1024, device=meta)
        self.logits = nn.Linear(1024, num_classes, device=meta)
        self.to_empty(device=device)
        self.generator = _resolve_generator(generator, device)
        init_lecun_(self, self.generator)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=2)

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x, fc.weight.to(dt), fc.bias.to(dt))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, 28, 28, 1) NHWC images in [0, 1] -> (B, num_classes) float32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self._conv(self.conv1, x)), 2, 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv2, x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order, as flax
        x = F.relu(self._dense(self.fc1, x))
        if train:
            x = dropout(x, self.dropout_rate, self.generator)
        return self._dense(self.logits, x).float()
