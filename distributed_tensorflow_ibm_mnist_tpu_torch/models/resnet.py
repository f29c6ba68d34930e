"""ResNets of the port: ResNet-20 for Fashion-MNIST and ResNet-50 for
CIFAR-10 (BASELINE.md configs 4-5).

The counterpart of the JAX package's ``models/resnet.py``, with its
submodule names (``stem``, ``stem_bn``, ``stage{i}_block{j}``,
``conv1..3``, ``bn1..3``, ``proj``, ``bn_proj``, ``logits``), so convert.py
maps the flax trees by name.  The input is the JAX model's NHWC float batch
in [0, 1]; it is viewed as NCHW with channels-last strides, the layout the
convolutions keep throughout.  Compute runs in ``dtype`` (bf16 by
default): the input and every weight are cast to it before use, as flax's
``dtype=`` does, while parameters and BatchNorm buffers stay float32 and
the logits come back float32.

Two things follow XLA and flax rather than PyTorch's defaults:

* SAME padding is XLA's: a total of ``max((ceil(n/s) - 1) * s + k - n,
  0)`` per spatial dim, ``total // 2`` before and the rest after
  (:func:`same_pads`).  A 3x3 stride-2 conv on 28 or 32 px pads (0, 1),
  not (1, 1); the 7x7/2 stem and the 3x3/2 max-pool alike (the pool pads
  with -inf, so padded taps never win).
* :class:`BatchNorm` is flax's ``nn.BatchNorm``: batch moments in at
  least float32 whatever the compute dtype, the biased variance ``E[x^2] - E[x]^2``
  clipped at 0, epsilon 1e-5, the normalisation in float32 and cast to the
  compute dtype, and the running update ``ra = momentum * ra + (1 -
  momentum) * batch`` with the biased batch variance (flax's momentum 0.9
  is the fraction kept; ``nn.BatchNorm2d`` keeps the unbiased variance and
  reads its momentum the other way round).

``model(x, train=True)`` normalises with the batch's moments and updates
the running statistics in place; ``train=False`` uses the running
statistics.  ``self.training`` plays no part.

Cross-replica BatchNorm (``axis_name="data"``, as flax's ``axis_name``):
the name is resolved when the model is built to the active data mesh
(``parallel.mesh.axis_mesh``; ``ValueError`` with no process group).  A
training forward then averages the float32 mean and ``E[x^2]`` across
the mesh's data group (under tensor parallelism the ranks of this model
index only, so each row of the batch counts once) before forming the
variance, as flax ``pmean``s both, so every rank
normalises with the global moments and holds the same running statistics.
The gradient through the moments needs the two channel reductions summed
across the data group: ``batch_norm_backward_reduce``, an all-reduce, then
``batch_norm_backward_elemt``, as ``SyncBatchNorm`` does (on CUDA; their
plain versions, :func:`backward_reduce_plain` and
:func:`backward_elemt_plain`, on the CPU, which has no such kernels).  Without
``axis_name`` nothing of this runs.  Under tensor parallelism every
convolution's output channels are split over the model group and gathered
before their BatchNorm (``parallel.tensor_parallel.conv2d``), so the
BatchNorm and its statistics stay whole on every model rank.

Weights are created on ``device`` (the GPU unless ``device="cpu"``) from
``generator`` (a fresh one seeded 0 when None): convolution and dense
kernels truncated-normal LeCun as flax's default, the dense bias 0,
BatchNorm scale 1 and bias 0, running mean 0 and variance 1.

``block_remat=True`` recomputes each residual block's activations in the
backward (``models/remat.py``; flax's ``nn.remat`` of the block class):
the running statistics still move once a step, because ``BatchNorm``
skips its running update during the recompute.  Eval and ``torch.no_grad``
run the blocks plainly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import (
    _resolve_generator,
    init_lecun_,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import recomputing, remat
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    all_reduce_sum,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tp
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh, axis_mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import resolve_device

def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim of size ``n`` for a window
    ``k`` at stride ``s``: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``(x, padding)`` for a ``k`` x ``k`` window at stride ``s`` over NCHW
    ``x`` under XLA's SAME rule: a symmetric padding is handed to the conv
    or pool as its own ``padding``; an asymmetric one is applied here with
    ``F.pad`` (filled with ``value``) and the window then runs unpadded."""
    (top, bottom), (left, right) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), 0


def _raw_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``E[x]`` and ``E[x^2]`` of NCHW ``x`` over (N, H, W), reduced from
    ``x`` read in at least float32 (float64 stays float64, as in flax)."""
    dims = (0, 2, 3)
    dt = torch.promote_types(x.dtype, torch.float32)
    mean = x.mean(dims, dtype=dt)
    mean_sq = torch.linalg.vector_norm(x, 2, dim=dims, dtype=dt).square()
    return mean, mean_sq / (x.numel() // x.shape[1])


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's batch statistics of NCHW ``x`` over (N, H, W): the mean and
    the biased variance ``E[x^2] - E[x]^2`` clipped at 0, in at least
    float32."""
    mean, mean_sq = _raw_moments(x)
    return mean, (mean_sq - mean.square()).clamp_min(0.0)


class _NormalizeBatch(torch.autograd.Function):
    """Normalise ``x`` by its own batch moments (given, float32) with the
    gradient of training-mode BatchNorm, which flows through the moments
    too.  Autograd keeps only ``x`` (in the compute dtype), the moments and
    the scale: no float32 copy of the activation."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            g, x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _backward_reduce(g, x, mean, invstd, weight):
    """Per channel: ``sum(g)``, ``sum(g (x - mean))`` and the local
    gradients of the scale and the bias."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(g, x, mean, invstd, weight, True, True, True)
    return backward_reduce_plain(g, x, mean, invstd, weight)


def backward_reduce_plain(g, x, mean, invstd, weight):
    """:func:`_backward_reduce` written out, on any device."""
    dt = mean.dtype
    gd, xmu = g.to(dt), x.to(dt) - _channel(mean)
    sum_dy, sum_dy_xmu = gd.sum((0, 2, 3)), (gd * xmu).sum((0, 2, 3))
    return sum_dy, sum_dy_xmu, (sum_dy_xmu * invstd).to(weight.dtype), sum_dy.to(weight.dtype)


def _backward_elemt(g, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count: int, ranks: int):
    """The input gradient of training-mode BatchNorm from the channel sums
    over every rank's ``count`` elements a channel."""
    if x.is_cuda:
        counts = torch.full((ranks,), count, dtype=torch.int32, device=x.device)
        return torch.batch_norm_backward_elemt(g, x, mean, invstd, weight, sum_dy,
                                               sum_dy_xmu, counts)
    return backward_elemt_plain(g, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count, ranks)


def backward_elemt_plain(g, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count: int,
                         ranks: int):
    """:func:`_backward_elemt` written out, on any device."""
    dt, total = mean.dtype, count * ranks
    xmu = x.to(dt) - _channel(mean)
    gx = (g.to(dt) - _channel(sum_dy / total)
          - xmu * _channel(invstd.square() * sum_dy_xmu / total))
    return (gx * _channel(invstd * weight.to(dt))).to(x.dtype)


class _NormalizeCrossReplica(torch.autograd.Function):
    """:class:`_NormalizeBatch` over moments averaged across the mesh's
    ranks: the backward sums its two channel reductions across ranks too."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, mesh):
        ctx.mesh = mesh
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        g = g.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, gw, gb = _backward_reduce(g, x, mean, invstd, weight)
        sum_dy, sum_dy_xmu = all_reduce_sum(torch.stack([sum_dy, sum_dy_xmu]),
                                            ctx.mesh.data_group)
        gx = _backward_elemt(g, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                             x.numel() // x.shape[1], ctx.mesh.size)
        return gx, gw, gb, None, None, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW activations (module
    docstring): float32 ``weight`` (flax's scale) and ``bias``, float32
    ``running_mean`` / ``running_var`` buffers (flax's ``batch_stats``
    ``mean`` / ``var``); the output in the input's dtype.  With ``mesh``
    a training forward uses the moments of the whole global batch."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None, mesh: Mesh | None = None):
        super().__init__()
        self.momentum, self.eps, self.mesh = momentum, eps, mesh
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            if self.mesh is None:
                mean, var = batch_moments(x)
            else:  # flax pmeans E[x] and E[x^2], then forms the variance
                mean, mean_sq = all_reduce_mean(torch.stack(_raw_moments(x)),
                                                self.mesh.data_group)
                var = (mean_sq - mean.square()).clamp_min(0.0)
            if not recomputing():  # a remat region's recompute: moved once already
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        if self.mesh is not None:
            return _NormalizeCrossReplica.apply(x, self.weight, self.bias, mean, var,
                                                self.eps, self.mesh)
        return _NormalizeBatch.apply(x, self.weight, self.bias, mean, var, self.eps)


class _ConvNet(nn.Module):
    """The compute-dtype convolution shared by the blocks and the stem."""

    dtype: torch.dtype

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """The SAME conv in the compute dtype; split on its output channels
        (tensor parallelism), this rank's channels, gathered before the
        BatchNorm and kept channels-last."""
        k, s = conv.kernel_size[0], conv.stride[0]
        x, pad = same_pad(x, k, s)
        w = conv.weight.to(self.dtype, memory_format=torch.channels_last)
        y = tp.conv2d(x, conv, w, None, s, pad)
        if tp.layer_mesh(conv) is not None:
            y = y.contiguous(memory_format=torch.channels_last)
        return y


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, bias=False, device="meta")


class BasicBlock(_ConvNet):
    """conv3x3 -> BN -> relu -> conv3x3 -> BN, plus the (projected)
    residual, then relu.  ``proj`` (1x1, strided) and ``bn_proj`` exist
    when the residual's shape changes."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 bn_momentum: float, mesh: Mesh | None = None):
        super().__init__()
        self.dtype = dtype
        norm = lambda n: BatchNorm(n, bn_momentum, device="meta", mesh=mesh)  # noqa: E731
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = norm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = norm(filters)
        self.has_proj = stride != 1 or cin != filters
        if self.has_proj:
            self.proj = _conv(cin, filters, 1, stride)
            self.bn_proj = norm(filters)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self._conv(self.conv1, x), train))
        y = self.bn2(self._conv(self.conv2, y), train)
        if self.has_proj:
            x = self.bn_proj(self._conv(self.proj, x), train)
        return F.relu(y + x)


class BottleneckBlock(_ConvNet):
    """conv1x1 -> BN -> relu -> conv3x3 (strided) -> BN -> relu -> conv1x1
    (x4 channels) -> BN, plus the (projected) residual, then relu."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype,
                 bn_momentum: float, mesh: Mesh | None = None):
        super().__init__()
        self.dtype = dtype
        norm = lambda n: BatchNorm(n, bn_momentum, device="meta", mesh=mesh)  # noqa: E731
        out = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = norm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = norm(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = norm(out)
        self.has_proj = stride != 1 or cin != out
        if self.has_proj:
            self.proj = _conv(cin, out, 1, stride)
            self.bn_proj = norm(out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self._conv(self.conv1, x), train))
        y = F.relu(self.bn2(self._conv(self.conv2, y), train))
        y = self.bn3(self._conv(self.conv3, y), train)
        if self.has_proj:
            x = self.bn_proj(self._conv(self.proj, x), train)
        return F.relu(y + x)


class ResNet(_ConvNet):
    """Generic ResNet.  ``low_res=True``: the CIFAR stem (3x3 conv, BN,
    relu, no pool); else the 7x7/2 conv, BN, relu and the 3x3/2 max-pool.
    Stage ``i`` has ``stage_sizes[i]`` blocks of ``width * 2**i`` filters,
    its first block strided 2 from stage 1 on.  ``in_channels`` is the
    images' channel count (flax reads it from the first input).
    ``axis_name``: cross-replica BatchNorm over that mesh axis (module
    docstring)."""

    def __init__(self, stage_sizes=(3, 3, 3), block: type = BasicBlock,
                 num_classes: int = 10, width: int = 16, low_res: bool = True,
                 dtype: torch.dtype = torch.bfloat16, bn_momentum: float = 0.9,
                 axis_name: str | None = None, block_remat: bool = False,
                 in_channels: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        mesh = axis_mesh(axis_name) if axis_name is not None else None
        self.block_remat = block_remat
        device = resolve_device(device)
        self.dtype, self.low_res, self.num_classes = dtype, low_res, num_classes
        self.stem = _conv(in_channels, width, 3 if low_res else 7, 1 if low_res else 2)
        self.stem_bn = BatchNorm(width, bn_momentum, device="meta", mesh=mesh)
        self.block_names: list[str] = []
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            filters = width * 2**i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"stage{i}_block{j}"
                self.add_module(name, block(cin, filters, stride, dtype, bn_momentum, mesh))
                self.block_names.append(name)
                cin = filters * block.expansion
        self.logits = nn.Linear(cin, num_classes, device="meta")
        self.to_empty(device=device)
        if device.type != "meta":  # a meta model is shapes only (convert.py, flops)
            self.reset_parameters(_resolve_generator(generator, device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: LeCun truncated-normal convolution and dense
        kernels, a zero dense bias; BatchNorm (1, 0) with running (0, 1)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init_lecun_(m, generator)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) NHWC images in [0, 1] -> (B, num_classes) float32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        x = F.relu(self.stem_bn(self._conv(self.stem, x), train))
        if not self.low_res:
            x, pad = same_pad(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, pad)
        for name in self.block_names:
            block = getattr(self, name)
            x = remat(block, x, train) if self.block_remat else block(x, train)
        x = x.mean((2, 3), dtype=torch.promote_types(self.dtype, torch.float32))
        x = x.to(self.dtype)  # a float32 mean, as jnp.mean of bf16 takes it
        return tp.linear(x, self.logits, self.dtype).float()


# The registry's architectures as ResNet keywords (convert.py reads them too)
ARCHS = {"resnet20": dict(stage_sizes=(3, 3, 3), block=BasicBlock, width=16),
         "resnet50": dict(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock, width=64)}


def ResNet20(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
             axis_name: str | None = None, block_remat: bool = False, **kw) -> ResNet:
    """CIFAR-style ResNet-20: 3 stages x 3 basic blocks, widths 16/32/64."""
    return ResNet(**ARCHS["resnet20"], num_classes=num_classes, low_res=True,
                  dtype=dtype, axis_name=axis_name, block_remat=block_remat, **kw)


def ResNet50(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16,
             axis_name: str | None = None, low_res: bool = True,
             block_remat: bool = False, **kw) -> ResNet:
    """ResNet-50: bottleneck stages [3, 4, 6, 3], width 64 (x4 expansion)."""
    return ResNet(**ARCHS["resnet50"], num_classes=num_classes, low_res=low_res,
                  dtype=dtype, axis_name=axis_name, block_remat=block_remat, **kw)
