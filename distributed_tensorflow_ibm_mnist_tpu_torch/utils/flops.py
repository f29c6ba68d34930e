"""FLOPs accounting + MFU (model FLOPs utilization) for the port.

The JAX package takes a training epoch's FLOPs from XLA's cost analysis of
the compiled program.  PyTorch runs eagerly and has no compiled program to
ask, so the port counts analytically from the layer shapes: 2 FLOPs per
multiply-accumulate of every convolution and dense layer (SAME convolutions
counted at every output position), forward only, times 3 for a training
step (forward + two backward products).  Pooling, activations, dropout, the
loss and the optimizer are left out.  The two counts therefore differ a
little: XLA's includes the elementwise work, this one does not.

MFU's denominator is the card's dense bf16 peak, looked up by the name
``torch.cuda.get_device_name`` reports (longest matching entry), or
``$DTM_PEAK_TFLOPS``.  Off the table, and on the CPU, MFU is None.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

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


def model_flops_per_image(model: str, model_kwargs: dict, num_classes: int,
                          in_features: int) -> float:
    """Analytic FLOPs of one training image for a registry model name."""
    if model == "lenet5":
        return lenet5_flops_per_image(num_classes)
    if model == "mlp":
        return mlp_flops_per_image(model_kwargs.get("hidden", (256,)), num_classes,
                                   in_features)
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
