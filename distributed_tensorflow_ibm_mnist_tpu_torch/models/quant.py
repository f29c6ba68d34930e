"""Weight-only int8 quantization for the port's serving path.

The counterpart of the JAX package's ``models/quant.py``.  Every 2-D
weight of a projection the JAX rule names (``qkv``, ``q_proj``,
``kv_proj``, ``proj``, ``dense_<i>``, ``logits``, ``fc<i>``) is stored
int8 with a symmetric per-OUTPUT-channel float32 scale:
``scale[o] = max(max_i |W[o, i]|, 1e-8) / 127`` and ``W_q = round(W /
scale)`` (half to even), both in float32.  ``nn.Linear`` keeps its weight
(out, in) where flax keeps its kernel (in, out), so the port's scale is
the amax over dim 1 where JAX's is over axis 0; on converted weights the
int8 values and the scales are bit-equal to JAX's.

Embeddings, norms and biases are not quantized (a tied head reads the
full-precision embedding).  :class:`Int8Linear` computes as JAX's
``Int8Dense``: the input in the compute dtype against the int8 weight as
that dtype, accumulated in float32, then ``* scale + bias`` in float32 and
one cast to the compute dtype.  The weight is dequantized eagerly (a
float32 copy per call); a fused int8 GEMM is later speed work.

Under tensor parallelism (``parallel.tensor_parallel.TPPlan`` cuts the
quantized model, as JAX shards its quantized tree, ``models/quant.py:14-33``
there): a column layer holds its block of the int8 rows with their
per-output scales and bias; a row layer holds its block of the columns and
the whole scale, applied after the partial sums are reduced over the model
group (a per-output factor is uniform over the contraction, so it passes
through the sum).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import column, row

# the module names whose 2-D weight is quantized (JAX's rule, copied)
_QUANT_MODULE = re.compile(r"qkv|q_proj|kv_proj|proj|dense_\d+|logits|fc\d*")


def quantize_kernel_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> ((out, in) int8, (out,) float32 scale), symmetric
    per output channel (floored so an all-zero row quantizes to zeros)."""
    wf = w.detach().float()
    scale = wf.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale[:, None]).to(torch.int8)
    return q, scale


def _quant_module(key: str) -> str | None:
    """The module path of a quantizable ``<path>.weight`` key, else None."""
    if not key.endswith(".weight"):
        return None
    path = key[: -len(".weight")]
    return path if _QUANT_MODULE.fullmatch(path.rsplit(".", 1)[-1]) else None


def quantize_state_dict_int8(state: dict) -> dict:
    """A ``state_dict`` -> the quant model's: every 2-D weight of a
    quantizable module becomes int8 with a ``<module>.scale`` sibling;
    every other entry passes through.  Idempotent: an int8 weight (with
    its scale) passes as it is."""
    out = {}
    for key, value in state.items():
        path = _quant_module(key)
        if path is None or value.ndim != 2:
            out.setdefault(key, value)
            continue
        if value.dtype == torch.int8:
            out[key] = value
            continue
        out[key], out[f"{path}.scale"] = quantize_kernel_int8(value)
    return out


def is_quantized(state: Mapping) -> bool:
    """True when ``state`` holds an int8 weight with its scale sibling: a
    ``state_dict`` (``<module>.weight`` and ``<module>.scale``) or a flax
    params tree of numpy leaves (a module's ``kernel`` and ``scale``)."""
    for key, value in state.items():
        if isinstance(value, Mapping):
            kern = value.get("kernel")
            if (getattr(kern, "dtype", None) == np.int8 and "scale" in value) \
                    or is_quantized(value):
                return True
        elif (key.endswith(".weight") and value.dtype == torch.int8
              and f"{key[:-len('.weight')]}.scale" in state):
            return True
    return False


def weight_stream_bytes(state: dict) -> int:
    """Bytes of every tensor in ``state``: what a decode step reads of the
    weights (int8 weights 1 byte an element, their scales 4)."""
    return sum(t.nbytes for t in state.values())


class Int8Linear(nn.Module):
    """``nn.Linear`` with an int8 weight (out, in), a float32 per-output
    scale (a buffer) and a float32 bias: ``(x @ W_q^T) * scale + bias`` in
    float32, cast to ``dtype``.  Built with zero weights and unit scales;
    real values arrive quantized (:func:`quantize_state_dict_int8`)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        self.weight = nn.Parameter(
            torch.zeros((out_features, in_features), dtype=torch.int8, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device),
                                 requires_grad=False)
        self.register_buffer("scale", torch.ones(out_features, device=device))

    def _product(self, x):
        return F.linear(x.to(self.dtype).float(), self.weight.float())

    def forward(self, x, entered: bool = False, local: bool = False):
        """The whole layer; split (``tp_dim``/``tp_mesh``, set by
        ``TPPlan.shard``) a column on the generic path (its output gathered)
        or, with ``local``, half of a Megatron pair, as
        ``tensor_parallel.linear``; ``entered``: ``x`` already passed
        ``copy_to_model``."""
        mesh = getattr(self, "tp_mesh", None)
        if mesh is not None and self.tp_dim == 0:
            return column(x, lambda h: (self._product(h) * self.scale + self.bias
                                        ).to(self.dtype),
                          mesh, entered=entered, gather=not local)
        y = self._product(x) if mesh is None else row(x, self._product, mesh, local=local)
        return (y * self.scale + self.bias).to(self.dtype)
