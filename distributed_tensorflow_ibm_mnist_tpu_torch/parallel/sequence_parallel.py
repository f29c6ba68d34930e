"""Ulysses all-to-all sequence parallelism over the mesh's ``seq`` axis.

The counterpart of the JAX package's ``parallel/sequence_parallel.py``,
the second long-context strategy beside the ring
(``parallel/ring_attention.py``).  Where the ring keeps the sequence
sharded and rotates K/V, Ulysses re-shards HEADS for the attention:

    (B, S/n, H, D)  --all_to_all-->  (B, S, H/n, D)
        attention over the full sequence for this rank's H/n heads
    (B, S, H/n, D)  --all_to_all-->  (B, S/n, H, D)

over the seq group (:func:`~.collectives.all_to_all`, differentiable: its
backward is the reverse exchange).  The inner kernel (``inner_attn``:
``vanilla_attention`` or the flash kernel) runs unchanged on the full
sequence, so a sliding ``window`` passes straight through to it.  Needs
``H % n == 0`` and ``H_kv % n == 0``; where they or the sequence do not
divide, :meth:`~.ring_attention.SeqParallelAttention.local_span` is None
and the model runs ``inner_attn`` on the whole sequence, as JAX's
callable falls back (``sequence_parallel.py:82-95`` there).

As the ring's, the callable takes this rank's (B_local, S_local, H, D)
shards (``parallel/ring_attention.py``'s module docstring: the layout).
q, k and v go out in one exchange when they share a head count (K and V
in one under GQA), the output in one more.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import all_to_all
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
    SeqParallelAttention,
    vanilla_attention,
)


def _to_heads(xs, group) -> list[torch.Tensor]:
    """Seq-sharded (B, S/n, H, D) tensors of one head count -> head-sharded
    (B, S, H/n, D): split the heads over the axis, gather the sequence, all
    of them in one all-to-all."""
    packed = all_to_all(torch.stack(xs, dim=2), split_axis=3, concat_axis=1, group=group)
    return list(packed.unbind(2))


def _ulysses_local(q, k, v, group, n: int, causal: bool, inner_attn: Callable,
                   window: int = 0):
    """This rank's (B, S_local, H, D) shards -> head-sharded full-sequence
    attention -> (B, S_local, H, D)."""
    for name, x in (("heads", q), ("heads_kv", k)):
        if x.shape[2] % n:
            raise ValueError(
                f"Ulysses splits {name} ({x.shape[2]}) over the seq axis ({n} ranks); "
                "they must divide (the model takes the unsharded path for such shapes)")
    if k.shape[2] == q.shape[2]:
        q_h, k_h, v_h = _to_heads([q, k, v], group)
    else:
        (q_h,), (k_h, v_h) = _to_heads([q], group), _to_heads([k, v], group)
    kw = {"window": window} if window else {}
    out = inner_attn(q_h, k_h, v_h, causal=causal, **kw)
    return all_to_all(out, split_axis=1, concat_axis=2, group=group)


def make_ulysses_attention(mesh: Mesh, causal: bool = False,
                           inner_attn: Callable = vanilla_attention,
                           window: int = 0) -> SeqParallelAttention:
    """``attn(q, k, v)`` with the sequence sharded over the mesh's seq axis,
    on this rank's (B_local, S_local, H, D) shards, as
    :func:`~.ring_attention.make_ring_attention`'s.  ``inner_attn(q, k, v,
    causal=..., [window=...])`` runs on the full sequence with this rank's
    head slice; ``window`` passes through to it."""
    group, n = mesh.seq_group, mesh.seq_size
    kw = {"window": window} if window else {}
    if n == 1:  # one rank holds every head and the whole sequence already
        fn = functools.partial(inner_attn, causal=causal, **kw)
    else:
        fn = functools.partial(_ulysses_local, group=group, n=n, causal=causal,
                               inner_attn=inner_attn, window=window)
    # the same inner kernel as the sharded path, just unsharded: the
    # implementation must not switch with the shape
    dense = functools.partial(inner_attn, causal=causal, **kw)
    return SeqParallelAttention(mesh, fn, dense, split_heads=True)
