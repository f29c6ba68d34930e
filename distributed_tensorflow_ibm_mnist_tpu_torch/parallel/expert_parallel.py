"""Mixture-of-experts FFN of the port: Switch top-1 and GShard top-k
routing with per-expert capacity, the experts local to one device.

The counterpart of the JAX package's ``parallel/expert_parallel.py``:
``expert_capacity``, ``_route``, ``_expert_ffn``, ``_aux_loss``,
``moe_ffn_local`` and the ``MoEBlock`` module (parameters ``router (D,
E)``, ``w1 (E, D, H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)`` in
float32, flax's layout, so converted weights pass as they are).

Routing follows JAX's exactly: the router logits ``x @ router`` in float32
(a bf16 ``x`` is promoted, as JAX promotes it), the softmax, the top-k
probabilities; the gate is the raw top-1 probability (Switch) or the top-k
probabilities renormalised over the k choices (GShard).  Buffer slots are
given in CHOICE-PRIORITY order: every first choice fills before any second
choice, each choice in token order, slot = the running count of that
expert's assignments so far.  An assignment whose slot is past the
capacity is dropped (counted in ``stats["dropped"]``).  The load-balancing
fractions come from the primary choice; ``stats["z"]`` is the mean squared
float32 logsumexp of the logits.

The dispatch differs from JAX's in form, not in value.  JAX builds
one-hot ``(T, E, C)`` dispatch and combine tensors and moves tokens with
two einsums (shaped for the TPU's matrix unit).  At the training shapes
those tensors are tens of GB (T = 65536, E = 8, C = 32768: 68.7 GB each), so
the port never builds them: each kept assignment's ``(expert, slot)`` is an
index, the tokens are copied into the ``(E, C, D)`` buffers, and the
combine gathers each token's k expert outputs back and sums ``gate * y``.
A slot holds at most one token and a token has at most k terms, so in
float32 the gather equals the one-hot einsum exactly and the combine's
sum is the einsum's (exactly for k <= 2).  Empty slots run through the
FFN (their ``b1``/``b2`` path) with combine weight 0, as in JAX.

Expert parallelism over the ``data`` mesh (``make_moe_dispatch``, JAX's
shard_map island, in its order): with ``E`` experts over ``A`` ranks each
rank owns ``E/A`` of them (``moe_expert_rule``: the rows of ``w1``/``b1``/
``w2``/``b2``; the router stays replicated) and routes its own tokens to
all ``E``; the same index dispatch fills its ``(E, C, D)`` float32
capacity buffers (``C`` a (rank, expert) pair), one
``collectives.all_to_all`` turns them into ``(E/A, A*C, D)``, the local
experts' FFN runs on every rank's tokens, the reverse all-to-all brings
the outputs home and the combine gathers them.  The routing fractions and
the stats are averaged across ranks BEFORE the aux product, so the aux
loss is exactly the global one (JAX ``expert_parallel.py:129-172``).
Both exchanges and the mean are differentiable: the gradient of an expert
row sums every rank's tokens on the rank that owns it, which
``parallel.fsdp.ShardPlan`` scales by 1/A instead of all-reducing.
``make_moe_dispatch_auto`` sizes the capacity from the token count of
each call (the trainer's hook) and runs ``moe_ffn_local`` on one rank.
The exchange runs over the mesh's data group: under tp and sp the ranks
that share this rank's model and seq index, every model rank of a data
row routing the same (bit-equal) tokens and running the same exchange.

Beside sequence parallelism a rank holds a slice of each sequence, but
JAX routes over the whole sequence: its island takes ``x`` as ``P("data",
None)``, so GSPMD gathers the sequence over ``seq`` and every seq device
runs the whole data shard's MoE.  The port does the same explicitly:
``MoEBlock(x, seq_group=)`` gathers the seq group's slices
(``collectives.gather_tokens``, whose backward sums each slice's
gradient back), routes the whole sequence's tokens in JAX's order (``b *
S + j``; every first choice before any second), capacity sized from its
``B * S`` tokens, and keeps this rank's slice of the output.  The aux
loss and the stats are then the whole sequence's on every seq rank, as
JAX's are.  (Gathering only the routing counts and scanning them would
move less, but the experts would still run on whole ``(E, C, D)``
buffers; the gather keeps one routing code path.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
import torch.nn.functional as F

from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import _TRUNC_STD
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_reduce_mean,
    all_to_all,
    axis_index,
    gather_tokens,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import P


def expert_capacity(n_tokens: int, n_experts: int, factor: float = 1.25) -> int:
    """Per-expert buffer size for ``n_tokens`` routed across ``n_experts``."""
    return max(1, int(n_tokens * factor / n_experts))


class Routing(NamedTuple):
    """Where each of a token's k assignments goes, choice by choice:
    ``expert``, ``slot`` (its position in that expert's buffer) and
    ``keep`` (False: dropped at capacity), each (T, k); ``gates`` (T, k)
    float32 combine weights (a dropped choice's gate still stands: it
    simply meets no output)."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor


def _route(x: torch.Tensor, w_router: torch.Tensor, n_experts: int, capacity: int,
           top_k: int = 1):
    """Top-k routing of ``x`` (T, D) -> ``(Routing, (frac_tokens,
    frac_probs), stats)``; ``stats`` = ``{"dropped": fraction of the T * k
    assignments with no slot, "z": mean squared logsumexp}`` (module
    docstring)."""
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k must be in [1, n_experts={n_experts}], got {top_k}")
    t = x.shape[0]
    logits = x.float() @ w_router.float()  # (T, E) float32, as JAX promotes
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)  # (T, k)
    if top_k == 1:
        gates = topk_probs  # Switch: the raw router probability
    else:
        gates = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
    experts = torch.arange(n_experts, device=x.device)[:, None]
    counts = torch.zeros((n_experts, 1), dtype=torch.long, device=x.device)
    slots, keeps = [], []
    for c in range(top_k):  # choice priority: all c-th choices before c+1
        # (E, T): the scan runs along the contiguous token axis
        onehot = (topk_idx[:, c][None, :] == experts).long()
        pos = onehot.cumsum(1) - 1 + counts  # running count per expert
        slot = pos.gather(0, topk_idx[None, :, c])[0]
        keep = slot < capacity
        counts = counts + (onehot * keep[None, :]).sum(1, keepdim=True)
        slots.append(slot)
        keeps.append(keep)
    keep = torch.stack(keeps, 1)
    frac_tokens = F.one_hot(topk_idx[:, 0], n_experts).float().mean(0)
    frac_probs = probs.mean(0)
    stats = {"dropped": 1.0 - keep.sum().float() / (t * top_k),
             "z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    routing = Routing(topk_idx, torch.stack(slots, 1), keep, gates)
    return routing, (frac_tokens, frac_probs), stats


def _expert_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN on ``x`` (E, C, D) with per-expert stacked
    parameters: ``w1``/``b1``, GELU (tanh form, flax's), ``w2``/``b2``."""
    h = torch.bmm(x, params["w1"]) + params["b1"][:, None]
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w2"]) + params["b2"][:, None]


def _aux_loss(frac_tokens: torch.Tensor, frac_probs: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch load-balancing loss: E x sum(frac_tokens * frac_probs)."""
    return n_experts * torch.sum(frac_tokens * frac_probs)


def _dispatch(x: torch.Tensor, r: Routing, n_experts: int, capacity: int):
    """The kept tokens copied into the ``(E, C, D)`` float32 expert buffers
    (empty slots zero), and each assignment's flat slot index ``(T, k)``:
    ``E * C`` (a trash row past every slot) for a dropped one.  A scatter
    (``index_copy``): its backward is a gather, with no accumulation into
    a row that many slots share (the empty slots, the dropped
    assignments), which serialises on the card."""
    t, d = x.shape
    k = r.expert.shape[1]
    trash = n_experts * capacity
    flat = torch.where(r.keep, r.expert * capacity + r.slot, trash)  # (T, k)
    # only the trash row is written more than once, and it is never read
    buf = x.new_zeros((trash + 1, d), dtype=torch.float32).index_copy(
        0, flat.reshape(-1), x.float().repeat_interleave(k, dim=0))
    return buf[:trash].view(n_experts, capacity, d), flat


def _combine(expert_out: torch.Tensor, flat: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each token's ``sum_c gate_c * y[slot_c]`` over its k assignments
    (a dropped one reads the zero trash row), float32 (T, D).  The gather
    is an ``index_select``, whose backward adds each slot's gradient once
    (the shared trash row's by atomics, and it is discarded)."""
    t, k = flat.shape
    d = expert_out.shape[-1]
    y = expert_out.reshape(-1, d)
    y_pad = torch.cat([y, y.new_zeros((1, d))])
    picked = y_pad.index_select(0, flat.reshape(-1)).view(t, k, d)
    return (picked * gates[..., None]).sum(1)  # (T, k, D) -> (T, D)


def moe_ffn_local(params: dict, x: torch.Tensor, n_experts: int, capacity: int,
                  top_k: int = 1):
    """Single-device MoE forward: ``x`` (T, D) -> ``(out (T, D) in
    x.dtype, aux_loss, stats)`` with ``stats`` = ``{"dropped", "z"}``.
    Routing, the experts and the combine run in float32."""
    r, fracs, stats = _route(x, params["router"], n_experts, capacity, top_k)
    expert_in, flat = _dispatch(x, r, n_experts, capacity)
    out = _combine(_expert_ffn(params, expert_in), flat, r.gates)
    return out.to(x.dtype), _aux_loss(*fracs, n_experts), stats


def make_moe_dispatch(mesh, n_experts: int, capacity: int, axis_name: str = "data",
                      top_k: int = 1):
    """The expert-parallel MoE forward over ``mesh``'s ``axis_name`` (its
    data group): ``moe(params, x) -> (out, aux, stats)`` with ``x`` this
    rank's (T, D) tokens, ``params["router"]`` whole and
    ``w1``/``b1``/``w2``/``b2`` this rank's ``n_experts / A`` expert rows;
    ``capacity`` is per (rank, expert) pair.  A collective: every rank
    calls it with the same ``capacity``."""
    if axis_name != "data":
        raise ValueError(f"expert parallelism runs over the 'data' axis, not {axis_name!r}")
    a = mesh.shape[axis_name]
    if n_experts % a:
        raise ValueError(f"n_experts={n_experts} not divisible by |{axis_name}|={a}")
    group = mesh.data_group

    def moe(params: dict, x: torch.Tensor):
        r, fracs, stats = _route(x, params["router"], n_experts, capacity, top_k)
        expert_in, flat = _dispatch(x, r, n_experts, capacity)
        # (E, C, D) -> (E/A, A*C, D): expert block j of every rank lands on rank j
        expert_in = all_to_all(expert_in, split_axis=0, concat_axis=1, group=group)
        expert_out = _expert_ffn(params, expert_in)
        # the reverse: (E/A, A*C, D) -> (E, C, D), each rank's buffers home
        expert_out = all_to_all(expert_out, split_axis=1, concat_axis=0, group=group)
        out = _combine(expert_out, flat, r.gates)
        # global fractions first, THEN the product: the exact global aux
        fracs = all_reduce_mean(list(fracs), group)
        stats = dict(zip(stats, all_reduce_mean(list(stats.values()), group)))
        return out.to(x.dtype), _aux_loss(*fracs, n_experts), stats

    return moe


def make_moe_dispatch_auto(mesh, n_experts: int, capacity_factor: float = 2.0,
                           axis_name: str = "data", top_k: int = 1):
    """The trainer's expert-parallel hook: the capacity is sized per call
    from this rank's token count (``expert_capacity(T * top_k, E,
    capacity_factor)``, T the rank's tokens, as JAX sizes it from the
    global count over A); a mesh of one rank, or experts that do not divide
    over it, run ``moe_ffn_local``."""
    a = mesh.shape[axis_name]

    def moe(params: dict, x: torch.Tensor):
        cap = expert_capacity(x.shape[0] * top_k, n_experts, capacity_factor)
        if a == 1 or n_experts % a:
            return moe_ffn_local(params, x, n_experts, cap, top_k)
        return make_moe_dispatch(mesh, n_experts, cap, axis_name, top_k)(params, x)

    return moe


def moe_expert_rule(axis: str = "data", marker: str = "moe"):
    """Spec rule splitting the expert-stacked leaves (``w1``/``b1``/``w2``/
    ``b2`` under a ``moe`` module) over ``axis`` along the expert dim: each
    rank owns its experts' weights, and their moments with them; the
    router stays replicated."""
    targets = {"w1", "b1", "w2", "b2"}

    def rule(path: tuple[str, ...], leaf) -> P:
        if marker in path and path[-1] in targets and getattr(leaf, "ndim", 0) >= 1:
            return P(axis, *([None] * (leaf.ndim - 1)))
        return P()

    return rule


@torch.no_grad()
def _lecun_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` on ``p``: truncated normal, std
    fan_in^-1/2 / 0.8796, cut at two std."""
    std = fan_in ** -0.5 / _TRUNC_STD
    w = torch.empty(p.shape, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(w)


class MoEBlock(nn.Module):
    """MoE FFN on (B, S, D) activations: ``forward(x)``
    -> ``(out (B, S, D), aux, stats)``, with the Switch load-balancing
    ``aux`` loss and ``stats`` = ``{"dropped", "z"}`` (raw; the caller
    weights ``z`` by ``z_weight``).  Capacity is sized per call for that
    call's B * S tokens: ``expert_capacity(B * S * top_k, n_experts,
    capacity_factor)``.  Parameters are float32 in every model (JAX's
    decode cast exempts them); flax's init: ``lecun_normal`` on the router
    and on the stacked ``w1``/``w2``, whose fan-in counts the expert axis
    (E * D for ``w1``, E * H for ``w2``, as flax's ``variance_scaling``
    reads a 3-D kernel), zero biases.  ``ep_fn`` (``make_moe_dispatch_auto``
    or a user's ``moe_fn``, ``ep_fn(params, tokens) -> (out, aux, stats)``)
    runs it expert-parallel; None computes every expert locally.
    ``forward(x, seq_group=)`` routes the whole sequences of a seq
    group's slices (module docstring)."""

    def __init__(self, dim: int, n_experts: int = 8, hidden_mult: int = 4,
                 capacity_factor: float = 2.0, top_k: int = 1, z_weight: float = 0.0,
                 ep_fn=None, device=None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k must be in [1, n_experts={n_experts}], got {top_k}")
        h = hidden_mult * dim
        self.dim, self.n_experts, self.hidden = dim, n_experts, h
        self.capacity_factor, self.top_k, self.z_weight = capacity_factor, top_k, z_weight
        self.ep_fn = ep_fn
        f32 = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty(dim, n_experts, **f32))
        self.w1 = nn.Parameter(torch.empty(n_experts, dim, h, **f32))
        self.b1 = nn.Parameter(torch.empty(n_experts, h, **f32))
        self.w2 = nn.Parameter(torch.empty(n_experts, h, dim, **f32))
        self.b2 = nn.Parameter(torch.empty(n_experts, dim, **f32))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_(self.router, self.dim, generator)
        _lecun_(self.w1, self.n_experts * self.dim, generator)
        _lecun_(self.w2, self.n_experts * self.hidden, generator)
        self.b1.zero_()
        self.b2.zero_()

    def params(self) -> dict:
        return {"router": self.router, "w1": self.w1, "b1": self.b1,
                "w2": self.w2, "b2": self.b2}

    def capacity(self, n_tokens: int) -> int:
        return expert_capacity(n_tokens * self.top_k, self.n_experts, self.capacity_factor)

    def forward(self, x: torch.Tensor, seq_group=None):
        """``seq_group``: ``x`` is this rank's slice of each sequence, the
        group's ranks holding the slices in order; the whole sequences are
        gathered and routed, and this rank's slice of the output returned
        (module docstring)."""
        b, s, d = x.shape
        lo = 0
        if seq_group is not None:
            lo = axis_index(seq_group) * s
            x = gather_tokens(x, 1, seq_group)
        whole = x.shape[1]
        tokens = x.reshape(b * whole, d)
        if self.ep_fn is not None:
            out, aux, stats = self.ep_fn(self.params(), tokens)
        else:
            out, aux, stats = moe_ffn_local(self.params(), tokens, self.n_experts,
                                            self.capacity(b * whole), self.top_k)
        return out.reshape(b, whole, d)[:, lo:lo + s], aux, stats


__all__ = ["MoEBlock", "Routing", "expert_capacity", "make_moe_dispatch",
           "make_moe_dispatch_auto", "moe_expert_rule", "moe_ffn_local"]
