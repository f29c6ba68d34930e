"""GPipe pipeline parallelism over the mesh's ``pipe`` axis.

The counterpart of the JAX package's ``parallel/pipeline.py``.  JAX runs
the pipeline as one SPMD program: every device holds its slice of the
stage-stacked parameters, a ``lax.scan`` over ``M + N - 1`` ticks streams M
microbatches through N stages, each tick ends with a ``ppermute`` round
the whole ring, and ``jax.grad`` of the scan is the GPipe backward.  A port
rank is a process, so the port writes that schedule out across processes:

* **Ticks and hops.**  Stage ``p`` (the rank at ``pipe_index = p``) runs
  its own blocks on microbatch ``t - p`` at tick ``t`` when ``0 <= t - p <
  M``, and hands the result to stage ``p + 1`` by one point-to-point send
  (``collectives.stage_hop``: ``batch_isend_irecv``, host-staged under
  gloo).  A bubble tick launches nothing, and no hand-off leaves the last
  stage: JAX computes its bubbles on clamped inputs and masks them out,
  and its ring's wrap-around hop carries nothing any stage reads, so the
  values are the same.
* **The backward** is one ``torch.autograd.Function`` (:class:`_Pipeline`),
  so every rank runs the same hops in the same order whatever its loss
  reads: the reverse ticks, each receiving dY from stage ``p + 1``,
  back-propagating this stage's saved graph of that microbatch and sending
  dX to stage ``p - 1``.  (Separate differentiable hops would drop out of
  the backward on the ranks whose loss does not read them, stage 0's
  receive above all, and the point-to-point pairs would then deadlock or
  pair the wrong messages.)  ``remat=True`` keeps only each microbatch's
  stage input and recomputes the stage in the backward.
* **The output**: the last stage's microbatches, in order, broadcast to
  every pipe rank (``collectives.broadcast_from_root``; JAX's
  ``broadcast``), whose backward hands the last stage its own cotangent
  once: every rank runs the head and the loss on the same values, so
  every rank's cotangent is the same.
* **Gradients**: a stage's leaves get theirs on their own rank.  A leaf
  outside the stages (the embedding, the patch projection, the head) is
  replicated over ``pipe``; stage 0 alone sees the gradient that reaches
  it through the pipeline's input, so every pipe rank takes stage 0's
  gradient of such a leaf (:meth:`PipePlan.reduce_grads`, one bucketed
  broadcast; the head's part is the same on every rank, so this counts it
  once, tied embeddings included).  Then the gradients are averaged over
  the replica group (the ``dp`` ranks of one ``(model_index,
  pipe_index)``), and the clip's global norm counts each stage leaf once
  (summed over ``pipe``) and each replicated leaf once.

:class:`PipePlan` is the state's plan at pp > 1 (``core.state``'s
interface, as ``tensor_parallel.TPPlan``): each rank holds its own stage's
blocks (``StackedBlocks.keep_stage``, JAX's ``pipeline_block_rule``) and
their optimizer moments; with tp > 1 inside the stages a ``TPPlan`` cuts
them further to this model rank's Megatron blocks.  The whole form
(checkpoints, decode, the converter) gathers every stage over ``pipe``, so
a pp checkpoint resumes at any pp.

The functional API keeps JAX's names and its tensors' form:
:func:`stack_stage_params`, :func:`make_pipeline_apply` over a stacked
tree (each rank takes its stage's slice, and under ``param_specs`` its
model block of it), and the pp x tp helpers :func:`permute_qkv_head_major`,
:func:`permute_kv_shard_major`, :func:`tp_stage_specs` and
:func:`make_tp_block_stage_fn` (flax-layout stage trees run through the
port's ``TransformerBlock`` as Megatron pairs), and
:func:`pipeline_block_rule`.
"""

from __future__ import annotations

import contextlib
import copy
from collections.abc import Mapping, Sequence
from typing import Any, Callable

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_reduce_sum,
    broadcast,
    broadcast_from_root,
    flatten_buckets,
    grouped_all_reduce_mean,
    make_bucket_layout,
    stage_hop,
    unflatten_buckets,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import (
    P,
    TPPlan,
    _tree_leaves,
    _tree_map,
    chain_rules,
    megatron_rule,
    model_param_specs,
)

AXIS = "pipe"
STAGE_PREFIX = "pipe_blocks.stages."  # the parameter names of the stage blocks


# ---------------------------------------------------------------- trees


def _leaf_at(tree, path: tuple):
    """The leaf of a nested mapping / sequence at ``path``."""
    for key in path:
        tree = tree[key] if isinstance(tree, Mapping) else tree[int(key)]
    return tree


def _tree_fill(tree, leaves: list):
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return _tree_map(lambda _, __: next(it), tree)


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack N congruent per-stage parameter trees (nested mappings of
    tensors) along a new leading axis: leaf shape ``(N, ...)``, one slice a
    stage, the tree :func:`make_pipeline_apply` takes."""
    return _tree_map(lambda path, _: torch.stack([_leaf_at(t, path) for t in per_stage_params]),
                     per_stage_params[0])


# ---------------------------------------------------------------- the schedule


class _Schedule:
    """One pipeline call's constants: ``fn(params, h)`` (this stage's
    computation), the pipe group, this stage's place ``p`` of ``n``, ``m``
    microbatches, whether the backward recomputes the stage and whether a
    backward follows at all (``grad``: without one, as in eval and init,
    the forward keeps no graph and no stage input)."""

    def __init__(self, fn: Callable, group, n: int, p: int, m: int, remat: bool,
                 grad: bool = True):
        self.fn, self.group, self.n, self.p, self.m, self.remat = fn, group, n, p, m, remat
        self.grad = grad

    def runs(self, t: int) -> bool:
        """Whether this stage computes at tick ``t`` (not a bubble)."""
        return 0 <= t - self.p < self.m

    def hop(self, send, to_next: bool, like, t_recv_runs: bool):
        """The hand-off after a tick: ``send`` one place on (``to_next``: up
        the pipe, else down), and receive the tensor the neighbour on the
        other side sends (when ``t_recv_runs``)."""
        step = 1 if to_next else -1
        to, frm = self.p + step, self.p - step
        send = send if send is not None and 0 <= to < self.n else None
        like = like if t_recv_runs and 0 <= frm < self.n else None
        return stage_hop(send, to, like, frm, self.group)


def _live(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors a stage's graph is built on: a leaf parameter itself (the
    modules use it), any other tensor as a new leaf of its values."""
    return [q if q.is_leaf else q.detach().requires_grad_(q.requires_grad) for q in params]


def _check_width(out: torch.Tensor, inp: torch.Tensor) -> None:
    if out.shape != inp.shape or out.dtype != inp.dtype:
        raise ValueError(
            f"a pipeline stage must keep its activation's shape and dtype (equal-width "
            f"stages): {tuple(inp.shape)} {inp.dtype} in, {tuple(out.shape)} {out.dtype} out")


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one stage (module docstring): forward ticks,
    then, in its backward, the reverse ticks with the same hops."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *params):
        ctx.sched = sched
        n, p, m = sched.n, sched.p, sched.m
        mbs = x.chunk(m)
        like = mbs[0]
        live = _live(params)
        ctx.live, ctx.like, ctx.x_shape = live, like, x.shape
        inputs: list = [None] * m
        graphs: list = [None] * m
        outs: list = []
        buf = None
        for t in range(m + n - 1):
            j, out = t - p, None
            if sched.runs(t):
                inp = (mbs[j] if p == 0 else buf).detach()
                if not sched.grad:
                    out = sched.fn(live, inp)
                elif sched.remat:
                    inputs[j] = inp
                    out = sched.fn(live, inp)
                else:
                    with torch.enable_grad():
                        leaf = inp.requires_grad_(True)
                        out = sched.fn(live, leaf)
                    inputs[j], graphs[j] = leaf, out
                    out = out.detach()
                _check_width(out, inp)
                if p == n - 1:
                    outs.append(out)
            buf = sched.hop(out, True, like, sched.runs(t + 1))
        ctx.inputs, ctx.graphs = inputs, graphs
        if p == n - 1:
            return torch.cat(outs)
        return x.new_empty(x.shape)  # the broadcast from the last stage fills it

    @staticmethod
    def backward(ctx, gy):
        sched = ctx.sched
        n, p, m = sched.n, sched.p, sched.m
        live, like = ctx.live, ctx.like
        g_out = gy.chunk(m) if p == n - 1 else None
        want = [q for q in live if q.requires_grad]
        grads: list = [None] * len(want)
        gx: list = [None] * m
        gbuf = None
        for t in reversed(range(m + n - 1)):
            j, g_in = t - p, None
            if sched.runs(t):
                g = (g_out[j] if p == n - 1 else gbuf).contiguous()
                leaf, out = ctx.inputs[j], ctx.graphs[j]
                if sched.remat:
                    with torch.enable_grad():
                        leaf = leaf.requires_grad_(True)
                        out = sched.fn(live, leaf)
                gs = torch.autograd.grad(out, [leaf, *want], g, allow_unused=True)
                ctx.inputs[j] = ctx.graphs[j] = None
                g_in = gs[0]
                for k, gk in enumerate(gs[1:]):
                    if gk is not None:
                        grads[k] = gk if grads[k] is None else grads[k] + gk
                if p == 0:
                    gx[j] = g_in
            gbuf = sched.hop(g_in, False, like, sched.runs(t - 1))
        ctx.live = ctx.inputs = ctx.graphs = None
        it = iter(grads)
        out = []
        for q in live:
            g = next(it) if q.requires_grad else None
            out.append(torch.zeros_like(q) if g is None and q.requires_grad else g)
        dx = None
        if ctx.needs_input_grad[1]:
            dx = torch.cat(gx) if p == 0 else gy.new_zeros(ctx.x_shape)
        return (None, dx, *out)


def run_pipeline(fn: Callable, params: Sequence[torch.Tensor], x: torch.Tensor, mesh,
                 n_microbatches: int, remat: bool = False) -> torch.Tensor:
    """``x`` (this data row's batch, the same on every pipe rank) through
    the stages: ``fn(params, h)`` is this rank's stage on ``params`` (the
    tensors its graph reads; leaf parameters are used as they are), the
    last stage's result is broadcast to every pipe rank.  Differentiable
    in ``x`` and ``params``; the batch must divide by ``n_microbatches``."""
    m = int(n_microbatches)
    if m < 1 or x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_microbatches={m}")
    n = mesh.pipe_size
    if n == 1:
        return fn(list(params), x)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or any(q.requires_grad for q in params))
    sched = _Schedule(fn, mesh.pipe_group, n, mesh.pipe_index, m, remat, grad)
    if grad:
        y = _Pipeline.apply(sched, x, *params)
    else:
        with torch.no_grad():
            y = _Pipeline.forward(_NoCtx(), sched, x, *params)
    return broadcast_from_root(y, n - 1, mesh.pipe_group)


class _NoCtx:
    """A stand-in ``ctx`` for a forward that no backward follows."""

    needs_input_grad = ()


def pad_to_microbatches(fn: Callable, x: torch.Tensor, m: int) -> torch.Tensor:
    """``fn`` on ``x`` zero-padded to a multiple of ``m`` rows, the result
    cut back to ``x``'s rows: the pipeline's form of JAX's fallback for a
    batch that does not divide (init samples, eval remainders), whose rows
    are independent through the blocks, so the values are the same."""
    rows = x.shape[0]
    pad = -rows % m
    if pad == 0:
        return fn(x)
    return fn(torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]))[:rows]


def make_pipeline_apply(stage_fn: Callable, mesh, n_microbatches: int,
                        axis_name: str = AXIS, remat: bool = False,
                        batch_axis: str | None = None, param_specs=None):
    """Build ``apply(stage_params, x) -> y`` streaming ``x`` through the
    stages (JAX's ``make_pipeline_apply``, in the port's form):

    * ``stage_fn(params, x) -> y``: one stage's computation on its tree of
      parameters; activations keep one shape and dtype through the pipeline.
    * ``stage_params``: the stacked tree (:func:`stack_stage_params`, leaves
      ``(n_stages, ...)``), the same on every rank; each rank runs its
      stage's slice ``[pipe_index]``, and with ``param_specs``
      (:func:`tp_stage_specs`) its model block of each leaf the spec splits
      over ``model`` (a contiguous 1/tp of that dim, as JAX's spec gives
      it), for a ``stage_fn`` doing the matching collectives
      (:func:`make_tp_block_stage_fn`).  Gradients reach the stacked leaves
      through the slices: a rank's are nonzero on its own stage only.
    * ``x``: ``(batch, ...)``; with ``batch_axis="data"`` the global batch,
      of which each data row streams its block through its own pipe, and
      the result is that block; with None every data row streams all of it.
      The streamed batch must divide by ``n_microbatches``.
    * ``remat``: recompute the stage in the backward.

    Returns this rank's result, the same on every pipe rank."""
    if axis_name != AXIS:
        raise ValueError(f"the port's pipeline runs over the mesh's {AXIS!r} axis, "
                         f"not {axis_name!r}")
    if batch_axis not in (None, "data"):
        raise ValueError(f"batch_axis must be None or 'data', got {batch_axis!r}")
    p = mesh.pipe_index

    def local(stacked) -> list:
        leaves = [leaf for _, leaf in _tree_leaves(stacked)]
        specs = ([P(axis_name)] * len(leaves) if param_specs is None
                 else [_leaf_at(param_specs, path) for path, _ in _tree_leaves(stacked)])
        out = []
        for leaf, spec in zip(leaves, specs):
            t = leaf[p]
            if "model" in spec and mesh.model_size > 1:
                d = spec.index("model") - 1
                t = t.chunk(mesh.model_size, d)[mesh.model_index]
            out.append(t)
        return out

    def apply(stage_params, x: torch.Tensor) -> torch.Tensor:
        if batch_axis == "data":
            if x.shape[0] % mesh.size:
                raise ValueError(f"batch {x.shape[0]} not divisible by dp={mesh.size}")
            per = x.shape[0] // mesh.size
            x = x[mesh.data_index * per:(mesh.data_index + 1) * per]
        leaves = local(stage_params)

        def fn(live, h):
            return stage_fn(_tree_fill(stage_params, live), h)

        return run_pipeline(fn, leaves, x, mesh, n_microbatches, remat=remat)

    return apply


# ---------------------------------------------------------------- pp x tp helpers


def permute_qkv_head_major(stacked, heads: int, head_dim: int):
    """Reorder the fused ``qkv`` projection's output features head-major
    (JAX's ``permute_qkv_head_major``): flax lays them ``(c * heads + h) *
    head_dim + d``; after this ``(h * 3 + c) * head_dim + d``, so a
    contiguous tp-way split of the last dim gives each model rank complete
    (q, k, v) triples of its ``heads / tp`` heads.  ``stacked`` is a
    flax-layout tree (``kernel`` (..., in, out), ``bias`` (..., out));
    only leaves under ``qkv`` change."""
    def fix(path, leaf):
        if "qkv" not in path:
            return leaf
        lead = leaf.shape[:-1]
        x = leaf.reshape(*lead, 3, heads, head_dim).transpose(-3, -2)
        return x.reshape(*lead, 3 * heads * head_dim)

    return _tree_map(fix, stacked)


def permute_kv_shard_major(stacked, heads_kv: int, head_dim: int, tp: int):
    """Reorder the GQA ``kv_proj`` projection's output features so a
    contiguous tp-way split gives each model rank its own (K heads, V
    heads) pair (JAX's ``permute_kv_shard_major``): ``(2, tp, heads_kv / tp,
    head_dim)`` becomes ``(tp, 2, heads_kv / tp, head_dim)``-major."""
    hkv_l = heads_kv // tp

    def fix(path, leaf):
        if "kv_proj" not in path:
            return leaf
        lead = leaf.shape[:-1]
        x = leaf.reshape(*lead, 2, tp, hkv_l, head_dim).transpose(-4, -3)
        return x.reshape(*lead, 2 * heads_kv * head_dim)

    return _tree_map(fix, stacked)


def tp_stage_specs(stacked, tp_axis: str = "model", axis: str = AXIS):
    """Per-leaf specs of a stacked flax-layout TransformerBlock tree
    (leaves ``(n_stages, per_stage, ...)``) under pp x tp (JAX's
    ``tp_stage_specs``): the stage dim over ``pipe`` everywhere, plus
    Megatron's dims over ``model``: ``qkv``/``q_proj``/``kv_proj``/
    ``dense_0`` column-parallel (last dim), ``proj``/``dense_1`` kernels
    row-parallel (second to last), their biases and the LayerNorms
    replicated."""
    col = {"qkv", "q_proj", "kv_proj", "dense_0"}
    row = {"proj", "dense_1"}

    def spec(path, leaf):
        mods = set(path)
        n = leaf.ndim
        if mods & col:
            return P(axis, *([None] * (n - 2)), tp_axis)
        if mods & row:
            if path[-1] == "kernel":
                return P(axis, *([None] * (n - 3)), tp_axis, None)
            return P(axis, *([None] * (n - 1)))
        return P(axis, *([None] * (n - 1)))

    return _tree_map(spec, stacked)


def _port_block_params(p: Mapping, heads_l: int, head_dim: int) -> dict[str, torch.Tensor]:
    """One block's flax-layout leaves (this model rank's) as the port's
    ``TransformerBlock`` parameters: ``scale`` -> ``weight``, a ``kernel``
    transposed to ``weight``, and the head-major ``qkv`` block (``(h, c,
    d)``, :func:`permute_qkv_head_major`) laid ``(c, h, d)`` as
    ``TPPlan`` lays a rank's block.  Differentiable, so the gradients reach
    the flax leaves."""
    out = {}
    for mod, leaves in p.items():
        for leaf, t in leaves.items():
            if mod == "qkv":
                t = t.unflatten(-1, (heads_l, 3, head_dim)).transpose(-3, -2).flatten(-3)
            key = "weight" if leaf in ("kernel", "scale") else leaf
            out[f"{mod}.{key}"] = t.T if leaf == "kernel" else t
    return out


def make_tp_block_stage_fn(heads: int, head_dim: int, tp: int, attn_fn: Callable,
                           rope: bool = False, dtype: torch.dtype = torch.bfloat16,
                           tp_axis: str = "model", eps: float = 1e-6,
                           block_remat: bool = False, heads_kv: int = 0, mesh=None):
    """The Megatron TransformerBlock stack of one stage under pp x tp (JAX's
    ``make_tp_block_stage_fn``): ``stage_fn(local_stage_params, h)`` over a
    flax-layout stage tree whose leaves are ``(per_stage, ...)`` and this
    model rank's blocks (:func:`make_pipeline_apply` with
    :func:`tp_stage_specs` cuts them; ``qkv`` head-major,
    :func:`permute_qkv_head_major`, or under GQA (``heads_kv``) ``q_proj``
    by q-head blocks and ``kv_proj`` shard-major,
    :func:`permute_kv_shard_major`).  Each block is the port's
    ``TransformerBlock``, the module a pp x tp Trainer's stages run, cut and
    marked by ``TPPlan.shard`` as the Trainer's are (both sublayers
    Megatron pairs over the model group of ``mesh``, ``heads / tp`` heads a
    rank; built on the meta device, it holds no weights) and called on the
    rank's leaves by ``torch.func.functional_call``.
    ``attn_fn(q, k, v)`` on (B, S, H, D); ``tp_axis`` is JAX's name for
    ``mesh``'s model axis."""
    if tp_axis != "model":
        raise ValueError(f"the port's tensor parallelism runs over 'model', not {tp_axis!r}")
    if heads % tp:
        raise ValueError(f"heads ({heads}) must divide by tp ({tp})")
    if heads_kv and (heads_kv % tp or heads % heads_kv):
        raise ValueError(
            f"GQA pp x tp needs tp ({tp}) | heads_kv ({heads_kv}) and "
            f"heads_kv | heads ({heads})")
    if (mesh.model_size if mesh is not None else 1) != tp:
        raise ValueError(f"tp ({tp}) must be the model axis of mesh "
                         f"({None if mesh is None else mesh.model_size})")
    from distributed_tensorflow_ibm_mnist_tpu_torch.models.remat import remat
    from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import TransformerBlock

    block = TransformerBlock(heads * head_dim, heads, heads_kv, attn_fn=attn_fn, rope=rope,
                             dtype=dtype, device="meta")
    block.norm_attn.eps = block.norm_mlp.eps = eps
    if tp > 1:
        TPPlan.shard(mesh, block)

    def run(p, h):
        params = _port_block_params(p, block.tp_heads, head_dim)
        return torch.func.functional_call(block, params, (h,), strict=True)[0]

    def stage_fn(stage_params, h):
        per_stage = next(iter(_tree_leaves(stage_params)))[1].shape[0]
        for i in range(per_stage):
            p = _tree_map(lambda _, a, i=i: a[i], stage_params)
            h = remat(run, p, h) if block_remat else run(p, h)
        return h

    return stage_fn


def pipeline_block_rule(axis: str = AXIS, marker: str = "pipe_blocks"):
    """Spec rule claiming the stacked block-stack leaves for ``pipe`` (JAX's
    ``pipeline_block_rule``): a leaf whose path passes through ``marker``
    (the models' ``StackedBlocks``) splits its leading stage dim over
    ``axis``, full-length, so each pipe rank holds its own stage only."""
    def rule(path: tuple[str, ...], leaf) -> P:
        if marker in path and getattr(leaf, "ndim", 0) >= 1:
            return P(axis, *([None] * (leaf.ndim - 1)))
        return P()

    return rule


# ---------------------------------------------------------------- the state


def is_stage_leaf(name: str) -> bool:
    """Whether the parameter ``name`` belongs to a pipeline stage's blocks."""
    return name.startswith(STAGE_PREFIX)


def stage_name(name: str, stage: int) -> str:
    """A stage leaf's name in stage ``stage`` (its blocks are congruent)."""
    rest = name[len(STAGE_PREFIX):].split(".", 1)[1]
    return f"{STAGE_PREFIX}{stage}.{rest}"


def tp_in_stages(heads: int, heads_kv: int, tp: int) -> bool:
    """Whether tp > 1 splits the stage blocks too (JAX's
    ``_pp_tp_in_stages``): MHA, or GQA whose ``heads_kv`` tp divides (and
    which divides ``heads``); an unaligned GQA stack keeps its stage blocks
    whole on every model rank."""
    hkv = heads_kv or heads
    return tp > 1 and heads > 0 and (hkv == heads or (hkv % tp == 0 and heads % hkv == 0))


def stage_param_specs(model, tp: int, in_stages: bool) -> dict[str, P]:
    """The model-axis specs of a pipelined model's parameters, by name, in
    the port's layout: :func:`pipeline_block_rule` chained before
    ``megatron_rule(tp)`` as JAX's Trainer chains them, the stage leaves it
    claims (their stage split is the rank's own stage, ``keep_stage``)
    whole on every model rank, or, ``in_stages``, split by Megatron's rule
    on each block's own leaves (tensor parallelism inside the stages)."""
    chained = model_param_specs(model, chain_rules(pipeline_block_rule(), megatron_rule(tp)))
    inner = model_param_specs(model, megatron_rule(tp)) if in_stages else {}
    return {name: (inner.get(name, P()) if AXIS in spec else spec)
            for name, spec in chained.items()}


class PipePlan:
    """How each parameter of a pp run lives on this rank (the interface of
    ``tensor_parallel.TPPlan`` that ``core.state`` and the step use): the
    module's own parameters (``masters``, and ``local_names`` beside them,
    as on every plan) are this stage's blocks and every replicated leaf,
    each cut to this model rank's block by ``tp_plan`` (a ``TPPlan``) under
    tp; ``names`` are the whole form's (every stage's blocks).  ``clip`` is the run's global-norm clip, lifted
    out of the optimizer and applied against the norm over the groups."""

    def __init__(self, mesh, model, tp_plan=None):
        self.mesh, self.n, self.index = mesh, mesh.pipe_size, mesh.pipe_index
        self.tp = tp_plan
        if tp_plan is not None:
            self.local_names, self.params = list(tp_plan.names), list(tp_plan.params)
            local_shapes = list(tp_plan.shapes)
        else:
            named = list(model.named_parameters())
            self.local_names = [n for n, _ in named]
            self.params = [p for _, p in named]
            local_shapes = [tuple(p.shape) for p in self.params]
        self.masters = self.params
        self.stage = [is_stage_leaf(n) for n in self.local_names]
        self.names, self.shapes = [], []
        for name, shape, st in zip(self.local_names, local_shapes, self.stage):
            if not st:
                self.names.append(name)
                self.shapes.append(shape)
        for s in range(self.n):
            for name, shape, st in zip(self.local_names, local_shapes, self.stage):
                if st:
                    self.names.append(stage_name(name, s))
                    self.shapes.append(shape)
        self.clip: float | None = None
        self._replicas = mesh.shape["data"] * mesh.shape["seq"]
        self._layout = None
        self._rep_layout = None

    # ---------------------------------------------------------------- layout

    def numel(self) -> int:
        """Elements of the whole parameter set."""
        return sum(int(np.prod(s)) for s in self.shapes)

    def whole(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tensors laid out as this rank's leaves (one each), gathered whole:
        over the model group (``tp_plan.whole``), then every stage's over
        the pipe group, in the order of ``names`` (a collective)."""
        ts = list(tensors) if self.tp is None else self.tp.whole(tensors)
        rep = [t for t, st in zip(ts, self.stage) if not st]
        mine = [t.detach().contiguous() for t, st in zip(ts, self.stage) if st]
        stages = [all_gather_dim(t.unsqueeze(0), 0, self.mesh.pipe_group) for t in mine]
        return rep + [g[s] for s in range(self.n) for g in stages]

    def gather(self) -> None:
        """Nothing to gather: the forward runs on this rank's leaves."""

    def release(self) -> None:
        """Nothing to release."""

    def gathered(self):
        """The eval runs the same pipeline."""
        return contextlib.nullcontext(self)

    # ---------------------------------------------------------------- step

    @torch.no_grad()
    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Stage 0's gradients of the replicated leaves on every pipe rank
        (one bucketed broadcast over ``pipe``), then every gradient's mean
        over the replica group (the dp ranks of this ``(model, pipe)``
        index)."""
        g = list(grads)
        rep = [i for i, st in enumerate(self.stage) if not st]
        if rep:
            if self._rep_layout is None:
                self._rep_layout = make_bucket_layout([self.params[i] for i in rep], 1)
            lay = self._rep_layout
            flat = [broadcast(b, 0, self.mesh.pipe_group)
                    for b in flatten_buckets([g[i] for i in rep], lay)]
            for i, t in zip(rep, unflatten_buckets(flat, lay)):
                g[i] = t
        if self._replicas == 1:
            return g
        if self._layout is None:
            self._layout = make_bucket_layout(self.params, 1)
        lay = self._layout
        return unflatten_buckets(grouped_all_reduce_mean(
            flatten_buckets(g, lay), self.mesh.replica_group), lay)

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's global L2 norm: each stage leaf's squares
        summed over ``pipe`` (and a model-split block's over ``model``),
        each replicated leaf counted once."""
        split = (self.tp.split if self.tp is not None else [None] * len(self.stage))
        zero = torch.zeros((), device=grads[0].device)
        sq = {(st, d is not None): zero for st in (True, False) for d in (None, 0)}
        for g, st, d in zip(grads, self.stage, split, strict=True):
            sq[(st, d is not None)] = sq[(st, d is not None)] + g.float().square().sum()
        if self.tp is not None and self.mesh.model_size > 1:
            both = all_reduce_sum(torch.stack([sq[(True, True)], sq[(False, True)]]),
                                  self.mesh.model_group)
            sq[(True, True)], sq[(False, True)] = both[0], both[1]
        stage = all_reduce_sum(sq[(True, True)] + sq[(True, False)], self.mesh.pipe_group)
        return (stage + sq[(False, True)] + sq[(False, False)]).sqrt()

    @torch.no_grad()
    def apply(self, optimizer, grads: Sequence[torch.Tensor]) -> None:
        """One update: stage 0's replicated gradients, the replica mean, the
        clip against the global norm, the optimizer's step."""
        g = self.reduce_grads(grads)
        if self.clip is not None:
            norm = self.grad_norm(g)
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm.clamp_min(1e-38))
            g = torch._foreach_mul(g, scale)
        optimizer.step(g)

    # ---------------------------------------------------------------- state

    def adopt(self, state) -> None:
        """Make ``state`` (its optimizer over this rank's leaves) this
        plan's: the clip lifted out (:meth:`apply` applies it)."""
        opt = state.optimizer
        if self.tp is not None:
            self.clip, self.tp.clip = self.tp.clip, None
        else:
            self.clip = opt.grad_clip
        opt.grad_clip = None
        state.plan = self

    def whole_moments(self, optimizer) -> dict[str, dict[str, torch.Tensor]]:
        """``optimizer``'s moments as ``{key: {leaf name: whole tensor}}``
        (a collective)."""
        return {key: dict(zip(self.names, self.whole(getattr(optimizer, key))))
                if getattr(optimizer, key) else {} for key in ("mu", "nu", "trace")}

    def _block(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        return whole if self.tp is None else self.tp.block_of(i, whole)

    def _whole_shape(self, i: int) -> tuple:
        return tuple(self.tp.shapes[i]) if self.tp is not None else tuple(self.params[i].shape)

    @torch.no_grad()
    def load_moments(self, optimizer, saved: Mapping) -> None:
        """Load whole moments (``count`` and ``{key: {leaf name: tensor}}``):
        this rank takes its stage's, each cut to its model block; strict."""
        form = {"count": saved["count"]}
        for key in ("mu", "nu", "trace"):
            ts = saved[key]
            if ts:
                missing = sorted(set(self.names) - set(ts))
                if missing:
                    raise ValueError(f"optimizer {key}: missing {missing[:4]}")
                picked = {}
                for i, n in enumerate(self.local_names):
                    if tuple(ts[n].shape) != self._whole_shape(i):
                        raise ValueError(f"optimizer {key}/{n}: saved shape "
                                         f"{tuple(ts[n].shape)}, expected {self._whole_shape(i)}")
                    picked[n] = self._block(i, ts[n])
                ts = picked
            form[key] = ts
        optimizer.load_state_dict(form, self.local_names)

    @torch.no_grad()
    def load_whole(self, params: Mapping[str, torch.Tensor]) -> None:
        """Load whole parameters (by name): this rank takes its stage's
        leaves, each cut to its model block."""
        for i, name in enumerate(self.local_names):
            src = params[name]
            if tuple(src.shape) != self._whole_shape(i):
                raise ValueError(f"params/{name}: saved shape {tuple(src.shape)}, "
                                 f"expected {self._whole_shape(i)}")
            self.params[i].copy_(self._block(i, src.to(self.params[i].device)))

    def whole_state_dict(self, model) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` with every leaf whole and every
        stage's blocks (a collective)."""
        whole = dict(zip(self.names, self.whole(self.masters)))
        local = set(self.local_names)
        return {**{k: v for k, v in model.state_dict().items() if k not in local}, **whole}


def keep_own_stage(model, mesh) -> None:
    """Drop every stage's blocks but this pipe rank's from ``model`` (a
    model built whole, the same on every rank)."""
    model.pipe_blocks.keep_stage(mesh.pipe_index)


def _keep_moments(state) -> None:
    """Cut ``state.optimizer`` to the parameters the model still holds."""
    keep = {id(p) for p in state.model.parameters()}
    old = state.optimizer
    opt = copy.copy(old)
    idx = [i for i, p in enumerate(old.params) if id(p) in keep]
    opt.params = [old.params[i] for i in idx]
    for key in ("mu", "nu", "trace"):
        ts = getattr(old, key)
        setattr(opt, key, [ts[i] for i in idx] if ts else ts)
    state.optimizer = opt


def shard_train_state(mesh, state, param_specs: Mapping[str, P] | None = None) -> PipePlan:
    """Place a whole ``core.state.TrainState`` of a pipelined model on the
    mesh: this rank keeps its stage's blocks and their moments, and under
    tp (``param_specs`` over ``model``, :func:`stage_param_specs`) its
    model blocks of them and of the replicated leaves; returns the plan,
    adopted by the state."""
    keep_own_stage(state.model, mesh)
    _keep_moments(state)
    tp_plan = None
    if mesh.model_size > 1:
        tp_plan = TPPlan.shard(mesh, state.model, param_specs)
        tp_plan.adopt(state)
        state.plan = None
    plan = PipePlan(mesh, state.model, tp_plan)
    plan.adopt(state)
    return plan


__all__ = ["AXIS", "PipePlan", "is_stage_leaf", "keep_own_stage", "make_pipeline_apply",
           "make_tp_block_stage_fn", "pad_to_microbatches", "permute_kv_shard_major",
           "permute_qkv_head_major", "pipeline_block_rule", "run_pipeline",
           "shard_train_state", "stack_stage_params", "stage_name", "stage_param_specs",
           "tp_in_stages", "tp_stage_specs"]
