"""The port's Trainer: one run's model, optimizer, data and loop.

The counterpart of the JAX package's ``core/trainer.py`` for the paths
ported so far: one device per rank, the dataset resident on it (uint8
images, or int32 token sequences), LeNet-5, the MLP, ResNet-20, ResNet-50 and the
ViT on images and the causal LM on ``dataset="retrieval"``, any
optimizer/schedule of ``core/optim.py``, the loss routed as
``core/steps.py`` routes it (``fused_xent=True`` runs the K1/K2 CUDA
kernels).  ``attn="flash"`` (the causal LM, the ViT) trains through the
flash kernels (K3 forward, K4/K5/K6 backward).  Semantics follow the JAX
Trainer:

* ``fit()`` (``trainer.py:1493-1772``): per-epoch metrics stay on the
  device and are read back once per eval interval; eval every
  ``eval_every`` epochs and at the end; early stop once the test accuracy
  reaches ``target_accuracy`` (``time_to_target_s`` measured from the start
  of ``fit``); ``TrainingDiverged`` on a non-finite epoch loss; ``epoch``
  and ``summary`` records under the JAX key names.
* ``measure_throughput(epochs)`` (``:1207-1278``): one warm-up epoch off
  the clock, then ``epochs`` epochs with one readback at the end; the
  state (parameters, BatchNorm statistics, optimizer, step, generators)
  is snapshotted first and restored after.
* The epoch's data order is a pure function of ``(seed, epoch)``, as JAX's
  ``fold_in(data_rng, epoch)`` makes it, with ``epoch`` the ABSOLUTE epoch
  index (the restored step // steps_per_epoch after a resume), so a resumed
  run replays the schedule the uninterrupted run has.  A resume from a
  mid-epoch step replays that epoch from its start, as JAX's does.
* Checkpoints (``checkpoint_dir``; utils/checkpoint.py, ``trainer.py:867-957``
  there): ``checkpoint_every`` epochs (independent of ``eval_every``; an
  async save that copies the state before it returns) and a final save;
  ``resume`` restores the newest INTACT step first (the hardened walk:
  ``restore_checkpoint()``; an explicit step restores exactly that one) and
  writes a ``resume`` record.  ``fit(preemption=h)`` polls ``h.triggered``
  (``utils.elastic.PreemptionHandler``) after every epoch, and in stream
  mode every ``preempt_poll_every`` steps: when set it saves, writes a
  ``preempted`` record and returns with ``"preempted": True``.  The save
  form is keyed by parameter and buffer name (``TrainState.state_dict``);
  under ZeRO-1 the optimizer's buckets are gathered whole on save, as
  JAX's are (``:904-921``), so such a checkpoint resumes only at its dp
  (``ValueError`` naming both); a replicated one resumes at any dp.
  Under dp rank 0 writes (behind a barrier when the save waits) and every
  rank restores.
* ``chaos`` (a ``utils.chaos.FaultInjector``): the ``train-step`` site
  fires once per epoch dispatch (``kind="nan"`` poisons one parameter
  element, other kinds raise ``ChaosFault``), ``data-batch`` once per
  stream batch (``OSError``), and the checkpoint sites in the manager.
* ``input_mode="stream"`` (``:959-1100``): the dataset stays in host
  memory; the native ``Prefetcher`` (data/native.py) assembles the
  epoch's batches ``prefetch_depth`` ahead, in the order of the same
  permutation device mode draws; each chunk of ``stream_chunk`` batches
  goes to the card in one transfer from pinned memory (``non_blocking``
  on a side stream, double-buffered one chunk ahead, a pinned buffer
  refilled only after its copy's event), runs as ``stream_chunk`` steps
  (``core.steps.make_chunk_runner``), and the epoch's remainder drains a
  step at a time.  Under dp every rank reads its rows of each global
  batch (``parallel.data_parallel.stream_rows``).
* ``remat=True`` recomputes the whole forward in the backward,
  ``remat="blocks"`` each residual or transformer block (the models'
  ``block_remat``); BatchNorm's running statistics move once a step.
* ``profile_dir``: a ``torch.profiler`` capture of the epochs after the
  first one's fence (all of them when ``epochs == 1``), written as a
  Chrome trace (utils/profiling.py).
* The attention's causal flag is derived as JAX derives it
  (``trainer.py:305-381``): ``model_kwargs["causal"]``, else
  ``config.causal``, else the family's default (True for causal_lm).  A
  family without a causal knob of its own (the ViT) gets a causal
  ``attn_fn`` (flash or vanilla, by its ``attn``) when the flag is set.
* The image models take their input size from the data: ResNets their
  ``in_channels``, the ViT its ``image_size`` and ``in_channels``.
* Token data adds ``tokens_per_sec_per_chip`` to the ``summary`` and
  throughput records.

Data parallelism (``dp > 1``, or a ``mesh``): one process per rank over
``torch.distributed`` (``launch/torchrun.py``); with no mesh given the
Trainer builds one over the initialised process group, and without a group
it raises ``ValueError``.  As the JAX Trainer: each rank holds its own rows
of the training set (``parallel.data_parallel.shard_dataset``) and draws
its own permutation of them from a seed that folds in its rank (at dp=1
the seed is unchanged); the eval set is sharded, zero-padded and masked;
the gradients are averaged across ranks each step (or the ZeRO-1 update
runs, ``sharded_update=True``); models that take ``axis_name`` (the
ResNets: cross-replica BatchNorm) get ``"data"``; rank 0's weights are
broadcast at start and each rank's dropout generator folds in its rank.
Metrics are averaged across ranks at each fence, so early stop and
``TrainingDiverged`` take the same branch on every rank; only rank 0
writes records, and ``fit()`` returns rank 0's summary on every rank.
``n_chips`` is dp (``dp * tp * sp * pp`` under tensor, sequence and
pipeline parallelism, below).

``tracer`` (utils/tracing.Tracer) records the JAX Trainer's spans:
``epoch_dispatch`` per epoch, ``fetch`` per readback interval, ``eval``,
``checkpoint_save`` / ``checkpoint_restore``, and in stream mode ``h2d``
and ``dispatch`` per shipped chunk.  ``telemetry``
(utils/telemetry.Telemetry) gets a ``trainer`` vitals source, and at each
fenced epoch a ``trainer_heartbeat_t`` heartbeat, a ``trainer_step`` gauge
and one ``maybe_sample``.  Both are nil-guarded like ``chaos``.
``generate`` and ``_decode_params`` serve the run's weights
(``InferenceEngine.from_trainer`` builds an engine on them).

Left out, because they describe XLA and there is nothing honest to put in
them: ``n_compiled_programs``, ``compile_time_s`` and ``compile_by_site``
(the kernel builds are counted by ``utils.tracing.CompileTracker``).
``compile_overhead_s`` (summary) and ``compile_and_first_epoch_s``
(throughput) keep their JAX names and meaning, the first interval's excess
over the steady pace: in the port that is the kernel build at first
launch, the library's algorithm choices and allocator growth, not XLA.
FLOPs are counted analytically (``utils/flops.py``).

The causal LM trains on float32 master weights (``param_dtype``; flax's
``param_dtype`` default) cast to its compute dtype per use, so Adam's
moments are float32 too; ``generate``, ``InferenceEngine.from_trainer``
and the serving tier take JAX's decode cast of them (``_decode_params``).
MoE runs (``moe_every``) add ``moe_aux_weight`` x the aux losses and the
pre-weighted z-losses to the training loss and ``moe_dropped_frac`` (6
places) to the epoch records; dropout draws from the model's generator;
a learned position table is sized by the data's ``seq_len``.

Sharded runs (JAX's GSPMD paths): ``fsdp=True`` (ZeRO-3,
``parallel/fsdp.py``; ``ValueError`` at dp = 1) splits every large leaf
and its moments over the ranks, ``sharded_update`` with it splits the
small leaves' moments too; MoE blocks at dp > 1 run expert-parallel
automatically (``parallel/expert_parallel.py``: each rank owns
n_experts / dp experts, ``ValueError`` when they do not divide).  Both
keep a ``parallel.fsdp.ShardPlan`` in ``state.plan`` and, as JAX's GSPMD
epoch does, draw one permutation of the whole training set (each rank
holds all of it) and train each rank on its block of every global
batch, so a sharded run sees the global batches of the dp = 1 run.  Eval
gathers the fsdp leaves (the experts stay on their ranks);
``generate``, ``InferenceEngine.from_trainer`` and ``_decode_params``
gather every leaf whole, and checkpoints hold the whole (replicated)
form, which resumes at any dp; under a sharded run each of these is a
collective.  ``input_mode="stream"`` does not compose with them
(``ValueError``, as in JAX).  ``dcn_dp > 1`` builds the multislice mesh
(``parallel.mesh.make_mesh``: the group must span that many nodes, each
holding ``(dp/N) * tp * sp * pp`` consecutive ranks), beside any tp, sp
and pp.

Composed (JAX ``trainer.py:546-600``): fsdp and MoE blocks compose with
tp and sp as JAX's GSPMD composes them.  Under tp the model is first cut
to this model rank's blocks (``TPPlan``) and the ``ShardPlan`` splits
those blocks over the rank's data group: ``make_fsdp_specs(base_rule=
megatron_rule(tp))`` keeps each Megatron dim and splits the largest free
one over ``data`` (``P("data", "model")``), and the expert leaves stay
whole over ``model``.  Under sp the plan lives at each seq index, the
split leaves' gradients averaged over the seq group before the data
group's reduce-scatter.  MoE blocks run whole on every model rank (the
experts and router replicated over ``model``, as ``megatron_rule`` leaves
them), their EP exchange over the data group; under sp each MoE block
gathers the seq group's slices and routes the whole sequences (JAX's
routing, capacity from their whole token count).

Sequence parallelism (``sp > 1``; JAX ``trainer.py:117-121, 349-356,
766-845``): the ranks form a ``(data, seq)`` mesh (``dp`` = world / sp
when 0), the model's attention is the ring (``sp_impl="ring"``, its
flash inner under ``attn="flash"``) or Ulysses (``"ulysses"``, the
window passed through) over the seq group, with the derived causal flag.
Each rank keeps its token slice of every activation (``core/steps.py``:
the loss on the local tokens; the ViT pools across the seq group), the
gradients are averaged over all ``dp * sp`` ranks, and, as JAX's GSPMD
epoch, one permutation of the whole set (on every rank) is cut into
global batches, each data row training on its block.  JAX's refusals
come with its messages (a model without ``attn_fn``, an unknown
``sp_impl``, a microbatch that does not divide by dp, ``window`` with
the ring, a sequence that does not divide by sp, Ulysses' head counts).
``n_chips`` and the throughput and MFU divisors are ``dp * sp``.  The
state is the same on every rank: rank 0 saves it, and a checkpoint
resumes at any layout; ``generate`` decodes on one device from the
whole weights (the decode model drops the island).  fsdp, MoE blocks and
multislice compose with sp (above); ``sharded_update`` without fsdp and
stream mode take JAX's ``ValueError``.

Tensor parallelism (``tp > 1``; JAX ``trainer.py:169-187, 471, 546-600``):
the ranks form a ``(data, model, seq)`` mesh (``dp`` = world / (tp x sp)
when 0; rank ``(d * tp + m) * sp + s``), and each model rank keeps its
block of every leaf ``megatron_rule(tp)`` splits, with its moments
(``parallel.tensor_parallel.TPPlan``, ``state.plan``).  The models run
Megatron's pairs where tp divides the heads (the attention on H/tp heads a
rank: K3/K4, or the ring and Ulysses under sp) and the generic gather /
scatter path elsewhere (the convs' output channels gathered before their
BatchNorm, whose statistics are the data group's).  Every model in
``TRAINABLE`` runs at any dp and sp, with remat, ``grad_accum``, label
smoothing and ``fused_xent``; the data is JAX's GSPMD epoch (one global
permutation, each data row on its block); gradients are averaged over
the ``dp x sp`` ranks of a model index and the clip's norm counts each
block once.  Dropout masks are drawn equal across a model group (seeded
by the data and seq index).  Saves gather the blocks whole (rank 0
writes), so a tp checkpoint resumes at any tp; ``generate`` and
``InferenceEngine.from_trainer`` decode from whole leaves.  ``n_chips``
is ``dp * tp * sp``; the run name's label gets ``tp{n}``.  fsdp (with or
without ``sharded_update``), MoE blocks and multislice compose with tp
(above); ``sharded_update`` without fsdp and stream mode take JAX's
``ValueError``.

Pipeline parallelism (``pp > 1``; JAX ``trainer.py:171-254, 383-389,
483-489, 578-586, 656-750``): the ranks form a ``(data, model, seq,
pipe)`` mesh (rank ``((d * tp + m) * sp + s) * pp + p``; ``dp`` = world /
(tp x pp) when 0), the ViT or the causal LM is built stage-stacked
(``pp_stages`` = pp, ``models/transformer.py`` ``StackedBlocks``) and
each pipe rank keeps its own stage's blocks and moments
(``parallel.pipeline.PipePlan``, ``state.plan``), its ``pipeline_fn``
the GPipe schedule of ``parallel/pipeline.py`` over ``pp_microbatches``
(0: pp) microbatches of each data row's batch (a batch that does not
divide, an eval remainder, padded to the multiple and cut back).  With
tp > 1 the stage blocks are Megatron-split too where tp divides the heads
(and heads_kv: JAX's ``_pp_tp_in_stages``; ``ValueError`` when the heads
do not divide), else kept whole on every model rank with JAX's warning.
The data is JAX's GSPMD epoch; each pipe rank takes stage 0's gradients
of the replicated leaves, the gradients are averaged over the data
group, and the clip's norm counts each stage leaf and each replicated
leaf once.  ``remat="blocks"`` recomputes each block inside its stage,
``remat=True`` the whole stage.  Saves gather every stage whole (rank 0
writes), so a pp checkpoint resumes at any pp; ``generate`` and
``InferenceEngine.from_trainer`` decode from the unstacked whole leaves
(``_decode_params``); ``generate(on_mesh=True)`` is JAX's ``ValueError``
(it decodes in a tp, fsdp or EP layout).
``n_chips`` is ``dp * tp * sp * pp``; the label gets ``pp{n}``.  JAX's
refusals come with its messages: a model without a block stack, pp
beside sp or fsdp, a batch that is not a multiple of ``dp *
microbatches``, dropout or MoE blocks in the stages (the models').
Multislice composes with pp: only the data axis crosses nodes.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import (
    init_sharded_opt_state,
    make_optimizer,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import (
    make_chunk_runner,
    make_epoch_runner,
    make_eval_fn,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.data import load_dataset
from distributed_tensorflow_ibm_mnist_tpu_torch.models import (
    CausalLM,
    VisionTransformer,
    get_model,
    model_accepts,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.models.causal_lm import check_decodable
from distributed_tensorflow_ibm_mnist_tpu_torch.models.transformer import (
    _resolve_attn,
    model_blocks,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
    ShardedUpdate,
    all_gather,
    all_gather_object,
    all_reduce_max,
    all_reduce_mean,
    broadcast_object,
    make_bucket_layout,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
    make_dp_chunk_runner,
    make_dp_epoch_runner,
    make_global_epoch_runner,
    replicate,
    shard_dataset,
    shard_eval_set,
    stream_rows,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.expert_parallel import (
    make_moe_dispatch_auto,
    moe_expert_rule,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.fsdp import (
    ShardPlan,
    make_fsdp_opt_specs,
    make_fsdp_specs,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import pipeline
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import (
    Mesh,
    hybrid_mesh_shapes,
    make_mesh,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.tensor_parallel import (
    TPPlan,
    megatron_rule,
    model_param_specs,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import ChaosFault
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.checkpoint import CheckpointManager
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.debug import (
    TrainingDiverged,
    find_nonfinite,
    inject_nan,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import rank_device, resolve_device
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import mfu as _mfu
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.flops import model_flops_per_image
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.metrics import MetricWriter
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.profiling import TraceSession
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import CompileTracker

TRAINABLE = ("lenet5", "mlp", "resnet20", "resnet50", "vit", "causal_lm")


_SP_IMPLS = ("ring", "ulysses")


def _unknown_sp_impl_msg(sp_impl: str) -> str:
    return f"unknown sp_impl {sp_impl!r}; use 'ring' or 'ulysses'"


# JAX's refusal of pp beside sp or fsdp (core/trainer.py:195-203 there), word for word
PP_BESIDE = ("pp composes with dp (batch over 'data') and with tp on the "
             "NON-pipelined leaves only (embed/head/patch — stacked-block "
             "leaves are claimed by the 'pipe' sharding; TP inside stages "
             "would need explicit-collective blocks, a measured rejection "
             "— see README); sp (nested shard_map islands) and fsdp do "
             "not pipeline yet")


def _refuse_unported(config: RunConfig) -> None:
    """Raise for every knob the port does not have yet, and JAX's refusals
    of pp (a model without a block stack; pp beside sp or fsdp)."""
    if config.pp > 1:
        if not model_accepts(config.model, "pipeline_fn"):
            raise ValueError(
                f"pp={config.pp} needs a model with a pipelineable block "
                f"stack (pipeline_fn/pp_stages, e.g. 'vit'); got {config.model!r}")
        if config.sp > 1 or config.fsdp:
            raise ValueError(PP_BESIDE)
    if config.dcn_dp < 1:
        raise ValueError(f"dcn_dp must be >= 1, got {config.dcn_dp}")
    if config.input_mode not in ("device", "stream"):
        raise ValueError(
            f"input_mode must be 'device' or 'stream', got {config.input_mode!r}")
    if config.remat not in (False, True, "blocks"):
        raise ValueError(f"remat must be False, True or 'blocks', got {config.remat!r}")
    if config.model not in TRAINABLE:
        raise ValueError(
            f"unknown model {config.model!r}; the port trains: {list(TRAINABLE)}")
    if (config.model == "causal_lm") != (config.dataset == "retrieval"):
        raise ValueError(
            "causal_lm trains on token sequences (dataset='retrieval') and the "
            f"image models on images; got model={config.model!r}, "
            f"dataset={config.dataset!r}")


def _default(model: str, name: str):
    """The model family's constructor default for ``name`` (0 when it has
    no such parameter)."""
    family = {"causal_lm": CausalLM, "vit": VisionTransformer}.get(model)
    par = inspect.signature(family).parameters.get(name) if family else None
    return 0 if par is None else par.default


def _unstacked_name(name: str, per_stage: int) -> str:
    """A stage block's parameter name in the plain stack's layout:
    ``pipe_blocks.stages.{s}.{i}.X`` -> ``blocks.{s * per_stage + i}.X``
    (every other name as it is)."""
    if not pipeline.is_stage_leaf(name):
        return name
    s, i, rest = name[len(pipeline.STAGE_PREFIX):].split(".", 2)
    return f"blocks.{int(s) * per_stage + int(i)}.{rest}"


def _seed_words(*key: int) -> int:
    """A 63-bit generator seed that is a pure function of ``key``."""
    return int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> 1)


def _data_mesh(config: RunConfig, mesh: Mesh | None
               ) -> tuple[int, int, int, int, Mesh | None]:
    """``(dp, tp, sp, pp, mesh)`` of a run: ``config.dp`` (0: the process
    group's world size over tp x sp x pp, 1 without a group); dp, tp, sp or
    pp > 1 builds a mesh over the initialised group unless one is given
    (``ValueError`` naming launch.torchrun without a group); a given mesh
    must have dp x tp x sp x pp ranks.  ``dcn_dp > 1`` builds the
    multislice mesh, at dp = 1 too (where it cannot divide)."""
    tp, sp, pp = max(1, config.tp), max(1, config.sp), max(1, config.pp)
    dp = config.dp
    if dp == 0:
        dp = mesh.size if mesh is not None else (
            max(1, dist.get_world_size() // (tp * sp * pp))
            if dist.is_available() and dist.is_initialized() else 1)
    if dp < 1:
        raise ValueError(f"dp must be >= 0, got {config.dp}")
    if config.dcn_dp > 1:
        if mesh is not None:
            raise ValueError(
                "dcn_dp with an explicit mesh is ambiguous — build the multislice "
                "mesh yourself via make_mesh(..., dcn_dp=N) and leave config.dcn_dp "
                "at 1, or pass no mesh")
        hybrid_mesh_shapes(dp, tp, sp, pp, config.dcn_dp)
        mesh = make_mesh(dp, tp=tp, sp=sp, pp=pp, dcn_dp=config.dcn_dp)
    if mesh is None and (dp > 1 or tp > 1 or sp > 1 or pp > 1):
        mesh = make_mesh(dp, tp=tp, sp=sp, pp=pp)
    if mesh is not None and mesh.size != dp:
        raise ValueError(f"dp={dp} but the mesh's data axis has {mesh.size} rank(s)")
    if mesh is not None and mesh.model_size != tp:
        raise ValueError(f"tp={tp} but the mesh's model axis has {mesh.model_size} rank(s)")
    if mesh is not None and mesh.seq_size != sp:
        raise ValueError(f"sp={sp} but the mesh's seq axis has {mesh.seq_size} rank(s)")
    if mesh is not None and mesh.pipe_size != pp:
        raise ValueError(f"pp={pp} but the mesh's pipe axis has {mesh.pipe_size} rank(s)")
    return dp, tp, sp, pp, mesh


class Trainer:
    """Owns the model, optimizer, device-resident data and loop of one run.

    ``device=None`` means the GPU (and raises without one): the rank's card
    ``cuda:{LOCAL_RANK}`` under a mesh; pass ``device="cpu"`` to run the
    plain PyTorch versions on the CPU.  ``mesh``: this rank's data mesh
    (``parallel.mesh.make_mesh``); built from the process group when
    ``config.dp > 1`` and none is given."""

    def __init__(self, config: RunConfig, mesh: Mesh | None = None,
                 writer: MetricWriter | None = None, device=None, chaos=None,
                 tracer=None, telemetry=None):
        _refuse_unported(config)
        self.config = config
        # utils/chaos.FaultInjector | None: every site below guards with
        # `is not None`, so an unwired trainer runs no chaos instruction
        self._chaos = chaos
        # utils/tracing.Tracer and utils/telemetry.Telemetry | None, under
        # the same nil-guard contract (module docstring)
        self._tracer = tracer
        self._telemetry = telemetry
        self._tel_epochs = 0
        self._tel_step: int | None = None
        self._gen_params = None  # (state step, decode state_dict) cache
        self._gen_cache: dict = {}
        self._compile = CompileTracker.install()
        if tracer is not None:
            self._compile.bind(tracer)
        self._stream = config.input_mode == "stream"
        self.dp, self.tp, self.sp, self.pp, self.mesh = _data_mesh(config, mesh)
        if config.fsdp and self.dp <= 1:
            raise ValueError(
                "fsdp=True needs dp>1 (ZeRO-3 shards over the 'data' axis); "
                f"got dp={self.dp}")
        # MoE + dp>1 runs expert-parallel automatically: experts split over
        # 'data', tokens exchanged by all_to_all (JAX's _moe_ep)
        self._moe_ep = (self.dp > 1 and bool(config.model_kwargs.get("moe_every", 0))
                        and model_accepts(config.model, "moe_fn"))
        # the sharded runs (JAX's GSPMD paths): a ShardPlan owns the update
        self._sharded_run = bool(config.fsdp) or self._moe_ep
        # the runs that draw JAX's GSPMD epoch: one global permutation, the
        # whole set on every rank, each data row on its block of a batch
        self._global_batches = self._sharded_run or self.tp > 1 or self.sp > 1 or self.pp > 1
        if self._global_batches and self._stream:
            raise ValueError(
                "input_mode='stream' does not compose with tp/sp/pp/fsdp/"
                "expert parallelism; use device mode")
        if config.sharded_update:
            if self.dp <= 1:
                raise ValueError(
                    "sharded_update shards the weight update over the 'data' "
                    f"axis; needs dp>1, got dp={self.dp}")
            if config.sharded_update_buckets < 1:
                raise ValueError(
                    f"sharded_update_buckets must be >= 1, got "
                    f"{config.sharded_update_buckets}")
            if self._global_batches and not config.fsdp:
                raise ValueError(
                    "sharded_update composes with plain dp (bucketed "
                    "reduce-scatter step) and with fsdp (opt-spec upgrade); "
                    "tp/sp/pp/expert runs already shard their updates via "
                    "their param specs")
        # the path label of the kernel-build attribution (JAX's census label)
        self._path_label = "_".join(
            [f"dp{self.dp}"] + [part for part, on in (
                (f"tp{self.tp}", self.tp > 1), (f"sp{self.sp}", self.sp > 1),
                (f"pp{self.pp}", self.pp > 1), ("fsdp", config.fsdp), ("ep", self._moe_ep),
                ("su", config.sharded_update), ("stream", self._stream)) if on])
        if config.batch_size % self.dp:
            raise ValueError(f"batch_size {config.batch_size} not divisible by dp={self.dp}")
        self._pp_tp_in_stages = self._check_pipeline(config)
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.device = resolve_device(device) if self.mesh is None else rank_device(device)
        data = load_dataset(
            config.dataset, n_train=config.n_train, n_test=config.n_test,
            seed=config.seed, synthetic=config.synthetic, **config.dataset_kwargs,
        )
        self.num_classes = data["num_classes"]
        self.data_synthetic: bool = bool(data.get("synthetic", True))
        image_shape = tuple(data["train_images"].shape[1:])
        tokens = data["train_images"].ndim == 2  # (N, S) token sequences
        if config.model == "lenet5" and image_shape != (28, 28, 1):
            raise ValueError(f"lenet5 takes (28, 28, 1) images, not {image_shape}")
        if not tokens and len(image_shape) != 3:
            raise ValueError(f"{config.model} takes (H, W, C) images, not {image_shape}")

        n_train = data["train_images"].shape[0]
        # under a mesh each rank steps through its own n/dp rows, B/dp at a time
        self.steps_per_epoch = (n_train // self.dp) // (config.batch_size // self.dp)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds training-set size {n_train}")
        total_steps = self.steps_per_epoch * config.epochs

        model_kwargs = dict(config.model_kwargs)
        in_features = int(np.prod(image_shape))
        if config.model == "mlp":
            model_kwargs.setdefault("in_features", in_features)
        if config.model in ("resnet20", "resnet50", "vit"):  # sized by the data
            model_kwargs.setdefault("in_channels", image_shape[2])
        if config.model == "vit":
            model_kwargs.setdefault("image_size", image_shape[:2])
        if config.model == "causal_lm":
            # float32 masters cast to the compute dtype per use, as flax's
            # param_dtype keeps them; a learned position table is sized by
            # the data's sequence length, as flax sizes it from the input
            model_kwargs.setdefault("param_dtype", torch.float32)
            if model_kwargs.get("pos") == "learned":
                model_kwargs.setdefault("seq_len", int(image_shape[0]))
        # the attention's causal flag: model_kwargs, then config, then the
        # family's default; a family with its own causal knob receives it
        family_causal = config.model == "causal_lm"
        self.causal = bool(model_kwargs["causal"] if "causal" in model_kwargs
                           else config.causal if config.causal is not None
                           else family_causal)
        if family_causal and config.causal is not None:
            model_kwargs.setdefault("causal", self.causal)
        if self.sp > 1:
            # sequence parallelism: the model's attention over 'seq', the
            # strategy by sp_impl (JAX trainer.py:349-356)
            if not model_accepts(config.model, "attn_fn"):
                raise ValueError(
                    f"sp={self.sp} needs a sequence model taking attn_fn "
                    f"(e.g. 'vit'); got {config.model!r}")
            self._validate_sp_hot_path(model_kwargs, data)
            model_kwargs.setdefault("attn_fn", self._make_sp_attn(model_kwargs))
        elif (self.causal and model_accepts(config.model, "attn_fn")
              and not model_accepts(config.model, "causal")):
            # causal attention for a family with no causal knob of its own
            # (the ViT): the masked kernel by the model's attn
            model_kwargs.setdefault("attn_fn", functools.partial(
                _resolve_attn(None, model_kwargs.get("attn", "vanilla")), causal=True))
        if self.dp > 1 and model_accepts(config.model, "axis_name"):
            model_kwargs.setdefault("axis_name", "data")  # cross-replica BatchNorm
        if self._moe_ep:
            n_exp = model_kwargs.get("n_experts", 8)
            if n_exp % self.dp:
                raise ValueError(
                    f"expert parallelism needs n_experts ({n_exp}) divisible "
                    f"by dp ({self.dp})")
            model_kwargs.setdefault("moe_fn", make_moe_dispatch_auto(
                self.mesh, n_exp,
                capacity_factor=model_kwargs.get("moe_capacity_factor", 2.0),
                top_k=int(model_kwargs.get("moe_top_k", 1))))
        if self.pp > 1:  # the block stack stage-stacked, run by the pipeline
            model_kwargs.setdefault("pp_stages", self.pp)
            model_kwargs.setdefault("pipeline_fn", self._make_pipeline_fn())
        if config.remat == "blocks":
            if not model_accepts(config.model, "block_remat"):
                raise ValueError(
                    "remat='blocks' needs a block-structured model "
                    f"(resnet*/vit/causal_lm); got {config.model!r}")
            model_kwargs.setdefault("block_remat", True)
        self._model_kwargs = model_kwargs
        self._data_seed = _seed_words(config.seed, 1)
        self.model = get_model(
            config.model, num_classes=self.num_classes, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                _seed_words(config.seed, 0)),
            **model_kwargs)
        if self.mesh is not None:
            replicate(self.mesh, self.model)
            model_gen = getattr(self.model, "generator", None)
            if self.dp * self.sp > 1 and model_gen is not None:
                # decorrelated dropout masks, each rank's tokens its own; the
                # ranks of a model group (the same tokens) draw the same
                model_gen.manual_seed(_seed_words(config.seed, 0, self.mesh.replica_index))
        params = list(self.model.parameters())
        self._sharded = None
        self._plan = None
        if self._sharded_run:
            optimizer = make_optimizer(config, total_steps, params)
        elif config.sharded_update:
            layout = make_bucket_layout(params, self.dp, config.sharded_update_buckets)
            optimizer, clip = init_sharded_opt_state(config, total_steps, params, layout)
            self._sharded = ShardedUpdate(layout=layout, clip=clip)
        else:
            optimizer = make_optimizer(config, total_steps, params)
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer,
                                data_generator=torch.Generator(device=self.device))
        # under pp, remat=True recomputes each stage in the pipeline's backward
        step_kw = dict(label_smoothing=config.label_smoothing, fused_xent=config.fused_xent,
                       grad_accum=config.grad_accum,
                       remat=config.remat is True and self.pp == 1)
        if self._sharded_run:
            # structural (expert) leaves first, then ZeRO-3's largest-dim rule
            # (beside tp: the Megatron dims kept, the largest free dim split),
            # each decided on the whole leaves before tp cuts them
            fsdp_specs = (make_fsdp_specs(self.model, self.mesh, base_rule=(
                megatron_rule(self.tp) if self.tp > 1 else None)) if config.fsdp else None)
            opt_specs = (make_fsdp_opt_specs(self.model, self.mesh, fsdp_specs)
                         if config.fsdp and config.sharded_update else None)
            expert_specs = (model_param_specs(self.model, moe_expert_rule())
                            if self._moe_ep else None)
            # under tp each model rank keeps its blocks first; the plan over
            # the data group splits those blocks again
            blocks = TPPlan.shard(self.mesh, self.model) if self.tp > 1 else None
            self._plan = ShardPlan.build(
                self.mesh, self.model, fsdp_specs, opt_specs=opt_specs,
                expert_specs=expert_specs, n_buckets=config.sharded_update_buckets, tp=blocks)
            self._plan.adopt(self.state)
        elif self.pp > 1:  # each pipe rank keeps its stage (and its model blocks)
            self._plan = pipeline.shard_train_state(self.mesh, self.state, pipeline.stage_param_specs(
                self.model, self.tp, self._pp_tp_in_stages))
        elif self.tp > 1:  # each model rank keeps its blocks (megatron_rule(tp))
            self._plan = TPPlan.shard(self.mesh, self.model)
            self._plan.adopt(self.state)
        if self._global_batches:  # JAX's GSPMD epoch: a block of every global batch
            self._run_epoch = make_global_epoch_runner(
                self.model, self.state.optimizer, config.batch_size, self.mesh,
                plan=self._plan, **step_kw)
        elif self._stream:  # k steps a transferred chunk; under dp this rank's rows
            self._train_chunk = (
                make_chunk_runner(self.model, optimizer, **step_kw) if self.mesh is None
                else make_dp_chunk_runner(self.model, optimizer, self.mesh,
                                          sharded_update=self._sharded, **step_kw))
        elif self.mesh is None:
            self._run_epoch = make_epoch_runner(self.model, optimizer, config.batch_size,
                                                **step_kw)
        else:  # this rank's shard at the per-rank batch
            self._run_epoch = make_dp_epoch_runner(self.model, optimizer, config.batch_size,
                                                   self.mesh, sharded_update=self._sharded,
                                                   **step_kw)
        flops_kw = model_kwargs
        family = {"causal_lm": CausalLM, "vit": VisionTransformer}.get(config.model)
        if family is not None:  # the architecture, defaults filled in
            flops_kw = {name: par.default for name, par
                        in inspect.signature(family).parameters.items()}
            flops_kw.update(model_kwargs)
        self._flops_per_image = model_flops_per_image(
            config.model, flops_kw, self.num_classes, in_features,
            seq_len=self._hot_seq_len(data), causal=self.causal,
            image_shape=image_shape)

        def put(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(data[key])).to(
                self.device, dtype)

        inputs = torch.int32 if tokens else torch.uint8
        if self._stream:  # host-resident, the whole set on every rank
            self.train_images = np.ascontiguousarray(
                data["train_images"], np.int32 if tokens else np.uint8)
            self.train_labels = np.ascontiguousarray(data["train_labels"], np.int32)
        if self.mesh is None:
            if not self._stream:
                self.train_images = put("train_images", inputs)
                self.train_labels = put("train_labels", torch.int32)
            self.test_images = put("test_images", inputs)
            self.test_labels = put("test_labels", torch.int32)
            self._eval = make_eval_fn(self.model, config.eval_batch_size)
        else:  # this rank's rows only (global batches: every row, one global order)
            if self._global_batches:
                self.train_images = put("train_images", inputs)
                self.train_labels = put("train_labels", torch.int32)
            elif not self._stream:
                train = shard_dataset(self.mesh, data["train_images"], data["train_labels"],
                                      self.device)
                self.train_images = train[0].to(inputs)
                self.train_labels = train[1].to(torch.int32)
            *test, n_valid = shard_eval_set(self.mesh, data["test_images"],
                                            data["test_labels"], self.device)
            self.test_images = test[0].to(inputs)
            self.test_labels = test[1].to(torch.int32)
            self._eval = make_eval_fn(self.model, max(1, config.eval_batch_size // self.dp),
                                      mesh=self.mesh, n_valid=n_valid)
        self.history: list[dict[str, Any]] = []
        # records come from rank 0 alone; the other ranks write to no sink
        self._owns_writer = writer is None or self.rank != 0
        self.writer = (writer if writer is not None and self.rank == 0 else MetricWriter(
            path=config.metrics_path if self.rank == 0 else None,
            stdout=not config.quiet and self.rank == 0))
        # every rank reads checkpoints; rank 0 alone writes them
        self._ckpt = (CheckpointManager(config.checkpoint_dir, chaos=chaos)
                      if config.checkpoint_dir else None)
        if telemetry is not None:
            telemetry.register_source("trainer", self._telemetry_vitals)

    def _telemetry_vitals(self) -> dict:
        """Health-sampler vitals: training progress as O(1) host reads."""
        return {"epochs_done": self._tel_epochs, "weight_step": self._tel_step,
                "history_len": len(self.history)}

    @property
    def n_chips(self) -> int:
        """Devices the run occupies: the images/sec/chip denominator (so the
        per-chip FLOPs of the MFU divide by ``dp * tp * sp * pp``)."""
        return self.dp * self.tp * self.sp * self.pp

    def _check_pipeline(self, config: RunConfig) -> bool:
        """JAX's checks of a pp run (``trainer.py:204-254, 483-489`` there):
        whether tp splits the stage blocks too (MHA, or GQA whose heads_kv
        tp divides; ``ValueError`` when the heads do not divide), the
        warning of an unaligned GQA stack (its stage blocks whole on every
        model rank), and the batch's multiple of ``dp * microbatches``."""
        if self.pp == 1:
            return False
        mk = config.model_kwargs
        heads = int(mk.get("heads", _default(config.model, "heads")) or 0)
        hkv = int(mk.get("heads_kv", _default(config.model, "heads_kv")) or 0)
        dim = int(mk.get("dim", _default(config.model, "dim")) or 0)
        in_stages = dim > 0 and pipeline.tp_in_stages(heads, hkv, self.tp)
        if in_stages and heads % self.tp:
            raise ValueError(f"pp x tp inside stages needs heads ({heads}) divisible "
                             f"by tp ({self.tp})")
        if self.tp > 1 and not in_stages:
            import warnings

            warnings.warn(
                f"pp={self.pp} x tp={self.tp} with heads_kv={hkv}: "
                "stacked-block params are sharded over 'pipe' only; "
                "Megatron 'model' sharding applies to the non-pipelined "
                "leaves (embeddings/head/patch). Attention/MLP weights "
                "inside stages are NOT tensor-parallel (MHA stacks are "
                "since round 4, GQA stacks with tp | heads_kv since "
                "round 5).", stacklevel=3)
        m = config.pp_microbatches or self.pp
        if config.batch_size % (self.dp * m):
            raise ValueError(
                f"batch_size {config.batch_size} must be a multiple of "
                f"dp*microbatches ({self.dp}x{m}={self.dp * m}) so training "
                f"always uses the pipeline island")
        return in_stages

    def _make_pipeline_fn(self):
        """The pp > 1 block-stack hook (JAX's ``_make_pipeline_fn``): the
        GPipe schedule of ``parallel/pipeline.py`` over this rank's stage,
        ``pp_microbatches`` microbatches (0: pp) of each data row's batch, a
        batch that does not divide padded to the microbatch multiple and
        cut back (init samples and eval remainders in JAX, where its local
        scan over the gathered stages gives the same values); ``remat=True``
        recomputes the stage in the backward."""
        mesh, m = self.mesh, self.config.pp_microbatches or self.pp
        remat = self.config.remat is True

        def pipeline_fn(stage_fn, params, x):
            return pipeline.pad_to_microbatches(
                lambda h: pipeline.run_pipeline(stage_fn, params, h, mesh, m, remat=remat),
                x, m)

        return pipeline_fn

    def _epoch_seed(self, *key: int) -> int:
        """An epoch's data-order seed.  Under dp > 1 in device mode it folds
        in the rank, as JAX folds the axis index into the epoch key (each
        rank permutes its own shard); in stream mode and in a sharded run
        every rank draws the same global permutation and reads its rows of
        each global batch, as under sequence parallelism."""
        if self.dp > 1 and not self._stream and not self._global_batches:
            key = (*key, self.rank)
        return _seed_words(self._data_seed, *key)

    def _rank_mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged across the ranks (itself without a mesh)."""
        return x if self.mesh is None else all_reduce_mean(x)

    def _validate_sp_hot_path(self, model_kwargs: dict, data: dict) -> None:
        """JAX's refusals of configs whose TRAINING batches would all miss
        the sp island (``trainer.py:766-817`` there, with its messages): the
        islands take the unsharded path for shapes that do not divide, which
        is right for an odd eval batch and wrong for every hot step."""
        cfg = self.config
        if cfg.sp_impl not in _SP_IMPLS:
            raise ValueError(_unknown_sp_impl_msg(cfg.sp_impl))
        ga = max(1, cfg.grad_accum)
        if cfg.batch_size % ga:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by "
                f"grad_accum={ga} (the per-step microbatch is batch/accum)")
        if (cfg.batch_size // ga) % self.dp:
            raise ValueError(
                f"sp={self.sp}: per-step microbatch (batch_size "
                f"{cfg.batch_size} / grad_accum {ga} = {cfg.batch_size // ga}) "
                f"must divide by dp={self.dp}, or every training step would "
                "fall back to unsharded attention")
        if model_kwargs.get("window", 0) and cfg.sp_impl == "ring":
            raise ValueError(
                f"sp={self.sp} with window={model_kwargs['window']}: the ring "
                "rotates K/V shards and cannot window-limit its hops — use "
                "sp_impl='ulysses' (full sequence local after the head "
                "reshard, window passes through) or sp=1")
        shape = data["train_images"].shape
        s = None
        if len(shape) == 2:
            s = int(shape[1])
        elif model_accepts(cfg.model, "patch_size") and len(shape) == 4:
            p = int(model_kwargs.get("patch_size", _default(cfg.model, "patch_size")))
            s = (shape[1] // p) * (shape[2] // p)
        if s is not None and s % self.sp:
            raise ValueError(
                f"sp={self.sp} does not divide the training sequence length "
                f"{s}; every training step would fall back to unsharded "
                "attention (pad the dataset's seq_len or change sp)")
        if cfg.sp_impl == "ulysses":
            heads = int(model_kwargs.get("heads", _default(cfg.model, "heads")))
            heads_kv = int(model_kwargs.get("heads_kv", _default(cfg.model, "heads_kv"))
                           or 0) or heads
            if self.tp > 1 and not (heads % self.tp or heads_kv % self.tp):
                # the head-aligned tp path hands the attention H/tp heads
                heads, heads_kv = heads // self.tp, heads_kv // self.tp
            if heads % self.sp or heads_kv % self.sp:
                raise ValueError(
                    f"sp_impl='ulysses' re-shards heads over the seq axis and "
                    f"needs heads % sp == 0 (and heads_kv % sp == 0 for GQA); "
                    f"got heads={heads}, heads_kv={heads_kv}, sp={self.sp} "
                    "— every training step would fall back to unsharded "
                    "attention (use sp_impl='ring' or adjust heads)")

    def _make_sp_attn(self, model_kwargs: dict):
        """The sp > 1 attention callable of the config (JAX
        ``trainer.py:819-845``): the ring (its flash inner under
        ``attn="flash"``) or Ulysses (the flash kernel or the plain
        attention inside, the window passed through), with the derived
        causal flag."""
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.ring_attention import (
            make_ring_attention,
            vanilla_attention,
        )
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.sequence_parallel import (
            make_ulysses_attention,
        )

        flash = model_kwargs.get("attn") == "flash"
        if self.config.sp_impl == "ring":
            return make_ring_attention(self.mesh, causal=self.causal,
                                       inner="flash" if flash else "dense")
        inner = _resolve_attn(None, "flash") if flash else vanilla_attention
        return make_ulysses_attention(self.mesh, causal=self.causal, inner_attn=inner,
                                      window=int(model_kwargs.get("window", 0) or 0))

    def _hot_seq_len(self, data: dict) -> int | None:
        """Sequence length the attention sees on the training path: the
        token length of rank-2 (LM) data, the patch-grid size of images
        through a patchifying model (the ViT's ``seq_len``); None
        otherwise."""
        shape = data["train_images"].shape
        if len(shape) == 2:
            return int(shape[1])
        return getattr(self.model, "seq_len", None)

    def _tokens_per_sec(self, sequences_per_sec: float) -> float | None:
        """sequences/sec -> tokens/sec for token data; None for images."""
        if self.train_images.ndim != 2:
            return None
        return round(sequences_per_sec * self.train_images.shape[1], 1)

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _mfu_fields(self, images_per_sec_per_chip: float) -> dict[str, Any]:
        """Analytic model TFLOP/s per chip and MFU; None off the GPU (a CPU
        rate is no device metric)."""
        if self.device.type != "cuda":
            return {"model_tflops_per_sec_per_chip": None, "mfu": None}
        fps_chip = self._flops_per_image * images_per_sec_per_chip
        m = _mfu(fps_chip, self._device_name())
        return {"model_tflops_per_sec_per_chip": round(fps_chip / 1e12, 6),
                "mfu": round(m, 6) if m is not None else None}

    def _epoch(self, epoch_seed: int, preemption=None) -> dict[str, torch.Tensor]:
        self.state.data_generator.manual_seed(epoch_seed)
        if self._stream:
            return self._run_epoch_stream(preemption)
        return self._run_epoch(self.state, self.train_images, self.train_labels)

    def _nonfinite_leaves(self) -> list[str]:
        """Names of the parameters holding NaN/Inf (a sharded run: in this
        rank's blocks)."""
        if self._plan is None:
            return find_nonfinite(self.model)
        with torch.no_grad():
            return [n for n, m in zip(self._plan.local_names, self._plan.masters)
                    if not bool(torch.isfinite(m).all())]

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` OR-ed across the ranks (itself without a mesh): every
        rank takes the branch any rank's signal asks for."""
        if self.mesh is None:
            return flag
        return bool(all_reduce_max(torch.tensor(float(flag), device=self.device)).item())

    def _run_epoch_stream(self, preemption=None) -> dict[str, torch.Tensor]:
        """One epoch in stream mode (module docstring): the permutation
        device mode would draw, this rank's rows of it through the native
        ``Prefetcher``, chunks of ``stream_chunk`` batches shipped in one
        transfer and double-buffered one chunk ahead, the remainder a step
        at a time.  With ``preemption`` and ``preempt_poll_every > 0`` the
        flag is polled whenever the count of computed steps crosses a poll
        boundary: when set, the epoch stops there (the prefetched and the
        staged-but-unrun batches are dropped; the resumed run replays them,
        ``state.step`` records exactly what ran)."""
        from distributed_tensorflow_ibm_mnist_tpu_torch.data.native import Prefetcher

        cfg = self.config
        n = self.train_images.shape[0]
        perm = torch.randperm(n, generator=self.state.data_generator,
                              device=self.device).cpu().numpy()
        rows = stream_rows(perm[: self.steps_per_epoch * cfg.batch_size],
                           cfg.batch_size, self.mesh)
        batch = cfg.batch_size // self.dp
        chunk = max(1, cfg.stream_chunk)
        poll = max(0, cfg.preempt_poll_every)
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        img_dtype = torch.from_numpy(self.train_images[:0]).dtype

        def host_buffer():
            return (torch.empty((chunk, batch, *self.train_images.shape[1:]), dtype=img_dtype,
                                pin_memory=cuda),
                    torch.empty((chunk, batch, *self.train_labels.shape[1:]),
                                dtype=torch.int32, pin_memory=cuda))

        buffers = [host_buffer(), host_buffer()]
        copied: list = [None, None]  # each buffer's last H2D event

        tracer = self._tracer  # nil-guarded below

        def stage(slot: int, lo: int, hi: int):
            """Ship batches [lo, hi) of a buffer to the card in one transfer."""
            img, lab = buffers[slot]
            span = (tracer.begin("h2d", cat="train", steps=hi - lo)
                    if tracer is not None else None)
            try:
                if not cuda:
                    return img[lo:hi].clone(), lab[lo:hi].clone(), None
                with torch.cuda.stream(side):
                    d_img = img[lo:hi].to(self.device, non_blocking=True)
                    d_lab = lab[lo:hi].to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                copied[slot] = event
                return d_img, d_lab, event
            finally:
                if span is not None:
                    tracer.end(span)  # enqueue time; the copy itself is async

        ms: list[dict[str, torch.Tensor]] = []
        steps_done = 0

        def run(staged) -> None:
            nonlocal steps_done
            d_img, d_lab, event = staged
            if event is not None:  # made on the side stream, used on this one
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(event)
                d_img.record_stream(compute)
                d_lab.record_stream(compute)
            span = (tracer.begin("dispatch", cat="train", steps=d_img.shape[0])
                    if tracer is not None else None)
            try:
                ms.append(self._train_chunk(self.state, {"image": d_img, "label": d_lab}))
            finally:
                if span is not None:
                    tracer.end(span)
            steps_done += d_img.shape[0]

        staged = None  # on the card, its compute not yet dispatched
        slot, filled, next_poll, stopped = 0, 0, poll, False
        with Prefetcher(self.train_images, self.train_labels, batch, rows,
                        depth=cfg.prefetch_depth) as pf:
            while True:
                img, lab = buffers[slot]
                if filled == 0 and copied[slot] is not None:
                    copied[slot].synchronize()  # its last transfer has left it
                if not pf.next_into(img[filled].numpy(), lab[filled].numpy()):
                    break
                if self._chaos is not None:
                    self._chaos.raise_if_fired("data-batch", OSError)
                filled += 1
                if filled == chunk:
                    # double buffer: ship chunk i+1, THEN dispatch chunk i's
                    # steps, so the transfer overlaps them
                    nxt = stage(slot, 0, chunk)
                    if staged is not None:
                        run(staged)
                    staged, slot, filled = nxt, slot ^ 1, 0
                if poll and preemption is not None and steps_done >= next_poll:
                    next_poll = steps_done + poll
                    if self._any_rank(preemption.triggered):
                        stopped = True
                        break
        if not stopped:
            if staged is not None:
                run(staged)
            for i in range(filled):  # the remainder (< chunk), a step at a time
                run(stage(slot, i, i + 1))
        return {k: torch.cat([m[k] for m in ms]) for k in ms[0]}

    # ------------------------------------------------------------------
    # checkpoints

    def _save_form(self) -> dict:
        """The on-disk state (``TrainState.state_dict``) plus ``dp`` and ``sp``; under
        a mesh every rank's generator states; under ZeRO-1 the optimizer's
        buckets gathered whole (collectives: every rank calls this)."""
        opt = None
        if self._sharded is not None:
            o = self.state.optimizer
            names = [f"bucket_{i}" for i in range(len(o.params))]
            opt = {"count": o.count, "zero1_dp": self.dp,
                   **{key: {n: all_gather(t) for n, t in zip(names, ts)}
                      for key, ts in (("mu", o.mu), ("nu", o.nu), ("trace", o.trace))}}
        form = self.state.state_dict(optimizer=opt)
        form["dp"], form["tp"], form["sp"], form["pp"] = self.dp, self.tp, self.sp, self.pp
        if self.mesh is not None:
            form["rank_generators"] = all_gather_object(form["generators"])
        return form

    @torch.no_grad()
    def _load_form(self, form: dict) -> None:
        """Load a save form into this run (strict; ``ValueError`` when the
        optimizer's layout cannot continue here)."""
        saved_dp = int(form.get("dp", 1))
        same_ranks = ((saved_dp, int(form.get("tp", 1)), int(form.get("sp", 1)),
                       int(form.get("pp", 1))) == (self.dp, self.tp, self.sp, self.pp))
        opt = form["optimizer"]
        zero1 = "zero1_dp" in opt
        if zero1 != (self._sharded is not None):
            raise ValueError(
                f"the checkpoint holds {'a ZeRO-1 (sharded_update)' if zero1 else 'a replicated'}"
                f" optimizer state saved at dp={saved_dp}; this run has "
                f"{'sharded_update at ' if self._sharded is not None else ''}dp={self.dp}:"
                " resume with the saving run's sharded_update setting")
        if zero1 and int(opt["zero1_dp"]) != self.dp:
            raise ValueError(
                f"a ZeRO-1 checkpoint's optimizer buckets are laid out for dp="
                f"{int(opt['zero1_dp'])}; this run has dp={self.dp}: resume it at "
                f"dp={int(opt['zero1_dp'])} (a replicated checkpoint resumes at any dp)")
        form = dict(form)
        if "rank_generators" in form and same_ranks:
            form["generators"] = form["rank_generators"][self.rank]
        elif not same_ranks:  # another layout: this run's own streams
            form["generators"] = self.state.generator_states()
        if not zero1:
            self.state.load_state_dict(form)
            return
        o = self.state.optimizer
        pairs = []
        for key, ts in (("mu", o.mu), ("nu", o.nu), ("trace", o.trace)):
            if len(opt[key]) != len(ts):
                raise ValueError(f"optimizer {key}: {len(opt[key])} saved buckets, "
                                 f"this run has {len(ts)}")
            for i, t in enumerate(ts):
                whole = opt[key][f"bucket_{i}"]
                if whole.numel() != t.numel() * self.dp:
                    raise ValueError(f"optimizer {key}/bucket_{i}: {whole.numel()} saved "
                                     f"elements, this run's bucket has {t.numel() * self.dp}")
                pairs.append((t, whole[self.rank * t.numel():(self.rank + 1) * t.numel()]))
        self.state.load_state_dict(form, optimizer=False)
        for t, src in pairs:
            t.copy_(src)
        o.count = int(opt["count"])

    def save_checkpoint(self, wait: bool = True) -> int | None:
        """Save the state at its step (None without ``checkpoint_dir``).
        ``wait=False`` returns once the state is copied; under a mesh it is
        a collective, rank 0 writes, and a waiting save ends at a barrier,
        so every rank knows the step is durable."""
        if self._ckpt is None:
            return None
        span = (self._tracer.begin("checkpoint_save", cat="train", wait=wait)
                if self._tracer is not None else None)
        try:
            form = self._save_form()
            if self.rank == 0:
                self._ckpt.save(form, wait=wait)
            if self.mesh is not None and wait:
                dist.barrier()
        finally:
            if span is not None:
                # wait=False: the span covers the copy, not the landing
                self._tracer.end(span)
        return self.state.step

    def restore_checkpoint(self, step: int | None = None) -> int:
        """Resume from the checkpoint dir; returns the restored step.

        ``step=None``: the hardened walk (``restore_latest_intact``): torn,
        corrupt, non-finite or mislabelled steps are walked past, newest ->
        oldest (``self._ckpt.skipped`` lists them with their reasons).  An
        explicit ``step`` restores exactly that step, and raises on a
        corrupt one."""
        if self._ckpt is None:
            raise ValueError("no checkpoint_dir configured")
        span = (self._tracer.begin("checkpoint_restore", cat="train",
                                   hardened=step is None)
                if self._tracer is not None else None)
        try:
            form = (self._ckpt.restore_latest_intact() if step is None
                    else self._ckpt.restore(step=step))
            self._load_form(form)
        except Exception as e:
            if span is not None:
                # the hardened walk found nothing, or the step was corrupt
                self._tracer.end(span, error=f"{type(e).__name__}: {e}")
            raise
        self._gen_params = None  # the decode weights changed
        if span is not None:
            self._tracer.end(span, restored_step=self.state.step)
        return self.state.step

    # ------------------------------------------------------------------
    # decode from the run's weights

    def _decode_model(self):
        """A fresh model of the run's configuration for decode, on the
        trainer's device: the training-only knobs (``attn_fn``,
        ``block_remat``, ``axis_name``, ``moe_fn``) dropped, as JAX drops its training
        islands; its weights are whatever :meth:`_decode_params` loads."""
        clean = {k: v for k, v in self._model_kwargs.items()
                 if k not in ("attn_fn", "block_remat", "axis_name", "param_dtype",
                              "moe_fn", "pipeline_fn", "pp_stages")}
        return get_model(self.config.model, num_classes=self.num_classes,
                         device=self.device, **clean)

    def _decode_params(self) -> dict:
        """The run's weights as the decode model's ``state_dict``: a copy
        on the trainer's device, cached per trained state (invalidated by
        every step and by a restore), in JAX's decode cast
        (``trainer.py:1291-1330`` there): floating leaves in the model's
        compute dtype, except the norms' and the MoE leaves (``norm_*``,
        ``moe``), which the model consumes at float32 and keep.  A sharded
        run gathers every leaf whole first (a collective)."""
        if self._gen_params is not None and self._gen_params[0] == self.state.step:
            return self._gen_params[1]
        dtype = self._model_kwargs.get("dtype", torch.bfloat16)

        def cast(name: str, t: torch.Tensor) -> torch.Tensor:
            parts = name.split(".")
            if not t.is_floating_point() or any(
                    p == "moe" or p.startswith("norm") for p in parts):
                return t.detach().clone()
            return t.detach().to(dtype, copy=True)

        whole = (self.model.state_dict() if self._plan is None
                 else self._plan.whole_state_dict(self.model))  # a collective
        stacked = getattr(self.model, "pipe_blocks", None)
        if stacked is not None:  # unstacked in schedule order (JAX's _decode_param_tree)
            whole = {_unstacked_name(k, stacked.per_stage): v for k, v in whole.items()}
        params = {k: cast(k, v) for k, v in whole.items()}
        self._gen_params = (self.state.step, params)
        return params

    def generate(self, prompt, max_new: int, max_len: int | None = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 rng=None, eos_id: int | None = None, pad_id: int = 0,
                 prompt_lens=None, on_mesh: bool = False,
                 with_lengths: bool = False):
        """Autoregressive decode from this run's trained weights
        (core/generate.py ``make_generator``; causal-LM family only): a
        decode model of the run's configuration holding
        :meth:`_decode_params`, and one generator per (max_len, max_new,
        sampling, eos_id, pad_id, with_lengths) configuration, cached.
        ``prompt`` is a (P,) or (B, P) int array or tensor; the result is
        on the trainer's device; under a sharded run a collective (every
        rank calls it).  ``on_mesh=True`` decodes in the run's sharded
        layout instead (tp, fsdp or EP; :meth:`_generate_on_mesh`), with
        JAX's ``ValueError`` for a run that has none, sp and pp."""
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import make_generator

        if not model_accepts(self.config.model, "pos"):
            raise ValueError(
                f"generate() needs a causal-LM-family model; got {self.config.model!r}")
        check_decodable(self.model)
        if not self.causal:
            raise ValueError(
                "generate() is autoregressive (KV-cache causal decode); this "
                "run trained a BIDIRECTIONAL model (causal=False), whose "
                "logits condition on future positions the decode path cannot "
                "provide — train causally to decode")
        if on_mesh and not (self.tp > 1 or self.config.fsdp or self._moe_ep):
            raise ValueError(
                "on_mesh=True decodes in the run's GSPMD layout; this run "
                "has none (tp/fsdp/EP shard params — dp/sp and single-chip "
                "runs decode via the default path)")
        if on_mesh and self.sp > 1:
            raise ValueError(
                "on_mesh=True with sp>1 is unsupported: the decode model "
                "drops the sequence-parallel islands, so its params/cache "
                "have no 'seq' layout to decode in — use the default "
                "single-device path")
        if on_mesh and (self.pp > 1 or self._model_kwargs.get("pp_stages", 0)):
            raise ValueError(
                "on_mesh=True with pipeline stages is unsupported: the "
                "decode model runs the plain block stack, not the "
                "pipe-sharded pipe_blocks/stacked layout — use the default "
                "path (which unstacks the stages on device)")
        prompt = torch.as_tensor(np.asarray(prompt), device=self.device)
        if prompt.ndim == 1:
            prompt = prompt[None, :]
        if max_len is None:
            max_len = int(prompt.shape[1]) + max_new
        key = (max_len, max_new, temperature, top_k, top_p, eos_id, pad_id, with_lengths)
        lens = None if prompt_lens is None else torch.as_tensor(
            np.asarray(prompt_lens), device=self.device)
        if on_mesh:
            return self._generate_on_mesh(key, prompt, lens, rng)
        model = self._gen_cache.get("model")
        if model is None:
            model = self._gen_cache["model"] = self._decode_model().eval()
        params = self._decode_params()
        if self._gen_cache.get("loaded") is not params:
            model.load_state_dict(params, strict=True)
            self._gen_cache["loaded"] = params
        gen = self._gen_cache.get(key)
        if gen is None:
            gen = self._gen_cache[key] = make_generator(
                model, max_len, max_new, temperature, top_k, top_p,
                eos_id=eos_id, pad_id=pad_id, with_lengths=with_lengths)
        return gen(prompt, prompt_lens=lens, rng=rng)

    def _generate_on_mesh(self, key: tuple, prompt, lens, rng):
        """``generate(on_mesh=True)``: decode through the run's own model in
        its sharded layout (a collective: every rank calls it with the same
        arguments and gets the same tokens).  Under tp each model rank runs
        its blocks through the split forward with a cache of its H_kv / tp
        heads; under fsdp each module gathers its leaves for its call and
        releases them (``ShardPlan.gathered_per_call``: each block's for its
        call, the embedding's, the final norm's and the head's for the
        model's); under EP the MoE
        blocks route through the run's all-to-all dispatch, each expert's
        leaves staying on the rank that owns them.  The float32 masters
        are cast to the compute dtype per use, as the default path's
        decode cast does once.  :meth:`_decode_params` is never built."""
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import make_generator

        gen = self._gen_cache.get(("on_mesh",) + key)
        if gen is None:
            gen = self._gen_cache[("on_mesh",) + key] = make_generator(
                self.model, key[0], key[1], key[2], key[3], key[4],
                eos_id=key[5], pad_id=key[6], with_lengths=key[7])
        gathers = (self._plan.gathered_per_call(self.model, model_blocks(self.model))
                   if self.config.fsdp else contextlib.nullcontext())
        with gathers:
            return gen(prompt, prompt_lens=lens, rng=rng)

    def close(self) -> None:
        """Let an async save land, and release a metric writer the trainer
        built itself.  Idempotent."""
        if self._ckpt is not None:
            self._ckpt.close()
        if self._owns_writer:
            self.writer.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def evaluate(self) -> dict[str, float]:
        """Test accuracy and loss over the whole test set (under a mesh a
        collective: every rank calls it, and every rank gets the same).  A
        ZeRO-3 run gathers its fsdp leaves for it."""
        with self._plan.gathered() if self._plan is not None else contextlib.nullcontext():
            out = self._eval(self.test_images, self.test_labels)
        acc, loss = torch.stack([out["accuracy"], out["loss"]]).tolist()
        return {"accuracy": acc, "loss": loss}

    def measure_throughput(self, epochs: int = 10) -> dict[str, Any]:
        """Steady-state training throughput + MFU: ``epochs`` epochs back
        to back with one readback at the end, after one warm-up epoch off
        the clock (in stream mode too, host pipeline included); training
        state is restored afterwards."""
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        cfg = self.config
        snap = self.state.snapshot()
        try:
            t0 = time.perf_counter()
            m = self._epoch(self._epoch_seed(123))
            m["loss"][-1].item()  # the fence
            first_epoch_s = time.perf_counter() - t0

            t1 = time.perf_counter()
            for i in range(epochs):
                m = self._epoch(self._epoch_seed(123, i))
            last_loss = self._rank_mean(m["loss"].mean()).item()
            wall = time.perf_counter() - t1
            if not math.isfinite(last_loss):
                raise RuntimeError(
                    f"non-finite loss during throughput measurement: {last_loss}")
            images = self.steps_per_epoch * cfg.batch_size * epochs
            ips_chip = images / wall / self.n_chips
            result = {
                "images_per_sec": round(images / wall, 1),
                "images_per_sec_per_chip": round(ips_chip, 1),
                "epochs": epochs,
                "steps_per_epoch": self.steps_per_epoch,
                "batch_size": cfg.batch_size,
                "chips": self.n_chips,
                "compile_and_first_epoch_s": round(first_epoch_s, 3),
                **self._mfu_fields(ips_chip),
                "last_loss": last_loss,
                "device": self._device_name(),
            }
            tokens = self._tokens_per_sec(ips_chip)
            if tokens is not None:
                result["tokens_per_sec_per_chip"] = tokens
            return result
        finally:
            self.state.restore(snap)

    def fit(self, preemption=None) -> dict[str, Any]:
        """Run the configured number of epochs (early-stop on target acc).

        ``preemption``: an object with a ``triggered`` property
        (``utils.elastic.PreemptionHandler``) polled after every epoch (and
        every ``preempt_poll_every`` steps in stream mode): when set, the
        loop checkpoints and returns with ``"preempted": True``."""
        cfg = self.config
        if cfg.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {cfg.epochs}")
        if cfg.resume and self._ckpt is not None and self._ckpt.latest_step() is not None:
            step = self.restore_checkpoint()
            self.writer.write("resume", step=step)
        chips = self.n_chips
        # the step base of the records: nonzero after a resume
        step0 = self.state.step
        # the data order is keyed by the ABSOLUTE epoch: a resumed run
        # replays the schedule the uninterrupted run has (a mid-epoch step
        # replays its epoch from the start, as JAX's does)
        abs_epoch0 = step0 // self.steps_per_epoch
        t0 = time.perf_counter()
        epoch_times: list[float] = []
        time_to_target = None
        best_acc = 0.0
        preempted = False
        # epoch metrics stay on the device until a fence (eval, checkpoint
        # or preemption), then come back in one transfer for the interval
        pending: list[tuple[int, dict[str, torch.Tensor]]] = []
        interval_t0 = t0
        first_interval_len = 0
        images = self.steps_per_epoch * cfg.batch_size
        # profile_dir: the epochs after the first one's fence (the kernel
        # builds and allocator growth stay out), all of them at epochs == 1
        prof = TraceSession(cfg.profile_dir) if cfg.profile_dir and self.rank == 0 else None
        if prof is not None and cfg.epochs == 1:
            prof.start()
        try:
            for epoch in range(cfg.epochs):
                if self._chaos is not None:
                    spec = self._chaos.fire("train-step")
                    if spec is not None:
                        if spec.kind != "nan":
                            raise ChaosFault("train-step", spec.kind,
                                             self._chaos.events("train-step") - 1)
                        # poison ONE parameter element: the epoch's loss goes
                        # non-finite and the real detector below must fire
                        if self._plan is not None:  # the first leaf's block
                            with torch.no_grad():
                                self._plan.masters[0].view(-1)[0] = float("nan")
                        else:
                            inject_nan(self.model,
                                       next(iter(self.model.named_parameters()))[0])
                espan = (self._tracer.begin("epoch_dispatch", cat="train", epoch=epoch)
                         if self._tracer is not None else None)
                try:
                    with self._compile.site(f"train_epoch[{self._path_label}]"):
                        metrics = self._epoch(self._epoch_seed(abs_epoch0 + epoch),
                                              preemption)
                except BaseException as e:
                    # a faulted epoch still closes its span: the timeline
                    # shows where the run died
                    if espan is not None:
                        self._tracer.end(espan, error=type(e).__name__)
                    raise
                if espan is not None:
                    self._tracer.end(espan)
                pending.append((epoch, metrics))
                if prof is not None and not prof.active:
                    metrics["loss"][-1].item()  # fence epoch 0 out of the trace
                    prof.start()
                eval_now = (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.epochs - 1
                preempt_now = preemption is not None and self._any_rank(preemption.triggered)
                ckpt_now = bool(self._ckpt is not None and cfg.checkpoint_every
                                and (epoch + 1) % cfg.checkpoint_every == 0)
                if not (eval_now or preempt_now or ckpt_now):
                    continue  # keep the device queue full; no host sync this epoch

                fspan = (self._tracer.begin("fetch", cat="train",
                                            interval_epochs=len(pending))
                         if self._tracer is not None else None)
                keys = ("loss", "accuracy", "moe_dropped_frac")
                means = self._rank_mean(torch.stack(
                    [torch.stack([m[k].mean() for k in keys if k in m])
                     for _, m in pending])).tolist()  # the fence
                if fspan is not None:
                    self._tracer.end(fspan)
                interval = time.perf_counter() - interval_t0
                epoch_time = interval / len(pending)  # amortized over the interval
                if first_interval_len == 0:
                    first_interval_len = len(pending)
                for (ep, _), (loss, acc, *drop) in zip(pending, means):
                    if not math.isfinite(loss):
                        if self._ckpt is not None:
                            self._ckpt.wait()  # a recovery reopens the directory
                        raise TrainingDiverged(
                            f"non-finite train loss in epoch {ep} (leaves localized "
                            f"from end-of-interval state, epoch {epoch})",
                            step=step0 + self.steps_per_epoch * (ep + 1),
                            bad_leaves=self._nonfinite_leaves(),
                        )
                    epoch_times.append(epoch_time)
                    record = {
                        "epoch": ep,
                        "train_loss": loss,
                        "train_accuracy": acc,
                        "epoch_time_s": round(epoch_time, 4),
                        "interval_epochs": len(pending),
                        "images_per_sec": round(images / epoch_time, 1),
                        "images_per_sec_per_chip": round(images / epoch_time / chips, 1),
                    }
                    if drop:
                        # the epoch-mean fraction of (token, choice)
                        # assignments dropped at expert capacity: MoE runs only
                        record["moe_dropped_frac"] = round(drop[0], 6)
                    if ep == epoch and eval_now:
                        vspan = (self._tracer.begin("eval", cat="train", epoch=ep)
                                 if self._tracer is not None else None)
                        with self._compile.site(f"eval[{self._path_label}]"):
                            ev = self.evaluate()
                        if vspan is not None:
                            self._tracer.end(vspan)
                        record["test_accuracy"] = ev["accuracy"]
                        record["test_loss"] = ev["loss"]
                        best_acc = max(best_acc, ev["accuracy"])
                        if (time_to_target is None and cfg.target_accuracy
                                and ev["accuracy"] >= cfg.target_accuracy):
                            time_to_target = time.perf_counter() - t0
                    self.history.append(record)
                    self.writer.write("epoch", step=step0 + self.steps_per_epoch * (ep + 1),
                                      **record)
                    if self._telemetry is not None:
                        self._tel_epochs += 1
                        self._tel_step = step0 + self.steps_per_epoch * (ep + 1)
                        self._telemetry.heartbeat("trainer")
                        self._telemetry.set_gauge("trainer_step", self._tel_step)
                        self._telemetry.maybe_sample()
                pending.clear()
                if ckpt_now:
                    self.save_checkpoint(wait=False)
                if time_to_target is not None and cfg.target_accuracy:
                    break
                if preempt_now:
                    preempted = True
                    self.save_checkpoint(wait=True)
                    self.writer.write("preempted", step=self.state.step)
                    break
                interval_t0 = time.perf_counter()
        finally:
            if prof is not None:
                prof.stop()

        total_time = time.perf_counter() - t0
        # the first interval carries the one-time start-up cost; the steady
        # rate excludes it and the overhead is its excess over steady pace
        steady = epoch_times[first_interval_len:] or epoch_times
        steady_mean = sum(steady) / len(steady)
        overhead = max(0.0, (epoch_times[0] - steady_mean) * first_interval_len)
        ips_chip = images / steady_mean / chips
        summary = {
            "name": cfg.name,
            "epochs_run": len(epoch_times),
            "total_time_s": round(total_time, 3),
            "compile_overhead_s": round(overhead, 3),
            "best_test_accuracy": best_acc,
            "time_to_target_s": round(time_to_target, 3) if time_to_target else None,
            "target_accuracy": cfg.target_accuracy,
            "images_per_sec": round(images / steady_mean, 1),
            "images_per_sec_per_chip": round(ips_chip, 1),
            "param_count": self.state.param_count(),
            **self._mfu_fields(ips_chip),
        }
        tokens = self._tokens_per_sec(ips_chip)
        if tokens is not None:
            summary["tokens_per_sec_per_chip"] = tokens
        if preempted:
            # the preemption path saved already: no second save of the step
            summary["preempted"] = True
        elif self._ckpt is not None:
            self.save_checkpoint(wait=True)
        if self.mesh is not None:  # every rank returns rank 0's summary
            summary = broadcast_object(summary)
        self.writer.write("summary", **summary)
        return summary
