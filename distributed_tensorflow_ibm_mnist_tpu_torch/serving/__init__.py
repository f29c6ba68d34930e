"""Continuous-batching serving of the port: a host loop over batched decode.

* :class:`~.engine.InferenceEngine` — the slot-multiplexed engine:
  decode-ahead windows with the prefill overlap, per-request sampling,
  the prefix cache and the paged KV cache with the radix trie,
  speculative decoding, int8 weights and KV, chunked prefill, and the
  stall watchdog (:class:`~.engine.EngineStalled`)
* :class:`~.drafter.NgramDrafter` — model-free prompt-lookup drafting for
  speculative decoding
* the int8 helpers of models/quant.py (``quantize_kernel_int8``,
  ``quantize_state_dict_int8``, ``is_quantized``, ``weight_stream_bytes``,
  ``Int8Linear``)
* :class:`~.scheduler.FIFOScheduler` / :class:`~.scheduler.Request` —
  bounded FIFO admission with prompt-length bucketing and deadlines
* :class:`~.sampling.SamplingParams` — the per-request sampling config
  (temperature, top-p, top-k, min-p, seed) on JAX's Threefry key schedule
* :class:`~.prefix_cache.PrefixCache` — the byte-bounded whole-prompt LRU
* :class:`~.kv_pool.KVPagePool` / :class:`~.radix_cache.RadixCache` —
  the paged pool's allocator and the prefix-sharing trie over it
* :class:`~.stats.ServingStats` — TTFT/latency percentiles, tokens/sec,
  occupancy, windows, sampling, SLO/goodput, prefix-cache and page
  accounting, and the cluster rollup ``merge``; :func:`~.stats.slo_verdict`
  and :func:`~.stats.transcript_digest`
* :class:`~.replica.Replica` / :class:`~.router.Router` /
  :class:`~.router.WeightWatcher` — the multi-replica tier: least-loaded
  dispatch, failover with exactly-once streams, hot swap from a trainer's
  checkpoints (:class:`~.router.RouterRequest`,
  :class:`~.router.NoHealthyReplica`)
* :class:`~.daemon.ServingDaemon` / :class:`~.daemon.DaemonRequest` — the
  threaded service front over a router, with the admission policies of
  serving/policies.py (:class:`~.policies.FIFOPolicy`,
  :class:`~.policies.PriorityPolicy`, :class:`~.policies.DeadlineAwarePolicy`,
  :class:`~.policies.SLOUnmeetable`), cancel, and elastic capacity
  (``add_replica``, ``restart_replica``, ``retire_replica``) steered by
  :class:`~.autoscaler.Autoscaler`
* the front door: :class:`~.frontend.FrontDoor` — an asyncio HTTP/1.1 +
  SSE server over the daemon (``POST /v1/generate`` streaming or unary,
  ``GET /healthz``, ``GET /metrics``; 429/503 with ``Retry-After``;
  ``Idempotency-Key`` and ``Last-Event-ID`` resume) with
  :class:`~.frontend.FrontDoorClient` as the stdlib wire client;
  :class:`~.traces.ArrivalTrace` / :class:`~.traces.TraceEvent` and the
  trace generators, :func:`~.traces.replay_trace`
* crash durability: :class:`~.journal.RequestJournal` — the checksummed,
  segment-rotated write-ahead request journal wired through
  ``ServingDaemon(journal=)``; :func:`~.journal.scan_journal` reads it
  torn-tail tolerant and :func:`~.journal.recover` rebuilds a tier after
  a SIGKILL, replaying every incomplete request exactly-once
* disaggregation: ``InferenceEngine(role="prefill" | "decode")`` and
  ``Router(roles=)``, the paged-KV handoff of serving/kv_handoff.py
  (:class:`~.kv_handoff.HandoffPacket`)
"""

from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    Int8Linear,
    is_quantized,
    quantize_kernel_int8,
    quantize_state_dict_int8,
    weight_stream_bytes,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.autoscaler import Autoscaler
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.daemon import (
    DaemonRequest,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.drafter import NgramDrafter
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.engine import (
    EngineStalled,
    InferenceEngine,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.frontend import (
    FrontDoor,
    FrontDoorClient,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.journal import (
    JournalScan,
    JournalWriteError,
    RecoveredRequest,
    Recovery,
    RequestJournal,
    recover,
    scan_journal,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_handoff import HandoffPacket
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    KVPagePool,
    init_paged_cache,
    pages_needed,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.policies import (
    AdmissionPolicy,
    DeadlineAwarePolicy,
    FIFOPolicy,
    PriorityPolicy,
    SLOUnmeetable,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    prefix_key,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.radix_cache import RadixCache
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.replica import Replica
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.router import (
    NoHealthyReplica,
    Router,
    RouterRequest,
    WeightWatcher,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import (
    GREEDY,
    SamplingParams,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    FIFOScheduler,
    QueueFull,
    Request,
    request_fingerprint,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import (
    ServingStats,
    slo_verdict,
    transcript_digest,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.traces import (
    ArrivalTrace,
    TraceEvent,
    bursty_trace,
    diurnal_trace,
    heavy_tail_trace,
    per_class_report,
    poisson_trace,
    replay_trace,
    with_slos,
)

__all__ = [
    "GREEDY",
    "AdmissionPolicy",
    "ArrivalTrace",
    "Autoscaler",
    "DaemonRequest",
    "DeadlineAwarePolicy",
    "EngineStalled",
    "FIFOPolicy",
    "FIFOScheduler",
    "FrontDoor",
    "FrontDoorClient",
    "HandoffPacket",
    "InferenceEngine",
    "Int8Linear",
    "JournalScan",
    "JournalWriteError",
    "KVPagePool",
    "NgramDrafter",
    "NoHealthyReplica",
    "PrefixCache",
    "PriorityPolicy",
    "QueueFull",
    "RadixCache",
    "RecoveredRequest",
    "Recovery",
    "Replica",
    "Request",
    "RequestJournal",
    "Router",
    "RouterRequest",
    "SLOUnmeetable",
    "SamplingParams",
    "ServingDaemon",
    "ServingStats",
    "TraceEvent",
    "WeightWatcher",
    "bursty_trace",
    "diurnal_trace",
    "heavy_tail_trace",
    "init_paged_cache",
    "is_quantized",
    "pages_needed",
    "per_class_report",
    "poisson_trace",
    "prefix_key",
    "quantize_kernel_int8",
    "quantize_state_dict_int8",
    "recover",
    "replay_trace",
    "request_fingerprint",
    "scan_journal",
    "slo_verdict",
    "transcript_digest",
    "weight_stream_bytes",
    "with_slos",
]
