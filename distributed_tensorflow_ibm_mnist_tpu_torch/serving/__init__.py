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
  :class:`~.policies.SLOUnmeetable`)
"""

from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import (
    Int8Linear,
    is_quantized,
    quantize_kernel_int8,
    quantize_state_dict_int8,
    weight_stream_bytes,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.daemon import (
    DaemonRequest,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.drafter import NgramDrafter
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.engine import (
    EngineStalled,
    InferenceEngine,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    KVPagePool,
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

__all__ = [
    "GREEDY",
    "AdmissionPolicy",
    "DaemonRequest",
    "DeadlineAwarePolicy",
    "EngineStalled",
    "FIFOPolicy",
    "FIFOScheduler",
    "InferenceEngine",
    "Int8Linear",
    "KVPagePool",
    "NgramDrafter",
    "NoHealthyReplica",
    "PrefixCache",
    "PriorityPolicy",
    "QueueFull",
    "RadixCache",
    "Replica",
    "Request",
    "Router",
    "RouterRequest",
    "SLOUnmeetable",
    "SamplingParams",
    "ServingDaemon",
    "ServingStats",
    "WeightWatcher",
    "is_quantized",
    "pages_needed",
    "prefix_key",
    "quantize_kernel_int8",
    "quantize_state_dict_int8",
    "request_fingerprint",
    "slo_verdict",
    "transcript_digest",
    "weight_stream_bytes",
]
