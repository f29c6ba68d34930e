"""Continuous-batching serving of the port: a host loop over batched decode.

* :class:`~.engine.InferenceEngine` — the slot-multiplexed engine:
  decode-ahead windows with the prefill overlap, per-request sampling,
  the prefix cache and the paged KV cache with the radix trie
* :class:`~.scheduler.FIFOScheduler` / :class:`~.scheduler.Request` —
  bounded FIFO admission with prompt-length bucketing and deadlines
* :class:`~.sampling.SamplingParams` — the per-request sampling config
  (temperature, top-p, top-k, min-p, seed) on JAX's Threefry key schedule
* :class:`~.prefix_cache.PrefixCache` — the byte-bounded whole-prompt LRU
* :class:`~.kv_pool.KVPagePool` / :class:`~.radix_cache.RadixCache` —
  the paged pool's allocator and the prefix-sharing trie over it
* :class:`~.stats.ServingStats` — TTFT/latency percentiles, tokens/sec,
  occupancy, windows, sampling, prefix-cache and page accounting
"""

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import (
    KVPagePool,
    pages_needed,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import (
    PrefixCache,
    prefix_key,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.radix_cache import RadixCache
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
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import ServingStats

__all__ = [
    "GREEDY",
    "FIFOScheduler",
    "InferenceEngine",
    "KVPagePool",
    "PrefixCache",
    "QueueFull",
    "RadixCache",
    "Request",
    "SamplingParams",
    "ServingStats",
    "pages_needed",
    "prefix_key",
    "request_fingerprint",
]
