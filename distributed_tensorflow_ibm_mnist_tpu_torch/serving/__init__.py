"""Continuous-batching serving of the port: a host loop over batched decode.

* :class:`~.engine.InferenceEngine` — the slot-multiplexed greedy engine
* :class:`~.scheduler.FIFOScheduler` / :class:`~.scheduler.Request` —
  bounded FIFO admission with prompt-length bucketing and deadlines
* :class:`~.sampling.SamplingParams` — the per-request sampling config
  (greedy only in this slice)
* :class:`~.stats.ServingStats` — TTFT/latency percentiles, tokens/sec,
  slot occupancy
"""

from distributed_tensorflow_ibm_mnist_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.prefix_cache import prefix_key
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.sampling import SamplingParams
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.scheduler import (
    FIFOScheduler,
    QueueFull,
    Request,
    request_fingerprint,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.stats import ServingStats

__all__ = [
    "FIFOScheduler",
    "InferenceEngine",
    "QueueFull",
    "Request",
    "SamplingParams",
    "ServingStats",
    "prefix_key",
    "request_fingerprint",
]
