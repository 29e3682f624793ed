"""``repro_torch.serving`` — the continuous-batching serving tier (the
counterpart of ``repro.serving``).

The robustness/perf front door for every retrieval backend:

* :mod:`repro_torch.serving.server` — :class:`BatchingServer`: bucketed
  coalescing dispatch, per-request ``t_cs``/``k`` knobs, cache-fronted
  submit, graceful drain
* :mod:`repro_torch.serving.buckets` — pow2 batch-shape buckets on the
  query axis (the ``repro_torch.exec.segments`` padding discipline)
* :mod:`repro_torch.serving.admission` — typed errors, bounded two-level
  priority queue, load shedding, deadlines
* :mod:`repro_torch.serving.cache` — exact-match result cache with
  LiveIndex-generation invalidation
* :mod:`repro_torch.serving.replicas` — :class:`ReplicaPool`:
  least-outstanding-work routing over N retrievers
* :mod:`repro_torch.serving.stats` — bounded latency window + counters

See README "The PyTorch/CUDA port".
"""
from repro_torch.serving.admission import (
    AdmissionError,
    AdmissionQueue,
    DeadlineExceeded,
    QueueFull,
    ServerClosed,
    ServingError,
)
from repro_torch.serving.buckets import bucket_batch_size, bucket_ladder
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.replicas import ReplicaPool
from repro_torch.serving.server import BatchingServer, RetrievalResult, ResultFuture
from repro_torch.serving.stats import LatencyWindow

__all__ = [
    "BatchingServer",
    "RetrievalResult",
    "ResultFuture",
    "ReplicaPool",
    "ResultCache",
    "LatencyWindow",
    "AdmissionQueue",
    "ServingError",
    "AdmissionError",
    "QueueFull",
    "DeadlineExceeded",
    "ServerClosed",
    "bucket_batch_size",
    "bucket_ladder",
]
