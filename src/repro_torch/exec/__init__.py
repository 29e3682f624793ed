"""``repro_torch.exec`` — the partition-execution layer (the counterpart of
``repro.exec``).

Every partitioned search is an :class:`ExecutionPlan`: partition groups,
each running the batch-first pipeline (``core.pipeline.run_pipeline``) per
partition, joined by ONE shared top-k merge
(``repro_torch.distributed.topk.merge_topk``).

* :mod:`repro_torch.exec.plan`     — the plan and the cross-group merge;
* :mod:`repro_torch.exec.segments` — the stacked-segment group (a loop over
  real segments that keeps the reference's clamp, padding, offsets and
  funnel) and the pow2 bucket rule;
* :mod:`repro_torch.exec.sharded`  — device-sharded partitions: the
  pipeline per shard of a ``launch.mesh.Mesh``, one collective merge;
* :mod:`repro_torch.exec.live`     — plan builder/cache for mutable
  indexes (the base sharded over a mesh, or on one device);
* :mod:`repro_torch.exec.bucketed` — pow2-bucketed static-cap dispatch:
  dynamic ``nprobe`` / ``ndocs`` sweeps over a few launch shapes;
* :mod:`repro_torch.exec.tiered`   — tiered doc-range partitions (host
  payloads, per-batch slice copies) as plan groups.
"""
from repro_torch.exec.bucketed import BucketedCapEngine
from repro_torch.exec.live import LiveExecutor, mesh_for_shards
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.exec.segments import (
    SegmentBucket,
    bucket_for,
    ceil_pow2,
    make_stacked_search,
    pack_offsets,
    pow2_bucket,
)
from repro_torch.exec.sharded import (
    DOC_AXES,
    index_as_dict,
    make_sharded_search,
    n_doc_shards,
    place_shards,
)
from repro_torch.exec.tiered import TieredExecutor, partition_tiered

__all__ = [
    "BucketedCapEngine",
    "DOC_AXES",
    "ExecutionPlan",
    "LiveExecutor",
    "SegmentBucket",
    "TieredExecutor",
    "bucket_for",
    "ceil_pow2",
    "index_as_dict",
    "make_sharded_search",
    "make_stacked_search",
    "mesh_for_shards",
    "n_doc_shards",
    "pack_offsets",
    "partition_tiered",
    "place_shards",
    "pow2_bucket",
]
