"""FunnelStats: per-query candidate counts through the PLAID funnel (the
counterpart of ``repro.obs.funnel``).

A few cheap reductions (``sum`` / ``sort`` over tensors the pipeline
already holds) that ``core.pipeline.run_pipeline(funnel=True)`` appends to
its outputs and ``retrieval.SearchResult.funnel`` carries to the caller.

All fields are per-lane ``(B,)`` int32 counts:

==========================  ===============================================
``probed_centroids``        distinct centroids the lane's top-``nprobe``
                            probe selected (<= nq*nprobe)
``stage1_candidates``       unique candidate passages out of the IVF walk
``alive_dropped``           distinct tombstoned passages the alive mask
                            removed BEFORE the candidate cap
``stage2_kept_centroids``   centroids surviving the ``t_cs`` prune
``stage2_survivors``        passages surviving stage-2 top-``ndocs``
``stage3_survivors``        finalists entering exact rescoring
``gathered_tokens``         doc tokens fetched by the shared gather
==========================  ===============================================

Merge semantics, for partitioned execution: documents are partitioned and
centroids replicated, so the doc-space counts ADD across partitions while
the centroid-space counts are identical per partition and merge by MAX.
Across device shards (:func:`psum_partitions`) the doc-space counts are
summed over every shard of the mesh and the centroid-space counts pass
through.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FunnelStats(NamedTuple):
    """Per-lane (B,) int32 counts at each funnel stage."""

    probed_centroids: torch.Tensor
    stage1_candidates: torch.Tensor
    alive_dropped: torch.Tensor
    stage2_kept_centroids: torch.Tensor
    stage2_survivors: torch.Tensor
    stage3_survivors: torch.Tensor
    gathered_tokens: torch.Tensor


#: Doc-space counts: partitions hold disjoint documents -> counts ADD.
ADDITIVE_FIELDS = (
    "stage1_candidates",
    "alive_dropped",
    "stage2_survivors",
    "stage3_survivors",
    "gathered_tokens",
)
#: Centroid-space counts: every partition shares ONE replicated centroid
#: space, so per-partition values are identical -> merge by MAX.
REPLICATED_FIELDS = ("probed_centroids", "stage2_kept_centroids")


def _apply(stats: FunnelStats, additive, replicated) -> FunnelStats:
    return FunnelStats(
        **{f: additive(getattr(stats, f)) for f in ADDITIVE_FIELDS},
        **{f: replicated(getattr(stats, f)) for f in REPLICATED_FIELDS},
    )


def reduce_stacked(stats: FunnelStats) -> FunnelStats:
    """(S, B) stacked-segment fields -> merged (B,)."""
    return _apply(
        stats,
        additive=lambda a: a.sum(dim=0, dtype=torch.int32),
        replicated=lambda a: a.amax(dim=0),
    )


def psum_partitions(stats_list, mesh) -> FunnelStats:
    """The mesh merge of this process's per-shard ``FunnelStats`` (in
    shard order): the doc-space counts summed over every shard of the mesh
    (one gather through ``launch.mesh.gather_shards``), the centroid-space
    counts passed through (they are the same on every shard: the centroids
    replicate).  Fields land on the mesh's first device."""
    from repro_torch.launch.mesh import gather_shards

    stats_list = list(stats_list)
    parts = [torch.stack([getattr(s, f) for f in ADDITIVE_FIELDS])[None] for s in stats_list]
    summed = gather_shards(mesh, parts, dim=0).sum(dim=0, dtype=torch.int32)
    home = mesh.devices[0]
    return FunnelStats(
        **dict(zip(ADDITIVE_FIELDS, summed)),
        **{f: getattr(stats_list[0], f).to(home) for f in REPLICATED_FIELDS},
    )


def merge(stats_list) -> FunnelStats:
    """Cross-group merge: elementwise add / max."""
    stats_list = list(stats_list)
    out = stats_list[0]
    for s in stats_list[1:]:
        out = FunnelStats(
            **{f: getattr(out, f) + getattr(s, f) for f in ADDITIVE_FIELDS},
            **{
                f: torch.maximum(getattr(out, f), getattr(s, f))
                for f in REPLICATED_FIELDS
            },
        )
    return out


def to_host(stats: FunnelStats) -> dict:
    """Tensors on any device -> plain dict of host numpy arrays, in one copy
    from the device (the fields are stacked first)."""
    host = torch.stack(tuple(stats)).cpu().numpy()
    return dict(zip(FunnelStats._fields, host))
