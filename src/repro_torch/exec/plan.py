"""ExecutionPlan: every partitioned search = partitions + ONE shared merge
(the counterpart of ``repro.exec.plan``).

    partitions (each: the pipeline locally, pids offset to global space)
        │ (B, k) score/pid tuples per partition group
        ▼
    distributed.topk.merge_topk   — the ONLY merge implementation

A *partition group* is a callable searching one set of partitions and
merging them itself (:mod:`repro_torch.exec.segments`).  A plan with one
group returns that group's result as is; with several, their tuples are
concatenated and merged once more, which gives the ranking of one flat
merge because ``merge_topk``'s ``(-score, pid)`` order is
hierarchy-invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.distributed import topk as dtopk
from repro_torch.obs import funnel as funnel_mod

#: A partition group: (qs, q_masks, t_cs, stage1) -> ((B, k) scores, (B, k)
#: global pids[, obs.FunnelStats]); the funnel output is present iff the
#: plan was built with ``funnel=True``.  ``stage1`` is
#: ``core.pipeline.shared_stage1`` of the batch, shared by every group.
PartitionGroup = Callable


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One search's structure: partition groups + the shared top-k merge."""

    groups: Sequence[PartitionGroup]
    k: int
    #: When True every group returns a third ``obs.FunnelStats`` output and
    #: ``search_batch`` merges them (doc-space counts add across groups,
    #: centroid-space counts max).
    funnel: bool = False

    def search_batch(self, qs, q_masks, t_cs, stage1=None):
        """qs (B, nq, dim), q_masks (B, nq), t_cs scalar or (B,) -> (B, k)."""
        parts = [g(qs, q_masks, t_cs, stage1) for g in self.groups]
        fstats = funnel_mod.merge([p[2] for p in parts]) if self.funnel else None
        if len(parts) == 1:
            scores, pids = parts[0][0], parts[0][1]
        else:
            scores = torch.cat([p[0] for p in parts], dim=-1)
            pids = torch.cat([p[1] for p in parts], dim=-1)
            scores, pids = dtopk.merge_topk(scores, pids, self.k)
        if self.funnel:
            return scores, pids, fstats
        return scores, pids
