"""Execution plans for live (mutable) indexes on one device (the
counterpart of ``repro.exec.live``).

``LiveExecutor`` turns a :class:`repro_torch.live.LiveIndex` snapshot into
an :class:`repro_torch.exec.plan.ExecutionPlan` and keeps what makes
repeat searches cheap:

* **partition structure** — the base segment is one partition group and
  all delta segments form a second (``repro_torch.exec.segments``); the
  plan's cross-group merge is the same ``merge_topk`` the groups use;
* **stage 1 once a batch** — every segment shares the base's centroid
  space, so ``core.pipeline.shared_stage1`` runs once per batch against
  the base's centroids and feeds every segment of both groups;
* **per-segment data** (each group's bucket and search) is cached per
  segment list, the entry of a superseded list dropped at the next plan
  build; the plan holds its segments weakly, so a compaction's old base is
  freed once no snapshot holds it.  The alive masks (the snapshot's
  per-segment device tensors) and pid offsets are built once per
  generation, so deletes and ``t_cs`` sweeps rebuild only the plan's
  wiring.

The bucket comes from Python ints of segment metadata, never from a device
read, and nothing in a search waits for the device.  The sharded base
(``mesh`` / ``n_shards > 1``) and ``mesh_for_shards`` belong to the
multi-GPU slice.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch.core import pipeline, plaid
from repro_torch.exec import segments as seg_exec
from repro_torch.exec.plan import ExecutionPlan


class LiveExecutor:
    """Plan builder/cache over one LiveIndex (see module docstring)."""

    def __init__(
        self,
        live,
        params: plaid.SearchParams | None = None,
        *,
        mesh=None,
        n_shards: int | None = None,
    ):
        if mesh is not None or (n_shards is not None and n_shards > 1):
            raise NotImplementedError(
                "a document-sharded live base (mesh / n_shards > 1) belongs to "
                "the multi-GPU slice (ROADMAP Queue 1 item 7)"
            )
        self.live = live
        self.params = params or plaid.SearchParams()
        self.mesh = None
        self.n_shards = 1
        # guards every cache below: one retriever may be shared between
        # threads.  Searches run outside the lock (plans are immutable).
        self._lock = threading.Lock()
        self._stacked_fns: dict = {}  # (bucket, impl, funnel) -> run
        self._buckets: dict = {}  # seg_ids -> SegmentBucket
        self._plan_key = None
        self._plan = None

    # ---- partition groups -------------------------------------------------
    def _stacked_group(self, segments, seg_ids, offsets, alive, funnel):
        pkey = tuple(seg_ids)
        if pkey not in self._buckets:
            self._buckets[pkey] = seg_exec.bucket_for(segments)
        bucket = self._buckets[pkey]
        fkey = (bucket, self.params.impl, funnel)
        if fkey not in self._stacked_fns:
            self._stacked_fns[fkey] = seg_exec.make_stacked_search(
                self.params, bucket, funnel=funnel
            )
        fn = self._stacked_fns[fkey]
        offs = seg_exec.pack_offsets(offsets, bucket, segments[0].device)
        # weak: a cached plan must not pin a segment list that a compaction
        # replaced.  A plan runs only for its own generation, whose snapshot
        # holds these segments for the whole search.
        refs = tuple(weakref.ref(s) for s in segments)

        def group(qs, q_masks, t_cs, stage1):
            return fn([r() for r in refs], qs, q_masks, t_cs, offs, alive, stage1)

        return group, pkey

    # ---- plan assembly ----------------------------------------------------
    def plan_for(self, snapshot, funnel: bool = False) -> ExecutionPlan:
        """The (cached) ExecutionPlan for one LiveIndex snapshot."""
        key = (snapshot.generation, self.params.impl, funnel)
        with self._lock:
            if self._plan_key == key:
                return self._plan
            return self._build_plan(snapshot, funnel, key)

    def _build_plan(self, snapshot, funnel, key):
        groups, live_pkeys = [], set()
        segs, sids = snapshot.segments, snapshot.seg_ids
        for sl in (slice(0, 1), slice(1, None)):  # the base, then the deltas
            if not segs[sl]:
                continue
            g, pkey = self._stacked_group(
                segs[sl], sids[sl], snapshot.offsets[sl], snapshot.alive[sl], funnel
            )
            groups.append(g)
            live_pkeys.add(pkey)
        # drop the buckets of segment lists a compaction replaced
        self._buckets = {k: v for k, v in self._buckets.items() if k in live_pkeys}
        plan = ExecutionPlan(tuple(groups), self.params.k, funnel=funnel)
        self._plan_key, self._plan = key, plan
        return plan

    # ---- search -----------------------------------------------------------
    def search_batch(self, qs, q_masks=None, *, t_cs=None, funnel: bool = False):
        """qs: (B, nq, dim) -> ((B, k) scores, (B, k) global pids[, merged
        obs.FunnelStats when ``funnel=True``]), on the index's device."""
        snapshot = self.live.snapshot()
        base = snapshot.segments[0]
        dev = base.device
        qs = plaid._as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = plaid._as_queries(q_masks, dev, 2)
        t = self.params.t_cs if t_cs is None else t_cs
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        plan = self.plan_for(snapshot, funnel)
        stage1 = pipeline.shared_stage1(base, qs, t, self.params)
        return plan.search_batch(qs, q_masks, t, stage1)

    def search(self, q, q_mask=None, *, t_cs=None, funnel: bool = False):
        """q: (nq, dim) -> ((k,), (k,)[, FunnelStats of 0-d counts]).  B=1
        squeeze of the batch path."""
        dev = self.live.base.device
        q = plaid._as_queries(q, dev, 2)
        mask = None if q_mask is None else plaid._as_queries(q_mask, dev, 1)[None]
        scores, pids, *aux = self.search_batch(q[None], mask, t_cs=t_cs, funnel=funnel)
        if funnel:
            fs = aux[0]
            return scores[0], pids[0], type(fs)(*(v[0] for v in fs))
        return scores[0], pids[0]
