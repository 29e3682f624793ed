"""Execution plans for live (mutable) indexes, sharded or on one device
(the counterpart of ``repro.exec.live``).

``LiveExecutor`` turns a :class:`repro_torch.live.LiveIndex` snapshot into
an :class:`repro_torch.exec.plan.ExecutionPlan` and keeps what makes
repeat searches cheap:

* **partition structure** — the base segment is one partition group
  (document-sharded over a ``launch.mesh.Mesh`` by ``shard_index`` when a
  mesh or ``n_shards > 1`` is given, ``exec.sharded``), and all delta
  segments form a second (``repro_torch.exec.segments``), replicated:
  every process of a sharded deployment runs it.  The plan's cross-group
  merge is the same ``merge_topk`` the groups use;
* **stage 1 once a batch** — every segment shares the base's centroid
  space, so without a mesh ``core.pipeline.shared_stage1`` runs once per
  batch against the base's centroids and feeds every segment of both
  groups (each shard of a sharded base runs its own, as the reference's
  ``shard_map`` does);
* **per-segment data** (each group's bucket and search) is cached per
  segment list, the entry of a superseded list dropped at the next plan
  build; the plan holds its segments weakly, so a compaction's old base is
  freed once no snapshot holds it.  The alive masks (the snapshot's
  per-segment device tensors) and pid offsets are built once per
  generation, so deletes and ``t_cs`` sweeps rebuild only the plan's
  wiring.

The bucket comes from Python ints of segment metadata, never from a device
read, and nothing in a search waits for the device.  A compaction swaps
in a new base, which the executor notices by its segment id and
re-shards; base tombstones ride in the padded sharded pid space, where
the pads are dead.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch.core import pipeline, plaid
from repro_torch.exec import segments as seg_exec
from repro_torch.exec import sharded as shard_exec
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.launch.mesh import mesh_for_shards  # noqa: F401  (the reference's home)


def _to(x, device):
    """A tensor, or a tuple of them (``FunnelStats``), on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(v.to(device) for v in x))


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
        self.live = live
        self.params = params or plaid.SearchParams()
        if mesh is None and n_shards is not None and n_shards > 1:
            mesh = mesh_for_shards(n_shards, live.device)
        self.mesh = mesh
        self.n_shards = mesh.n_shards if mesh is not None else 1
        if n_shards is not None and self.n_shards != max(n_shards, 1):
            raise ValueError(
                f"n_shards={n_shards} must equal the mesh's shard count "
                f"({self.n_shards}); build the mesh to match"
            )
        # guards every cache below: one retriever may be shared between
        # threads.  Searches run outside the lock (plans are immutable).
        self._lock = threading.Lock()
        self._stacked_fns: dict = {}  # (bucket, impl, funnel) -> run
        self._buckets: dict = {}  # seg_ids -> SegmentBucket
        self._base_shards = None  # dict(sid, shards, meta, per, fns)
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

    def _sharded_base_group(self, base, base_sid, alive, funnel):
        from repro_torch.core.engine_sharded import shard_index

        st = self._base_shards
        if st is None or st["sid"] != base_sid:  # first use, or compacted
            self._base_shards = st = None  # free the old shards first
            idx_dict, meta, per = shard_index(base, self.n_shards)
            shards = shard_exec.place_shards(self.mesh, idx_dict, meta)
            del idx_dict
            st = dict(sid=base_sid, shards=shards, meta=meta, per=per, fns={})
            self._base_shards = st
        fkey = (self.params.impl, funnel)
        if fkey not in st["fns"]:
            st["fns"][fkey] = shard_exec.make_sharded_search(
                self.mesh,
                shard_exec.clamp_to_shard(self.params, st["per"]),
                docs_per_shard=st["per"],
                static_meta=st["meta"],
                funnel=funnel,
            )
        fn = st["fns"][fkey]
        # base tombstones in the padded sharded pid space (pads are dead)
        padded = torch.zeros(self.n_shards * st["per"], dtype=torch.bool, device=alive.device)
        padded[: alive.shape[0]] = alive
        shards, home = st["shards"], base.device

        def group(qs, q_masks, t_cs, stage1):
            # on the base's device, where the delta group's tuples are
            return tuple(_to(x, home) for x in fn(shards, qs, q_masks, t_cs, padded))

        return group

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
        stacked = (slice(0, 1), slice(1, None))  # the base, then the deltas
        if self.mesh is not None:
            groups.append(
                self._sharded_base_group(segs[0], sids[0], snapshot.alive[0], funnel)
            )
            stacked = stacked[1:]
        for sl in stacked:
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
        # a sharded base runs stage 1 on each shard; the delta group then
        # runs its own from its first segment (the same centroids)
        stage1 = None if self.mesh is not None else pipeline.shared_stage1(
            base, qs, t, self.params)
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
