"""Device-sharded partition execution: one mesh device = one document
shard (the counterpart of ``repro.exec.sharded``).

Every shard runs the stock batch-first pipeline (``core.pipeline``) on its
sub-corpus, on its own device, offsets its local pids into the global id
space (``distributed.topk.local_to_global_pids``) and joins the one shared
merge (``distributed.topk.merge_topk`` over the mesh, the collective
case: the bytes gathered are independent of the corpus size).  With
``params.impl="cuda"`` each shard launches K1 (stages 2 and 3) and K2, or
K3 when ``fused``, on its device.

The reference runs this under ``shard_map`` on a ``jax`` mesh; here a
``launch.mesh.Mesh`` lists this process's shard devices and the process
group joining the others, and the shards of one process run one after
another.  Nothing waits for the device before the caller's ``_finish``
(across a gloo group the gathered tuples cross the host).

The tombstone bitmap ``alive`` is a per-call operand in the sharded
(padded) pid space, so a sharded index serves a mutable pid space
(``repro_torch.exec.live``) without re-sharding on deletes.
``repro_torch.core.engine_sharded`` holds the partitioner ``shard_index``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pipeline
from repro_torch.core.index import ARRAY_FIELDS, PlaidIndex
from repro_torch.distributed import topk as dtopk
from repro_torch.obs import funnel as funnel_mod

#: the reference's mesh axes, flattened into one logical docs axis; the
#: port's ``Mesh`` is flat already (its ``shape`` names the one axis)
DOC_AXES = ("pod", "data", "model")

#: centroid-space arrays: replicated on every shard, not doc-partitioned
REPLICATED_FIELDS = ("centroids", "centroids_q", "centroids_scale", "cutoffs", "weights")

#: static metadata for callers that pass bare array dicts without any
_DEFAULT_META = dict(dim=128, nbits=2, doc_maxlen=128, ivf_list_cap=256, eivf_list_cap=512)


def n_doc_shards(mesh) -> int:
    return mesh.n_shards


def index_as_dict(index: PlaidIndex) -> dict:
    """A PlaidIndex's array fields as a dict."""
    return {f: getattr(index, f) for f in ARRAY_FIELDS}


def _n_stacked(idx_dict: dict) -> int:
    """How many shards a stacked dict holds (one ``(K+1,)`` IVF offset
    table each)."""
    return idx_dict["ivf_offsets"].shape[0] // (idx_dict["centroids"].shape[0] + 1)


def place_shards(mesh, idx_dict: dict, static_meta: dict | None = None) -> list:
    """This process's shards of a shard-stacked dict (``shard_index``
    layout) as ``PlaidIndex`` objects on their mesh devices.

    The dict holds either every shard of the mesh (this process takes its
    own) or exactly this process's.  A shard on the dict's device is a
    view of it, not a copy.
    """
    meta = dict(_DEFAULT_META)
    meta.update(static_meta or {})
    n_local = len(mesh.devices)
    n = _n_stacked(idx_dict)
    if n == mesh.n_shards:
        ids = list(mesh.shard_ids())
    elif n == n_local:
        ids = list(range(n_local))
    else:
        raise ValueError(
            f"the index dict holds {n} shards; the mesh has {mesh.n_shards} "
            f"({n_local} in this process)"
        )
    shards = []
    for dev, s in zip(mesh.devices, ids):
        arrays = {}
        for f in ARRAY_FIELDS:
            v = idx_dict[f]
            if f not in REPLICATED_FIELDS:
                rows = v.shape[0] // n
                v = v[s * rows : (s + 1) * rows]
            arrays[f] = v.to(dev)
        shards.append(PlaidIndex(**arrays, **meta))
    return shards


def make_sharded_search(mesh, params, *, docs_per_shard: int, static_meta: dict | None = None,
                        funnel: bool = False):
    """Returns ``search(index, qs, q_masks, t_cs=None, alive=None) ->
    ((B, k) scores, (B, k) global pids[, FunnelStats])`` on the mesh's
    first device.

    ``index`` is a shard-stacked dict (``shard_index`` layout: every
    doc-partitioned array stacked along axis 0 in shard order, offsets
    LOCAL to each shard) or this process's shards already placed
    (:func:`place_shards`).  Queries are replicated to every shard.
    ``funnel=True`` appends the mesh-merged ``FunnelStats``
    (``obs.funnel.psum_partitions``).  ``alive`` is a ``(n_shards *
    docs_per_shard,)`` bool bitmap in the sharded (padded) pid space;
    ``None`` is all alive.

    ``params`` are used as given: stage 3's keep comes from the raw
    ``ndocs // 4`` as in the reference, so callers clamp only
    ``candidate_cap`` (to the shard's corpus), never ``ndocs``.
    """
    meta = dict(_DEFAULT_META)
    meta.update(static_meta or {})
    per = int(docs_per_shard)

    def run(index, qs, q_masks, t_cs=None, alive=None):
        shards = index if isinstance(index, (list, tuple)) else place_shards(mesh, index, meta)
        t = params.t_cs if t_cs is None else t_cs
        scores, pids, stats = [], [], []
        for dev, s, shard in zip(mesh.devices, mesh.shard_ids(), shards):
            a = None if alive is None else alive[s * per : (s + 1) * per].to(dev)
            tt = t.to(dev) if isinstance(t, torch.Tensor) else t
            sc, pid, *aux = pipeline.run_pipeline(
                shard, qs.to(dev), q_masks.to(dev), tt, params, funnel=funnel, alive=a,
            )  # (B, kk) a shard
            scores.append(sc)
            pids.append(dtopk.local_to_global_pids(pid, s, per))
            stats.extend(aux)
        merged = dtopk.merge_topk(scores, pids, params.k, mesh=mesh)
        if funnel:
            return (*merged, funnel_mod.psum_partitions(stats, mesh))
        return merged

    return run


def clamp_to_shard(params, docs_per_shard: int):
    """The stage-1 bound is per shard: ``candidate_cap`` clamped to the
    shard's corpus, ``max(per, 2)``; ``ndocs`` is left as given."""
    return dataclasses.replace(
        params, candidate_cap=min(params.candidate_cap, max(int(docs_per_shard), 2))
    )
