"""Mutable-corpus retrieval backends: the ``"live"`` family behind the facade
(the counterpart of ``repro.live.backend``).

=====================  ===================================================
``live``               Segmented mutable index on one device, plain
                       PyTorch ops
``live-cuda``          The same through the Hopper kernels (the
                       counterpart of ``live-pallas``): K1 for stages 2/3
                       and K2, or K3 when ``fused=True``, for stage 4, on
                       every segment; on CPU tensors the kernels' plain
                       versions run
``live-sharded``       The base segment document-sharded over a
                       ``launch.mesh.Mesh`` (``shard_index``), the delta
                       segments replicated, tombstones in both groups
``live-sharded-cuda``  The same through the Hopper kernels on every shard
                       and delta (the counterpart of
                       ``live-sharded-pallas``)
=====================  ===================================================

On top of the facade's search / save / describe, each implements the
``MutableRetriever`` surface: ``add_passages``, ``delete_passages``,
``writer(flush_every=...)``, ``compactor(...)``, ``compact()`` and the
``generation`` counter.  ``retrieval.load`` restores a live retriever from
v2 (segment manifest) and v1 directories; a ``live-sharded`` save stamps
the manifest with its shard count (``"sharding"``), so a bare directory
sniffs back to ``live-sharded``.
"""
from __future__ import annotations

import time

from repro_torch.core import pipeline
from repro_torch.live import manifest as manifest_mod
from repro_torch.live.compactor import Compactor
from repro_torch.live.engine import LiveEngine
from repro_torch.live.index import IndexWriter, LiveIndex
from repro_torch.retrieval import registry
from repro_torch.retrieval.backends import (
    _as_request,
    _build_index,
    _finish,
    _reject_diagnostics,
    to_engine_params,
)
from repro_torch.retrieval.types import (
    DYNAMIC_FIELDS,
    STATIC_FIELDS,
    RetrieverConfig,
    SearchParams,
)


@registry.register("live")
class LiveRetriever:
    """Segmented mutable PLAID index behind the facade."""

    impl = "ref"

    def __init__(self, live_index: LiveIndex, params: SearchParams | None = None):
        self.index = live_index
        self.params = params or SearchParams()
        self._engine = self._make_engine()

    def _make_engine(self) -> LiveEngine:
        return LiveEngine(self.index, to_engine_params(self.params, self.impl))

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda"):
        return cls(LiveIndex(_build_index(corpus_embs, cfg, doc_lens, device)), cfg.params)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig):
        if not isinstance(index, LiveIndex):
            index = LiveIndex(index)
        return cls(index, cfg.params)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda"):
        return cls(LiveIndex.load(path, device), params)

    def save(self, path: str) -> None:
        self.index.save(path)
        registry.write_meta(path, self)

    # ---- generation ------------------------------------------------------
    @property
    def generation(self) -> int:
        """The LiveIndex's monotonic mutation counter, bumped by every add,
        delete and compaction swap: a result cache keyed on it is
        invalidated by one integer compare."""
        return self.index.generation

    # ---- mutation --------------------------------------------------------
    def add_passages(self, doc_embeddings, doc_lens=None):
        """Ingest passages as one delta segment -> global pids."""
        return self.index.add_passages(doc_embeddings, doc_lens=doc_lens)

    def delete_passages(self, pids) -> int:
        """Tombstone global pids; returns how many were newly deleted."""
        return self.index.delete(pids)

    def writer(self, *, flush_every: int | None = None) -> IndexWriter:
        return IndexWriter(self.index, flush_every=flush_every)

    def compactor(self, **kw) -> Compactor:
        return Compactor(self.index, **kw)

    def compact(self):
        """Merge deltas into the base now; returns the old->new pid map."""
        return self.index.compact()

    # ---- search ----------------------------------------------------------
    def _search(self, fn, q, q_mask, t_cs, with_diagnostics, with_funnel):
        req = _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        t0 = time.perf_counter()
        out = fn(req.q, req.q_mask, t_cs=t, funnel=req.with_funnel)
        return _finish(
            out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
            funnel=req.with_funnel,
        )

    def search(self, q, q_mask=None, *, t_cs=None, with_diagnostics=False,
               with_funnel=False):
        """One query matrix (nq, dim) -> top-k SearchResult (global pids)."""
        return self._search(self._engine.search, q, q_mask, t_cs,
                            with_diagnostics, with_funnel)

    def search_batch(self, qs, q_masks=None, *, t_cs=None,
                     with_diagnostics=False, with_funnel=False):
        """Query batch (B, nq, dim) -> batched top-k SearchResult."""
        return self._search(self._engine.search_batch, qs, q_masks, t_cs,
                            with_diagnostics, with_funnel)

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        live = self.index
        base = live.base
        return dict(
            backend=self.backend_name,
            impl=self.impl,
            device=str(live.device),
            static=self.params.static_dict(),
            dynamic=self.params.dynamic_dict(),
            static_fields=STATIC_FIELDS,
            dynamic_fields=DYNAMIC_FIELDS,
            index=dict(
                num_passages=live.num_passages,
                num_alive=live.num_alive,
                num_deleted=live.num_deleted,
                num_segments=live.num_segments,
                num_deltas=live.num_deltas,
                generation=live.generation,
                num_centroids=base.num_centroids,
                dim=base.dim,
                nbits=base.nbits,
                doc_maxlen=max(s.doc_maxlen for s in live.snapshot().segments),
            ),
            compile=dict(trace_count=pipeline.trace_count()),
        )


@registry.register("live-cuda")
class LiveCudaRetriever(LiveRetriever):
    """The live backend through the Hopper kernels (the counterpart of
    ``live-pallas``)."""

    impl = "cuda"


@registry.register("live-sharded")
class ShardedLiveRetriever(LiveRetriever):
    """Mutable index whose base segment is document-sharded over a mesh.

    The base shards over the mesh's devices (the ``shard_index`` layout of
    ``"plaid-sharded"``); the delta segments stay replicated (small by
    construction, and folded into the sharded base at compaction, which
    the executor notices and re-shards); tombstones ride through both
    partition groups.  Mutations go through the ``MutableRetriever``
    surface and the ``BatchingServer`` unchanged.  ``n_shards`` defaults
    to every visible card (one shard a process on the host); ``mesh=``
    places the shards explicitly (several on one card).
    """

    impl = "ref"
    partitions = True  # honours RetrieverConfig.n_shards

    def __init__(self, live_index: LiveIndex, params: SearchParams | None = None, *,
                 n_shards: int | None = None, mesh=None):
        from repro_torch.retrieval.backends import default_n_shards

        if mesh is not None and n_shards is not None and n_shards != mesh.n_shards:
            raise ValueError(f"n_shards={n_shards} but the mesh has {mesh.n_shards} shards")
        self.mesh = mesh
        if n_shards is None:
            n_shards = mesh.n_shards if mesh is not None else default_n_shards(live_index.device)
        self.n_shards = n_shards
        super().__init__(live_index, params)

    def _make_engine(self) -> LiveEngine:
        return LiveEngine(self.index, to_engine_params(self.params, self.impl),
                          mesh=self.mesh, n_shards=self.n_shards)

    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda", mesh=None):
        base = _build_index(corpus_embs, cfg, doc_lens, device)
        return cls(LiveIndex(base), cfg.params, n_shards=cfg.n_shards, mesh=mesh)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig, *, mesh=None):
        if not isinstance(index, LiveIndex):
            index = LiveIndex(index)
        return cls(index, cfg.params, n_shards=cfg.n_shards, mesh=mesh)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda", mesh=None):
        """The ``"sharding"`` stamp is a placement hint, not data: the
        segments do not depend on the devices, so a process with fewer
        cards than the stamp re-shards to what it has (as the reference
        does) instead of refusing to serve."""
        from repro_torch.launch.mesh import visible_shards

        live = LiveIndex.load(path, device)
        n_shards = (manifest_mod.read_manifest(path).get("sharding") or {}).get("n_shards")
        if mesh is not None:
            n_shards = mesh.n_shards
        elif n_shards is not None and visible_shards(device) is not None:
            n_shards = min(n_shards, visible_shards(device))
        return cls(live, params, n_shards=n_shards, mesh=mesh)

    def save(self, path: str) -> None:
        self.index.save(path, extra_manifest=dict(sharding=dict(n_shards=self.n_shards)))
        registry.write_meta(path, self)

    def describe(self) -> dict:
        d = super().describe()
        mesh = self._engine.mesh
        d["sharding"] = dict(
            n_shards=self.n_shards,
            mesh=mesh.shape if mesh is not None else None,
            deltas="replicated",
        )
        return d


@registry.register("live-sharded-cuda")
class ShardedLiveCudaRetriever(ShardedLiveRetriever):
    """The sharded live index through the Hopper kernels on every shard and
    delta (the counterpart of ``live-sharded-pallas``)."""

    impl = "cuda"
