"""The built-in backends behind the ``Retriever`` facade (the counterpart
of the ``plaid`` / ``plaid-pallas`` part of ``repro.retrieval.backends``).

==============  =========================================================
``vanilla``     ColBERTv2 baseline (embedding-level IVF, full padded
                decompression through K4).  No dynamic parameters.
``plaid``       PLAID 4-stage pipeline, plain PyTorch ops (any device).
``plaid-cuda``  The same pipeline through the Hopper kernels
                (``repro_torch.kernels``); on CPU tensors the kernels'
                plain versions run, so it also answers on ``device="cpu"``.
``plaid-tiered``  The tiered index: host-resident (mmap) token payloads,
                a per-batch candidate-slice copy (``repro_torch.core.
                tiered`` / ``exec.tiered``), plain PyTorch ops.
                ``SearchParams(tiered=True)`` routes the plaid family here.
``plaid-tiered-cuda``  The tiered index through the Hopper kernels (K1 in
                phase A; K2, or K3 fused, over the compacted slices).
``plaid-sharded``  Document-sharded PLAID: one shard a mesh device
                (``launch.mesh.Mesh``), centroids replicated, one gathered
                top-k merge; ``impl="cuda"`` runs the Hopper kernels on
                every shard.
==============  =========================================================

``SearchParams.candidate_cap`` is the stage-1 bound in each engine's own
unit: candidate *passages* for PLAID, candidate *embeddings* for vanilla.

Funnel telemetry (``with_funnel=True``) runs on the plaid family (tiered
included) and is refused on ``vanilla``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import indexer, pipeline
from repro_torch.core import plaid as plaid_mod
from repro_torch.core import vanilla as vanilla_mod
from repro_torch.obs import funnel as funnel_mod
from repro_torch.retrieval import registry
from repro_torch.retrieval.types import (
    DYNAMIC_FIELDS,
    RetrieverConfig,
    SearchParams,
    SearchRequest,
    SearchResult,
    STATIC_FIELDS,
)

_DIAG_NAMES = ("stage1_candidates", "stage2_kept_centroids", "stage3_survivors")


def _build_index(corpus_embs, cfg: RetrieverConfig, doc_lens, device):
    """Every facade ``build`` routes through the streaming two-pass builder
    (``repro_torch.build``) on ``device``, with ``cfg.index`` as its
    keywords."""
    from repro_torch.build import build_index_streaming

    return build_index_streaming(corpus_embs, doc_lens=doc_lens, device=device, **cfg.index)


def to_engine_params(p: SearchParams, impl: str = "ref") -> plaid_mod.SearchParams:
    """Facade ``SearchParams`` -> core ``plaid.SearchParams`` (``tiered`` is
    a storage choice, settled by the registry's routing)."""
    return plaid_mod.SearchParams(
        k=p.k,
        nprobe=p.nprobe,
        t_cs=p.t_cs,
        ndocs=p.ndocs,
        candidate_cap=p.candidate_cap,
        impl=impl,
        score_dtype=p.score_dtype,
        stage1_dtype=p.stage1_dtype,
        fused=p.fused,
    )


def _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel=False):
    if isinstance(q, SearchRequest):
        return q
    return SearchRequest(
        q=q, q_mask=q_mask, t_cs=t_cs, with_diagnostics=with_diagnostics,
        with_funnel=with_funnel,
    )


def _reject_funnel(req: SearchRequest, backend: str) -> None:
    if req.with_funnel:
        raise ValueError(
            f"with_funnel is not supported by backend {backend!r} "
            "(funnel telemetry exists on the PLAID-pipeline backends)"
        )


def _reject_diagnostics(req: SearchRequest, backend: str) -> None:
    if req.with_diagnostics:
        raise ValueError(
            f"with_diagnostics is not supported by backend {backend!r} "
            "(per-stage survivor counts exist on 'plaid'/'plaid-cuda')"
        )


def _index_summary(index) -> dict:
    return dict(
        num_passages=index.num_passages,
        num_tokens=index.num_tokens,
        num_centroids=index.num_centroids,
        dim=index.dim,
        nbits=index.nbits,
        doc_maxlen=index.doc_maxlen,
    )


def _finish(out, *, backend, k, t_cs, t0, diag: bool = False,
            funnel: bool = False) -> SearchResult:
    """Wait for the device and wrap the result with serving metadata:
    ``latency_ms`` measures a completed search."""
    scores, pids, *extras = out
    if pids.device.type == "cuda":
        torch.cuda.synchronize(pids.device)
    latency_ms = (time.perf_counter() - t0) * 1e3
    diagnostics = funnel_stats = None
    if diag:
        d = extras.pop(0)
        diagnostics = {
            name: np.asarray(d[name].cpu()) if d[name].ndim else int(d[name])
            for name in _DIAG_NAMES
        }
    if funnel:
        funnel_stats = {
            name: v if v.ndim else int(v)
            for name, v in funnel_mod.to_host(extras.pop(0)).items()
        }
    return SearchResult(
        scores=scores, pids=pids, backend=backend, k=k,
        latency_ms=latency_ms, t_cs=t_cs, diagnostics=diagnostics,
        funnel=funnel_stats,
    )


@registry.register("plaid")
class PlaidRetriever:
    """Single-device PLAID engine behind the facade."""

    impl = "ref"

    def __init__(self, index, params: SearchParams | None = None):
        self.index = index
        self.params = params or SearchParams()
        self._engine = plaid_mod.PlaidEngine(
            index, to_engine_params(self.params, self.impl)
        )

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda"):
        return cls(_build_index(corpus_embs, cfg, doc_lens, device), cfg.params)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig):
        return cls(index, cfg.params)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda"):
        return cls(indexer.load_index(path, device), params)

    def save(self, path: str) -> None:
        indexer.save_index(path, self.index)
        registry.write_meta(path, self)

    # ---- search ----------------------------------------------------------
    def _search(self, fn, q, q_mask, t_cs, with_diagnostics, with_funnel):
        req = _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        t0 = time.perf_counter()
        out = fn(req.q, req.q_mask, t_cs=t, diag=req.with_diagnostics,
                 funnel=req.with_funnel)
        return _finish(
            out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
            diag=req.with_diagnostics, funnel=req.with_funnel,
        )

    def search(self, q, q_mask=None, *, t_cs=None, with_diagnostics=False,
               with_funnel=False):
        """One query matrix (nq, dim) -> top-k SearchResult."""
        return self._search(self._engine.search, q, q_mask, t_cs,
                            with_diagnostics, with_funnel)

    def search_batch(self, qs, q_masks=None, *, t_cs=None,
                     with_diagnostics=False, with_funnel=False):
        """Query batch (B, nq, dim) -> batched top-k SearchResult."""
        return self._search(self._engine.search_batch, qs, q_masks, t_cs,
                            with_diagnostics, with_funnel)

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        return dict(
            backend=self.backend_name,
            impl=self.impl,
            device=str(self.index.device),
            static=self.params.static_dict(),
            static_effective=self._engine._kwargs(),
            dynamic=self.params.dynamic_dict(),
            static_fields=STATIC_FIELDS,
            dynamic_fields=DYNAMIC_FIELDS,
            index=_index_summary(self.index),
            compile=dict(trace_count=pipeline.trace_count()),
        )


@registry.register("plaid-cuda")
class PlaidCudaRetriever(PlaidRetriever):
    """PLAID through the Hopper kernels (the counterpart of ``plaid-pallas``)."""

    impl = "cuda"


# --------------------------------------------------------------------------
# Vanilla ColBERTv2 baseline
# --------------------------------------------------------------------------
@registry.register("vanilla")
class VanillaRetriever:
    """ColBERTv2 baseline behind the facade.  No dynamic parameters
    (``t_cs`` overrides are accepted and ignored: the pipeline has no
    pruning stage).  It always runs ``impl="cuda"``: K4 decompresses for an
    index on the card, its plain version for an index on the CPU."""

    impl = "cuda"

    def __init__(self, index, params: SearchParams | None = None):
        self.index = index
        self.params = params or SearchParams()
        p = self.params
        self._engine = vanilla_mod.VanillaEngine(
            index,
            vanilla_mod.VanillaParams(
                k=p.k, nprobe=p.nprobe, ncandidates=p.candidate_cap,
                ndocs_cap=p.ndocs, impl=self.impl,
            ),
        )

    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda"):
        return cls(_build_index(corpus_embs, cfg, doc_lens, device), cfg.params)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig):
        return cls(index, cfg.params)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda"):
        return cls(indexer.load_index(path, device), params)

    def save(self, path: str) -> None:
        indexer.save_index(path, self.index)
        registry.write_meta(path, self)

    def _search(self, fn, q, q_mask, t_cs, with_diagnostics, with_funnel):
        req = _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        _reject_funnel(req, self.backend_name)
        t0 = time.perf_counter()
        out = fn(req.q, req.q_mask)
        return _finish(out, backend=self.backend_name, k=self.params.k, t_cs=None, t0=t0)

    def search(self, q, q_mask=None, *, t_cs=None, with_diagnostics=False,
               with_funnel=False):
        """One query matrix (nq, dim) -> top-k SearchResult."""
        return self._search(self._engine.search, q, q_mask, t_cs,
                            with_diagnostics, with_funnel)

    def search_batch(self, qs, q_masks=None, *, t_cs=None,
                     with_diagnostics=False, with_funnel=False):
        """Query batch (B, nq, dim) -> batched top-k SearchResult."""
        return self._search(self._engine.search_batch, qs, q_masks, t_cs,
                            with_diagnostics, with_funnel)

    def describe(self) -> dict:
        return dict(
            backend=self.backend_name,
            impl=self.impl,
            device=str(self.index.device),
            static=self.params.static_dict(),
            static_effective=self._engine._kwargs(),
            dynamic={},
            static_fields=STATIC_FIELDS,
            dynamic_fields=(),  # vanilla has no per-call knobs
            index=_index_summary(self.index),
        )


# --------------------------------------------------------------------------
# The tiered index
# --------------------------------------------------------------------------
@registry.register("plaid-tiered")
class TieredRetriever:
    """PLAID with host-resident payloads: the funnel on the device, the
    token payload in host memory.

    Wraps :class:`repro_torch.exec.tiered.TieredExecutor` (two phases per
    partition, one shared top-k merge).  ``RetrieverConfig.n_shards`` sets
    the partition count (here the partitions split the host tier, not a
    set of devices).  Results are identical to ``"plaid"`` on the same
    index; only the finalists' CSR slices cross to the device a batch,
    counted in ``transfer_totals`` / ``last_transfer_bytes``.
    """

    impl = "ref"
    partitions = True  # honours RetrieverConfig.n_shards

    def __init__(self, tiered, params: SearchParams | None = None, *,
                 n_partitions: int = 1, device_budget_bytes: int | None = None):
        from repro_torch.core import tiered as tiered_mod
        from repro_torch.exec.tiered import TieredExecutor

        if not isinstance(tiered, tiered_mod.TieredIndex):
            tiered = tiered_mod.tiered_from_index(tiered)
        self.tiered = tiered
        self.params = params or SearchParams()
        self.n_partitions = max(int(n_partitions), 1)
        self._executor = TieredExecutor(
            tiered, to_engine_params(self.params, self.impl),
            n_partitions=self.n_partitions, device_budget_bytes=device_budget_bytes,
        )

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda"):
        return cls.from_index(_build_index(corpus_embs, cfg, doc_lens, device), cfg)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig):
        return cls(index, cfg.params, n_partitions=cfg.n_shards or 1)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda"):
        from repro_torch.core import tiered as tiered_mod

        return cls(tiered_mod.load_tiered(path, device), params)

    def save(self, path: str) -> None:
        from repro_torch.core import tiered as tiered_mod

        tiered_mod.save_tiered(path, self.tiered)
        registry.write_meta(path, self)

    # ---- transfer accounting ---------------------------------------------
    @property
    def transfer_totals(self) -> dict:
        return self._executor.transfer_totals

    def last_transfer_bytes(self) -> tuple[int, int]:
        return self._executor.last_transfer_bytes()

    # ---- search ----------------------------------------------------------
    def search(self, q, q_mask=None, *, t_cs=None, with_diagnostics=False,
               with_funnel=False):
        """One query matrix (nq, dim) -> top-k SearchResult."""
        req = _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        dev = self.tiered.device.device
        q1 = plaid_mod._as_queries(req.q, dev, 2)[None]
        mask = None if req.q_mask is None else plaid_mod._as_queries(req.q_mask, dev, 1)[None]
        t0 = time.perf_counter()
        scores, pids, *aux = self._executor.search_batch(q1, mask, t, funnel=req.with_funnel)
        out = (scores[0], pids[0])
        if req.with_funnel:
            fs = aux[0]
            out = (*out, type(fs)(*(v[0] for v in fs)))
        return _finish(out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
                       funnel=req.with_funnel)

    def search_batch(self, qs, q_masks=None, *, t_cs=None, with_diagnostics=False,
                     with_funnel=False):
        """Query batch (B, nq, dim) -> batched top-k SearchResult."""
        req = _as_request(qs, q_masks, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        t0 = time.perf_counter()
        out = self._executor.search_batch(req.q, req.q_mask, t, funnel=req.with_funnel)
        return _finish(out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
                       funnel=req.with_funnel)

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        t = self.tiered
        ex = self._executor
        return dict(
            backend=self.backend_name,
            impl=self.impl,
            device=str(t.device.device),
            static=self.params.static_dict(),
            dynamic=self.params.dynamic_dict(),
            static_fields=STATIC_FIELDS,
            dynamic_fields=DYNAMIC_FIELDS,
            storage=dict(
                mode="tiered",
                n_partitions=self.n_partitions,
                device_bytes=ex.device_nbytes(),
                resident_payload_bytes=ex.resident_payload_nbytes(),
                device_budget_bytes=ex.device_budget_bytes,
                payload_itemsize=t.payload_itemsize,
            ),
            transfer=self.transfer_totals,
            index=dict(
                num_passages=t.num_passages,
                num_tokens=t.num_tokens,
                num_centroids=t.device.num_centroids,
                dim=t.device.dim,
                nbits=t.device.nbits,
                doc_maxlen=t.device.doc_maxlen,
            ),
            compile=dict(trace_count=pipeline.trace_count()),
        )


@registry.register("plaid-tiered-cuda")
class TieredCudaRetriever(TieredRetriever):
    """The tiered index through the Hopper kernels (the counterpart of
    ``plaid-tiered-pallas``): K1 in phase A, K2 or K3 over the compacted
    slice arrays in phase B."""

    impl = "cuda"


# --------------------------------------------------------------------------
# Document-sharded PLAID
# --------------------------------------------------------------------------
def default_n_shards(device) -> int:
    """The reference's default, every visible device: the cards of every
    process, or one shard a process on the host."""
    from repro_torch.launch import mesh as mesh_mod

    n = mesh_mod.visible_shards(device)
    if n is None:  # the host: one shard a process
        mesh = mesh_mod.make_multihost_mesh(device)
        return mesh.n_shards
    return n


@registry.register("plaid-sharded")
class ShardedRetriever:
    """Document-sharded PLAID: one shard a mesh device, replicated
    centroids, one all-gather top-k merge (``exec.sharded``).

    Holds this process's shards (``engine_sharded.shard_index`` layout,
    placed on the mesh's devices), not a ``PlaidIndex``.  ``impl`` picks the
    plain path (``"ref"``) or the Hopper kernels (``"cuda"``) on every
    shard; by default the kernels where the mesh is on the cards, the plain
    path on the host (so a loaded index keeps its path).  The mesh defaults to ``mesh_for_shards(n_shards)`` on the
    index's device: one card a shard, the host repeated on the CPU; pass
    ``mesh=`` to place several shards on one card.
    """

    partitions = True  # honours RetrieverConfig.n_shards

    def __init__(
        self,
        idx_dict,
        meta: dict,
        *,
        docs_per_shard: int,
        n_shards: int,
        params: SearchParams | None = None,
        mesh=None,
        impl: str | None = None,
        device="cuda",
    ):
        from repro_torch.exec import sharded as shard_exec
        from repro_torch.launch.mesh import mesh_for_shards

        self.params = params or SearchParams()
        self.mesh = mesh if mesh is not None else mesh_for_shards(n_shards, device)
        if impl is None:
            impl = "cuda" if self.mesh.devices[0].type == "cuda" else "ref"
        self.impl = impl
        if n_shards != self.mesh.n_shards:
            raise ValueError(
                f"n_shards={n_shards} must equal the mesh's shard count "
                f"({self.mesh.n_shards}); build the mesh to match the shard layout"
            )
        self._shards = shard_exec.place_shards(self.mesh, idx_dict, meta)
        self._meta = dict(meta)
        self.docs_per_shard = int(docs_per_shard)
        self.n_shards = n_shards
        self._engine_params = shard_exec.clamp_to_shard(
            to_engine_params(self.params, impl), self.docs_per_shard
        )
        self._search_fns: dict = {}  # funnel flag -> search

    def _search_fn(self, funnel: bool):
        from repro_torch.exec.sharded import make_sharded_search

        if funnel not in self._search_fns:
            self._search_fns[funnel] = make_sharded_search(
                self.mesh, self._engine_params, docs_per_shard=self.docs_per_shard,
                static_meta=self._meta, funnel=funnel,
            )
        return self._search_fns[funnel]

    # ---- construction ----------------------------------------------------
    @classmethod
    def build(cls, corpus_embs, cfg: RetrieverConfig, doc_lens=None, *, device="cuda",
              mesh=None, impl: str | None = None):
        return cls.from_index(_build_index(corpus_embs, cfg, doc_lens, device), cfg,
                              mesh=mesh, impl=impl)

    @classmethod
    def from_index(cls, index, cfg: RetrieverConfig, *, mesh=None, impl: str | None = None):
        from repro_torch.core import engine_sharded

        n_shards = cfg.n_shards or (mesh.n_shards if mesh is not None
                                    else default_n_shards(index.device))
        idx_dict, meta, per = engine_sharded.shard_index(index, n_shards)
        return cls(idx_dict, meta, docs_per_shard=per, n_shards=n_shards,
                   params=cfg.params, mesh=mesh, impl=impl, device=index.device)

    @classmethod
    def load(cls, path: str, params: SearchParams | None = None, *, device="cuda",
             mesh=None, impl: str | None = None):
        """Each process reads only its own shards."""
        from repro_torch.launch.mesh import mesh_for_shards

        n_shards = indexer.read_sharded_manifest(path)["n_shards"]
        if mesh is None:
            mesh = mesh_for_shards(n_shards, device)
        idx_dict, meta, per = indexer.load_sharded(
            path, mesh.devices[0], shard_ids=list(mesh.shard_ids()))
        return cls(idx_dict, meta, docs_per_shard=per, n_shards=n_shards, params=params,
                   mesh=mesh, impl=impl)

    def save(self, path: str) -> None:
        """Each process writes its own shards; the one holding shard 0 the
        manifest and ``retriever.json``."""
        from repro_torch.core.index import ARRAY_FIELDS

        idx_dict = {
            f: torch.cat([getattr(s, f).cpu() for s in self._shards])
            if f not in indexer._REPLICATED else getattr(self._shards[0], f)
            for f in ARRAY_FIELDS
        }
        ids = list(self.mesh.shard_ids())
        indexer.save_sharded_arrays(path, idx_dict, self._meta, n_shards=self.n_shards,
                                    docs_per_shard=self.docs_per_shard, shard_ids=ids)
        if 0 in ids:
            registry.write_meta(path, self)

    # ---- search ----------------------------------------------------------
    def _run(self, qs, q_masks, t_cs, funnel=False):
        dev = self.mesh.devices[0]
        qs = plaid_mod._as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = plaid_mod._as_queries(q_masks, dev, 2)
        if isinstance(t_cs, np.ndarray):
            t_cs = torch.from_numpy(t_cs)
        return self._search_fn(funnel)(self._shards, qs, q_masks, t_cs)

    def search(self, q, q_mask=None, *, t_cs=None, with_diagnostics=False,
               with_funnel=False):
        """One query matrix (nq, dim) -> top-k SearchResult (global pids)."""
        req = _as_request(q, q_mask, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        dev = self.mesh.devices[0]
        mask = None if req.q_mask is None else plaid_mod._as_queries(req.q_mask, dev, 1)[None]
        t0 = time.perf_counter()
        scores, pids, *aux = self._run(plaid_mod._as_queries(req.q, dev, 2)[None], mask, t,
                                       funnel=req.with_funnel)
        out = (scores[0], pids[0])
        if req.with_funnel:
            fs = aux[0]
            out = (*out, type(fs)(*(v[0] for v in fs)))
        return _finish(out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
                       funnel=req.with_funnel)

    def search_batch(self, qs, q_masks=None, *, t_cs=None, with_diagnostics=False,
                     with_funnel=False):
        """Query batch (B, nq, dim) -> batched top-k SearchResult."""
        req = _as_request(qs, q_masks, t_cs, with_diagnostics, with_funnel)
        _reject_diagnostics(req, self.backend_name)
        t = self.params.t_cs if req.t_cs is None else req.t_cs
        t0 = time.perf_counter()
        out = self._run(req.q, req.q_mask, t, funnel=req.with_funnel)
        return _finish(out, backend=self.backend_name, k=self.params.k, t_cs=t, t0=t0,
                       funnel=req.with_funnel)

    # ---- introspection ---------------------------------------------------
    def describe(self) -> dict:
        return dict(
            backend=self.backend_name,
            impl=self.impl,
            device=[str(d) for d in self.mesh.devices],
            static=self.params.static_dict(),
            dynamic=self.params.dynamic_dict(),
            static_fields=STATIC_FIELDS,
            dynamic_fields=DYNAMIC_FIELDS,
            sharding=dict(
                n_shards=self.n_shards,
                docs_per_shard=self.docs_per_shard,
                mesh=self.mesh.shape,
                candidate_cap_per_shard=self._engine_params.candidate_cap,
            ),
            index=dict(
                num_passages=self.n_shards * self.docs_per_shard,
                dim=self._meta["dim"],
                nbits=self._meta["nbits"],
                doc_maxlen=self._meta["doc_maxlen"],
            ),
            compile=dict(trace_count=pipeline.trace_count()),
        )
