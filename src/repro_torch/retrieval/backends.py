"""The built-in backends behind the ``Retriever`` facade (the counterpart
of the ``plaid`` / ``plaid-pallas`` part of ``repro.retrieval.backends``).

==============  =========================================================
``vanilla``     ColBERTv2 baseline (embedding-level IVF, full padded
                decompression through K4).  No dynamic parameters.
``plaid``       PLAID 4-stage pipeline, plain PyTorch ops (any device).
``plaid-cuda``  The same pipeline through the Hopper kernels
                (``repro_torch.kernels``); on CPU tensors the kernels'
                plain versions run, so it also answers on ``device="cpu"``.
==============  =========================================================

``SearchParams.candidate_cap`` is the stage-1 bound in each engine's own
unit: candidate *passages* for PLAID, candidate *embeddings* for vanilla.

Funnel telemetry (``with_funnel=True``) runs on ``plaid`` and ``plaid-cuda``
and is refused on ``vanilla``.  The tiered storage mode is not ported and is
refused with a ``NotImplementedError``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import indexer
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
    """Facade ``SearchParams`` -> core ``plaid.SearchParams``."""
    if p.tiered:
        raise NotImplementedError(
            "SearchParams(tiered=True): the tiered index "
            "(repro_torch.core.tiered) is not ported"
        )
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
