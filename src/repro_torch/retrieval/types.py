"""Facade types: parameters, requests, results (the counterpart of
``repro.retrieval.types``).

``STATIC_FIELDS`` are the shape-setting caps and code-path choices;
``DYNAMIC_FIELDS`` are per-call knobs.  The port runs eagerly, so neither
compiles anything, but the split is kept: ``retriever.json`` files and
``describe()`` read the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

from repro_torch.constants import DEFAULT_CANDIDATE_CAP

DEFAULT_SCORE_DTYPE = "float32"

STATIC_FIELDS = (
    "k",
    "nprobe",
    "ndocs",
    "candidate_cap",
    "score_dtype",
    "stage1_dtype",
    "fused",
    "tiered",
)
DYNAMIC_FIELDS = ("t_cs",)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Backend-agnostic search parameters (paper Table 2 + engine caps)."""

    k: int = 10
    nprobe: int = 1
    ndocs: int = 256
    candidate_cap: int = DEFAULT_CANDIDATE_CAP
    score_dtype: str = DEFAULT_SCORE_DTYPE
    #: stage-1 ``C·Qᵀ`` operand dtype: "float32" | "bfloat16" | "int8"
    stage1_dtype: str = "float32"
    #: stage 3-5 tail through the fused gather->decompress->maxsim kernel
    fused: bool = False
    #: host-resident payloads (the tiered index, ``repro_torch.core.tiered``):
    #: ``True`` routes ``plaid`` / ``plaid-cuda`` to ``plaid-tiered`` /
    #: ``plaid-tiered-cuda`` when a retriever is made
    tiered: bool = False
    t_cs: float = 0.5

    def replace(self, **changes) -> "SearchParams":
        return dataclasses.replace(self, **changes)

    def static_dict(self) -> dict:
        return {f: getattr(self, f) for f in STATIC_FIELDS}

    def dynamic_dict(self) -> dict:
        return {f: getattr(self, f) for f in DYNAMIC_FIELDS}

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


#: Paper Table 2 settings, keyed by final k.
PAPER_PARAMS = {
    10: SearchParams(k=10, nprobe=1, t_cs=0.5, ndocs=256),
    100: SearchParams(k=100, nprobe=2, t_cs=0.45, ndocs=1024),
    1000: SearchParams(k=1000, nprobe=4, t_cs=0.4, ndocs=4096),
}


def params_for_k(k: int, candidate_cap: int | None = None) -> SearchParams:
    """Paper Table 2 params for ``k`` (default cap ``DEFAULT_CANDIDATE_CAP``)."""
    base = PAPER_PARAMS.get(k, SearchParams(k=k))
    if candidate_cap is None:
        candidate_cap = DEFAULT_CANDIDATE_CAP
    return base.replace(candidate_cap=candidate_cap)


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """Everything ``retrieval.build`` needs: backend choice + parameters.

    ``index`` is forwarded to the streaming index builder
    (``repro_torch.build.build_index_streaming``): the classic knobs
    (``num_centroids``, ``nbits``, ``kmeans_iters``, ``seed``,
    ``ivf_list_cap``, frozen ``centroids``/``codec``, ``prune_fraction``)
    plus the streaming geometry (``chunk_docs``, ``sample_size``,
    ``stat_blocks``).  ``n_shards`` sets the document shards of the
    device-sharded backends (``plaid-sharded``, ``live-sharded[-cuda]``)
    and the tiered backends' partition count; the others refuse
    ``n_shards > 1``.
    """

    backend: str = "plaid"
    params: SearchParams = SearchParams()
    n_shards: int | None = None
    index: dict = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "RetrieverConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SearchRequest:
    """One search call: a query (or batch) plus per-request knobs.

    ``t_cs`` and ``k`` are the per-request latency/quality knobs the
    serving tier (``repro_torch.serving``) exposes: ``t_cs`` rides through
    a coalesced batch as a per-lane threshold, and ``k`` is served by
    max-``k`` dispatch plus per-request truncation (the batch runs at the
    retriever's ``params.k``; a request's ``k`` must not exceed it).
    ``priority`` / ``deadline_ms`` feed the serving tier's admission
    control: two-level priority queues ("interactive" ahead of "batch")
    and expiry before dispatch.  Direct ``Retriever.search*`` calls ignore
    the serving-only fields.
    """

    q: Any  # (nq, dim) single query matrix, or (B, nq, dim) batch
    q_mask: Any | None = None  # (nq,) / (B, nq); None = all tokens valid
    t_cs: float | None = None
    with_diagnostics: bool = False  # per-stage survivor counts
    with_funnel: bool = False  # attach obs.FunnelStats funnel telemetry
    # --- serving-tier per-request knobs (repro_torch.serving) ------------
    k: int | None = None  # truncate the result to k <= retriever params.k
    priority: str = "interactive"  # admission class: "interactive" | "batch"
    deadline_ms: float | None = None  # relative deadline; expired requests
    # are failed with DeadlineExceeded instead of dispatched

    @property
    def batched(self) -> bool:
        return getattr(self.q, "ndim", 0) == 3


@dataclasses.dataclass
class SearchResult:
    """Top-k result plus serving metadata; iterable as ``(scores, pids)``.
    ``scores``/``pids`` are tensors on the index's device."""

    scores: Any  # (k,) or (B, k) f32
    pids: Any  # (k,) or (B, k) int32
    backend: str
    k: int
    latency_ms: float | None = None
    t_cs: float | None = None
    diagnostics: dict | None = None  # per-stage survivor counts (if requested)
    funnel: dict | None = None  # obs.FunnelStats as host numpy arrays (if
    # requested via with_funnel): per-query counts at every funnel stage

    def __iter__(self):
        return iter((self.scores, self.pids))


@runtime_checkable
class MutableRetriever(Protocol):
    """A retriever whose corpus can change at serving time: the ``"live"``
    ``"live-cuda"``, ``"live-sharded"`` and ``"live-sharded-cuda"`` backends
    (``repro_torch.live``).  Mutations are
    snapshot-consistent with in-flight searches, and ``generation`` (the
    LiveIndex mutation counter) lets a result cache invalidate on them."""

    def add_passages(self, doc_embeddings, doc_lens=None):
        """Ingest passages (one delta segment); returns their global pids."""
        ...

    def delete_passages(self, pids) -> int:
        """Tombstone global pids; returns how many were newly deleted."""
        ...

    def compact(self):
        """Merge delta segments into the base, dropping tombstoned docs;
        returns the old->new global pid map (``-1`` = dropped)."""
        ...
