"""``repro_torch.retrieval`` — the port's public retrieval API.

    from repro_torch import retrieval

    r = retrieval.from_index(index, backend="plaid-cuda")   # or load(path)
    res = r.search_batch(qs)          # SearchResult: scores, pids, metadata
    res2 = r.search_batch(qs, t_cs=0.4)
    r.save("/idx");  r2 = retrieval.load("/idx")

Backends: ``"plaid"`` (plain PyTorch), ``"plaid-cuda"`` (Hopper kernels),
``"vanilla"`` (the ColBERTv2 baseline, K4 on the card), the tiered
``"plaid-tiered"`` / ``"plaid-tiered-cuda"`` (host-resident payloads,
``SearchParams(tiered=True)``), and the mutable ``"live"`` /
``"live-cuda"`` (``repro_torch.live``: ``add_passages``,
``delete_passages``, ``compact``); see ``retrieval.list_backends()``.
"""
from repro_torch.retrieval.registry import (
    build,
    from_index,
    get_backend,
    list_backends,
    load,
    register,
)
from repro_torch.retrieval.types import (
    DEFAULT_SCORE_DTYPE,
    DYNAMIC_FIELDS,
    MutableRetriever,
    PAPER_PARAMS,
    RetrieverConfig,
    SearchParams,
    SearchRequest,
    SearchResult,
    STATIC_FIELDS,
    params_for_k,
)

# importing the modules registers the built-in backends (incl. the
# mutable-corpus "live" / "live-cuda" engines of repro_torch.live)
from repro_torch.retrieval import backends as _backends  # noqa: E402,F401
from repro_torch.live import backend as _live_backend  # noqa: E402,F401

__all__ = [
    "build",
    "from_index",
    "load",
    "register",
    "get_backend",
    "list_backends",
    "RetrieverConfig",
    "SearchParams",
    "SearchRequest",
    "SearchResult",
    "PAPER_PARAMS",
    "params_for_k",
    "STATIC_FIELDS",
    "DYNAMIC_FIELDS",
    "DEFAULT_SCORE_DTYPE",
]
