"""String-keyed backend registry + the build / from_index / load factories
(the counterpart of ``repro.retrieval.registry``).

    r = retrieval.build(corpus, backend="plaid-cuda", index=dict(num_centroids=4096))
    r = retrieval.from_index(index, backend="plaid-cuda")
    r.save(path)
    r = retrieval.load(path)              # backend recorded on disk

``retriever.json`` has the reference's format, so a ``"plaid"``,
``"vanilla"``, ``"live"``, ``"plaid-tiered"``, ``"plaid-sharded"`` or
``"live-sharded"`` directory moves between the packages with its backend
and params.
"""
from __future__ import annotations

import json
import os
from typing import Any

import torch

from repro_torch.retrieval.types import RetrieverConfig, SearchParams

_REGISTRY: dict[str, type] = {}

_META_FILE = "retriever.json"


def register(name: str):
    """Class decorator: expose a Retriever implementation as ``name``."""

    def deco(cls):
        cls.backend_name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown retrieval backend {name!r}; registered: {list_backends()}"
        ) from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


#: ``SearchParams(tiered=True)`` routes the plaid family to its tiered twin
#: when a retriever is made: the storage mode is a params decision, not a
#: separate backend string at the call site.
_TIERED_BACKEND = {
    "plaid": "plaid-tiered",
    "plaid-cuda": "plaid-tiered-cuda",
    "plaid-tiered": "plaid-tiered",
    "plaid-tiered-cuda": "plaid-tiered-cuda",
}


def _resolve_tiered(cfg: RetrieverConfig) -> RetrieverConfig:
    if not cfg.params.tiered:
        return cfg
    mapped = _TIERED_BACKEND.get(cfg.backend)
    if mapped is None:
        raise ValueError(
            f"SearchParams(tiered=True) is only meaningful for the plaid "
            f"family ({sorted(set(_TIERED_BACKEND))}); backend "
            f"{cfg.backend!r} has no tiered storage mode"
        )
    return cfg.replace(backend=mapped) if mapped != cfg.backend else cfg


def _resolve(cfg: RetrieverConfig) -> RetrieverConfig:
    """``_resolve_tiered``, then refuse ``n_shards > 1`` for a backend that
    neither shards nor partitions its index (``partitions`` unset):
    running unsharded instead would ignore the request."""
    cfg = _resolve_tiered(cfg)
    if (cfg.n_shards or 1) > 1 and not getattr(get_backend(cfg.backend), "partitions", False):
        raise ValueError(
            f"backend {cfg.backend!r} does not partition its index "
            f"(n_shards={cfg.n_shards}); use 'plaid-sharded' or 'live-sharded' "
            "for a document-sharded index"
        )
    return cfg


def coerce_config(cfg: Any = None, **overrides) -> RetrieverConfig:
    """Accept RetrieverConfig | backend name | SearchParams | None."""
    if cfg is None:
        cfg = RetrieverConfig()
    elif isinstance(cfg, str):
        cfg = RetrieverConfig(backend=cfg)
    elif isinstance(cfg, SearchParams):
        cfg = RetrieverConfig(params=cfg)
    elif not isinstance(cfg, RetrieverConfig):
        raise TypeError(
            "cfg must be RetrieverConfig, backend name, SearchParams or "
            f"None, got {type(cfg).__name__}"
        )
    return cfg.replace(**overrides) if overrides else cfg


def build(
    corpus_embs, cfg=None, *, doc_lens=None, device: str | torch.device = "cuda",
    **overrides,
):
    """Corpus embeddings -> index on ``device`` -> ready Retriever.

    ``corpus_embs``: list of (len_i, dim) arrays or tensors, packed
    (Nt, dim) with ``doc_lens``, a ``build.ChunkStream`` or a chunk
    factory.  The index comes from the streaming builder
    (``repro_torch.build.build_index_streaming``) with ``cfg.index`` as its
    keywords.  ``cfg``/``overrides``: see :func:`coerce_config`
    (``backend=``, ``params=``, ``index=``).
    """
    cfg = _resolve(coerce_config(cfg, **overrides))
    return get_backend(cfg.backend).build(corpus_embs, cfg, doc_lens=doc_lens, device=device)


def from_index(index, cfg=None, **overrides):
    """Wrap a ``repro_torch.core.index.PlaidIndex`` (on its device) in any
    registered backend (``params.tiered`` routes the plaid family to its
    tiered twin)."""
    cfg = _resolve(coerce_config(cfg, **overrides))
    return get_backend(cfg.backend).from_index(index, cfg)


def load(
    path: str,
    backend: str | None = None,
    params: SearchParams | None = None,
    *,
    device: str | torch.device = "cuda",
):
    """Restore a Retriever saved with ``.save(path)`` onto ``device``.

    Backend and params come from ``retriever.json``; a bare directory is
    sniffed from its manifest (``"plaid"``, ``"live"``, ``"plaid-tiered"``,
    ``"plaid-sharded"`` or ``"live-sharded"``).  Both can be overridden.
    """
    meta = read_meta(path)
    if backend is None:
        backend = meta["backend"] if meta is not None else _sniff_backend(path)
    if params is None and meta is not None:
        params = SearchParams(**meta["params"])
    return get_backend(backend).load(path, params=params, device=device)


def write_meta(path: str, retriever) -> None:
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(
            dict(
                format_version=1,
                backend=retriever.backend_name,
                params=retriever.params.asdict(),
            ),
            f,
        )


def read_meta(path: str) -> dict | None:
    p = os.path.join(path, _META_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _sniff_backend(path: str) -> str:
    """Identify the backend of a bare index directory from its manifest,
    as the reference does: a ``storage: "tiered"`` stamp is
    ``"plaid-tiered"``; a shard layout (top-level ``n_shards``) is
    ``"plaid-sharded"``; a v2 segment manifest stamped ``"sharding"`` is
    ``"live-sharded"``, one with a lineage uuid, several segments or
    tombstones ``"live"``, a single clean segment and a v1 directory
    ``"plaid"``.  A manifest with both ``n_shards`` and ``segments``, an
    unknown storage layout and an unknown version are refused."""
    manifest = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest):
        raise FileNotFoundError(
            f"{path!r} holds neither {_META_FILE!r} nor a manifest.json"
        )
    with open(manifest) as f:
        m = json.load(f)
    # the storage stamp first: a tiered directory's arrays.npz lacks the
    # payload fields, so a resident loader would misread it
    storage = m.get("storage", "resident")
    if storage == "tiered":
        return "plaid-tiered"
    if storage != "resident":
        raise ValueError(
            f"{path!r} stamps an unknown storage layout {storage!r} (this "
            "build knows 'resident' and 'tiered'); refusing to guess"
        )
    if "n_shards" in m and "segments" in m:
        raise ValueError(
            f"{path!r} has a mixed manifest layout: both 'n_shards' (shard "
            "directory) and 'segments' (segment manifest) are present; the "
            "directory is corrupt or half-migrated: re-save it, or pass "
            "backend= to retrieval.load"
        )
    if "n_shards" in m:
        return "plaid-sharded"
    version = m.get("format_version", 1)
    if version not in (1, 2):
        raise ValueError(
            f"{path!r} has manifest.json with format_version={version!r}; "
            "refusing to guess"
        )
    if "segments" in m:
        if m.get("sharding"):
            return "live-sharded"
        if m.get("index_uuid") or len(m["segments"]) > 1 or m.get("tombstones"):
            return "live"
        return "plaid"
    if version == 1:
        return "plaid"
    raise ValueError(
        f"{path!r} has a v2 manifest.json without a segment list; refusing "
        "to guess"
    )
