"""String-keyed backend registry + the build / from_index / load factories
(the counterpart of ``repro.retrieval.registry``).

    r = retrieval.from_index(index, backend="plaid-cuda")
    r.save(path)
    r = retrieval.load(path)              # backend recorded on disk

``retriever.json`` has the reference's format, so a ``"plaid"`` directory
moves between the packages with its backend and params.
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


def build(corpus_embs, cfg=None, *, doc_lens=None, **overrides):
    """Corpus embeddings -> index -> Retriever: routes through the streaming
    builder, which is not ported yet."""
    raise NotImplementedError(
        "repro_torch.retrieval.build routes through the streaming index "
        "builder, which is not ported yet (ROADMAP Queue 1 item 5).  For an "
        "in-memory corpus, build with repro_torch.core.index.build_index and "
        "wrap the index with retrieval.from_index"
    )


def from_index(index, cfg=None, **overrides):
    """Wrap a ``repro_torch.core.index.PlaidIndex`` (on its device) in any
    registered backend."""
    cfg = coerce_config(cfg, **overrides)
    return get_backend(cfg.backend).from_index(index, cfg)


def load(
    path: str,
    backend: str | None = None,
    params: SearchParams | None = None,
    *,
    device: str | torch.device = "cuda",
):
    """Restore a Retriever saved with ``.save(path)`` onto ``device``.

    Backend and params come from ``retriever.json``; a bare
    ``save_index`` directory loads as ``"plaid"``.  Both can be overridden.
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
    """A bare index directory: single-segment layouts load as ``"plaid"``;
    sharded, live and tiered layouts are not ported and are refused."""
    manifest = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest):
        raise FileNotFoundError(
            f"{path!r} holds neither {_META_FILE!r} nor a manifest.json"
        )
    with open(manifest) as f:
        m = json.load(f)
    if (
        "n_shards" in m
        or m.get("storage", "resident") != "resident"
        or len(m.get("segments", [None])) > 1
        or m.get("tombstones")
        or m.get("index_uuid")
    ):
        raise ValueError(
            f"{path!r} is a sharded, tiered or live index directory; those "
            "backends are not ported yet"
        )
    if m.get("format_version", 1) not in (1, 2):
        raise ValueError(
            f"{path!r} has manifest.json with format_version="
            f"{m.get('format_version')!r}; refusing to guess"
        )
    return "plaid"
