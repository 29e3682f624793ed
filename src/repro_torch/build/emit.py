"""Emit a built index into a serving layout (the counterpart of
``repro.build.emit``).

==============  ==========================================================
``"v2"``        single-base-segment v2 segment-manifest directory — loads
                via ``core.indexer.load_index`` / the ``"plaid"`` backends
                of either package
``"sharded"``   per-shard directory layout (``core.indexer.save_sharded``)
                for the ``"plaid-sharded"`` backend of either package
``"live"``      v2 directory stamped with a LiveIndex lineage uuid, so a
                bare save sniffs back to the ``"live"`` backend (the
                build seeds the live index's BASE segment)
==============  ==========================================================
"""
from __future__ import annotations

from repro_torch.core.index import PlaidIndex

LAYOUTS = ("v2", "sharded", "live")


def save_v2(path: str, index: PlaidIndex) -> None:
    """Single-base-segment v2 segment-manifest directory."""
    from repro_torch.core import indexer

    indexer.save_index(path, index)


def save_sharded(path: str, index: PlaidIndex, n_shards: int) -> None:
    """Per-shard deploy layout for the document-sharded engine."""
    from repro_torch.core import indexer

    indexer.save_sharded(path, index, n_shards)


def to_live_index(index: PlaidIndex):
    """Wrap the built index as a LiveIndex base segment (in memory)."""
    from repro_torch.live.index import LiveIndex

    return LiveIndex(index)


def save_live(path: str, index: PlaidIndex):
    """v2 directory with a live lineage stamp; returns the LiveIndex."""
    live = to_live_index(index)
    live.save(path)
    return live


def emit(index: PlaidIndex, path: str, *, layout: str = "v2", n_shards: int | None = None):
    """Dispatch on ``layout`` (see module docstring)."""
    if layout == "v2":
        return save_v2(path, index)
    if layout == "sharded":
        if not n_shards:
            raise ValueError("layout='sharded' requires n_shards")
        return save_sharded(path, index, n_shards)
    if layout == "live":
        return save_live(path, index)
    raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
