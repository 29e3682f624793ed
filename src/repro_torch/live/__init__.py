"""``repro_torch.live`` — segmented mutable PLAID indexes: streaming ingest,
tombstone deletes, background compaction (the counterpart of
``repro.live``)::

    from repro_torch import retrieval

    r = retrieval.from_index(index, backend="live-cuda")
    pids = r.add_passages(new_docs)        # one delta segment, no downtime
    r.delete_passages(pids[:3])            # tombstones, no array rewrite
    r.compact()                            # merge deltas, drop tombstones
    r.save(path); retrieval.load(path)     # v2 segment manifest round trip

Design notes live in the submodules: ``live.index`` (segments, pid space,
concurrency), ``live.engine`` (search through ``repro_torch.exec``),
``live.manifest`` (on-disk format v2), ``live.compactor`` (background
merge).  The ``"live"`` / ``"live-cuda"`` backends and their
document-sharded twins ``"live-sharded"`` / ``"live-sharded-cuda"``
register on ``import repro_torch.retrieval``.
"""
from repro_torch.live import manifest
from repro_torch.live.compactor import Compactor
from repro_torch.live.engine import LiveEngine
from repro_torch.live.index import (
    IndexWriter,
    LiveIndex,
    LiveSnapshot,
    build_delta_segment,
    compact_segments,
)

__all__ = [
    "Compactor",
    "IndexWriter",
    "LiveEngine",
    "LiveIndex",
    "LiveSnapshot",
    "build_delta_segment",
    "compact_segments",
    "manifest",
]
