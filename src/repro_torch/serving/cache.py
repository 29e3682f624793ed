"""Generation-aware exact-match query result cache (the counterpart of
``repro.serving.cache``).

Retrieval traffic is heavy-tailed — head queries repeat — and a PLAID
search is deterministic given ``(query bytes, params, corpus state)``.
That makes exact-match caching sound *if and only if* corpus state is part
of the validity check.  The live index already maintains the perfect
epoch: the :class:`repro_torch.live.LiveIndex` **generation counter**, bumped
atomically under the index lock by every ingest, delete, and compaction
swap.  Each cache entry is stamped with the generation its search ran
against; a lookup is a hit only when the entry's stamp equals the index's
*current* generation.  Mutations therefore invalidate the whole cache
atomically — one integer bump, no scan, no per-entry TTLs — and a static
(immutable) backend, which has no generation, caches forever at the
constant generation 0.

Keys are ``(query bytes, shape, dtype, effective t_cs)``; the retriever's
static params (``k``, ``nprobe``, ...) are constants of the serving
process, so they key the *server*, not each entry.  Values are the
full ``(scores, pids)`` arrays at the dispatch ``k``; per-request ``k``
truncation happens on read, so one entry serves every ``k <=
params.k`` and hits are array-identical to an uncached search (the
serving-tier stress test asserts bitwise equality).

Eviction is plain LRU.  Stale entries (generation mismatch) are removed
lazily on touch — they also age out via LRU — and counted as
``invalidations``.
"""
from __future__ import annotations

import collections
import threading

import numpy as np


def query_key(q: np.ndarray, t_cs: float) -> tuple:
    """Exact-match cache key for one query matrix + effective threshold."""
    q = np.ascontiguousarray(q)
    return (q.tobytes(), q.shape, str(q.dtype), float(t_cs))


class ResultCache:
    """Thread-safe LRU of ``key -> (generation, scores, pids)``."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0  # stale entries removed on touch
        self.insertions = 0
        self.evictions = 0  # LRU capacity evictions

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: tuple, generation: int):
        """The cached ``(scores, pids)`` for ``key`` at ``generation``, or
        ``None``.  An entry from an older generation is a miss AND is
        dropped (counted under ``invalidations``)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            gen, scores, pids = entry
            if gen != generation:
                del self._entries[key]
                self.invalidations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return scores, pids

    def put(self, key: tuple, generation: int, scores, pids) -> None:
        """Insert a result computed at ``generation``.  The caller must
        guarantee the search actually ran against that generation (the
        server re-reads the counter after dispatch and skips insertion if
        a mutation raced the batch)."""
        scores = np.asarray(scores)
        pids = np.asarray(pids)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = (generation, scores, pids)
            self.insertions += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return dict(
                size=len(self._entries),
                capacity=self.capacity,
                hits=self.hits,
                misses=self.misses,
                invalidations=self.invalidations,
                insertions=self.insertions,
                evictions=self.evictions,
            )
