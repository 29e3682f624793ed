"""LiveIndex: a segmented, mutable view over PLAID indexes (the counterpart
of ``repro.live.index``).

The static ``PlaidIndex`` is build-once; this module makes the corpus
mutable at serving time without ever mutating a tensor:

* an immutable **base segment** plus zero or more **delta segments** — each
  delta is a small ``PlaidIndex`` built online by nearest-centroid
  assignment and residual encoding against the base's FROZEN centroids
  and codec (:func:`build_delta_segment`);
* a **tombstone bitmap** over global pids for deletes (host numpy; a
  delete never touches segment tensors);
* a monotonic **generation** counter, bumped on every mutation and recorded
  in the on-disk manifest (``repro_torch.live.manifest``).

Global pid space is the concatenation of segments in order: the base owns
``[0, base.num_passages)``, each delta the next contiguous range.  Because
every segment shares one centroid space and one codec, compaction is pure
re-packing on the segments' device (:func:`compact_segments`): surviving
codes and residual bytes are concatenated and the CSR arrays and both IVFs
rebuilt, array-identical to the reference's.

Concurrency (readers never block, writers serialize): every mutation goes
through ``self._lock`` and replaces references; searches run on a
``snapshot()``, an immutable view of (segments, per-segment alive masks on
the device, generation), so an in-flight query is never torn by a
concurrent add, delete or compaction.

Spans (``obs.trace``, the reference's names and attributes): a
``live.add_passages`` span, a ``live.delete`` instant, a
``live.compact.merge`` span around the merge and a ``live.compact.swap``
instant after the swap.
"""
from __future__ import annotations

import dataclasses
import threading
import uuid

import numpy as np
import torch

from repro_torch.core import index as index_mod
from repro_torch.core.index import PlaidIndex
from repro_torch.live import manifest as manifest_mod
from repro_torch.obs.trace import get_tracer


def build_delta_segment(doc_embeddings, base: PlaidIndex, doc_lens=None) -> PlaidIndex:
    """Build a small online segment on ``base``'s device against its frozen
    tables.

    No k-means, no codec fitting: tokens are assigned to the base's
    centroids and compressed with its cutoffs and weights, through the
    streaming builder (``repro_torch.build``, pass 1 skipped), so the
    segment is array-identical to what a full rebuild gives these
    passages.
    """
    from repro_torch.build import build_index_streaming

    return build_index_streaming(
        doc_embeddings,
        doc_lens=doc_lens,
        centroids=base.centroids,
        codec=base.codec,
        n_devices=1,
        device=base.device,
    )


def compact_segments(segments, tombstones: np.ndarray):
    """Merge segments, dropping tombstoned passages, on their device.

    Returns ``(new_base, pid_map)``: ``pid_map[old_global_pid]`` is the
    passage's pid in the compacted index, or ``-1`` if it was tombstoned.
    Codes and residual bytes are reused verbatim (one frozen centroid space
    and codec everywhere); only the CSR arrays and the two IVFs are rebuilt
    (``core.index.assemble_index``).  The payloads never leave the device.
    """
    base = segments[0]
    alive_np = ~np.asarray(tombstones, bool)
    if not alive_np.any():
        raise ValueError("compaction would drop every passage")
    dev = base.device
    alive = torch.from_numpy(alive_np).to(dev)
    doc_lens = torch.cat([s.doc_lens for s in segments])
    tok_alive = torch.repeat_interleave(alive, doc_lens.long())
    new_base = index_mod.assemble_index(
        base.centroids,
        torch.cat([s.codes for s in segments])[tok_alive],
        torch.cat([s.residuals for s in segments])[tok_alive],
        doc_lens[alive],
        cutoffs=base.cutoffs,
        weights=base.weights,
        nbits=base.nbits,
        device=dev,
    )
    pid_map = np.where(alive_np, np.cumsum(alive_np) - 1, -1).astype(np.int64)
    return new_base, pid_map


@dataclasses.dataclass(frozen=True)
class LiveSnapshot:
    """Immutable view a search runs against (see LiveIndex.snapshot)."""

    segments: tuple  # of PlaidIndex
    seg_ids: tuple  # stable per-segment ids (cache keys for repro_torch.exec)
    offsets: tuple  # global pid base per segment (Python ints)
    alive: tuple  # per-segment (Nd_s,) bool tensors on the index's device
    generation: int
    num_passages: int


class LiveIndex:
    """Segmented mutable index: base + deltas + tombstones + generation."""

    def __init__(
        self,
        base: PlaidIndex,
        deltas=(),
        *,
        tombstones: np.ndarray | None = None,
        generation: int = 0,
        seg_ids=None,
        index_uuid: str | None = None,
    ):
        # one id per index lineage: lets save() skip re-serializing
        # segments the on-disk manifest (same lineage) already holds
        self._uuid = index_uuid or uuid.uuid4().hex
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()  # serializes compactions only
        self._save_lock = threading.Lock()  # serializes saves only
        self._segments: list[PlaidIndex] = [base, *deltas]
        total = sum(s.num_passages for s in self._segments)
        if tombstones is None:
            tombstones = np.zeros(total, bool)
        tombstones = np.asarray(tombstones, bool).copy()
        if tombstones.shape[0] != total:
            raise ValueError(
                f"tombstone bitmap covers {tombstones.shape[0]} pids, index holds {total}"
            )
        self._tombstones = tombstones
        self._generation = int(generation)
        ids = list(seg_ids) if seg_ids is not None else list(range(len(self._segments)))
        if len(ids) != len(self._segments):
            raise ValueError("seg_ids/segments length mismatch")
        self._seg_ids = ids
        self._next_seg_id = max(ids) + 1
        self._cached_snapshot: LiveSnapshot | None = None

    # ---- introspection ---------------------------------------------------
    @property
    def base(self) -> PlaidIndex:
        return self._segments[0]

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    @property
    def num_deltas(self) -> int:
        return len(self._segments) - 1

    @property
    def num_passages(self) -> int:
        """Total pid space, INCLUDING tombstoned passages."""
        return sum(s.num_passages for s in self._segments)

    @property
    def num_alive(self) -> int:
        with self._lock:
            return int((~self._tombstones).sum())

    @property
    def num_deleted(self) -> int:
        with self._lock:
            return int(self._tombstones.sum())

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def dim(self) -> int:
        return self.base.dim

    def tombstones(self) -> np.ndarray:
        with self._lock:
            return self._tombstones.copy()

    # ---- mutation --------------------------------------------------------
    def _bump(self) -> None:
        self._generation += 1
        self._cached_snapshot = None

    def add_passages(self, doc_embeddings, doc_lens=None) -> np.ndarray:
        """Ingest new passages as one delta segment; returns global pids.

        The segment build runs outside the lock (it only reads the frozen
        tables every segment shares), so queries and deletes proceed.
        """
        with get_tracer().span("live.add_passages", n_docs=len(doc_embeddings)):
            seg = build_delta_segment(doc_embeddings, self.base, doc_lens=doc_lens)
            with self._lock:
                start = self.num_passages
                self._segments.append(seg)
                self._seg_ids.append(self._next_seg_id)
                self._next_seg_id += 1
                self._tombstones = np.concatenate(
                    [self._tombstones, np.zeros(seg.num_passages, bool)]
                )
                self._bump()
        return np.arange(start, start + seg.num_passages, dtype=np.int64)

    def delete(self, pids) -> int:
        """Tombstone global pids; returns how many were newly deleted."""
        pids = np.unique(np.atleast_1d(np.asarray(pids, np.int64)))
        get_tracer().instant("live.delete", n_pids=int(pids.size))
        with self._lock:
            n = self.num_passages
            if pids.size and (pids.min() < 0 or pids.max() >= n):
                raise IndexError(f"pid out of range for index with {n} passages")
            newly = int((~self._tombstones[pids]).sum())
            if newly:
                self._tombstones[pids] = True
                self._bump()
        return newly

    def compact(self, stream: torch.cuda.Stream | None = None) -> np.ndarray:
        """Merge the current segments into a new base, dropping tombstones.

        Returns the old->new global pid map over the WHOLE pid space at
        swap time (``-1`` = dropped).  The merge runs outside the index
        lock, so readers and writers proceed during it; at swap time it is
        reconciled with what happened meanwhile (segments appended after
        the merge's snapshot stay deltas, deletes issued during the merge
        are re-applied to the new base).  Concurrent ``compact`` calls
        serialize.  With ``stream`` the merge is issued on that CUDA stream
        after the work already queued on the caller's current stream (the
        readers' stream), its new tensors are recorded as used there, and
        the stream is synchronized before the swap, so readers only ever
        see finished tensors.
        """
        with self._compact_lock:  # one merge at a time; index stays usable
            with self._lock:
                snap_segments = list(self._segments)
                snap_tomb = self._tombstones.copy()
            n_old = int(sum(s.num_passages for s in snap_segments))

            # the expensive part: no index lock held
            with get_tracer().span(
                "live.compact.merge", n_segments=len(snap_segments), n_passages=n_old
            ):
                if stream is None:
                    new_base, pid_map = compact_segments(snap_segments, snap_tomb)
                else:
                    # the merge reads segments whose producing work may still
                    # be queued on the readers' stream; the readers then use
                    # the new base, allocated from the merge stream's pool
                    readers = torch.cuda.current_stream(self.device)
                    stream.wait_stream(readers)
                    with torch.cuda.stream(stream):
                        new_base, pid_map = compact_segments(snap_segments, snap_tomb)
                    for f in index_mod.ARRAY_FIELDS:
                        getattr(new_base, f).record_stream(readers)
                    stream.synchronize()

            with self._lock:
                # only appends/deletes can have happened (compactions are
                # serialized), so the snapshot is a prefix of the present
                assert all(
                    a is b for a, b in zip(self._segments, snap_segments)
                ), "segment prefix changed during compaction"
                extra_segments = self._segments[len(snap_segments):]
                extra_ids = self._seg_ids[len(snap_segments):]
                total_now = self.num_passages
                # deletes that raced the merge: re-apply onto the new base
                base_tomb = np.zeros(new_base.num_passages, bool)
                raced = np.flatnonzero(self._tombstones[:n_old] & ~snap_tomb)
                base_tomb[pid_map[raced]] = True
                # full old->new pid map: merged prefix + shifted tail
                full_map = np.full(total_now, -1, np.int64)
                full_map[:n_old] = pid_map
                full_map[n_old:] = new_base.num_passages + np.arange(total_now - n_old)
                self._segments = [new_base, *extra_segments]
                self._seg_ids = [self._next_seg_id, *extra_ids]
                self._next_seg_id += 1
                self._tombstones = np.concatenate([base_tomb, self._tombstones[n_old:]])
                self._bump()
            get_tracer().instant("live.compact.swap", generation=self._generation)
        return full_map

    # ---- search-side view ------------------------------------------------
    def snapshot(self) -> LiveSnapshot:
        """Immutable (segments, alive masks, generation) view for readers.

        Cached per generation: searches between mutations reuse the same
        alive masks on the device.
        """
        with self._lock:
            if self._cached_snapshot is None:
                offsets, alive, off = [], [], 0
                dev = self.device
                for seg in self._segments:
                    offsets.append(off)
                    mask = ~self._tombstones[off : off + seg.num_passages]
                    alive.append(torch.from_numpy(mask).to(dev))
                    off += seg.num_passages
                self._cached_snapshot = LiveSnapshot(
                    segments=tuple(self._segments),
                    seg_ids=tuple(self._seg_ids),
                    offsets=tuple(offsets),
                    alive=tuple(alive),
                    generation=self._generation,
                    num_passages=off,
                )
            return self._cached_snapshot

    # ---- persistence -----------------------------------------------------
    def save(self, path: str, *, extra_manifest: dict | None = None) -> None:
        """Write the v2 segment-manifest layout (atomic manifest swap).

        Saves of one LiveIndex serialize on their own lock, held across
        the snapshot AND the write, so generations reach disk in order even
        when a Compactor spill races a user save, without blocking
        mutations or readers.  ``extra_manifest`` entries are recorded in
        the manifest as given (the ``"sharding"`` stamp of
        ``"live-sharded"``)."""
        with self._save_lock:
            with self._lock:
                segments = list(self._segments)
                seg_ids = list(self._seg_ids)
                tombstones = self._tombstones.copy()
                generation = self._generation
            manifest_mod.save_segmented(
                path, segments, seg_ids, tombstones, generation,
                index_uuid=self._uuid, extra_manifest=extra_manifest,
            )

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "LiveIndex":
        """Read a v2 directory, or a v1 one as a single-base-segment index,
        onto ``device``."""
        segments, seg_ids, tombstones, generation, index_uuid = (
            manifest_mod.load_segmented(path, device=device)
        )
        return cls(
            segments[0],
            segments[1:],
            tombstones=tombstones,
            generation=generation,
            seg_ids=seg_ids,
            index_uuid=index_uuid,
        )


class IndexWriter:
    """Buffered mutation handle over a LiveIndex: ``add``/``delete``/``flush``.

    ``add`` buffers passages on the host; ``flush`` turns the buffer into ONE
    delta segment (amortizing the per-segment search cost over many adds)
    and returns the assigned global pids.  ``delete`` applies immediately.
    With ``flush_every`` set, the buffer self-flushes once it holds that
    many passages.  Leaving a ``with`` block flushes.
    """

    def __init__(self, live: LiveIndex, *, flush_every: int | None = None):
        self.live = live
        self.flush_every = flush_every
        self._buffer: list = []
        self._lock = threading.Lock()

    @property
    def pending(self) -> int:
        """Number of buffered (un-flushed) passages."""
        with self._lock:
            return len(self._buffer)

    def add(self, doc_embeddings) -> None:
        """Buffer one or more (len_i, dim) passages (arrays or tensors)."""
        if getattr(doc_embeddings, "ndim", None) == 2:  # one passage matrix
            doc_embeddings = [doc_embeddings]
        with self._lock:
            self._buffer.extend(doc_embeddings)
            should_flush = (
                self.flush_every is not None and len(self._buffer) >= self.flush_every
            )
        if should_flush:
            self.flush()

    def delete(self, pids) -> int:
        return self.live.delete(pids)

    def flush(self) -> np.ndarray:
        """Materialize buffered passages as one delta segment -> global pids."""
        with self._lock:
            buffered, self._buffer = self._buffer, []
        if not buffered:
            return np.zeros(0, np.int64)
        return self.live.add_passages(buffered)

    def __enter__(self) -> "IndexWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()
