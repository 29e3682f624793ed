"""Background compaction for LiveIndex (the counterpart of
``repro.live.compactor``).

A ``Compactor`` watches a LiveIndex from its own daemon thread and merges
delta segments back into the base (dropping tombstoned passages) once the
delta count reaches ``min_deltas``.

Compaction itself is ``LiveIndex.compact()``: the merge runs outside the
index lock (readers and writers proceed; racing appends and deletes are
reconciled at swap time), and the swap is a brief reference swap.  The
thread works on the index's device explicitly.  On the default stream (no
``stream=``) its work is ordered before any later search issued on that
stream; with a ``stream`` of its own the merge runs there, after the work
already queued on the default stream (where the segments were built and
readers search), and the stream is synchronized before the swap, so
neither the merge nor a search reads unfinished tensors.

Persistence: compaction is in memory; construct with ``spill_path`` (or
call ``LiveIndex.save``) to publish the compacted generation behind the
manifest's atomic swap, inside a ``live.compact.spill`` span
(``obs.trace``).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.live.index import LiveIndex
from repro_torch.obs.trace import get_tracer


class Compactor:
    """Merge delta segments into the base when they pile up."""

    def __init__(
        self,
        live: LiveIndex,
        *,
        min_deltas: int = 2,
        interval_s: float = 0.05,
        spill_path: str | None = None,
        stream: torch.cuda.Stream | None = None,
    ):
        self.live = live
        self.min_deltas = max(1, int(min_deltas))
        self.interval_s = interval_s
        self.spill_path = spill_path
        self.stream = stream
        self.compactions = 0
        self.last_pid_map: np.ndarray | None = None
        self.last_error: BaseException | None = None
        self._spill_pending = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _compact(self) -> np.ndarray:
        return self.live.compact(stream=self.stream)

    # ---- synchronous API -------------------------------------------------
    def maybe_compact(self) -> np.ndarray | None:
        """Compact iff the delta count reached the threshold.

        Returns the old->new pid map, or None if nothing was done.  A
        spill save that failed before is retried even on ticks where no
        compaction is due, so the on-disk index does not stay stale."""
        if self.live.num_deltas < self.min_deltas:
            if self._spill_pending:
                self._spill()
            return None
        pid_map = self._compact()
        self.compactions += 1
        self.last_pid_map = pid_map
        if self.spill_path is not None:
            self._spill_pending = True
            self._spill()
        return pid_map

    def _spill(self) -> None:
        with get_tracer().span("live.compact.spill", path=self.spill_path):
            self.live.save(self.spill_path)
        self._spill_pending = False

    # ---- background thread -----------------------------------------------
    def start(self) -> "Compactor":
        if self._thread is not None:
            raise RuntimeError("Compactor already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, *, final_compact: bool = False) -> None:
        """Stop the thread.  ``final_compact=True`` force-compacts whatever
        is pending (ignoring ``min_deltas``) and spills; a plain stop still
        flushes a pending failed spill."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if final_compact and (self.live.num_deltas > 0 or self.live.num_deleted > 0):
            self.last_pid_map = self._compact()
            self.compactions += 1
            if self.spill_path is not None:
                self._spill_pending = True
        if self._spill_pending:
            self._spill()

    def _loop(self) -> None:
        dev = self.live.device
        on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with on_card:
            while not self._stop.wait(self.interval_s):
                try:
                    if self.maybe_compact() is not None:
                        # only a completed compaction (and its spill) clears
                        # the error; a no-op tick must not erase it
                        self.last_error = None
                except Exception as e:
                    # e.g. every passage tombstoned (ValueError) or a failed
                    # spill (OSError): record it and retry on the next tick
                    self.last_error = e

    def __enter__(self) -> "Compactor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
