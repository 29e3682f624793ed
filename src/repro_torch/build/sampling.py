"""Order-invariant token sampling for the streaming build's pass 1 (the
counterpart of ``repro.build.sampling``).

A classic reservoir sample (Vitter's Algorithm R) depends on arrival
order, so re-chunking the corpus would change the training set and,
through k-means, every array in the index.  Instead each token gets a
pseudorandom *priority* that is a pure function of its GLOBAL token index
(a splitmix64 bijection keyed by the build seed), and the sample is the
``capacity`` tokens with the smallest priorities.  The selected set is
therefore invariant to chunk boundaries and arrival order.  Because
splitmix64 is a bijection per seed, priorities never tie.

Priorities depend on indices alone, so the ranking runs in host numpy (8
bytes a token) while the kept rows stay on the device they arrived on.
Kept indices and rows are the reference's for any chunking.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _finalize(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a bijection of the uint64 space."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def token_priorities(indices: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64 finalizer over global token indices -> uint64 priorities.

    A bijection of the uint64 index space for every seed: distinct indices
    get distinct priorities.  The seed is itself passed through the
    finalizer before offsetting the index stream, so distinct seeds get
    distinct (not merely shifted-by-one) offsets.
    """
    with np.errstate(over="ignore"):  # uint64 wrap-around is the point
        offset = _finalize(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) + _GOLDEN)
        return _finalize(np.asarray(indices, np.uint64) + offset)


def _take(rows: torch.Tensor, positions: np.ndarray) -> torch.Tensor:
    return rows[torch.from_numpy(positions).to(rows.device)]


class ReservoirSampler:
    """Bottom-``capacity``-priority token sample over a streamed corpus.

    ``offer`` takes one chunk of token rows (a tensor on any device, or a
    numpy array) plus the global index of its first token; the sample holds
    at most ``capacity`` rows, on the device of the rows offered.
    ``sample()`` returns the kept rows in ascending global-token order (the
    canonical order, so downstream k-means sees a chunking-invariant
    array).
    """

    def __init__(self, capacity: int, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.seed = int(seed)
        self.n_offered = 0
        self._rows: torch.Tensor | None = None  # (m, d) f32, m <= capacity
        self._prio = np.zeros(0, np.uint64)
        self._idx = np.zeros(0, np.int64)

    def offer(self, rows, start_index: int) -> None:
        rows = torch.as_tensor(rows).float()
        n = rows.shape[0]
        if n == 0:
            return
        idx = np.arange(start_index, start_index + n, dtype=np.int64)
        prio = token_priorities(idx, self.seed)
        self.n_offered += n
        if self._prio.size >= self.capacity:
            # fast path: only contenders below the current cut can enter
            pos = np.flatnonzero(prio < self._prio.max())
            if pos.size == 0:
                return
            rows, idx, prio = _take(rows, pos), idx[pos], prio[pos]
        merged_prio = np.concatenate([self._prio, prio])
        merged_idx = np.concatenate([self._idx, idx])
        merged_rows = rows if self._rows is None else torch.cat([self._rows, rows])
        if merged_prio.size > self.capacity:
            sel = np.argpartition(merged_prio, self.capacity - 1)[: self.capacity]
            merged_prio, merged_idx = merged_prio[sel], merged_idx[sel]
            merged_rows = _take(merged_rows, sel)
        self._prio, self._idx, self._rows = merged_prio, merged_idx, merged_rows

    @property
    def n_kept(self) -> int:
        return self._prio.size

    def sample(self) -> torch.Tensor:
        """Kept rows in ascending global-token order."""
        if self._rows is None:
            raise ValueError("reservoir never saw a token")
        return _take(self._rows, np.argsort(self._idx))
