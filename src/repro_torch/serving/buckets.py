"""Pow2 batch-shape buckets for the query axis of coalesced dispatch (the
counterpart of ``repro.serving.buckets``).

A fixed-batch micro-batcher pads *every* tail to one batch size: a single
arrival at B=16 pays 16 lanes of stage-1..4 work for one answer.  This
module applies the repo's one padding discipline
(``repro_torch.exec.segments.pow2_bucket`` — the rule that buckets live
delta segments) to the *query-batch* axis instead: a burst of ``n``
requests dispatches at the smallest power-of-two bucket >= ``n``, clamped
to the server's ``max_batch_size``.  A burst of 3 runs at B=4, a lone
arrival at B=1, and a server configured for ``max_batch_size=16`` launches
its kernels at no more than ``log2(16)+1 = 5`` batch shapes.

Pad lanes replicate the last real request's query and threshold, so the
padded batch is shape-identical for any occupancy of the bucket and the
pad lanes' results are simply dropped.
"""
from __future__ import annotations

import numpy as np

from repro_torch.exec.segments import pow2_bucket


def bucket_batch_size(n: int, max_batch_size: int) -> int:
    """The dispatch bucket for ``n`` coalesced requests: pow2-rounded,
    clamped to ``max_batch_size`` (itself a terminal bucket even when not
    a power of two)."""
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    if n > max_batch_size:
        raise ValueError(
            f"{n} requests exceed max_batch_size={max_batch_size}"
        )
    return pow2_bucket(n, hi=max_batch_size)


def bucket_ladder(max_batch_size: int) -> tuple[int, ...]:
    """Every bucket a server with this cap can dispatch, ascending —
    the batch shapes a warm-up pass should visit."""
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


def pad_batch(
    queries: list[np.ndarray],
    t_cs: list[float],
    bucket: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ``n`` queries + per-request thresholds into bucket-shaped
    arrays: ``(bucket, nq, dim)`` queries and a ``(bucket,)`` float32
    ``t_cs`` lane vector.  Pad lanes replicate the last real request
    (their results are discarded), so per-lane outputs for the real
    requests are identical at any occupancy.
    """
    n = len(queries)
    assert 1 <= n <= bucket, (n, bucket)
    qs = np.stack(queries)
    ts = np.asarray(t_cs, np.float32)
    if n < bucket:
        qs = np.concatenate([qs, np.repeat(qs[-1:], bucket - n, axis=0)])
        ts = np.concatenate([ts, np.repeat(ts[-1:], bucket - n)])
    return qs, ts
