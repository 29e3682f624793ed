"""Stacked-segment partition execution (the counterpart of
``repro.exec.segments``).

The reference searches N segments under ONE compiled program: segments
are padded to a shared :class:`SegmentBucket` shape signature, stacked
along a leading axis and searched by ``vmap(run_pipeline_impl)``, then
merged once by ``distributed.topk.merge_topk``.  The port runs eagerly and
has no program to share, so it never pads or stacks segment arrays (for a
2M-passage base the pow2 token cap alone would copy the 6.75 GB index into
a ~13 GB array).  Its stacked group is a loop over the REAL segments, each
searched with its own tensors, that carries exactly what changes a result:

* **the clamp basis** — every segment of a group is clamped with
  ``plaid.clamp_params(params, bucket.nd_clamp)``, the group's largest TRUE
  passage count (not the segment's own, not the total).  Under truncating
  caps it decides stage 3's keep;
* **k padding** — a segment whose top list is shorter than ``k`` is padded
  with ``NEG`` / ``-1`` before its pid offset is added;
* **offsets** — ``pid + offset`` only where ``pid >= 0``;
* **the funnel** — per-segment ``FunnelStats`` reduce as
  ``obs.funnel.reduce_stacked`` does (doc counts add, centroid counts take
  the max);
* **stage 1** — the segments share one centroid space, so the ``C·Qᵀ``
  product, the probe and the prune mask are computed once per batch
  (``core.pipeline.shared_stage1``), as they are inside the reference's
  ``vmap``, where they depend on unbatched inputs only.

The reference's filler segments contribute only ``NEG``, ``-1`` and zero
counts, so the loop skips them.  The pow2 static meta of the bucket
(``doc_maxlen``, ``ivf_list_cap``, the pad sentinel) only widens masked
windows there and moves no result, so each segment keeps its own.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.constants import NEG
from repro_torch.core import pipeline, plaid
from repro_torch.distributed import topk as dtopk
from repro_torch.obs import funnel as funnel_mod


def ceil_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pow2_bucket(n: int, *, lo: int = 1, hi: int | None = None) -> int:
    """The smallest power of two >= ``n``, clamped to ``[lo, hi]``.

    A non-pow2 ``hi`` is itself a terminal bucket, so the bucket never
    exceeds what the caller configured.
    """
    b = max(ceil_pow2(n), ceil_pow2(lo))
    if hi is not None:
        b = min(b, int(hi))
    return b


@dataclasses.dataclass(frozen=True)
class SegmentBucket:
    """What the port keeps of the reference's stacked-group signature:
    the stacked axis size and the clamp basis.  The reference's other
    fields (pow2 token, IVF and passage-length caps) size its padding only,
    and the port pads nothing."""

    n_segments: int  # stacked axis size (the reference pads with fillers)
    nd_clamp: int  # true max passage count: the param-clamp basis


def bucket_for(segments) -> SegmentBucket:
    """The group signature of a segment list, from the segments'
    Python-int metadata (no device sync)."""
    assert segments, "bucket_for needs at least one segment"
    first = segments[0]
    for s in segments[1:]:
        assert s.num_centroids == first.num_centroids, (
            "stacked segments must share one centroid space"
        )
        assert (s.dim, s.nbits) == (first.dim, first.nbits)
    return SegmentBucket(
        n_segments=pow2_bucket(len(segments)),
        nd_clamp=max(s.num_passages for s in segments),
    )


def pack_offsets(offsets, bucket: SegmentBucket, device="cpu") -> torch.Tensor:
    """Per-segment global pid offsets as an (n_segments,) int32 tensor on
    ``device``, filler segments pinned to 0."""
    out = torch.zeros(bucket.n_segments, dtype=torch.int32)
    out[: len(offsets)] = torch.as_tensor(list(offsets), dtype=torch.int32)
    return out.to(device)


def make_stacked_search(params, bucket: SegmentBucket, *, funnel: bool = False):
    """The search of one segment group.

    Returns ``run(segments, qs, q_masks, t_cs, offsets, alive, stage1=None)
    -> ((B, k) scores, (B, k) global pids[, FunnelStats])``: each real
    segment through ``core.pipeline.run_pipeline`` at the bucket's clamp,
    its pids offset by ``offsets[i]`` (:func:`pack_offsets` on the
    segments' device) and its tombstones read from ``alive[i]``, the
    segment's own (Nd_s,) bool mask, then the one shared merge
    (``merge_topk``, local case).  ``stage1`` is ``pipeline.shared_stage1``
    of the batch (computed here from the first segment's centroids when
    ``None``).
    """
    # per-group clamp against the LARGEST segment's true passage count: the
    # rule PlaidEngine applies per corpus, so a one-segment group is the
    # PlaidEngine search of that segment
    p = dataclasses.replace(plaid.clamp_params(params, bucket.nd_clamp), t_cs=0.0)
    k = params.k

    def run(segments, qs, q_masks, t_cs, offsets, alive, stage1=None):
        if stage1 is None:
            stage1 = pipeline.shared_stage1(segments[0], qs, t_cs, p)
        scores, pids, stats = [], [], []
        for i, seg in enumerate(segments):
            s, pid, *aux = pipeline.run_pipeline(
                seg, qs, q_masks, t_cs, p, funnel=funnel,
                alive=alive[i], stage1=stage1,
            )  # (B, kk) with kk = min(k, stage-3 keep)
            if s.shape[1] < k:  # a small segment: pad its top-k to k
                pad = (0, k - s.shape[1])
                s = torch.nn.functional.pad(s, pad, value=NEG)
                pid = torch.nn.functional.pad(pid, pad, value=-1)
            scores.append(s)
            pids.append(torch.where(pid >= 0, pid + offsets[i], -1))
            stats.extend(aux)
        merged = dtopk.merge_topk(torch.cat(scores, dim=1), torch.cat(pids, dim=1), k)
        if funnel:
            stacked = funnel_mod.FunnelStats(*(torch.stack(f) for f in zip(*stats)))
            return (*merged, funnel_mod.reduce_stacked(stacked))
        return merged

    return run
