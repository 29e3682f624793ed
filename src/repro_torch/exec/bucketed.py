"""Pow2-bucketed static-cap dispatch: sweep ``nprobe`` / ``ndocs`` over a
few launch shapes (the counterpart of ``repro.exec.bucketed``).

``SearchParams.nprobe`` and ``SearchParams.ndocs`` set the shapes of the
pipeline's tensors and kernel launches.  This module runs a requested
(nprobe, ndocs) point at the pow2 bucket of each cap (clamped to its
lossless ceiling: ``num_centroids`` for nprobe, the corpus-clamped
``candidate_cap`` for ndocs) and passes the requested caps as the
``nprobe_t`` / ``ndocs_t`` arguments of ``core.pipeline.run_pipeline``,
which mask the bucket's tensors down to them.  So a whole grid runs at
most ``log2(K) * log2(cap)`` distinct launch shapes.

The masked result is IDENTICAL (scores and pids) to a program run at the
requested caps: every selection is ``scoring.stable_topk``, which is
prefix-stable (``top_k(x, m)[..., :n] == top_k(x, n)`` for ``n <= m``,
ties toward the lower index in both), so masking the tail of a larger
top-k reproduces the smaller one.

The reference keys its jit cache on the bucket and counts retraces inside
a bucket.  Eager PyTorch traces nothing, so ``retraces_within_bucket``
stays 0 by construction (``core.pipeline.trace_count`` is always 0);
``n_programs`` still counts the distinct (bucket, batch shape, funnel)
signatures, which are the distinct launch shapes of K1-K3.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pipeline, plaid
from repro_torch.core.index import PlaidIndex
from repro_torch.exec.segments import pow2_bucket


class BucketedCapEngine:
    """Whole-corpus PLAID search at DYNAMIC (nprobe, ndocs) caps, on the
    index's device.

    ``search_batch(..., nprobe=, ndocs=)`` picks the pow2 bucket and passes
    the requested caps on; ``t_cs`` is a per-call value as ever.
    """

    def __init__(self, index: PlaidIndex, params: plaid.SearchParams):
        self.index = index
        self.base_params = plaid.clamp_params(params, index.num_passages)
        self._seen: set[tuple] = set()  # launch signatures already run
        self.retraces_within_bucket = 0

    # ---- bucket arithmetic ----------------------------------------------
    def effective_caps(self, nprobe: int, ndocs: int) -> tuple[int, int]:
        """Requested caps clamped to their lossless ceilings (matching
        ``clamp_params`` + the top-k bound on nprobe)."""
        np_eff = max(1, min(int(nprobe), self.index.num_centroids))
        nd_eff = max(1, min(int(ndocs), self.base_params.candidate_cap))
        return np_eff, nd_eff

    def bucket(self, nprobe: int, ndocs: int) -> tuple[int, int]:
        """The pow2 (nprobe, ndocs) bucket a requested point runs in."""
        np_eff, nd_eff = self.effective_caps(nprobe, ndocs)
        return (
            pow2_bucket(np_eff, hi=self.index.num_centroids),
            pow2_bucket(nd_eff, hi=self.base_params.candidate_cap),
        )

    def params_for(self, nprobe: int, ndocs: int) -> plaid.SearchParams:
        np_b, nd_b = self.bucket(nprobe, ndocs)
        return dataclasses.replace(self.base_params, nprobe=np_b, ndocs=nd_b)

    # ---- search ----------------------------------------------------------
    def search_batch(
        self,
        qs,
        q_masks=None,
        t_cs=None,
        *,
        nprobe: int,
        ndocs: int,
        funnel: bool = False,
    ):
        """Batched search at the requested (nprobe, ndocs, t_cs) point.

        Returns ``run_pipeline``'s output at the BUCKET's shapes: ranked
        (scores, pids[, FunnelStats]) whose rank prefix equals a program at
        the requested caps; slots past the cap carry pid -1 / NEG, which
        every consumer treats as padding.
        """
        dev = self.index.device
        qs = plaid._as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = plaid._as_queries(q_masks, dev, 2)
        t = self.base_params.t_cs if t_cs is None else t_cs
        np_eff, nd_eff = self.effective_caps(nprobe, ndocs)
        params_b = self.params_for(nprobe, ndocs)
        key = (params_b.nprobe, params_b.ndocs, bool(funnel), tuple(qs.shape))
        before = pipeline.trace_count()
        out = pipeline.run_pipeline(
            self.index, qs, q_masks, t, params_b, funnel=funnel,
            nprobe_t=np_eff, ndocs_t=nd_eff,
        )
        if key in self._seen:
            self.retraces_within_bucket += pipeline.trace_count() - before
        self._seen.add(key)
        return out

    # ---- launch-shape accounting -----------------------------------------
    @property
    def n_programs(self) -> int:
        """Distinct (bucket, batch-shape, funnel) signatures run so far."""
        return len(self._seen)

    def assert_zero_retrace_within_bucket(self) -> None:
        """The reference harness's compile-discipline gate (always passes
        in eager PyTorch; kept so the harness reads the same)."""
        if self.retraces_within_bucket:
            raise AssertionError(
                f"{self.retraces_within_bucket} pipeline retrace(s) inside "
                "already-run cap buckets"
            )
