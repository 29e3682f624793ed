"""The PLAID 4-stage engine (paper Fig. 5): parameters and ``PlaidEngine``.

Stage 1  candidate generation: top-``nprobe`` centroids per query token ->
         union of passages from the centroid->pid inverted lists.
Stage 2  *pruned* centroid interaction (threshold ``t_cs``) -> top ``ndocs``.
Stage 3  full centroid interaction -> top ``ndocs // 4``.
Stage 4  residual decompression + exact MaxSim -> final top-``k``.

The counterpart of ``repro.core.plaid``; ``impl`` picks the plain PyTorch
ops (``"ref"``) or the Hopper kernels (``"cuda"``).  The single-query
``_search`` oracle is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.constants import DEFAULT_CANDIDATE_CAP
from repro_torch.core import pipeline
from repro_torch.core.index import PlaidIndex

IMPLS = ("ref", "cuda")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Hyperparameters (paper Table 2) + engine caps."""

    k: int = 10
    nprobe: int = 1
    t_cs: float = 0.5
    ndocs: int = 256
    #: C_max: bound on |stage-1 candidates|; clamped to the corpus size
    candidate_cap: int = DEFAULT_CANDIDATE_CAP
    impl: str = "ref"  # "ref" (plain torch) | "cuda" (Hopper kernels)
    score_dtype: str = "float32"  # stage 1-3 approximate-score dtype
    stage1_dtype: str = "float32"  # stage-1 C·Qᵀ operand dtype:
    # "float32" | "bfloat16" | "int8" (quantized centroid table)
    fused: bool = False  # stage 3-5 tail through the fused gather->
    # decompress->maxsim kernel instead of the materialized gather

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")


#: Paper Table 2 settings, keyed by final k.
PAPER_PARAMS = {
    10: SearchParams(k=10, nprobe=1, t_cs=0.5, ndocs=256),
    100: SearchParams(k=100, nprobe=2, t_cs=0.45, ndocs=1024),
    1000: SearchParams(k=1000, nprobe=4, t_cs=0.4, ndocs=4096),
}


def params_for_k(k: int, candidate_cap: int | None = None, impl: str = "ref"):
    """Paper Table 2 params for ``k`` (``candidate_cap=None`` keeps the
    default ``DEFAULT_CANDIDATE_CAP``)."""
    base = PAPER_PARAMS.get(k, SearchParams(k=k))
    if candidate_cap is None:
        candidate_cap = DEFAULT_CANDIDATE_CAP
    return dataclasses.replace(base, candidate_cap=candidate_cap, impl=impl)


def clamp_params(params: SearchParams, n_passages: int) -> SearchParams:
    """Corpus-clamped caps — the reference's clamp rule."""
    cap = min(params.candidate_cap, max(n_passages, 2))
    return dataclasses.replace(params, candidate_cap=cap, ndocs=min(params.ndocs, cap))


def _as_queries(x, device, ndim: int) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    if x.ndim != ndim:
        raise ValueError(f"expected a {ndim}-d query tensor, got shape {tuple(x.shape)}")
    return x


class PlaidEngine:
    """Engine handle over one in-memory index (on the index's device).

    The public, backend-agnostic API is ``repro_torch.retrieval``; this
    class is what the ``"plaid"`` / ``"plaid-cuda"`` backends wrap.
    ``search`` is the B=1 squeeze of ``search_batch``.  Queries may be numpy
    arrays or tensors; they are moved to the index's device.
    """

    def __init__(self, index: PlaidIndex, params: SearchParams | None = None):
        self.index = index
        self.params = params or SearchParams()

    def _pipeline_params(self) -> SearchParams:
        return clamp_params(self.params, self.index.num_passages)

    def _kwargs(self):
        """The effective caps after clamping to the corpus."""
        p = self._pipeline_params()
        return dict(
            k=p.k,
            nprobe=p.nprobe,
            ndocs=p.ndocs,
            candidate_cap=p.candidate_cap,
            impl=p.impl,
            score_dtype=p.score_dtype,
        )

    def search(self, q, q_mask=None, *, t_cs: float | None = None, diag: bool = False):
        """q: (nq, dim) one query matrix -> (scores (k,), pids (k,))."""
        dev = self.index.device
        q = _as_queries(q, dev, 2)
        q_mask = None if q_mask is None else _as_queries(q_mask, dev, 1)[None]
        scores, pids, *extras = self.search_batch(q[None], q_mask, t_cs=t_cs, diag=diag)
        if diag:
            return scores[0], pids[0], {k: v[0] for k, v in extras[0].items()}
        return scores[0], pids[0]

    def search_batch(self, qs, q_masks=None, *, t_cs: float | None = None, diag: bool = False):
        """qs: (B, nq, dim) -> (scores (B, k), pids (B, k))."""
        dev = self.index.device
        qs = _as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = _as_queries(q_masks, dev, 2)
        t = self.params.t_cs if t_cs is None else t_cs
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return pipeline.run_pipeline(
            self.index, qs, q_masks, t, self._pipeline_params(), diag=diag
        )
