"""The PLAID 4-stage engine (paper Fig. 5): parameters and ``PlaidEngine``.

Stage 1  candidate generation: top-``nprobe`` centroids per query token ->
         union of passages from the centroid->pid inverted lists.
Stage 2  *pruned* centroid interaction (threshold ``t_cs``) -> top ``ndocs``.
Stage 3  full centroid interaction -> top ``ndocs // 4``.
Stage 4  residual decompression + exact MaxSim -> final top-``k``.

The counterpart of ``repro.core.plaid``; ``impl`` picks the plain PyTorch
ops (``"ref"``) or the Hopper kernels (``"cuda"``).  ``PlaidEngine`` runs
the batched ``core.pipeline``; :func:`_search` is the single-query monolith
kept as its oracle (``impl="cuda"`` runs K5 and K6, the B=1 launches of
the K1 and K2 kernels).  The reference's ``trace_count`` and jit cache are
XLA's and have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.constants import DEFAULT_CANDIDATE_CAP, NEG
from repro_torch.core import pipeline, scoring
from repro_torch.core.index import PlaidIndex
from repro_torch.kernels import ref as kref

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


# --------------------------------------------------------------------------
# Stage 1 — candidate generation (one query)
# --------------------------------------------------------------------------
def candidate_generation(
    index: PlaidIndex, s_cq: torch.Tensor, nprobe: int, candidate_cap: int
) -> torch.Tensor:
    """(K, nq) scores -> (candidate_cap,) sorted unique pids, -1 pads at the
    tail.  Pads are ``num_passages`` (past every real pid) through the
    sorted-unique truncation, so they never displace a real candidate; the
    probe keeps ``jax.lax.top_k``'s tie order (``stable_topk``)."""
    n = index.num_passages
    _, cids = scoring.stable_topk(s_cq.T, nprobe)  # (nq, nprobe)
    cids = cids.reshape(-1)
    starts = index.ivf_offsets[cids].long()
    lens = index.ivf_lens[cids]
    pos = torch.arange(index.ivf_list_cap, device=s_cq.device)
    valid = pos[None, :] < lens[:, None]
    idx = torch.where(valid, starts[:, None] + pos[None, :], 0)
    pids = torch.where(valid, index.ivf_pids[idx], n)  # (nq*nprobe, cap)
    cand = scoring.unique_sized(pids.reshape(-1), candidate_cap, n)
    return torch.where(cand < n, cand, -1)


# --------------------------------------------------------------------------
# Stage 4 — decompress + exact MaxSim (plain path, one query)
# --------------------------------------------------------------------------
def decompress_and_score_ref(
    index: PlaidIndex,
    q: torch.Tensor,  # (nq, dim)
    q_mask: torch.Tensor,  # (nq,)
    codes_blk: torch.Tensor,  # (nd, L) i32, -1 pad
    res_blk: torch.Tensor,  # (nd, L, packed_dim) u8
    tok_valid: torch.Tensor,  # (nd, L) bool
) -> torch.Tensor:
    """(nd,) exact scores: ``centroids[code] + weights[idx]`` against ``q``,
    in K6's f32 order (``kernels.ref.decompress_and_score_ref``), so the
    ``ref`` and ``cuda`` oracles agree bit for bit, as the pipeline's do."""
    return kref.decompress_and_score_ref(
        q, q_mask, codes_blk, res_blk, tok_valid, index.centroids,
        index.weights, nbits=index.nbits,
    )


# --------------------------------------------------------------------------
# Full pipeline (single query matrix): the oracle of ``run_pipeline``
# --------------------------------------------------------------------------
def _search(
    index: PlaidIndex,
    q: torch.Tensor,  # (nq, dim)
    q_mask: torch.Tensor | None = None,  # (nq,)
    s_cq: torch.Tensor | None = None,  # precomputed (K, nq) stage-1 scores
    t_cs=0.5,
    *,
    k: int,
    nprobe: int,
    ndocs: int,
    candidate_cap: int,
    impl: str,
    score_dtype: str = "float32",
    diag: bool = False,
):
    """One query through stages 1-4 -> (scores (kk,), pids (kk,)[, diag]).

    The reference's ``_search`` op for op, on ``index``'s device.
    ``impl="cuda"`` runs stages 2/3 through K5 and stage 4 through K6
    (``kernels.ops.centroid_interaction`` / ``decompress_and_score``);
    ``impl="ref"`` runs their plain versions, in the kernels' f32 order.
    """
    if impl == "cuda":
        from repro_torch.kernels import ops as K

        interaction = K.centroid_interaction
        decompress_score = K.decompress_and_score
    elif impl == "ref":
        def interaction(s, codes, mask, keep):
            return kref.centroid_interaction_ref(s, codes, keep, mask)

        decompress_score = None
    else:
        raise ValueError(f"unknown impl: {impl!r} (expected one of {IMPLS})")
    q = q.float()
    if q_mask is None:
        q_mask = torch.ones(q.shape[0], dtype=torch.float32, device=q.device)
    q_mask = q_mask.float()
    dtype = pipeline._SCORE_DTYPES[score_dtype]

    # ---- Stage 1: query-centroid scores + candidate generation
    if s_cq is None:
        s_cq = scoring.centroid_scores(q, index.centroids, dtype=dtype)  # (K, nq)
    else:
        s_cq = s_cq.to(dtype)
    candidates = candidate_generation(index, s_cq, nprobe, candidate_cap)

    # ---- Stage 2: pruned centroid interaction
    keep = scoring.prune_mask(s_cq, t_cs)  # (K,)
    codes_blk, tok_valid = scoring.gather_doc_tokens(
        index.codes, index.doc_offsets, index.doc_lens, candidates,
        index.doc_maxlen, fill=-1,
    )
    approx2 = interaction(s_cq, codes_blk, q_mask, keep)
    approx2 = torch.where(candidates >= 0, approx2, NEG)
    n2 = min(ndocs, candidate_cap)
    _, idx2 = scoring.stable_topk(approx2, n2)

    # ---- Stage 3: full centroid interaction on the survivors
    codes3 = codes_blk[idx2]
    approx3 = interaction(s_cq, codes3, q_mask, None)
    approx3 = torch.where(candidates[idx2] >= 0, approx3, NEG)
    n3 = min(max(ndocs // 4, k), n2)
    _, idx3 = scoring.stable_topk(approx3, n3)
    final_pids = candidates[idx2][idx3]  # (n3,)

    # ---- Stage 4: residual decompression + exact MaxSim
    codes4 = codes3[idx3]
    tok_valid4 = tok_valid[idx2][idx3]
    res_blk, _ = scoring.gather_doc_tokens(
        index.residuals, index.doc_offsets, index.doc_lens, final_pids,
        index.doc_maxlen, fill=0,
    )
    if decompress_score is None:
        exact = decompress_and_score_ref(index, q, q_mask, codes4, res_blk, tok_valid4)
    else:
        exact = decompress_score(
            q, q_mask, codes4, res_blk, tok_valid4, index.centroids,
            index.weights, nbits=index.nbits,
        )
    exact = torch.where(final_pids >= 0, exact, NEG)
    kk = min(k, n3)
    top_scores, idxk = scoring.stable_topk(exact, kk)
    if diag:
        diagnostics = dict(
            stage1_candidates=(candidates >= 0).sum(),
            stage2_kept_centroids=keep.sum(),
            stage3_survivors=(final_pids >= 0).sum(),
        )
        return top_scores, final_pids[idxk], diagnostics
    return top_scores, final_pids[idxk]


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
