"""Batch-first PLAID stage pipeline over a query batch (the counterpart of
``repro.core.pipeline``).

``stage1_scores_batched``
    ONE ``C·Qᵀ`` matmul for the whole (B, nq) query batch.
``candidate_generation_batched``
    Per-lane top-``nprobe`` probe + IVF union, batched over B.
``gather_candidate_tokens_shared``
    ONE doc-token gather for the batch's deduplicated candidate pool.
``centroid_interaction_batched`` / ``decompress_score_batched``
    Stages 2–4 over (B, cap) candidate blocks; with ``impl="cuda"`` these
    go through the Hopper kernels (``repro_torch.kernels.ops``).

The ops and their order are the reference's, so the same index and queries
give identical ranked pids.  ``t_cs`` is a scalar or a per-lane ``(B,)``
tensor.  The stage-1 product runs in full float32: TF32 is switched off
for CUDA matmuls around that product only (the reference's dot is f32).

Not ported yet: the ``funnel=`` telemetry and the traced ``nprobe_t`` /
``ndocs_t`` caps of ``exec.bucketed``.
"""
from __future__ import annotations

import torch

from repro_torch import ieee_f32_matmul
from repro_torch.constants import NEG
from repro_torch.core import scoring
from repro_torch.core.index import PlaidIndex
from repro_torch.kernels import ref as kref

#: int32 key standing in for the -1 "padded slot" sentinel wherever a SORTED
#: order is needed (pool construction): it sorts after every real pid.
_PAD_KEY = torch.iinfo(torch.int32).max

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# Stage 1 — batched query-centroid scores + candidate generation
# --------------------------------------------------------------------------
def stage1_scores_batched(
    index: PlaidIndex,
    qs: torch.Tensor,
    score_dtype: str = "float32",
    stage1_dtype: str = "float32",
) -> torch.Tensor:
    """(B, nq, d) queries -> (B, K, nq) score tensor via ONE ``C·Qᵀ`` product.

    ``stage1_dtype`` picks the operand precision with f32 accumulation:
    ``"bfloat16"`` rounds both operands to bf16 (their products are exact in
    f32, as the reference's ``preferred_element_type=f32`` dot gives);
    ``"int8"`` uses ``centroids_q`` and rescales by ``centroids_scale``.
    """
    B, nq, d = qs.shape
    flat = qs.float().reshape(B * nq, d)
    if stage1_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown stage1_dtype: {stage1_dtype!r}")
    with ieee_f32_matmul():
        if stage1_dtype == "float32":
            s = index.centroids.float() @ flat.T  # (K, B*nq)
        elif stage1_dtype == "bfloat16":
            s = index.centroids.bfloat16().float() @ flat.bfloat16().float().T
        else:
            s = (index.centroids_q.float() @ flat.T) * index.centroids_scale[:, None]
    s = s.reshape(s.shape[0], B, nq).permute(1, 0, 2)  # (B, K, nq)
    return s.to(_SCORE_DTYPES[score_dtype]).contiguous()


def candidate_generation_batched(
    index: PlaidIndex,
    s_cq: torch.Tensor,
    nprobe: int,
    candidate_cap: int,
    alive: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, K, nq) scores -> (B, candidate_cap) sorted unique pids, -1 pad.

    Pads are ``num_passages`` through the sorted-unique truncation so they
    sort past every real pid (a -1 pad would evict the highest pid at a
    full cap).  ``alive`` is the tombstone mask: dead pids are nulled
    BEFORE the truncation.
    """
    B = s_cq.shape[0]
    _, cids = scoring.stable_topk(s_cq.transpose(1, 2), nprobe)  # (B, nq, np)
    cids = cids.reshape(B, -1)
    starts = index.ivf_offsets[cids].long()
    lens = index.ivf_lens[cids]
    pos = torch.arange(index.ivf_list_cap, device=s_cq.device)
    valid = pos[None, None, :] < lens[..., None]
    idx = torch.where(valid, starts[..., None] + pos[None, None, :], 0)
    n = index.num_passages
    pids = torch.where(valid, index.ivf_pids[idx], n)  # (B, nq*np, cap)
    if alive is not None:
        real = pids < n
        safe = torch.where(real, pids, 0).long()
        pids = torch.where(real & alive[safe], pids, n)
    candidates = scoring.unique_sized(pids.reshape(B, -1), candidate_cap, n)
    return torch.where(candidates < n, candidates, -1)


# --------------------------------------------------------------------------
# Shared candidate-token gather
# --------------------------------------------------------------------------
def gather_candidate_tokens_shared(
    index: PlaidIndex, candidates: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One doc-token gather for the whole batch's candidate union.

    Returns (codes (B, cap, L) with -1 pad, tok_valid (B, cap, L) bool),
    identical to per-lane ``scoring.gather_doc_tokens`` output.
    """
    B, cap = candidates.shape
    keyed = torch.where(candidates >= 0, candidates, _PAD_KEY)
    pool = scoring.unique_sized(keyed.reshape(-1), B * cap, _PAD_KEY)
    pos = torch.searchsorted(pool, keyed)  # (B, cap), side="left"
    pool_pids = torch.where(pool != _PAD_KEY, pool, -1)
    codes_pool, valid_pool = scoring.gather_doc_tokens(
        index.codes, index.doc_offsets, index.doc_lens, pool_pids,
        index.doc_maxlen, fill=-1,
    )
    return codes_pool[pos], valid_pool[pos]


# --------------------------------------------------------------------------
# Stages 2-3 and 4 — plain paths (the kernels' plain versions)
# --------------------------------------------------------------------------
def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq)
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    q_mask: torch.Tensor | None = None,  # (B, nq)
    keep_centroid: torch.Tensor | None = None,  # (B, K) bool
) -> torch.Tensor:
    """Batched ``scoring.centroid_interaction``: (B, nd) approximate scores."""
    return kref.centroid_interaction_batched_ref(s_cq, codes, keep_centroid, q_mask)


def decompress_score_batched(
    index: PlaidIndex,
    qs: torch.Tensor,  # (B, nq, d)
    q_masks: torch.Tensor,  # (B, nq)
    codes_blk: torch.Tensor,  # (B, nd, L) i32, -1 pad
    res_blk: torch.Tensor,  # (B, nd, L, pd) u8
    tok_valid: torch.Tensor,  # (B, nd, L) bool
) -> torch.Tensor:
    """Residual decompression + exact MaxSim: (B, nd) exact scores."""
    return kref.decompress_and_score_batched_ref(
        qs, q_masks, codes_blk, res_blk, tok_valid, index.centroids,
        index.weights, nbits=index.nbits,
    )


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None...], axis=1)`` for (B, n, ...) x."""
    lane = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lane, idx]


# --------------------------------------------------------------------------
# Stages 1-3 — finalist selection
# --------------------------------------------------------------------------
def select_finalists_impl(
    index: PlaidIndex,
    qs: torch.Tensor,  # (B, nq, dim)
    q_masks: torch.Tensor,  # (B, nq)
    t_cs,  # scalar or per-lane (B,)
    *,
    params,  # plaid.SearchParams (t_cs field ignored)
    diag: bool = False,
    alive: torch.Tensor | None = None,
    keep_blocks: bool = True,
):
    """Stages 1-3: pick the (B, n3) finalist passages.

    Returns ``(final_pids, codes4, tok_valid4, extras)``; ``extras`` holds
    the ``diag`` dict when asked for.  ``keep_blocks=False`` (the fused
    tail reads CSR rows itself) skips the per-finalist blocks.
    """
    p = params
    if p.impl == "cuda":
        from repro_torch.kernels import ops as K

        interaction = K.centroid_interaction_batched
    elif p.impl == "ref":
        interaction = centroid_interaction_batched
    else:
        raise ValueError(f"unknown impl: {p.impl!r} (expected 'ref' or 'cuda')")

    # ---- Stage 1: one batched C.Q^T + per-lane candidate generation
    s_cq = stage1_scores_batched(index, qs, p.score_dtype, p.stage1_dtype)
    candidates = candidate_generation_batched(
        index, s_cq, p.nprobe, p.candidate_cap, alive
    )

    # ---- Stage 2: pruned centroid interaction over the shared gather
    t_arr = torch.as_tensor(t_cs, dtype=torch.float32, device=qs.device)
    t_bcast = t_arr if t_arr.ndim == 0 else t_arr[:, None]  # vs (B, K) max
    keep = scoring.prune_mask(s_cq, t_bcast)  # (B, K)
    codes_blk, tok_valid = gather_candidate_tokens_shared(index, candidates)
    approx2 = interaction(s_cq, codes_blk, q_masks, keep)  # (B, cap)
    approx2 = torch.where(candidates >= 0, approx2, NEG)
    n2 = min(p.ndocs, p.candidate_cap)
    _, idx2 = scoring.stable_topk(approx2, n2)  # (B, n2)

    # ---- Stage 3: full centroid interaction on the survivors
    codes3 = _take_rows(codes_blk, idx2)
    cand2 = _take_rows(candidates, idx2)
    approx3 = interaction(s_cq, codes3, q_masks, None)
    approx3 = torch.where(cand2 >= 0, approx3, NEG)
    n3 = min(max(p.ndocs // 4, p.k), n2)
    _, idx3 = scoring.stable_topk(approx3, n3)  # (B, n3)
    final_pids = _take_rows(cand2, idx3)

    if keep_blocks:
        codes4 = _take_rows(codes3, idx3)
        tok_valid4 = _take_rows(_take_rows(tok_valid, idx2), idx3)
    else:
        codes4 = tok_valid4 = None

    extras = []
    if diag:
        extras.append(
            dict(
                stage1_candidates=(candidates >= 0).sum(dim=1),
                stage2_kept_centroids=keep.sum(dim=1),
                stage3_survivors=(final_pids >= 0).sum(dim=1),
            )
        )
    return final_pids, codes4, tok_valid4, extras


# --------------------------------------------------------------------------
# Stage 4 — exact rescoring of the finalists + final top-k
# --------------------------------------------------------------------------
def exact_stage4_impl(
    index: PlaidIndex,
    qs: torch.Tensor,  # (B, nq, dim)
    q_masks: torch.Tensor,  # (B, nq)
    final_pids: torch.Tensor,  # (B, n3)
    codes4: torch.Tensor | None,  # (B, n3, L) — required when not fused
    tok_valid4: torch.Tensor | None,  # (B, n3, L)
    *,
    params,
) -> torch.Tensor:
    """Residual decompression + exact MaxSim over the finalists: raw (B, n3)
    scores (padding lanes are masked by :func:`finalize_topk`)."""
    p = params
    B, n3 = final_pids.shape
    qs = qs.float().contiguous()
    q_masks = q_masks.float().contiguous()
    if p.fused:
        # gather + decompress + MaxSim straight off the CSR token arrays
        if p.impl == "cuda":
            from repro_torch.kernels import ops as K

            fn = K.gather_decompress_maxsim
        else:
            fn = kref.gather_decompress_maxsim_ref
        return fn(
            qs, q_masks, final_pids, index.codes, index.residuals,
            index.doc_offsets, index.doc_lens, index.centroids, index.weights,
            nbits=index.nbits, doc_maxlen=index.doc_maxlen,
        )
    res_blk, _ = scoring.gather_doc_tokens(
        index.residuals, index.doc_offsets, index.doc_lens,
        final_pids.reshape(-1), index.doc_maxlen, fill=0,
    )  # one gather for all B*n3 finalists
    res_blk = res_blk.reshape(B, n3, index.doc_maxlen, -1)
    if p.impl == "cuda":
        from repro_torch.kernels import ops as K

        return K.decompress_and_score_batched(
            qs, q_masks, codes4, res_blk, tok_valid4, index.centroids,
            index.weights, nbits=index.nbits,
        )
    return decompress_score_batched(index, qs, q_masks, codes4, res_blk, tok_valid4)


def finalize_topk(
    exact: torch.Tensor,  # (B, n3) raw stage-4 scores
    final_pids: torch.Tensor,  # (B, n3) global pids (-1 pad)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask padding lanes and take the final top-k over the finalists."""
    exact = torch.where(final_pids >= 0, exact, NEG)
    kk = min(k, final_pids.shape[1])
    top_scores, idxk = scoring.stable_topk(exact, kk)
    return top_scores, _take_rows(final_pids, idxk)


def run_pipeline(
    index: PlaidIndex,
    qs: torch.Tensor,  # (B, nq, dim)
    q_masks: torch.Tensor,  # (B, nq)
    t_cs,  # scalar or per-lane (B,)
    params,  # plaid.SearchParams (t_cs field ignored)
    *,
    diag: bool = False,
    alive: torch.Tensor | None = None,  # (Nd,) bool; False = tombstoned
):
    """Batched (B >= 1) PLAID search on ``index``'s device.

    Returns ((B, k) scores, (B, k) int32 pids[, diagnostics dict of (B,)
    counters]).  Stages 1-3 (:func:`select_finalists_impl`), stage 4
    (:func:`exact_stage4_impl`) and :func:`finalize_topk`, in the
    reference's order.
    """
    final_pids, codes4, tok_valid4, extras = select_finalists_impl(
        index, qs, q_masks, t_cs, params=params, diag=diag, alive=alive,
        keep_blocks=not params.fused,
    )
    exact = exact_stage4_impl(
        index, qs, q_masks, final_pids, codes4, tok_valid4, params=params
    )
    top_scores, top_pids = finalize_topk(exact, final_pids, params.k)
    return (top_scores, top_pids, *extras)
