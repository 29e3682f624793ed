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

``funnel=True`` appends ``obs.FunnelStats`` (per-lane candidate counts at
every stage) after the ``diag`` dict.  ``nprobe_t`` / ``ndocs_t`` are
effective caps below the shape caps ``params.nprobe`` / ``params.ndocs``
(``exec.bucketed``): they mask a program built at a pow2 bucket down to
the requested caps.  Every selection is ``scoring.stable_topk``, which is
prefix-stable with ties toward the lower index, so the masked program
ranks exactly as one built at the requested caps.
"""
from __future__ import annotations

import torch

from repro_torch import ieee_f32_matmul
from repro_torch.constants import NEG
from repro_torch.core import scoring
from repro_torch.core.index import PlaidIndex
from repro_torch.kernels import ref as kref
from repro_torch.obs.funnel import FunnelStats

#: int32 key standing in for the -1 "padded slot" sentinel wherever a SORTED
#: order is needed (pool construction): it sorts after every real pid.
_PAD_KEY = torch.iinfo(torch.int32).max

_SCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def trace_count() -> int:
    """The reference counts its pipeline's jit traces here.  The port runs
    eagerly and never traces, so this counts nothing and stays 0; it is
    kept so ``exec.bucketed`` reads as the reference does."""
    return 0


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


def probe_centroids(s_cq: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(B, K, nq) scores -> (B, nq, nprobe) int64 top-``nprobe`` centroid ids
    per query token, in ``jax.lax.top_k``'s order."""
    return scoring.stable_topk(s_cq.transpose(1, 2), nprobe)[1]


def candidate_generation_batched(
    index: PlaidIndex,
    s_cq: torch.Tensor,
    nprobe: int,
    candidate_cap: int,
    alive: torch.Tensor | None = None,
    *,
    with_stats: bool = False,
    nprobe_t: int | None = None,
    cids: torch.Tensor | None = None,
):
    """(B, K, nq) scores -> (B, candidate_cap) sorted unique pids, -1 pad.

    Pads are ``num_passages`` through the sorted-unique truncation so they
    sort past every real pid (a -1 pad would evict the highest pid at a
    full cap).  ``alive`` is the tombstone mask: dead pids are nulled
    BEFORE the truncation.

    ``with_stats=True`` also returns a per-lane ``(B,)`` int32 count of the
    DISTINCT tombstoned passages the alive mask removed (clamped at
    ``candidate_cap`` distinct dead pids, the bound the live candidates
    get).  ``nprobe_t <= nprobe`` gives probe ranks ``>= nprobe_t`` a
    zero-length IVF window: the candidate set of a static
    ``nprobe=nprobe_t`` program.  ``cids`` is the probe
    (:func:`probe_centroids`) when the caller already has it.
    """
    B = s_cq.shape[0]
    if cids is None:
        cids = probe_centroids(s_cq, nprobe)  # (B, nq, np)
    cids = cids.reshape(B, -1)
    starts = index.ivf_offsets[cids].long()
    lens = index.ivf_lens[cids]
    if nprobe_t is not None:
        # probe rank of each flattened (token, probe) slot
        nq = s_cq.shape[2]
        rank = torch.arange(nprobe, device=s_cq.device).repeat(nq)
        lens = torch.where(rank[None, :] < nprobe_t, lens, 0)
    pos = torch.arange(index.ivf_list_cap, device=s_cq.device)
    valid = pos[None, None, :] < lens[..., None]
    idx = torch.where(valid, starts[..., None] + pos[None, None, :], 0)
    n = index.num_passages
    pids = torch.where(valid, index.ivf_pids[idx], n)  # (B, nq*np, cap)
    dead_pids = None
    if alive is not None:
        real = pids < n
        live = alive[torch.where(real, pids, 0).long()]
        if with_stats:
            dead_pids = torch.where(real & ~live, pids, n)  # raw pid where tombstoned
        pids = torch.where(real & live, pids, n)
    candidates = scoring.unique_sized(pids.reshape(B, -1), candidate_cap, n)
    candidates = torch.where(candidates < n, candidates, -1)
    if not with_stats:
        return candidates
    if dead_pids is None:
        alive_dropped = torch.zeros(B, dtype=torch.int32, device=s_cq.device)
    else:
        uniq_dead = scoring.unique_sized(dead_pids.reshape(B, -1), candidate_cap, n)
        alive_dropped = (uniq_dead < n).sum(dim=1, dtype=torch.int32)
    return candidates, alive_dropped


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
    funnel: bool = False,
    alive: torch.Tensor | None = None,
    keep_blocks: bool = True,
    nprobe_t: int | None = None,  # effective caps <= params.nprobe /
    ndocs_t: int | None = None,  # params.ndocs (exec.bucketed)
):
    """Stages 1-3: pick the (B, n3) finalist passages.

    Returns ``(final_pids, codes4, tok_valid4, extras)``; ``extras`` holds
    the ``diag`` dict and then ``FunnelStats`` when asked for.
    ``keep_blocks=False`` (the fused tail reads CSR rows itself) skips the
    per-finalist blocks.
    """
    p = params
    B = qs.shape[0]
    if p.impl == "cuda":
        from repro_torch.kernels import ops as K

        interaction = K.centroid_interaction_batched
    elif p.impl == "ref":
        interaction = centroid_interaction_batched
    else:
        raise ValueError(f"unknown impl: {p.impl!r} (expected 'ref' or 'cuda')")

    # ---- Stage 1: one batched C.Q^T + per-lane candidate generation
    s_cq = stage1_scores_batched(index, qs, p.score_dtype, p.stage1_dtype)
    cids = probe_centroids(s_cq, p.nprobe)  # (B, nq, np)
    cand_out = candidate_generation_batched(
        index, s_cq, p.nprobe, p.candidate_cap, alive, with_stats=funnel,
        nprobe_t=nprobe_t, cids=cids,
    )
    if funnel:
        candidates, alive_dropped = cand_out
        cids_f = cids
        if nprobe_t is not None:
            # probes past the cap collapse onto each token's top-1 centroid,
            # so the distinct count matches a static nprobe_t run
            rank_f = torch.arange(p.nprobe, device=qs.device)[None, None, :]
            cids_f = torch.where(rank_f < nprobe_t, cids_f, cids_f[..., :1])
        cids_sorted = torch.sort(cids_f.reshape(B, -1), dim=1).values
        probed_centroids = 1 + (cids_sorted[:, 1:] != cids_sorted[:, :-1]).sum(
            dim=1, dtype=torch.int32
        )
    else:
        candidates = cand_out

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
    if ndocs_t is not None:
        # approx2's real entries are >= 0 and its pads NEG, so the first
        # nd_t of idx2 are what a static ndocs=ndocs_t program selects
        nd_t = min(ndocs_t, p.candidate_cap)
        rank2 = torch.arange(n2, device=qs.device)[None, :]
        cand2 = torch.where(rank2 < nd_t, cand2, -1)
    approx3 = interaction(s_cq, codes3, q_masks, None)
    approx3 = torch.where(cand2 >= 0, approx3, NEG)
    n3 = min(max(p.ndocs // 4, p.k), n2)
    _, idx3 = scoring.stable_topk(approx3, n3)  # (B, n3)
    final_pids = _take_rows(cand2, idx3)
    if ndocs_t is not None:
        # stage 3 keeps max(ndocs // 4, k) of its survivors, at the cap too
        n3_t = min(max(ndocs_t // 4, p.k), nd_t)
        rank3 = torch.arange(n3, device=qs.device)[None, :]
        final_pids = torch.where(rank3 < n3_t, final_pids, -1)

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
    if funnel:
        i32 = torch.int32
        extras.append(
            FunnelStats(
                probed_centroids=probed_centroids,
                stage1_candidates=(candidates >= 0).sum(dim=1, dtype=i32),
                alive_dropped=alive_dropped,
                stage2_kept_centroids=keep.sum(dim=1, dtype=i32),
                stage2_survivors=(cand2 >= 0).sum(dim=1, dtype=i32),
                stage3_survivors=(final_pids >= 0).sum(dim=1, dtype=i32),
                gathered_tokens=tok_valid.sum(dim=(1, 2), dtype=i32),
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
    funnel: bool = False,
    alive: torch.Tensor | None = None,  # (Nd,) bool; False = tombstoned
    nprobe_t=None,
    ndocs_t=None,
):
    """Batched (B >= 1) PLAID search on ``index``'s device.

    Returns ((B, k) scores, (B, k) int32 pids[, diagnostics dict of (B,)
    counters][, ``FunnelStats``]).  Stages 1-3
    (:func:`select_finalists_impl`), stage 4 (:func:`exact_stage4_impl`)
    and :func:`finalize_topk`, in the reference's order.  ``nprobe_t`` /
    ``ndocs_t`` (ints, or 0-d tensors read once) cap the static
    ``params.nprobe`` / ``params.ndocs``; the result equals a program built
    at those caps.
    """
    final_pids, codes4, tok_valid4, extras = select_finalists_impl(
        index, qs, q_masks, t_cs, params=params, diag=diag, funnel=funnel,
        alive=alive, keep_blocks=not params.fused,
        nprobe_t=None if nprobe_t is None else int(nprobe_t),
        ndocs_t=None if ndocs_t is None else int(ndocs_t),
    )
    exact = exact_stage4_impl(
        index, qs, q_masks, final_pids, codes4, tok_valid4, params=params
    )
    top_scores, top_pids = finalize_topk(exact, final_pids, params.k)
    return (top_scores, top_pids, *extras)
