"""Vanilla ColBERTv2 retrieval — the baseline PLAID is measured against (the
counterpart of ``repro.core.vanilla``).

Pipeline (Santhanam et al. 2021, retained faithfully including its costs):
  1. top-``nprobe`` centroids per query token -> *embedding ids* from the
     centroid->eid inverted file (embedding-level, not passage-level).
  2. decompress those candidate embeddings, score them against the query
     tokens, and keep the ``ndocs_cap * 4`` best-scoring embeddings.
  3. map the survivors to passages; gather **all** tokens of every
     candidate passage into a padded (nd, L, dim) tensor, decompress all
     residuals, and run exact padded MaxSim.

``impl="cuda"`` runs both decompressions (steps 2 and 3) through K4
(``kernels.ops.decompress_residuals``); the centroid gather and the add stay
plain torch, as they are plain ``jnp`` in the reference.  ``impl="ref"``
decompresses with K4's plain version.  A batch is a loop over its queries,
as the reference vmaps the one-query search.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import ieee_f32_matmul
from repro_torch.constants import NEG
from repro_torch.core import scoring
from repro_torch.core.index import PlaidIndex
from repro_torch.core.plaid import IMPLS, _as_queries
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class VanillaParams:
    k: int = 10
    nprobe: int = 2
    ncandidates: int = 2**13  # candidate *embeddings* cap (paper: 2^13..2^16)
    ndocs_cap: int = 4096  # bound on candidate passages
    impl: str = "ref"  # "ref" (plain torch) | "cuda" (K4 decompressions)

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")


def _vanilla_search(
    index: PlaidIndex,
    q: torch.Tensor,  # (nq, dim)
    q_mask: torch.Tensor,  # (nq,)
    *,
    k: int,
    nprobe: int,
    ncandidates: int,
    ndocs_cap: int,
    impl: str = "ref",
):
    """One query -> (scores (kk,), pids (kk,)); the reference's ops in order."""
    if impl == "cuda":
        from repro_torch.kernels import ops as K

        decompress_residuals = K.decompress_residuals
    else:
        decompress_residuals = kref.decompress_residuals_ref
    cents = index.centroids

    def decompress(codes, packed):
        safe = torch.where(codes >= 0, codes, 0).long()
        return cents[safe] + decompress_residuals(packed, index.weights, nbits=index.nbits)

    # ---- 1. candidate embedding ids from the embedding-level IVF
    s_cq = scoring.centroid_scores(q, cents)  # (K, nq)
    _, cids = scoring.stable_topk(s_cq.T, nprobe)  # (nq, nprobe)
    cids = cids.reshape(-1)
    starts = index.eivf_offsets[cids].long()
    lens = index.eivf_lens[cids]
    pos = torch.arange(index.eivf_list_cap, device=q.device)
    valid = pos[None, :] < lens[:, None]
    idx = torch.where(valid, starts[:, None] + pos[None, :], 0)
    # pads are ``num_tokens`` (sorting past every real eid) through the
    # unique truncation, so they never evict the highest eid at a full cap
    nt = index.num_tokens
    eids = torch.where(valid, index.eivf_eids[idx], nt).reshape(-1)
    eids = scoring.unique_sized(eids, ncandidates, nt)
    eids = torch.where(eids < nt, eids, -1)

    # ---- 2. decompress candidate embeddings & rank them (the costly prune)
    safe = torch.where(eids >= 0, eids, 0).long()
    emb = decompress(index.codes[safe], index.residuals[safe])  # (ncandidates, dim)
    with ieee_f32_matmul():
        e_scores = emb @ q.T  # (ncandidates, nq)
    e_best = torch.where(eids >= 0, e_scores.amax(dim=-1), NEG)
    n_keep = min(ncandidates, ndocs_cap * 4)
    _, keep_idx = scoring.stable_topk(e_best, n_keep)
    kept_eids = eids[keep_idx]

    # ---- 3. passage set + full padded decompression + exact MaxSim
    npass = index.num_passages
    kept_safe = torch.where(kept_eids >= 0, kept_eids, 0).long()
    pids = torch.where(kept_eids >= 0, index.tok_pid[kept_safe], npass)
    pids = scoring.unique_sized(pids, ndocs_cap, npass)
    pids = torch.where(pids < npass, pids, -1)
    codes_blk, tok_valid = scoring.gather_doc_tokens(
        index.codes, index.doc_offsets, index.doc_lens, pids, index.doc_maxlen, fill=-1,
    )
    res_blk, _ = scoring.gather_doc_tokens(
        index.residuals, index.doc_offsets, index.doc_lens, pids, index.doc_maxlen, fill=0,
    )
    d_emb = decompress(codes_blk, res_blk)  # (ndocs_cap, L, dim): the padded 3-D tensor PLAID avoids
    exact = scoring.maxsim(q, d_emb, q_mask=q_mask, d_mask=tok_valid)
    exact = torch.where(pids >= 0, exact, NEG)
    kk = min(k, ndocs_cap)
    top_scores, idxk = scoring.stable_topk(exact, kk)
    return top_scores, pids[idxk]


class VanillaEngine:
    """Engine handle over one in-memory index (on the index's device); the
    public API is ``repro_torch.retrieval`` (backend ``"vanilla"``).
    Returns raw ``(scores, pids)`` tuples."""

    def __init__(self, index: PlaidIndex, params: VanillaParams | None = None):
        self.index = index
        self.params = params or VanillaParams()

    def _kwargs(self):
        """The caps clamped to the corpus, as the reference clamps them."""
        p = self.params
        nd = min(p.ndocs_cap, max(self.index.num_passages, 2))
        nc = min(p.ncandidates, max(self.index.num_tokens, 2))
        return dict(k=p.k, nprobe=p.nprobe, ncandidates=nc, ndocs_cap=nd, impl=p.impl)

    def search(self, q, q_mask=None):
        """q: (nq, dim) one query matrix -> (scores (k,), pids (k,))."""
        dev = self.index.device
        q = _as_queries(q, dev, 2)
        if q_mask is None:
            q_mask = torch.ones(q.shape[0], dtype=torch.float32, device=dev)
        else:
            q_mask = _as_queries(q_mask, dev, 1)
        return _vanilla_search(self.index, q, q_mask, **self._kwargs())

    def search_batch(self, qs, q_masks=None):
        """qs: (B, nq, dim) -> (scores (B, k), pids (B, k)), one query at a
        time."""
        dev = self.index.device
        qs = _as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = _as_queries(q_masks, dev, 2)
        kw = self._kwargs()
        outs = [_vanilla_search(self.index, q, m, **kw) for q, m in zip(qs, q_masks)]
        return torch.stack([s for s, _ in outs]), torch.stack([p for _, p in outs])
