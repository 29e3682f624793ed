"""PLAID as an ANN index over a recsys item catalog (the counterpart of
``repro.core.item_retrieval``).

BERT4Rec's ``retrieval_cand`` cell scores one user state against a 1M-item
catalog.  Treating every item embedding as a one-token document, the PLAID
pipeline becomes a centroid-pruned ANN index: stage 1 probes the centroid
space, centroid interaction ranks items by their centroid's score, and
stage 4 re-ranks the survivors by exact dot products with the decompressed
embeddings.  With ``impl="cuda"`` stages 2 and 3 run on K1
(``kernels/maxsim.py``) and stage 4 on K2 (``kernels/decompress.py``), at
nq = 1 and one token a document; they equal ``impl="ref"`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import index as index_mod
from repro_torch.core import plaid


def _unit_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows divided by max(norm, 1e-6), the norms (n, 1))."""
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norms, min=1e-6), norms


def build_item_index(
    item_table,  # (V, d) numpy array or tensor
    *,
    nbits: int = 2,
    num_centroids: int | None = None,
    kmeans_iters: int = 4,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> index_mod.PlaidIndex:
    """Index a (V, d) item-embedding table as V one-token documents (the
    rows normalized to unit length) with ``core.index.build_index`` on
    ``device``."""
    dev = resolve_device(device)
    emb = item_table if isinstance(item_table, torch.Tensor) else torch.from_numpy(
        np.asarray(item_table, np.float32))
    emb, _ = _unit_rows(emb.to(dev, torch.float32))
    return index_mod.build_index(
        emb,
        doc_lens=torch.ones(emb.shape[0], dtype=torch.int32, device=dev),
        nbits=nbits,
        num_centroids=num_centroids,
        kmeans_iters=kmeans_iters,
        seed=seed,
        device=dev,
    )


def item_search_params(k: int, nprobe: int, candidate_cap: int,
                       impl: str = "cuda") -> plaid.SearchParams:
    """The reference's search settings for one-token documents.  A
    one-token item's stage-2/3 score is its centroid's score, so every item
    of a cluster ties and a staged cut would keep arbitrary members:
    ``t_cs = -1e9`` keeps every centroid and ``ndocs = 4 * candidate_cap``
    passes every candidate to stage 4, which re-ranks them exactly (IVF
    probing plus a compressed exact re-rank), unfused."""
    return plaid.SearchParams(k=k, nprobe=nprobe, t_cs=-1e9, ndocs=4 * candidate_cap,
                              candidate_cap=candidate_cap, impl=impl)


def retrieve_items(
    index: index_mod.PlaidIndex,
    user_state,  # (d,) or (B, d)
    *,
    k: int = 100,
    nprobe: int = 8,
    candidate_cap: int = 4096,
    impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k items by dot product through the PLAID pipeline -> (scores (B,
    k), pids (B, k)).  Each user state is a one-token query, normalized for
    the search; the scores are rescaled by the users' norms."""
    q = torch.as_tensor(user_state, dtype=torch.float32).to(index.device)
    q = q.reshape(-1, q.shape[-1])  # (B, d)
    qn, norms = _unit_rows(q)
    engine = plaid.PlaidEngine(index, item_search_params(k, nprobe, candidate_cap, impl))
    scores, pids = engine.search_batch(qn[:, None, :])  # (B, 1, d) queries
    return scores * norms, pids
