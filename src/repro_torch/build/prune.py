"""Build-time token pruning: drop low-signal document tokens (the
counterpart of ``repro.build.prune``).

Dropping the least informative ``prune_fraction`` of each document's
tokens shrinks the resident payload (codes + packed residuals) almost
exactly proportionally, at a measured quality cost.

Scoring is **doc-local and deterministic**: a token's importance depends
only on its own document's embeddings, never on chunk boundaries or
corpus order.  That keeps the streaming builder's two passes consistent
(both prune a chunk identically) and makes a pruned streaming build
array-identical to a pruned monolithic build.

Methods:

* ``"attention"`` (default) — ``|t . mean_dir|``, the token against its
  document's mean direction, plus ``1e-9 * norm`` as a tie-break, so
  near-zero (noise) tokens prune first.
* ``"norm"`` — plain L2 norm; small-norm tokens contribute least to any
  MaxSim because every query-token similarity they can win is small.

Scores are float64 and computed on the host by the reference's own numpy
expressions: a float64 sum taken on the card in another order could flip a
near tie, and the keep mask must be the reference's bit for bit.  The
ranking is one vectorized stable sort (document, then score, then
position) in place of the reference's loop over documents; it gives the
same mask.  Tensors in, tensors out: only the scoring reads a host copy,
and the kept rows stay on their device.

Pruning always keeps at least one token per document and preserves the
surviving tokens' original order (CSR layout invariants).
"""
from __future__ import annotations

import numpy as np
import torch

METHODS = ("attention", "norm")


def _host(emb) -> np.ndarray:
    if isinstance(emb, torch.Tensor):
        emb = emb.detach().cpu().numpy()
    return np.asarray(emb, np.float32)


def _doc_segments(doc_lens: np.ndarray) -> np.ndarray:
    """Start offset of each document in the packed token axis."""
    starts = np.zeros(len(doc_lens), np.int64)
    np.cumsum(doc_lens[:-1], out=starts[1:])
    return starts


def token_importance(emb, doc_lens, *, method: str = "attention") -> np.ndarray:
    """Per-token keep-priority scores, float64 (higher = keep longer).

    ``emb`` is the packed ``(Nt, d)`` float array (numpy or a tensor on any
    device), ``doc_lens`` the per-document token counts summing to ``Nt``.
    """
    emb = _host(emb)
    doc_lens = np.asarray(doc_lens, np.int64)
    if emb.ndim != 2:
        raise ValueError(f"emb must be (Nt, d), got {emb.shape}")
    if int(doc_lens.sum()) != emb.shape[0]:
        raise ValueError(f"doc_lens sum {int(doc_lens.sum())} != tokens {emb.shape[0]}")
    norms = np.linalg.norm(emb.astype(np.float64), axis=1)
    if method == "norm":
        return norms
    if method != "attention":
        raise ValueError(f"unknown importance method {method!r}; use {METHODS}")
    starts = _doc_segments(doc_lens)
    # per-doc mean direction, broadcast back to tokens via repeat
    sums = np.add.reduceat(emb.astype(np.float64), starts, axis=0)
    mean = sums / np.maximum(doc_lens, 1)[:, None]
    mean_dir = mean / np.maximum(np.linalg.norm(mean, axis=1, keepdims=True), 1e-30)
    tok_dir = np.repeat(mean_dir, doc_lens, axis=0)
    align = np.abs((emb * tok_dir).sum(axis=1))
    # tie-break by norm at tiny weight so identical alignments (e.g. exact
    # duplicate tokens) prune deterministically smallest-norm-first
    return align + 1e-9 * norms


def prune_mask(emb, doc_lens, *, fraction: float, method: str = "attention") -> np.ndarray:
    """Boolean host keep-mask over the packed token axis.

    Each document drops its ``min(floor(fraction * len), len - 1)`` lowest
    importance tokens (ties broken by position, stable: earlier tokens
    survive), so every document keeps >= 1 token and surviving tokens keep
    their original order.
    """
    doc_lens = np.asarray(doc_lens, np.int64)
    if not 0.0 <= fraction < 1.0:
        raise ValueError(f"prune fraction must be in [0, 1), got {fraction}")
    n = int(doc_lens.sum())
    if fraction == 0.0:
        return np.ones(n, bool)
    scores = token_importance(emb, doc_lens, method=method)
    n_drop = np.minimum((fraction * doc_lens).astype(np.int64), doc_lens - 1)
    doc = np.repeat(np.arange(len(doc_lens)), doc_lens)
    # stable: within a document, equal scores keep position order, as the
    # reference's per-document argsort(kind="stable") does
    order = np.lexsort((scores, doc))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - _doc_segments(doc_lens)[doc[order]]
    return rank >= n_drop[doc]


def prune_chunk(emb, doc_lens, *, fraction: float, method: str = "attention"):
    """Prune one packed chunk -> ``(emb_kept, doc_lens_kept)``.

    Doc-local and order-preserving, so applying it per streaming chunk
    (chunks cut on document boundaries) equals applying it to the whole
    corpus at once.  ``fraction == 0`` returns the inputs untouched.
    ``emb_kept`` is a tensor on ``emb``'s device when ``emb`` is a tensor;
    ``doc_lens_kept`` is host int32.
    """
    if fraction == 0.0:
        return emb, doc_lens
    doc_lens_np = np.asarray(doc_lens, np.int64)
    keep = prune_mask(emb, doc_lens_np, fraction=fraction, method=method)
    offsets = np.zeros(len(doc_lens_np) + 1, np.int64)
    np.cumsum(doc_lens_np, out=offsets[1:])
    kept_cum = np.concatenate([[0], np.cumsum(keep.astype(np.int64))])
    kept_per_doc = (kept_cum[offsets[1:]] - kept_cum[offsets[:-1]]).astype(np.int32)
    if isinstance(emb, torch.Tensor):
        return emb[torch.from_numpy(keep).to(emb.device)], kept_per_doc
    return np.asarray(emb, np.float32)[keep], kept_per_doc
