"""Vectorized retrieval-quality metrics over ranked pid arrays (the
counterpart of ``repro.eval.metrics``, with the same results on every
input).

All metrics consume a ``(Q, depth)`` int array of ranked passage ids
(rank 0 first; ``-1`` pads unreachable slots and never matches a judged
pid) plus per-query relevance judgments, and reduce to one float.  A
tensor (on any device) is moved to the host first; everything after that
is numpy, as in the reference.  The qrels lookup builds a ``(Q, depth)``
gain matrix once; every metric/k is array arithmetic over
:func:`relevance_gains`.

Conventions (matching ``trec_eval`` / ``pytrec_eval``):

* a pid is RELEVANT iff its judged gain is ``> 0`` (graded judgments keep
  their gain for nDCG; the binary metrics threshold at 0);
* recall@k divides by ``|judged relevant|`` (not by ``k``);
* nDCG@k uses the linear-gain DCG ``sum(gain_i / log2(i + 2))``
  normalized by the ideal DCG over ALL judged relevant docs (truncated to
  k), so an unjudged-free perfect ranking scores exactly 1.0;
* queries with no judged relevant pid are EXCLUDED from the mean (the
  trec_eval convention).

Duplicated pids in a ranklist each count on their own rank, so a ranklist
that repeats a relevant pid over-counts: ``recall_at_k([[0] * 7] * 3,
[{}, {}, {0: 1.0}], k=2) == 2.0``.  The reference does the same, and the
port keeps it so that both give one answer on every input; the engines
never emit duplicates (the final top-k is over unique candidates).
"""
from __future__ import annotations

import numpy as np
import torch

#: rank cutoffs reported by default everywhere (sweep records, BENCH JSON)
DEFAULT_KS = (1, 5, 10, 100)

Qrels = "list[dict[int, float]]"  # per-query {pid: gain > 0}


def relevance_gains(ranked_pids, qrels) -> tuple[np.ndarray, np.ndarray]:
    """(Q, depth) ranked pids + per-query qrels -> (gains, n_rel).

    ``gains[q, r]`` is the judged gain of the pid at rank ``r`` (0.0 when
    unjudged / padded); ``n_rel[q]`` counts the judged relevant pids of
    query ``q`` (recall's denominator).  This is the one qrels lookup —
    every metric below is pure array math over its output.
    """
    if isinstance(ranked_pids, torch.Tensor):
        ranked_pids = ranked_pids.cpu().numpy()
    ranked = np.asarray(ranked_pids)
    if ranked.ndim != 2:
        raise ValueError(f"ranked_pids must be (Q, depth), got {ranked.shape}")
    if len(qrels) != ranked.shape[0]:
        raise ValueError(
            f"{len(qrels)} qrels entries for {ranked.shape[0]} queries"
        )
    gains = np.zeros(ranked.shape, np.float64)
    n_rel = np.zeros(ranked.shape[0], np.int64)
    for qi, rel in enumerate(qrels):
        n_rel[qi] = sum(1 for g in rel.values() if g > 0)
        row = ranked[qi]
        for r in range(row.shape[0]):
            pid = int(row[r])
            if pid >= 0:
                g = rel.get(pid, 0.0)
                if g > 0:
                    gains[qi, r] = g
    return gains, n_rel


def _judged(n_rel: np.ndarray) -> np.ndarray:
    return n_rel > 0


def _mean_over_judged(values: np.ndarray, n_rel: np.ndarray) -> float:
    m = _judged(n_rel)
    if not m.any():
        return float("nan")
    return float(values[m].mean())


def recall_at_k(ranked_pids, qrels, k: int) -> float:
    """Mean over judged queries of |relevant in top k| / |relevant|."""
    gains, n_rel = relevance_gains(ranked_pids, qrels)
    hits = (gains[:, :k] > 0).sum(axis=1)
    frac = hits / np.maximum(n_rel, 1)
    return _mean_over_judged(frac, n_rel)


def success_at_k(ranked_pids, qrels, k: int) -> float:
    """Fraction of judged queries with >= 1 relevant pid in the top k."""
    gains, n_rel = relevance_gains(ranked_pids, qrels)
    hit = (gains[:, :k] > 0).any(axis=1).astype(np.float64)
    return _mean_over_judged(hit, n_rel)


def mrr_at_k(ranked_pids, qrels, k: int) -> float:
    """Mean reciprocal rank of the FIRST relevant pid, 0 past rank k."""
    gains, n_rel = relevance_gains(ranked_pids, qrels)
    rel = gains[:, :k] > 0
    hit = rel.any(axis=1)
    first = rel.argmax(axis=1)  # 0 when no hit; masked by ``hit`` below
    rr = np.where(hit, 1.0 / (first + 1.0), 0.0)
    return _mean_over_judged(rr, n_rel)


def ndcg_at_k(ranked_pids, qrels, k: int) -> float:
    """Linear-gain nDCG@k: DCG over the ranklist / ideal DCG over qrels."""
    gains, n_rel = relevance_gains(ranked_pids, qrels)
    disc = 1.0 / np.log2(np.arange(k) + 2.0)
    g = gains[:, :k]
    if g.shape[1] < k:  # ranklist shallower than k: missing ranks gain 0
        g = np.pad(g, ((0, 0), (0, k - g.shape[1])))
    dcg = (g * disc).sum(axis=1)
    idcg = np.zeros(gains.shape[0], np.float64)
    for qi, rel in enumerate(qrels):
        ideal = sorted((v for v in rel.values() if v > 0), reverse=True)[:k]
        idcg[qi] = sum(v * disc[i] for i, v in enumerate(ideal))
    ndcg = dcg / np.maximum(idcg, 1e-30)
    return _mean_over_judged(ndcg, n_rel)


def compute_metrics(ranked_pids, qrels, ks=DEFAULT_KS) -> dict[str, float]:
    """Every metric at every cutoff -> ``{"recall@10": ..., ...}``.

    Cutoffs deeper than the ranklist are still reported (metrics saturate
    at the list depth — recall@100 over a depth-10 list equals recall@10),
    matching trec_eval's behavior on shallow runs.
    """
    out: dict[str, float] = {}
    for k in ks:
        out[f"recall@{k}"] = recall_at_k(ranked_pids, qrels, k)
        out[f"success@{k}"] = success_at_k(ranked_pids, qrels, k)
        out[f"mrr@{k}"] = mrr_at_k(ranked_pids, qrels, k)
        out[f"ndcg@{k}"] = ndcg_at_k(ranked_pids, qrels, k)
    return out
