"""IR quality metrics over gold pids (the paper's Tables 3-6 measures; the
counterpart of ``repro.core.metrics``, numpy only).  ``repro_torch.eval.
metrics`` holds the graded-qrels versions the quality harness uses."""
from __future__ import annotations

import numpy as np


def success_at_k(pids: np.ndarray, gold: np.ndarray, k: int) -> float:
    """Fraction of queries whose gold pid appears in the top-k."""
    pids = np.asarray(pids)[:, :k]
    return float(np.mean([g in set(row.tolist()) for row, g in zip(pids, gold)]))


def mrr_at_k(pids: np.ndarray, gold: np.ndarray, k: int) -> float:
    """Mean reciprocal rank, 0 beyond depth k (MS MARCO protocol)."""
    out = []
    for row, g in zip(np.asarray(pids)[:, :k], gold):
        hits = np.where(row == g)[0]
        out.append(1.0 / (hits[0] + 1) if len(hits) else 0.0)
    return float(np.mean(out))


def recall_at_k(pids: np.ndarray, relevant: list[set], k: int) -> float:
    """Fraction of each query's relevant set recovered in the top-k."""
    out = []
    for row, rel in zip(np.asarray(pids)[:, :k], relevant):
        if not rel:
            continue
        out.append(len(set(row.tolist()) & rel) / len(rel))
    return float(np.mean(out)) if out else 0.0


def agreement_at_k(pids: np.ndarray, ref_pids: np.ndarray, k: int) -> float:
    """Set overlap of two systems' top-k (the fidelity metric of Fig. 3)."""
    a = np.asarray(pids)[:, :k]
    b = np.asarray(ref_pids)[:, :k]
    return float(
        np.mean(
            [
                len(set(x.tolist()) & set(y.tolist())) / k
                for x, y in zip(a, b)
            ]
        )
    )
