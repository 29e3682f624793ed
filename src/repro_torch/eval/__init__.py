"""``repro_torch.eval`` — the retrieval-quality harness (the counterpart of
``repro.eval``, with the same exports).

Every knob that trades work for quality (``t_cs`` pruning, ``nprobe`` /
``ndocs`` caps, int8/bf16 stage 1, the fused tail) is measured here
against IR metrics, not only against rank identity to an oracle.

* :mod:`repro_torch.eval.metrics` — vectorized recall@k / MRR@k /
  success@k / nDCG@k over ranked pid arrays;
* :mod:`repro_torch.eval.qrels`   — relevance-judgment sources (the
  deterministic synthetic-labeled generator, MS MARCO / TREC qrels files);
* :mod:`repro_torch.eval.sweep`   — t_cs × nprobe × ndocs grids through the
  pow2 cap buckets of ``exec.bucketed``, per-point (work, latency,
  quality) records, the Pareto frontier, and lossless-caps certification
  of every backend.
"""
from repro_torch.eval.metrics import (
    DEFAULT_KS,
    compute_metrics,
    mrr_at_k,
    ndcg_at_k,
    recall_at_k,
    relevance_gains,
    success_at_k,
)
from repro_torch.eval.qrels import (
    QuerySet,
    load_trec_qrels,
    synthetic_query_set,
    trec_query_set,
)
from repro_torch.eval.sweep import (
    GridPoint,
    SweepRecord,
    certify_backends,
    default_grid,
    pareto_frontier,
    sweep_quality,
)

__all__ = [
    "DEFAULT_KS",
    "GridPoint",
    "QuerySet",
    "SweepRecord",
    "certify_backends",
    "compute_metrics",
    "default_grid",
    "load_trec_qrels",
    "mrr_at_k",
    "ndcg_at_k",
    "pareto_frontier",
    "recall_at_k",
    "relevance_gains",
    "success_at_k",
    "sweep_quality",
    "synthetic_query_set",
    "trec_query_set",
]
