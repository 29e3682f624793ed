"""Pluggable relevance-judgment (qrels) sources for the quality harness
(the counterpart of ``repro.eval.qrels``; the same seed gives the same
arrays and judgments in both packages).

Two producers, one consumer shape: a :class:`QuerySet` bundles the query
embedding batch with per-query ``{pid: gain}`` judgments, aligned by
position, which is exactly what ``repro_torch.eval.metrics`` consumes.

1. :func:`synthetic_query_set` — deterministic judgments derived from the
   synthetic corpus generator (``repro_torch.data.synthetic``): each query is a
   noisy subset of one document's tokens, so the source doc is gold
   (gain 2) and every other doc of the same TOPIC is partially relevant
   (gain 1).  Graded gains make nDCG non-trivial and give approximations
   (token pruning, aggressive caps) measurable headroom to lose — an
   all-or-nothing gold label saturates too easily at small corpus scale.
2. :func:`load_trec_qrels` / :func:`trec_query_set` — standard TREC
   4-column (``qid iter pid rel``) and MS MARCO 2/3-column qrels files,
   for plugging real collections into the same sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QuerySet:
    """A query batch + positionally-aligned relevance judgments."""

    queries: np.ndarray  # (Q, nq, dim) f32 query token embeddings
    qrels: list  # list of {pid: gain > 0}, len Q
    name: str = "queryset"

    def __post_init__(self):
        if len(self.qrels) != self.queries.shape[0]:
            raise ValueError(
                f"{len(self.qrels)} qrels for {self.queries.shape[0]} queries"
            )

    @property
    def n_queries(self) -> int:
        return self.queries.shape[0]


def synthetic_query_set(
    docs,
    doc_topics,
    n_queries: int,
    *,
    q_len: int = 8,
    noise: float = 0.12,
    seed: int = 1,
    gold_gain: float = 2.0,
    topic_gain: float = 1.0,
) -> QuerySet:
    """Deterministic synthetic-labeled qrels from the corpus generator.

    ``docs``/``doc_topics`` come straight from
    ``repro_torch.data.synthetic.embedding_corpus``; queries are drawn by
    ``queries_from_docs`` with the same ``seed`` discipline, so the whole
    query set is a pure function of ``(corpus seed, n_queries, seed)`` —
    CI runs on two machines produce identical judgments.

    Judgments: the source document gets ``gold_gain``; every OTHER doc
    sharing its topic gets ``topic_gain`` (topics are the cluster
    structure the corpus is generated with, so same-topic docs genuinely
    score higher under MaxSim than off-topic ones).
    """
    from repro_torch.data import synthetic as syn

    qs, gold = syn.queries_from_docs(
        docs, n_queries, q_len=q_len, noise=noise, seed=seed
    )
    doc_topics = np.asarray(doc_topics)
    by_topic = {
        int(t): np.where(doc_topics == t)[0] for t in np.unique(doc_topics)
    }
    qrels = []
    for g in gold:
        g = int(g)
        rel = {int(pid): float(topic_gain) for pid in by_topic[int(doc_topics[g])]}
        rel[g] = float(gold_gain)
        qrels.append(rel)
    return QuerySet(np.asarray(qs, np.float32), qrels, name="synthetic")


# --------------------------------------------------------------------------
# TREC / MS MARCO qrels files
# --------------------------------------------------------------------------
def load_trec_qrels(path: str) -> dict[str, dict[int, float]]:
    """Parse a qrels file -> ``{qid: {pid: gain}}`` (zero/negative gains
    dropped — they are explicit NON-relevance judgments).

    Accepted line layouts (whitespace- or tab-separated, ``#`` comments
    and blank lines skipped):

    * ``qid iter pid rel``  — standard TREC qrels (iter ignored);
    * ``qid pid rel``       — 3-column variant;
    * ``qid pid``           — MS MARCO train/dev qrels (implicit rel 1).
    """
    out: dict[str, dict[int, float]] = {}
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                if len(parts) == 4:
                    qid, _, pid, rel = parts
                elif len(parts) == 3:
                    qid, pid, rel = parts
                elif len(parts) == 2:
                    (qid, pid), rel = parts, "1"
                else:
                    raise ValueError(f"{len(parts)} columns")
                pid_i, rel_f = int(pid), float(rel)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{ln}: unparseable qrels line {raw!r} ({e}); "
                    "expected 'qid [iter] pid [rel]'"
                ) from e
            if rel_f > 0:
                out.setdefault(qid, {})[pid_i] = rel_f
    return out


def trec_query_set(
    queries: np.ndarray,
    qids: list[str],
    qrels_by_qid: dict[str, dict[int, float]],
    *,
    name: str = "trec",
) -> QuerySet:
    """Align encoded queries with loaded TREC/MS MARCO judgments.

    ``queries[i]`` must be the encoding of ``qids[i]``; qids absent from
    the qrels map get an empty judgment dict (the metrics layer then
    excludes them from means, matching trec_eval).
    """
    if len(qids) != queries.shape[0]:
        raise ValueError(f"{len(qids)} qids for {queries.shape[0]} queries")
    qrels = [dict(qrels_by_qid.get(q, {})) for q in qids]
    return QuerySet(np.asarray(queries, np.float32), qrels, name=name)
