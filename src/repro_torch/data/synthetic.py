"""Synthetic retrieval data (the counterpart of the retrieval part of
``repro.data.synthetic``), plain numpy, so that one seed gives the same
arrays in both packages.

Corpora are generated with CLUSTER STRUCTURE (topic centers + within-topic
noise, unit-normalized) so k-means centroids are meaningful and PLAID's
centroid interaction behaves as it does on real embeddings; queries are
derived from documents with noise so relevance is well-defined (the source
doc is the gold passage).  The LM, ColBERT-training and recsys generators
are not ported yet.
"""
from __future__ import annotations

import numpy as np


def embedding_corpus(
    n_docs: int,
    dim: int = 128,
    *,
    min_len: int = 8,
    max_len: int = 48,
    n_topics: int = 32,
    n_concepts: int | None = None,
    noise: float = 0.35,
    seed: int = 0,
):
    """Concept-vocabulary corpus matching late-interaction geometry.

    Tokens cluster around unit "concept" vectors (the structure ColBERTv2's
    k-means centroids capture); a document is a bag of concepts drawn from
    its topic's concept pool; ``noise`` is the RELATIVE perturbation norm
    (token = normalize(concept + noise * u), ||u|| ~ 1).  Query tokens (below)
    then score ~1/sqrt(1+noise^2) against their own concept and ~0 against
    the rest — the skewed centroid-score distribution of the paper's Fig. 4,
    which makes the t_cs pruning thresholds meaningful.

    Returns (list of (len_i, dim) unit-norm arrays, doc topic ids).
    """
    rng = np.random.default_rng(seed)
    if n_concepts is None:
        n_concepts = int(min(4096, max(64, n_docs)))
    concepts = rng.standard_normal((n_concepts, dim)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=-1, keepdims=True)
    concept_topic = np.arange(n_concepts) % n_topics
    pools = [np.where(concept_topic == t)[0] for t in range(n_topics)]
    doc_topics = rng.integers(0, n_topics, n_docs)
    nscale = noise / np.sqrt(dim)
    docs = []
    for t in doc_topics:
        ln = int(rng.integers(min_len, max_len + 1))
        cids = rng.choice(pools[t], ln)
        e = concepts[cids] + nscale * rng.standard_normal((ln, dim)).astype(
            np.float32
        )
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
        docs.append(e.astype(np.float32))
    return docs, doc_topics


def queries_from_docs(
    docs: list[np.ndarray],
    n_queries: int,
    *,
    q_len: int = 8,
    noise: float = 0.12,
    seed: int = 1,
):
    """Queries = noisy subsets of doc tokens; gold pid = source doc."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, len(docs), n_queries)
    qs, golds = [], []
    dim = docs[0].shape[1]
    nscale = noise / np.sqrt(dim)  # relative perturbation (see above)
    for pid in pids:
        d = docs[pid]
        idx = rng.integers(0, len(d), q_len)
        q = d[idx] + nscale * rng.standard_normal((q_len, dim)).astype(
            np.float32
        )
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        qs.append(q.astype(np.float32))
        golds.append(int(pid))
    return np.stack(qs), np.asarray(golds)
