"""Synthetic retrieval data (the counterpart of the retrieval part of
``repro.data.synthetic``), plain numpy, so that one seed gives the same
arrays in both packages.

Corpora are generated with CLUSTER STRUCTURE (topic centers + within-topic
noise, unit-normalized) so k-means centroids are meaningful and PLAID's
centroid interaction behaves as it does on real embeddings; queries are
derived from documents with noise so relevance is well-defined (the source
doc is the gold passage).  ``colbert_batches`` gives ColBERT training
triples, ``lm_batches`` the LM family's token streams and
``recsys_batches`` the recsys family's examples.
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


def colbert_batches(
    vocab: int,
    batch: int,
    *,
    q_len: int = 32,
    d_len: int = 64,
    nway: int = 4,
    seed: int = 0,
):
    """Training triples for the ColBERT loss: positives share tokens with
    the query (lexical overlap => learnable relevance signal)."""
    rng = np.random.default_rng(seed)
    while True:
        q = rng.integers(0, vocab, (batch, q_len)).astype(np.int32)
        d = rng.integers(0, vocab, (batch, nway, d_len)).astype(np.int32)
        # positive (slot 0) copies query tokens into a random span
        start = rng.integers(0, d_len - q_len, batch)
        for i in range(batch):
            d[i, 0, start[i] : start[i] + q_len] = q[i]
        yield {
            "q_tokens": q,
            "q_mask": np.ones((batch, q_len), np.float32),
            "d_tokens": d,
            "d_mask": np.ones((batch, nway, d_len), np.float32),
            "target_scores": np.concatenate(
                [
                    np.full((batch, 1), 4.0, np.float32),
                    np.zeros((batch, nway - 1), np.float32),
                ],
                axis=1,
            ),
        }


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0):
    """Infinite iterator of ``{"tokens", "targets"}`` (batch, seq) int32 with
    zipfian marginals: one draw of ``seq + 1`` tokens a row, the targets
    the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        t = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
        yield {"tokens": t[:, :-1], "targets": t[:, 1:]}


def recsys_batches(cfg, batch: int, *, seed: int = 0):
    """The recsys family's examples (the reference's ``recsys_batches``,
    draw for draw): ``labels`` (B,) click bits; for the CTR models
    (``cin`` / ``concat``) ``sparse_ids`` (B, n_sparse) per-field ids and
    ``dense_feats`` (B, n_dense); for the sequence models ``seq_ids`` (B,
    seq_len), ``target_id`` (B,) and ``dense_feats`` when ``n_dense``.
    BERT4Rec (``bidir-seq``) masks each position with probability
    ``mask_frac``: ``seq_ids`` holds the ``[MASK]`` row ``item_vocab`` there
    and ``labels`` (B, seq_len) the original id (-1 elsewhere)."""
    rng = np.random.default_rng(seed)
    while True:
        out = {"labels": rng.integers(0, 2, batch).astype(np.int32)}
        if cfg.interaction in ("cin", "concat"):
            out["sparse_ids"] = rng.integers(0, cfg.hash_size, (batch, cfg.n_sparse)).astype(np.int32)
            out["dense_feats"] = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        if cfg.seq_len:
            out["seq_ids"] = rng.integers(0, cfg.item_vocab, (batch, cfg.seq_len)).astype(np.int32)
            out["target_id"] = rng.integers(0, cfg.item_vocab, batch).astype(np.int32)
            if cfg.n_dense:
                out["dense_feats"] = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
        if cfg.interaction == "bidir-seq":
            mask = rng.random((batch, cfg.seq_len)) < cfg.mask_frac
            labels = np.where(mask, out["seq_ids"], -1).astype(np.int32)
            seq = out["seq_ids"].copy()
            seq[mask] = cfg.item_vocab  # the [MASK] row
            out["seq_ids"], out["labels"] = seq, labels
        yield out
