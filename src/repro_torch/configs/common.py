"""Shared config machinery of the port (the counterpart of
``repro/configs/common.py``): the shape cell and the four families' cells
(LM, recsys, GNN and the paper's retrieval family).

Every arch module exposes ``FAMILY``, ``full_config()`` (the published
architecture), ``reduced_config()`` (a tiny config of the same family for
CPU tests) and ``CELLS`` (its input shapes: the full parameters, the
reduced ones and a skip reason).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | full_graph |
    #            minibatch | molecule | encode | search
    full: dict
    reduced: dict
    skip: str | None = None


def lm_cells(long_skip: str | None) -> list[ShapeCell]:
    """The LM family's four cells, the reference's values."""
    return [
        ShapeCell(
            "train_4k",
            "train",
            full=dict(seq_len=4096, global_batch=256, n_micro=8),
            reduced=dict(seq_len=32, global_batch=4, n_micro=2),
        ),
        ShapeCell(
            "prefill_32k",
            "prefill",
            full=dict(seq_len=32768, global_batch=32),
            reduced=dict(seq_len=64, global_batch=2),
        ),
        ShapeCell(
            "decode_32k",
            "decode",
            full=dict(seq_len=32768, global_batch=128),
            reduced=dict(seq_len=64, global_batch=4),
        ),
        ShapeCell(
            "long_500k",
            "decode",
            full=dict(seq_len=524288, global_batch=1),
            reduced=dict(seq_len=128, global_batch=1),
            skip=long_skip,
        ),
    ]


def recsys_cells() -> list[ShapeCell]:
    """The recsys family's four cells, the reference's values."""
    return [
        ShapeCell(
            "train_batch",
            "train",
            full=dict(batch=65536, n_micro=4),
            reduced=dict(batch=32, n_micro=2),
        ),
        ShapeCell(
            "serve_p99",
            "serve",
            full=dict(batch=512),
            reduced=dict(batch=16),
        ),
        ShapeCell(
            "serve_bulk",
            "serve",
            full=dict(batch=262144),
            reduced=dict(batch=64),
        ),
        ShapeCell(
            "retrieval_cand",
            "retrieval",
            full=dict(n_candidates=1_000_000, top_k=100),
            reduced=dict(n_candidates=512, top_k=10),
        ),
    ]


def gnn_cells() -> list[ShapeCell]:
    """SchNet's four cells, the reference's values: cora's full graph,
    reddit's sampled minibatch, ogbn-products' full graph and a batch of
    molecules."""
    return [
        ShapeCell(
            "full_graph_sm",
            "full_graph",
            full=dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
            reduced=dict(n_nodes=128, n_edges=512, d_feat=33, n_classes=7),
        ),
        ShapeCell(
            "minibatch_lg",
            "minibatch",
            full=dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                      fanout=(15, 10), d_feat=602, n_classes=41),
            reduced=dict(n_nodes=512, n_edges=4096, batch_nodes=16, fanout=(4, 3),
                         d_feat=33, n_classes=7),
        ),
        ShapeCell(
            "ogb_products",
            "full_graph",
            full=dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
            reduced=dict(n_nodes=256, n_edges=2048, d_feat=25, n_classes=11),
        ),
        ShapeCell(
            "molecule",
            "molecule",
            full=dict(n_nodes=30, n_edges=64, batch=128),
            reduced=dict(n_nodes=8, n_edges=16, batch=4),
        ),
    ]


def retrieval_cells() -> list[ShapeCell]:
    """The paper's own architecture: ColBERTv2 training, corpus encoding
    and PLAID serving, the reference's values."""
    return [
        ShapeCell(
            "train_triples",
            "train",
            full=dict(global_batch=256, q_len=32, d_len=180, nway=4, n_micro=8),
            reduced=dict(global_batch=4, q_len=8, d_len=16, nway=2, n_micro=2),
        ),
        ShapeCell(
            "encode_corpus",
            "encode",
            full=dict(batch=4096, d_len=180),
            reduced=dict(batch=8, d_len=16),
        ),
        ShapeCell(
            "search_9m",
            "search",
            # MS MARCO v1 scale: 8.8M passages over 512 shards
            full=dict(n_queries=32, q_len=32, docs_per_shard=17_408, avg_doclen=68,
                      n_centroids=65_536, k=100, candidate_cap=4096, ivf_list_cap=256,
                      doc_maxlen=128),
            reduced=dict(n_queries=2, q_len=8, docs_per_shard=128, avg_doclen=12,
                         n_centroids=64, k=10, candidate_cap=64, ivf_list_cap=32,
                         doc_maxlen=24),
        ),
        ShapeCell(
            "search_140m",
            "search",
            # MS MARCO v2 scale: 140M passages, 1-bit residuals (paper §5.1)
            full=dict(n_queries=32, q_len=32, docs_per_shard=273_438, avg_doclen=68,
                      n_centroids=262_144, k=100, candidate_cap=8192, ivf_list_cap=256,
                      doc_maxlen=128, nbits=1),
            reduced=dict(n_queries=2, q_len=8, docs_per_shard=256, avg_doclen=12,
                         n_centroids=128, k=10, candidate_cap=64, ivf_list_cap=32,
                         doc_maxlen=24, nbits=1),
        ),
    ]


#: the reason the full-attention LM archs skip ``long_500k``
FULL_ATTENTION_LONG_SKIP = (
    "pure full attention: 524k-token decode has no sub-quadratic "
    "mechanism in the published arch (DESIGN §Arch-applicability)"
)
