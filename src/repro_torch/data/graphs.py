"""Graph generation and neighbor sampling for the GNN cells (the
counterpart of ``repro.data.graphs``), plain numpy, so that one seed gives
the same arrays in both packages.

``neighbor_sample`` is a fanout sampler (GraphSAGE-style): hop h picks up
to ``fanout[h]`` neighbors of each frontier node from a CSR adjacency, then
emits a padded block of fixed shape (its caps follow from the seeds and
the fanout) with node and edge masks.  ``molecule_batch`` concatenates
small molecules with a graph id per atom (SchNet's regime).  Host-side
numpy: this is the data pipeline, not model code.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    edge_src: np.ndarray  # (E,)
    edge_dst: np.ndarray  # (E,)
    feat: np.ndarray | None  # (N, d_feat)
    labels: np.ndarray | None  # (N,)
    n_nodes: int

    # CSR adjacency (built lazily for sampling)
    _indptr: np.ndarray | None = None
    _indices: np.ndarray | None = None

    def csr(self):
        if self._indptr is None:
            order = np.argsort(self.edge_src, kind="stable")
            dst = self.edge_dst[order]
            counts = np.bincount(self.edge_src, minlength=self.n_nodes)
            indptr = np.zeros(self.n_nodes + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._indptr, self._indices = indptr, dst
        return self._indptr, self._indices


def random_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int = 0,
    n_classes: int = 0,
    *,
    seed: int = 0,
    power_law: bool = True,
):
    """Degree-skewed random graph (preferential-attachment-ish degrees)."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / np.arange(1, n_nodes + 1)
        w /= w.sum()
        src = rng.choice(n_nodes, n_edges, p=w).astype(np.int64)
    else:
        src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    feat = (
        rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
        if d_feat
        else None
    )
    labels = (
        rng.integers(0, n_classes, n_nodes).astype(np.int32)
        if n_classes
        else None
    )
    return Graph(src, dst, feat, labels, n_nodes)


def neighbor_sample(
    g: Graph,
    seeds: np.ndarray,
    fanout: tuple[int, ...],
    *,
    seed: int = 0,
):
    """Fanout-sample a block around ``seeds``.

    Returns dict with PADDED static shapes derived from (len(seeds), fanout):
      nodes      (Np,)  global node ids (first len(seeds) are the seeds)
      edge_src / edge_dst (Ep,) LOCAL indices into ``nodes``
      edge_mask  (Ep,)  1.0 for real edges
      node_mask  (Np,)
    """
    rng = np.random.default_rng(seed)
    indptr, indices = g.csr()
    n_seeds = len(seeds)
    cap_nodes = n_seeds
    cap_edges = 0
    f_cum = n_seeds
    for f in fanout:
        cap_edges += f_cum * f
        f_cum *= f
        cap_nodes += f_cum

    node_ids = list(seeds)
    local = {int(n): i for i, n in enumerate(seeds)}
    e_src, e_dst = [], []
    frontier = list(seeds)
    for f in fanout:
        nxt = []
        for u in frontier:
            lo, hi = indptr[u], indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = indices[lo + rng.choice(deg, take, replace=False)]
            for v in picks:
                v = int(v)
                if v not in local:
                    local[v] = len(node_ids)
                    node_ids.append(v)
                    nxt.append(v)
                # message flows v (src) -> u (dst)
                e_src.append(local[v])
                e_dst.append(local[u])
        frontier = nxt
        if not frontier:
            break

    Np, Ep = cap_nodes, cap_edges
    nodes = np.zeros(Np, np.int64)
    nodes[: len(node_ids)] = node_ids
    node_mask = np.zeros(Np, np.float32)
    node_mask[: len(node_ids)] = 1.0
    es = np.zeros(Ep, np.int32)
    ed = np.zeros(Ep, np.int32)
    emask = np.zeros(Ep, np.float32)
    es[: len(e_src)] = e_src
    ed[: len(e_dst)] = e_dst
    emask[: len(e_src)] = 1.0
    return {
        "nodes": nodes,
        "edge_src": es,
        "edge_dst": ed,
        "edge_mask": emask,
        "node_mask": node_mask,
        "n_real_nodes": len(node_ids),
        "n_real_edges": len(e_src),
    }


def molecule_batch(
    batch: int,
    n_atoms: int,
    n_edges: int,
    *,
    seed: int = 0,
):
    """Batched small molecules, concatenated with graph_id (SchNet regime)."""
    rng = np.random.default_rng(seed)
    N = batch * n_atoms
    E = batch * n_edges
    z = rng.integers(1, 20, N).astype(np.int32)
    pos = (rng.standard_normal((N, 3)) * 2.0).astype(np.float32)
    # edges within each molecule only
    src = rng.integers(0, n_atoms, E).astype(np.int32)
    dst = rng.integers(0, n_atoms, E).astype(np.int32)
    offs = np.repeat(np.arange(batch, dtype=np.int32) * n_atoms, n_edges)
    graph_id = np.repeat(np.arange(batch, dtype=np.int32), n_atoms)
    energy = rng.standard_normal(batch).astype(np.float32)
    return {
        "z": z,
        "pos": pos,
        "edge_src": src + offs,
        "edge_dst": dst + offs,
        "graph_id": graph_id,
        "energy": energy,
        "edge_mask": np.ones(E, np.float32),
        "node_mask": np.ones(N, np.float32),
    }
