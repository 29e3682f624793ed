"""Lloyd k-means in PyTorch (the counterpart of ``repro.core.kmeans``): the
centroids of an index build.

ColBERTv2 sets the number of centroids proportional to sqrt(#embeddings)
(``16 * sqrt(n)`` rounded up to a power of two).  Training runs on a sample
of the token embeddings, with assignment in row chunks so the (n, K)
distance matrix never exists whole.  Every product is full float32
(``ieee_f32_matmul``: no TF32).  ``torch.Generator`` draws replace the
reference's ``jax.random`` keys, so the two packages train different
centroids from the same seed; tests compare trained builds by recall.

Training is deterministic on the card as on the host.  Assignment runs in
windows of exactly ``chunk`` rows (the last one zero-padded, as the
reference pads), so cuBLAS sees one shape whatever the caller's row count
and a row's distances do not depend on where its window starts.  Cluster
sums (:func:`cluster_sums`) add each cluster's rows serially in row order,
with no atomic adds.  So the monolithic ``build_index`` trains
bit-identical centroids on two runs, and so does the streaming build's
block-ordered k-means (``repro_torch.build.kmeans_mesh``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import ieee_f32_matmul


def num_centroids_for(n_tokens: int, cap: int = 2**18) -> int:
    """ColBERTv2 heuristic: next power of two >= 16*sqrt(n), capped."""
    k = 2 ** int(math.ceil(math.log2(max(16.0 * math.sqrt(max(n_tokens, 1)), 2.0))))
    return int(min(k, cap, max(2, n_tokens)))


def _assign_chunked(
    x: torch.Tensor, centroids: torch.Tensor, chunk: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """argmin_c ||x - c||^2 in row chunks -> (codes (n,) i32, min d2 (n,) f32).

    ``d2 = ||c||^2 - 2 x.c`` (``||x||^2`` is constant per row), one GEMM a
    window with ``||c||^2`` added in its epilogue (``-2 x.c`` is exact, so
    the sum rounds once, as the reference's does); ``argmin`` keeps the
    first index on ties, as ``jnp.argmin`` does.  Every window is ``chunk``
    rows: a short last one is zero-padded, so a row's distances are the
    same bits whichever window and offset it is assigned in (the streaming
    build's chunks against the monolithic build).
    """
    x, centroids = x.float(), centroids.float()
    n = x.shape[0]
    c_sq = (centroids * centroids).sum(dim=-1)
    codes = torch.empty(n, dtype=torch.int32, device=x.device)
    dists = torch.empty(n, dtype=torch.float32, device=x.device)
    for r0 in range(0, n, chunk):
        rows = x[r0 : r0 + chunk]
        m = rows.shape[0]
        if m < chunk:
            rows = torch.cat([rows, rows.new_zeros(chunk - m, x.shape[1])])
        with ieee_f32_matmul():
            d2 = torch.addmm(c_sq, rows, centroids.T, alpha=-2.0)
        best, idx = torch.min(d2[:m], dim=-1)
        codes[r0 : r0 + m] = idx.to(torch.int32)
        dists[r0 : r0 + m] = best
        del d2  # one window's distances alive at a time, not two
    return codes, dists


def cluster_sums(
    x: torch.Tensor, codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster ``(sums (k, d) f32, counts (k,) f32)`` of the rows of
    ``x`` under ``codes``, each cluster's rows added in row order.

    A stable sort by code puts each cluster's rows together in row order,
    and ``segment_reduce`` adds each segment serially (no atomic adds, as
    ``index_add_`` uses on the card), so the card and the host give the same
    bits on every run.  Counts are integer counts.
    """
    idx = codes.long()
    counts = torch.bincount(idx, minlength=k)
    order = torch.sort(idx, stable=True).indices
    sums = torch.segment_reduce(x.float()[order], "sum", lengths=counts)
    return sums, counts.to(torch.float32)


def update_centroids(
    sums: torch.Tensor, counts: torch.Tensor, reseed: torch.Tensor
) -> torch.Tensor:
    """Each centroid moves to its cluster's mean; an empty cluster takes its
    row of ``reseed`` (k, d)."""
    means = sums / counts.clamp(min=1.0)[:, None]
    return torch.where((counts > 0)[:, None], means, reseed)


def lloyd_step(
    x: torch.Tensor, centroids: torch.Tensor, reseed: torch.Tensor, chunk: int = 16384
) -> torch.Tensor:
    """One Lloyd iteration: assign, then each centroid moves to its
    cluster's mean; an empty cluster takes its row of ``reseed`` (k, d)."""
    codes, _ = _assign_chunked(x, centroids, chunk)
    return update_centroids(*cluster_sums(x, codes, centroids.shape[0]), reseed)


def init_centroids(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` distinct random rows of ``x`` (with replacement only when n < k)."""
    n = x.shape[0]
    dev = generator.device
    if n < k:
        init_idx = torch.randint(0, n, (k,), generator=generator, device=dev)
    else:
        init_idx = torch.randperm(n, generator=generator, device=dev)[:k]
    return x[init_idx.to(x.device)]


def reseed_rows(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` random rows of ``x``: one Lloyd iteration's empty-cluster seeds."""
    idx = torch.randint(0, x.shape[0], (k,), generator=generator, device=generator.device)
    return x[idx.to(x.device)]


def kmeans_fit(
    x: torch.Tensor, k: int, *, generator: torch.Generator, iters: int = 8, chunk: int = 16384
) -> torch.Tensor:
    """Lloyd iterations from ``k`` distinct random rows (with replacement
    only when n < k); empty clusters are re-seeded from random rows."""
    x = x.float()
    centroids = init_centroids(x, k, generator)
    for _ in range(iters):
        centroids = lloyd_step(x, centroids, reseed_rows(x, k, generator), chunk)
    return centroids


def fit_generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """Two independent generators from one seed: one for WHICH tokens train,
    one for WHERE the Lloyd iteration starts (one stream would correlate
    them)."""
    seeds = torch.randint(
        0, 2**62, (2,), generator=torch.Generator().manual_seed(seed), dtype=torch.int64
    ).tolist()
    return tuple(torch.Generator(device=device).manual_seed(s) for s in seeds)


def train_centroids(
    embeddings: torch.Tensor,
    k: int | None = None,
    *,
    seed: int = 0,
    sample: int = 1 << 18,
    iters: int = 8,
) -> torch.Tensor:
    """Index-build entry point: sample -> fit -> (k, d) f32 centroids, on
    the device of ``embeddings``."""
    emb = embeddings.float()
    n = emb.shape[0]
    if k is None:
        k = num_centroids_for(n)
    g_sample, g_fit = fit_generators(seed, emb.device)
    if n > sample:
        emb = emb[torch.randperm(n, generator=g_sample, device=emb.device)[:sample]]
    return kmeans_fit(emb, k, generator=g_fit, iters=iters)
