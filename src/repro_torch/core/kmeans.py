"""Lloyd k-means in PyTorch (the counterpart of ``repro.core.kmeans``): the
centroids of an index build.

ColBERTv2 sets the number of centroids proportional to sqrt(#embeddings)
(``16 * sqrt(n)`` rounded up to a power of two).  Training runs on a sample
of the token embeddings, with assignment in row chunks so the (n, K)
distance matrix never exists whole.  Every product is full float32
(``ieee_f32_matmul``: no TF32).  ``torch.Generator`` draws replace the
reference's ``jax.random`` keys, so the two packages train different
centroids from the same seed; tests compare trained builds by recall.
On the card the cluster sums are atomic adds, so the last bits of a trained
centroid may differ from run to run.
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

    ``d2 = ||c||^2 - 2 x.c`` (``||x||^2`` is constant per row); ``argmin``
    keeps the first index on ties, as ``jnp.argmin`` does.
    """
    x, centroids = x.float(), centroids.float()
    c_sq = (centroids * centroids).sum(dim=-1)
    codes = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    dists = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        with ieee_f32_matmul():
            d2 = c_sq[None, :] - 2.0 * (x[r0 : r0 + chunk] @ centroids.T)
        best, idx = torch.min(d2, dim=-1)
        codes[r0 : r0 + chunk] = idx.to(torch.int32)
        dists[r0 : r0 + chunk] = best
    return codes, dists


def lloyd_step(
    x: torch.Tensor, centroids: torch.Tensor, reseed: torch.Tensor, chunk: int = 16384
) -> torch.Tensor:
    """One Lloyd iteration: assign, then each centroid moves to its
    cluster's mean; an empty cluster takes its row of ``reseed`` (k, d)."""
    k = centroids.shape[0]
    codes, _ = _assign_chunked(x, centroids, chunk)
    idx = codes.long()
    sums = torch.zeros_like(centroids).index_add_(0, idx, x)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(
        0, idx, torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    )
    means = sums / counts.clamp(min=1.0)[:, None]
    return torch.where((counts > 0)[:, None], means, reseed)


def kmeans_fit(
    x: torch.Tensor, k: int, *, generator: torch.Generator, iters: int = 8, chunk: int = 16384
) -> torch.Tensor:
    """Lloyd iterations from ``k`` distinct random rows (with replacement
    only when n < k); empty clusters are re-seeded from random rows."""
    x = x.float()
    n = x.shape[0]
    dev = generator.device
    if n < k:
        init_idx = torch.randint(0, n, (k,), generator=generator, device=dev)
    else:
        init_idx = torch.randperm(n, generator=generator, device=dev)[:k]
    centroids = x[init_idx.to(x.device)]
    for _ in range(iters):
        reseed = x[torch.randint(0, n, (k,), generator=generator, device=dev).to(x.device)]
        centroids = lloyd_step(x, centroids, reseed, chunk)
    return centroids


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
    # Two independent streams: one generator for WHICH tokens train, another
    # for WHERE the Lloyd iteration starts (one stream would correlate them).
    seeds = torch.randint(
        0, 2**62, (2,), generator=torch.Generator().manual_seed(seed), dtype=torch.int64
    ).tolist()
    g_sample = torch.Generator(device=emb.device).manual_seed(seeds[0])
    g_fit = torch.Generator(device=emb.device).manual_seed(seeds[1])
    if n > sample:
        emb = emb[torch.randperm(n, generator=g_sample, device=emb.device)[:sample]]
    return kmeans_fit(emb, k, generator=g_fit, iters=iters)
