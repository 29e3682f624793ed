"""Block-ordered Lloyd k-means for the streaming build's pass 1 (the
single-device counterpart of ``repro.build.kmeans_mesh.kmeans_fit_mesh``).

The training sample is split into a FIXED number of equal blocks
(``stat_blocks``, the reference pads the last one with weight-0 rows; a
weight-0 row adds nothing, so here the last blocks are just shorter).
Each Lloyd iteration assigns every block's rows to their nearest centroid,
takes each block's per-cluster ``(sums, counts)`` as the reference's
``_block_stats`` does, and adds the block partials in block order, as
``repro.distributed.reduce.ordered_block_sum`` does.  Within a block each
cluster's rows are summed in row order (``core.kmeans.cluster_sums``), so
the trained centroids are the same bits on every run and for every
chunking of the corpus (the reservoir sample is chunking-invariant).

Init and empty-cluster reseeding are ``core.kmeans.kmeans_fit``'s, with
``torch.Generator`` draws in place of the reference's ``jax.random`` keys.
The multi-GPU side (the reference's ``mesh``, ``shard_map`` and
``build_mesh``) is not ported: ``n_devices`` other than ``None`` or 1
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import kmeans as _kmeans

#: the reference's mesh axis name (kept for its exports; no mesh here)
BUILD_AXIS = "build"

#: fixed statistics granularity: the block decomposition (and so every
#: float sum's association) is the same whatever runs it
DEFAULT_STAT_BLOCKS = 8


def check_single_device(n_devices: int | None) -> None:
    if n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={n_devices}: the multi-GPU build (the port of "
            "repro.build.kmeans_mesh's mesh and repro.distributed) is not ported"
        )


def block_stats(
    x: torch.Tensor, centroids: torch.Tensor, stat_blocks: int, chunk: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster ``(sums, counts)`` of ``x`` under its nearest centroids,
    as ``stat_blocks`` equal blocks' partials added in block order."""
    k, d = centroids.shape
    n = x.shape[0]
    block = -(-n // stat_blocks)  # ceil
    sums = torch.zeros(k, d, dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    for b in range(stat_blocks):
        xb = x[b * block : (b + 1) * block]
        if xb.shape[0] == 0:  # all weight-0 pads in the reference
            continue
        codes, _ = _kmeans._assign_chunked(xb, centroids, chunk)
        s, c = _kmeans.cluster_sums(xb, codes, k)
        sums += s
        counts += c
    return sums, counts


def kmeans_fit_mesh(
    x,
    k: int,
    *,
    generator: torch.Generator,
    iters: int = 8,
    n_devices: int | None = None,
    stat_blocks: int = DEFAULT_STAT_BLOCKS,
) -> torch.Tensor:
    """Train ``(k, d)`` centroids on ``x`` (on its device) with
    block-ordered Lloyd steps; bit-reproducible (module docstring)."""
    check_single_device(n_devices)
    if stat_blocks < 1:
        raise ValueError(f"stat_blocks must be >= 1, got {stat_blocks}")
    x = torch.as_tensor(x).float()
    centroids = _kmeans.init_centroids(x, k, generator)
    for _ in range(iters):
        reseed = _kmeans.reseed_rows(x, k, generator)
        centroids = _kmeans.update_centroids(
            *block_stats(x, centroids, stat_blocks), reseed
        )
    return centroids
