"""Block-ordered, mesh-parallel Lloyd k-means for the streaming build's
pass 1 (the counterpart of ``repro.build.kmeans_mesh``).

The training sample is split into a FIXED number of equal blocks
(``stat_blocks``, independent of the mesh size; the reference pads the
last one with weight-0 rows, and a weight-0 row adds nothing, so here the
last blocks are just shorter).  Blocks are spread over the mesh's devices
in contiguous shard order, and each Lloyd iteration

* assigns every block's rows to their nearest centroid on the block's
  device and takes the block's per-cluster ``(sums, counts)`` as the
  reference's ``_block_stats`` does (within a block each cluster's rows
  are summed in row order, ``core.kmeans.cluster_sums``);
* adds the block partials in global block order with
  ``repro_torch.distributed.reduce.ordered_block_sum``: one addition
  chain, whatever the device count.

So for every device count dividing ``stat_blocks`` the trained centroids
are BITWISE identical to the one-device run, and to every chunking of the
corpus (the reservoir sample is chunking-invariant).  Init and
empty-cluster reseeding are ``core.kmeans.kmeans_fit``'s, with
``torch.Generator`` draws in place of the reference's ``jax.random`` keys.
"""
from __future__ import annotations

import torch

from repro_torch.core import kmeans as _kmeans
from repro_torch.distributed.reduce import ordered_block_sum
from repro_torch.launch.mesh import Mesh

#: the reference's mesh axis name (kept for its exports)
BUILD_AXIS = "build"

#: fixed statistics granularity: every device count dividing it gives the
#: same bits as every other one (1/2/4/8 for the default)
DEFAULT_STAT_BLOCKS = 8


def build_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A process-local build mesh of ``n_devices`` (default: every visible
    card; one on the host): ``cuda:0..n-1``, raising when that exceeds the
    visible cards, or the host repeated for ``device="cpu"``."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else None
    n = (visible or 1) if n_devices is None else max(1, int(n_devices))
    if visible is not None and n > visible:
        raise ValueError(f"n_devices={n} exceeds the {visible} visible devices")
    if dev.type != "cuda":
        return Mesh((dev,) * n)
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _block_rows(n: int, stat_blocks: int, b: int) -> slice:
    block = -(-n // stat_blocks)  # ceil
    return slice(b * block, (b + 1) * block)


def _device_blocks(x: torch.Tensor, mesh: Mesh, stat_blocks: int) -> list:
    """This process's blocks of ``x``: for each mesh device, its
    ``stat_blocks // n_shards`` blocks in order, copied there once."""
    per_dev = stat_blocks // mesh.n_shards
    return [
        [x[_block_rows(x.shape[0], stat_blocks, s * per_dev + b)].to(dev) for b in range(per_dev)]
        for dev, s in zip(mesh.devices, mesh.shard_ids())
    ]


def block_stats(
    x: torch.Tensor, centroids: torch.Tensor, stat_blocks: int, chunk: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster ``(sums, counts)`` of ``x`` under its nearest centroids,
    as ``stat_blocks`` equal blocks' partials added in block order, on
    ``x``'s device."""
    mesh = Mesh((x.device,))
    return mesh_block_stats(_device_blocks(x, mesh, stat_blocks), centroids, mesh,
                            stat_blocks, chunk)


def mesh_block_stats(blocks, centroids: torch.Tensor, mesh: Mesh, stat_blocks: int,
                     chunk: int = 16384) -> tuple[torch.Tensor, torch.Tensor]:
    """``block_stats`` over the mesh: ``blocks[i]`` holds the blocks of
    this process's device ``i`` (:func:`_device_blocks`); each device takes
    its blocks' partials, and the sums and counts are added in global
    block order on the mesh's first device."""
    per_dev = stat_blocks // mesh.n_shards
    k, d = centroids.shape
    sums, counts = [], []
    for dev, rows in zip(mesh.devices, blocks):
        cents = centroids.to(dev)
        s = torch.zeros(per_dev, k, d, dtype=torch.float32, device=dev)
        c = torch.zeros(per_dev, k, dtype=torch.float32, device=dev)
        for b in range(per_dev):
            xb = rows[b]
            if xb.shape[0] == 0:  # all weight-0 pads in the reference
                continue
            codes, _ = _kmeans._assign_chunked(xb, cents, chunk)
            s[b], c[b] = _kmeans.cluster_sums(xb, codes, k)
        sums.append(s)
        counts.append(c)
    return ordered_block_sum(sums, mesh), ordered_block_sum(counts, mesh)


def kmeans_fit_mesh(
    x,
    k: int,
    *,
    generator: torch.Generator,
    iters: int = 8,
    mesh: Mesh | None = None,
    stat_blocks: int = DEFAULT_STAT_BLOCKS,
) -> torch.Tensor:
    """Train ``(k, d)`` centroids on ``x`` (on its device) with
    block-ordered, mesh-parallel Lloyd steps; bitwise invariant to the
    mesh's device count for any count dividing ``stat_blocks`` (module
    docstring).  ``mesh=None`` runs every block on ``x``'s device."""
    if stat_blocks < 1:
        raise ValueError(f"stat_blocks must be >= 1, got {stat_blocks}")
    x = torch.as_tensor(x).float()
    if mesh is None:
        mesh = Mesh((x.device,))
    n_dev = mesh.n_shards
    if stat_blocks % n_dev:
        raise ValueError(
            f"stat_blocks={stat_blocks} must be divisible by the mesh device count "
            f"({n_dev}), and kept CONSTANT across runs that must be bit-identical"
        )
    blocks = _device_blocks(x, mesh, stat_blocks)
    centroids = _kmeans.init_centroids(x, k, generator)
    for _ in range(iters):
        reseed = _kmeans.reseed_rows(x, k, generator)
        sums, counts = mesh_block_stats(blocks, centroids, mesh, stat_blocks)
        centroids = _kmeans.update_centroids(sums.to(x.device), counts.to(x.device), reseed)
    return centroids
