"""Deterministic cross-device reductions for the index build (the
counterpart of ``repro.distributed.reduce``).

Float addition is not associative, so summing per-device partials in
whatever order a collective picks would make the same corpus trained on 1
and on 4 devices differ in the last ulp, and Lloyd iterations amplify
that into other centroids.  The streaming build promises bit-identical
output for every device count that divides its block count, so its
statistics are reduced here: partials are taken at a FIXED block
granularity (independent of the device count), gathered in global block
order and added left to right, one addition chain.
"""
from __future__ import annotations

import torch


def ordered_block_sum(partials, mesh=None) -> torch.Tensor:
    """Sum leading-axis block partials in global block order.

    ``partials``: a ``(blocks, ...)`` tensor, or with ``mesh`` (a
    ``launch.mesh.Mesh``) a sequence of this process's per-device
    ``(local_blocks, ...)`` tensors, blocks assigned to the mesh's devices
    in contiguous shard order.  Returns the ``(...)`` total on the mesh's
    first device (the tensor's device without one): ``0 + p[0] + p[1] +
    ...``, the same bits for every device count.
    """
    if mesh is not None:
        from repro_torch.launch.mesh import gather_shards

        parts = [partials] if isinstance(partials, torch.Tensor) else list(partials)
        partials = gather_shards(mesh, parts, dim=0)
    total = torch.zeros_like(partials[0])
    for block in partials:
        total = total + block
    return total
