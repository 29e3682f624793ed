"""THE top-k merge for partitioned retrieval (the counterpart of
``repro.distributed.topk``).

Every partitioned search of the port — device shards
(``repro_torch.exec.sharded``), live-index segments searched one after
another, and the cross-group merge in ``repro_torch.exec.plan`` — funnels
through :func:`merge_topk`.  In the local case the caller has already
concatenated the partitions' ``(score, pid)`` tuples; in the collective
case (``mesh=``) each shard's tuples are gathered through
``launch.mesh.gather_shards`` first, so the bytes moved are
``n_shards * k * 8`` a query, independent of the corpus size.

Determinism: ties are broken by ascending pid (the key is ``(-score,
pid)``), NOT by position, so a ranking does not depend on how the corpus
is partitioned, and merging per-partition top-k lists gives the ranking
of one flat merge however the partitions are grouped.  Like the
reference's ``jax.lax.sort``, the merge treats ``-0.0`` and ``+0.0`` as
equal scores (the pid decides between them), unlike ``stable_topk``,
which ranks ``+0.0`` above ``-0.0`` as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import torch

#: pid sort key for empty/padded slots (real pids are >= 0): sorts after
#: every real pid, so among equal scores padding loses deterministically.
_PAD_PID_KEY = torch.iinfo(torch.int32).max


def merge_topk(scores, pids, k: int, mesh=None):
    """Merge partition top-k tuples into the global top-k.

    ``scores``/``pids``: ``(..., m)`` tuples concatenated over the
    partitions along the last axis; ``pids`` are GLOBAL ids (offset
    shard-local ids with :func:`local_to_global_pids` first), ``-1``
    marking padded slots.  With ``mesh`` (a ``launch.mesh.Mesh``) they are
    instead sequences of this process's per-shard tuples, in shard order,
    gathered along the last axis across the mesh first.  Returns the top
    ``min(k, m)`` by ``(-score, pid)``: the scores as given (a ``-0.0``
    stays ``-0.0``) and their pids, on the mesh's first device.
    """
    if mesh is not None:
        from repro_torch.launch.mesh import gather_shards

        scores, pids = gather_shards(mesh, scores), gather_shards(mesh, pids)
    m = scores.shape[-1]
    # + 0.0 turns -0.0 into +0.0, so both map to one ordered int below
    bits = (scores.float() + 0.0).contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # float order as int order
    pid_key = torch.where(pids >= 0, pids.long(), _PAD_PID_KEY)
    # one int64 key, larger = better: the score above, the reversed pid
    # below; a stable sort keeps equal tuples in position order, as the
    # reference's stable ``jax.lax.sort`` does
    key = ordered.long() * (1 << 32) + (_PAD_PID_KEY - pid_key)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., : min(k, m)]
    return scores.gather(-1, idx), pids.gather(-1, idx)


def local_to_global_pids(local_pids: torch.Tensor, shard: int, shard_size: int) -> torch.Tensor:
    """Offset shard ``shard``'s local passage ids into the global id space
    (``-1`` pads stay ``-1``)."""
    return torch.where(local_pids >= 0, local_pids + shard * shard_size, local_pids)
