"""Search over a LiveIndex (the counterpart of ``repro.live.engine``).

The reference's ``LiveEngine`` forwards every call to its
``LiveExecutor``; here it is the executor itself
(:class:`repro_torch.exec.live.LiveExecutor`).  A search builds (or
reuses) an :class:`repro_torch.exec.plan.ExecutionPlan` — the base segment
as one partition group, every delta segment in a second — and merges
across segments with the one shared implementation in
``repro_torch.distributed.topk``.  Every segment shares one centroid space
and codec, so per-passage scores are the numbers one merged index gives,
and multi-segment results are rank-identical to a rebuild of the union
corpus under non-truncating caps (the executor clamps per group as
``PlaidEngine`` clamps per corpus).

The public API is ``repro_torch.retrieval`` (backends ``"live"`` and
``"live-cuda"``); the engine returns raw ``(scores, pids)`` tuples in
global pid space, on the index's device.
"""
from __future__ import annotations

from repro_torch.exec.live import LiveExecutor

LiveEngine = LiveExecutor
