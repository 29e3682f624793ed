"""Tiered partitions under the plan abstraction: N engines, ONE merge (the
counterpart of ``repro.exec.tiered``).

A tiered corpus larger than one device tier's budget splits into contiguous
document-range partitions, each a self-contained
:class:`core.tiered.TieredIndex` (its own device tier and host-payload
slices: the host arrays and mmaps are sliced, never copied).  Each
partition runs the two-phase tiered search; the results join as an
:class:`repro_torch.exec.plan.ExecutionPlan`:

    partition groups (TieredEngine.search_batch, pids offset to global)
        │ (B, k) score/pid tuples per partition
        ▼
    distributed.topk.merge_topk — the ONE merge, hierarchy-invariant

Partitions run one after another within a batch, each with its own staging
ring and copy stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.constants import NEG
from repro_torch.core import plaid
from repro_torch.core.tiered import TieredBudgetError, TieredEngine, TieredIndex
from repro_torch.exec.plan import ExecutionPlan


def partition_tiered(
    tiered: TieredIndex, n_partitions: int
) -> tuple[list[TieredIndex], list[int]]:
    """Split a tiered index into contiguous doc-range partitions.

    Returns ``(partitions, pid_offsets)``.  Host payloads are slices of the
    parent's arrays (no copy); each partition's device tier slices the
    parent's device ``codes`` and gets its own centroid -> pid IVF,
    restricted to its range by a host ``bincount`` over the parent's IVF
    (the per-row pid order kept, so it is the IVF a build of that range
    over the shared centroid space gives).  The centroid-space tensors
    (centroids, quantized tables, codec) are shared across partitions.
    """
    if n_partitions < 1:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    nd = tiered.num_passages
    if n_partitions > nd:
        raise ValueError(f"cannot split {nd} passages into {n_partitions} partitions")
    dev = tiered.device
    h_offs = np.asarray(tiered.host_doc_offsets, np.int64)
    bounds = np.linspace(0, nd, n_partitions + 1).astype(np.int64)
    ivf_pids_h = dev.ivf_pids.cpu().numpy().astype(np.int64)
    ivf_lens_h = dev.ivf_lens.cpu().numpy().astype(np.int64)
    K = int(dev.num_centroids)
    pair_cid = np.repeat(np.arange(K), ivf_lens_h)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.int32)).to(dev.device)

    parts: list[TieredIndex] = []
    offsets: list[int] = []
    for d0, d1 in zip(bounds[:-1], bounds[1:]):
        d0, d1 = int(d0), int(d1)
        t0, t1 = int(h_offs[d0]), int(h_offs[d1])
        sel = (ivf_pids_h >= d0) & (ivf_pids_h < d1)
        new_lens = np.bincount(pair_cid[sel], minlength=K).astype(np.int32)
        new_offs = np.zeros(K + 1, np.int32)
        np.cumsum(new_lens, out=new_offs[1:])
        new_pids = (ivf_pids_h[sel] - d0).astype(np.int32)
        if new_pids.size == 0:
            new_pids = np.zeros(1, np.int32)
        part_offs = np.asarray(h_offs[d0 : d1 + 1] - t0, np.int32)
        part_lens = np.asarray(tiered.host_doc_lens[d0:d1], np.int32)
        part_dev = dataclasses.replace(
            dev,
            codes=dev.codes[t0:t1],
            doc_offsets=on_dev(part_offs),
            doc_lens=on_dev(part_lens),
            ivf_pids=on_dev(new_pids),
            ivf_offsets=on_dev(new_offs),
            ivf_lens=on_dev(new_lens),
            ivf_list_cap=int(max(new_lens.max(initial=1), 1)),
        )
        parts.append(
            TieredIndex(
                device=part_dev,
                host_codes=tiered.host_codes[t0:t1],
                host_residuals=tiered.host_residuals[t0:t1],
                host_doc_offsets=part_offs,
                host_doc_lens=part_lens,
            )
        )
        offsets.append(d0)
    return parts, offsets


class TieredExecutor:
    """Partitioned tiered search as an :class:`ExecutionPlan`.

    ``device_budget_bytes`` bounds the SUM of the partitions' device tiers
    (what an operator provisions); the constructor raises
    :class:`TieredBudgetError` when it does not fit, instead of letting the
    first search run out of device memory.
    """

    def __init__(
        self,
        tiered: TieredIndex,
        params: plaid.SearchParams | None = None,
        *,
        n_partitions: int = 1,
        device_budget_bytes: int | None = None,
    ):
        self.params = params or plaid.SearchParams()
        if n_partitions == 1:
            parts, offsets = [tiered], [0]
        else:
            parts, offsets = partition_tiered(tiered, n_partitions)
        self.engines = [TieredEngine(p, self.params) for p in parts]
        self.offsets = offsets
        if device_budget_bytes is not None:
            got = self.device_nbytes()
            if got > device_budget_bytes:
                raise TieredBudgetError(
                    f"device tier needs {got} bytes across {len(parts)} "
                    f"partition(s) but the budget is {device_budget_bytes}"
                )
        self.device_budget_bytes = device_budget_bytes
        self._plans: dict[bool, ExecutionPlan] = {}

    # -- accounting --------------------------------------------------------
    def device_nbytes(self) -> int:
        return sum(e.tiered.device_nbytes() for e in self.engines)

    def resident_payload_nbytes(self) -> int:
        return sum(e.tiered.resident_payload_nbytes() for e in self.engines)

    def resident_nbytes(self) -> int:
        return sum(e.tiered.resident_nbytes() for e in self.engines)

    @property
    def transfer_totals(self) -> dict:
        totals: dict[str, int] = {}
        for e in self.engines:
            for key, v in e.transfer_totals.items():
                totals[key] = totals.get(key, 0) + v
        return totals

    def last_transfer_bytes(self) -> tuple[int, int]:
        """(slice_bytes, staged_bytes) summed over partitions, last batch."""
        slices = staged = 0
        for e in self.engines:
            if e.last_transfer is not None:
                slices += e.last_transfer.slice_bytes
                staged += e.last_transfer.staged_bytes
        return slices, staged

    # -- the plan ----------------------------------------------------------
    def _group(self, engine: TieredEngine, offset: int, funnel: bool):
        k = self.params.k

        def group(qs, q_masks, t, stage1=None):
            out = engine.search_batch(qs, q_masks, t, funnel=funnel)
            s, pid = out[0], out[1]
            if s.shape[1] < k:  # a small partition: pad to the plan-wide k
                pad = k - s.shape[1]
                s = torch.nn.functional.pad(s, (0, pad), value=NEG)
                pid = torch.nn.functional.pad(pid, (0, pad), value=-1)
            pid = torch.where(pid >= 0, pid + offset, -1)
            return (s, pid, out[2]) if funnel else (s, pid)

        return group

    def plan_for(self, funnel: bool = False) -> ExecutionPlan:
        plan = self._plans.get(funnel)
        if plan is None:
            plan = ExecutionPlan(
                groups=[self._group(e, off, funnel) for e, off in zip(self.engines, self.offsets)],
                k=self.params.k,
                funnel=funnel,
            )
            self._plans[funnel] = plan
        return plan

    # -- search ------------------------------------------------------------
    def search_batch(self, qs, q_masks=None, t_cs=None, *, funnel=False):
        dev = self.engines[0].tiered.device.device
        qs = plaid._as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        t = self.params.t_cs if t_cs is None else t_cs
        return self.plan_for(funnel).search_batch(qs, q_masks, t)
