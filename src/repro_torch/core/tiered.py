"""Tiered index: the funnel's state on the device, the token payload in host
memory (the counterpart of ``repro.core.tiered``).

PLAID's funnel reads a small part of the token payload a query (stage 4
rescores ``B * n3`` passages out of millions), yet the resident engine
keeps every packed residual byte on the card.  This module splits the
index at the device boundary:

    device tier (small)                        host tier (dominant)
    ---------------------------------          --------------------------
    centroids / centroids_q / scale            residuals (Nt, pd) u8, mmap
    codes            (Nt,) i32                 codes     (Nt,)   i32, mmap
    doc_offsets / doc_lens (CSR)               tok_pid / eivf_eids: never
    ivf_* centroid -> pid CSR                    loaded
    codec tables (cutoffs / weights)

and searches in two phases over the ``core.pipeline`` split:

    phase A (device)      stages 1-3 on the stripped index: (B, n3) finalists
         │  final_pids.cpu(): the one device-to-host sync of a batch
    slice gather (host)   the finalists' sorted unique pool; one gather a
         │                payload from the host arrays into a page-locked
         │                staging slot (two slots, round robin)
    copy (copy stream)    only the pool's CSR slices cross the bus; the
         │                compute stream waits on the copy's event
    phase B (device)      stage 4 (K2, or K3 fused) on the compacted slices,
                          then the top-k over the global pids

Phase B wraps the slices in a pool-local :class:`PlaidIndex` and runs
``pipeline.exact_stage4_impl`` unchanged, with the pool-local positions as
the gather identity and the global pids as the output identity, so scores
and ranks are bit-identical to the resident engine's.  The compacted
shapes are pow2 buckets (``exec.segments.pow2_bucket``), so the staging
slots are reused across batches.

On the card each staging slot holds page-locked host tensors, the copy is
queued with ``non_blocking=True`` on a CUDA stream of its own, and the host
waits on a slot's copy event before it refills that slot (two batches
later): a fill that overwrote bytes the copy is still reading would corrupt
the batch.  With ``device="cpu"`` the slots are ordinary tensors and the
copy is a plain copy; on the card a failure to pin or to copy raises.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.core import pipeline as pl
from repro_torch.core import plaid
from repro_torch.core.index import PlaidIndex, index_from_numpy
from repro_torch.kernels.costs import resident_payload_bytes
from repro_torch.obs.trace import get_tracer


class TieredBudgetError(ValueError):
    """The device tier does not fit the configured device-memory budget."""


def trace_counts() -> tuple[int, int]:
    """(phase A, phase B) trace counts.  The reference counts its jit
    traces here; the port runs eagerly and never traces, so both stay 0,
    as ``core.pipeline.trace_count`` does."""
    return 0, 0


# --------------------------------------------------------------------------
# The tiered index: a payload-stripped device PlaidIndex + host arrays
# --------------------------------------------------------------------------
def strip_payload(index: PlaidIndex) -> PlaidIndex:
    """Device-tier view: ``residuals`` / ``tok_pid`` / ``eivf_eids``
    replaced by 1-row placeholders; ``codes`` stays (stages 2-3 read it).
    Every other tensor is shared with ``index``."""
    dev = index.device
    pd = index.residuals.shape[1]
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    return dataclasses.replace(
        index,
        residuals=torch.zeros((1, pd), dtype=torch.uint8, device=dev),
        tok_pid=z,
        eivf_eids=z,
    )


@dataclasses.dataclass
class TieredIndex:
    """Device tier + host-resident payload arrays (often ``np.memmap``)."""

    device: PlaidIndex  # payload-stripped (see strip_payload)
    host_codes: np.ndarray  # (Nt,) i32
    host_residuals: np.ndarray  # (Nt, pd) u8
    host_doc_offsets: np.ndarray  # (Nd+1,) i32
    host_doc_lens: np.ndarray  # (Nd,) i32

    @property
    def num_passages(self) -> int:
        return int(self.host_doc_lens.shape[0])

    @property
    def num_tokens(self) -> int:
        return int(self.host_codes.shape[0])

    @property
    def payload_itemsize(self) -> int:
        """Bytes a token sends over the bus: packed residual + i32 code."""
        return int(self.host_residuals.shape[1]) + 4

    def device_nbytes(self) -> int:
        """Bytes the device tier holds (the budgeted quantity)."""
        return int(sum(self.device.nbytes().values()))

    def resident_payload_nbytes(self) -> int:
        """Bytes the resident engine holds for the token payload: what
        tiering evicts (the transfer model's ``resident_payload_bytes``)."""
        return resident_payload_bytes(
            num_tokens=self.num_tokens, pd=int(self.host_residuals.shape[1])
        )

    def resident_nbytes(self) -> int:
        """Device bytes the resident engine holds for this corpus: the
        device tier plus every O(Nt) array tiering strips (residuals,
        ``tok_pid``, ``eivf_eids``), less their 1-row placeholders."""
        pd = int(self.host_residuals.shape[1])
        placeholders = pd + 4 + 4
        return self.device_nbytes() - placeholders + self.num_tokens * (pd + 4 + 4)


def tiered_from_index(index: PlaidIndex) -> TieredIndex:
    """Demote a resident index: payloads copied to host numpy, the funnel's
    tensors kept (shared) on the index's device."""
    return TieredIndex(
        device=strip_payload(index),
        host_codes=index.codes.cpu().numpy(),
        host_residuals=index.residuals.cpu().numpy(),
        host_doc_offsets=index.doc_offsets.cpu().numpy(),
        host_doc_lens=index.doc_lens.cpu().numpy(),
    )


# --------------------------------------------------------------------------
# Host staging ring and the copy to the device
# --------------------------------------------------------------------------
#: staged field -> dtype, in the order the ring hands them out
_STAGED = (
    ("codes", torch.int32),  # (t_cap,) compacted slice codes
    ("res", torch.uint8),  # (t_cap, pd) compacted slice residuals
    ("offs", torch.int32),  # (p_cap + 1,) pool-local CSR offsets
    ("lens", torch.int32),  # (p_cap,) pool-local lengths
    ("pos", torch.int32),  # (B, n3) pool-local positions, -1 pad
)


class _Slot:
    """One staging slot: a flat host buffer a field, and on the card the
    events bracketing the last copy that read it."""

    def __init__(self):
        self.bufs: dict[str, torch.Tensor] = {}
        self.start = self.done = None


class _StagingRing:
    """Two reusable host staging slots, round robin a batch.

    A slot is allocated once and grown only when a larger pow2 bucket
    appears.  On the card its buffers are page-locked, the copy runs on
    ``self.stream`` with ``non_blocking=True``, and :meth:`take` waits on
    the slot's copy event before handing the slot out again, so a fill
    never overwrites bytes a copy is still reading.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.on_card else None
        self._slots = [_Slot(), _Slot()]
        self._turn = 0
        self.last: _Slot | None = None

    def take(self, shapes: dict) -> tuple[_Slot, list[torch.Tensor]]:
        """The next slot and its staging views of ``shapes`` (field ->
        shape), once the slot's last copy has finished."""
        slot = self._slots[self._turn]
        self._turn = 1 - self._turn
        if slot.done is not None:
            slot.done.synchronize()
        views = []
        for name, dtype in _STAGED:
            shape = shapes[name]
            need = int(np.prod(shape))
            buf = slot.bufs.get(name)
            if buf is None or buf.numel() < need:
                buf = torch.empty(max(need, 1), dtype=dtype, pin_memory=self.on_card)
                slot.bufs[name] = buf
            views.append(buf[:need].view(shape))
        return slot, views

    def upload(self, slot: _Slot, staged: list[torch.Tensor]) -> list[torch.Tensor]:
        """``staged`` on the device.  On the card: destinations allocated on
        the compute stream, copies on the copy stream after the compute
        stream's queued work, and the compute stream waits on their event."""
        if not self.on_card:
            return [t.clone() for t in staged]
        compute = torch.cuda.current_stream(self.device)
        dst = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in staged]
        if slot.done is None:
            slot.start = torch.cuda.Event(enable_timing=True)
            slot.done = torch.cuda.Event(enable_timing=True)
        self.stream.wait_stream(compute)
        with torch.cuda.stream(self.stream):
            slot.start.record(self.stream)
            for d, s in zip(dst, staged):
                d.copy_(s, non_blocking=True)
            slot.done.record(self.stream)
        compute.wait_event(slot.done)
        self.last = slot
        return dst

    def last_copy_ms(self) -> float | None:
        """Device ms of the last copy, between its two events on the copy
        stream (waits for it); None before the first copy or on the CPU."""
        if self.last is None:
            return None
        self.last.done.synchronize()
        return self.last.start.elapsed_time(self.last.done)


@dataclasses.dataclass
class TransferStats:
    """One batch's host-to-device accounting for the candidate slices."""

    pool_docs: int  # distinct finalist passages across the batch
    slice_tokens: int  # exact CSR token count of those passages
    slice_bytes: int  # exact candidate-slice bytes (tokens * (pd + 4))
    staged_bytes: int  # bytes copied (pow2-padded staging + pos_pids)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _StepClock:
    """One batch's step times, kept while ``TieredEngine.time_steps`` is
    set (else every call is a no-op): host stamps after each step and, on
    the card, events on the compute stream around phase A and phase B."""

    def __init__(self, enabled: bool, on_card: bool):
        self.enabled, self.on_card = enabled, enabled and on_card
        self.host: dict[str, float] = {}
        self.events: dict[str, torch.cuda.Event] = {}

    def mark(self, name: str, *, event: bool = False, wait: bool = False) -> None:
        """Stamp ``name`` on the host clock; with ``event`` first record an
        event on the compute stream, and with ``wait`` wait for it, so the
        next host step starts once the device work before it has ended
        (the step after phase A waits for it anyway)."""
        if not self.enabled:
            return
        if event and self.on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name] = e
            if wait:
                e.synchronize()
        self.host[name] = time.perf_counter()

    def split(self, copy_ms: float | None) -> dict:
        """Step ms: phase A and phase B on the device (None on the CPU),
        the finalists' copy to the host, the host slice gather, the copy's
        enqueue (host) and the copy itself (``copy_ms``)."""
        h, ev = self.host, self.events

        def dev_ms(a, b):
            if not self.on_card:
                return None
            ev[b].synchronize()
            return ev[a].elapsed_time(ev[b])

        return dict(
            phase_a_ms=dev_ms("start", "phase_a"),
            d2h_ms=(h["d2h"] - h["phase_a"]) * 1e3,
            gather_ms=(h["gather"] - h["d2h"]) * 1e3,
            copy_enqueue_ms=(h["upload"] - h["gather"]) * 1e3,
            h2d_ms=copy_ms,
            phase_b_ms=dev_ms("upload", "phase_b"),
        )


# --------------------------------------------------------------------------
# The tiered engine
# --------------------------------------------------------------------------
class TieredEngine:
    """Batch search over a :class:`TieredIndex` in two phases.

    ``PlaidEngine.search_batch``'s semantics (the same clamp, ``t_cs``
    scalar or per lane, the optional ``FunnelStats``) with bit-identical
    results; keeps the last batch's :class:`TransferStats`
    (``last_transfer``) and running ``transfer_totals``.  With
    ``time_steps`` set, ``last_steps()`` gives the last batch's step times.
    """

    def __init__(
        self,
        tiered: TieredIndex,
        params: plaid.SearchParams | None = None,
        *,
        device_budget_bytes: int | None = None,
    ):
        self.tiered = tiered
        self.params = params or plaid.SearchParams()
        if device_budget_bytes is not None:
            got = tiered.device_nbytes()
            if got > device_budget_bytes:
                raise TieredBudgetError(
                    f"device tier needs {got} bytes but the budget is "
                    f"{device_budget_bytes}; shrink the corpus per partition "
                    "(exec.tiered.partition_tiered) or raise the budget"
                )
        self.device_budget_bytes = device_budget_bytes
        self._staging = _StagingRing(tiered.device.device)
        self.last_transfer: TransferStats | None = None
        self.time_steps = False
        self._clock: _StepClock | None = None
        self.transfer_totals = dict(
            batches=0, pool_docs=0, slice_tokens=0, slice_bytes=0, staged_bytes=0
        )

    def _pipeline_params(self) -> plaid.SearchParams:
        return plaid.clamp_params(self.params, self.tiered.num_passages)

    # -- the phases --------------------------------------------------------
    def _phase_a(self, qs, q_masks, t, *, funnel=False, alive=None):
        """Stages 1-3 on the device tier: ``(final_pids, codes4, tok_valid4,
        extras)``; the per-finalist blocks only when not fused."""
        p = self._pipeline_params()
        return pl.select_finalists_impl(
            self.tiered.device, qs, q_masks, t, params=p, funnel=funnel,
            alive=alive, keep_blocks=not p.fused,
        )

    def _gather_slices(self, final_pids: np.ndarray):
        """Dedup the finalists into a sorted pool and copy their CSR slices
        into the next staging slot.

        Returns ``(slot, [codes_c, res_c, offs_c, lens_c, pos_pids],
        stats)``: views sized to pow2 buckets, ``pos_pids`` mapping each
        finalist lane to its pool-local row (-1 for padding lanes).
        """
        # lazy: repro_torch.exec imports this module (exec.tiered)
        from repro_torch.exec.segments import pow2_bucket

        t = self.tiered
        pd = t.host_residuals.shape[1]
        pool = np.unique(final_pids[final_pids >= 0]).astype(np.int64)
        lens = t.host_doc_lens[pool].astype(np.int64)
        starts = t.host_doc_offsets[pool].astype(np.int64)
        cum = np.zeros(pool.size + 1, np.int64)
        np.cumsum(lens, out=cum[1:])
        total = int(cum[-1])

        p_cap = pow2_bucket(max(pool.size, 1), lo=1)
        t_cap = pow2_bucket(max(total, 1), lo=t.device.doc_maxlen)
        slot, staged = self._staging.take(dict(
            codes=(t_cap,), res=(t_cap, pd), offs=(p_cap + 1,), lens=(p_cap,),
            pos=final_pids.shape,
        ))
        codes_c, res_c, offs_c, lens_c, pos_c = (s.numpy() for s in staged)

        # one gather a payload, straight into the staging slot; the indices
        # come from the CSR, so each is in range ("clip" skips numpy's
        # buffered range check)
        tok_idx = np.repeat(starts - cum[:-1], lens) + np.arange(total)
        np.take(t.host_codes, tok_idx, axis=0, out=codes_c[:total], mode="clip")
        codes_c[total:] = 0
        np.take(t.host_residuals, tok_idx, axis=0, out=res_c[:total], mode="clip")
        res_c[total:] = 0
        offs_c[: pool.size + 1] = cum
        offs_c[pool.size + 1:] = total
        lens_c[: pool.size] = lens
        lens_c[pool.size:] = 0
        pos = np.searchsorted(pool, np.where(final_pids >= 0, final_pids, 0))
        pos_c[...] = np.where(final_pids >= 0, pos, -1)

        stats = TransferStats(
            pool_docs=int(pool.size),
            slice_tokens=total,
            slice_bytes=total * (pd + 4),
            staged_bytes=int(sum(s.nbytes for s in (codes_c, res_c, offs_c, lens_c, pos_c))),
        )
        return slot, staged, stats

    def _upload(self, slot, staged, stats: TransferStats) -> list[torch.Tensor]:
        """The staged slices on the device, inside a ``tiered.transfer``
        span (the span times the host's enqueue; the copy runs on)."""
        with get_tracer().span(
            "tiered.transfer",
            slice_bytes=stats.slice_bytes,
            staged_bytes=stats.staged_bytes,
            pool_docs=stats.pool_docs,
        ):
            return self._staging.upload(slot, staged)

    def _phase_b(self, qs, q_masks, final_pids, codes4, tok_valid4, codes_c, res_c,
                 offs_c, lens_c, pos_pids):
        """Stage 4 over the compacted slices + the final top-k.

        The pool-local index keeps the device tier's centroid space and
        codec; stage 4 reads only its token and CSR arrays.  ``pos_pids``
        (pool-local) is the gather identity, ``final_pids`` (global) the
        output identity.
        """
        p = self._pipeline_params()
        compact = dataclasses.replace(
            self.tiered.device, codes=codes_c, residuals=res_c,
            doc_offsets=offs_c, doc_lens=lens_c,
        )
        exact = pl.exact_stage4_impl(
            compact, qs, q_masks, pos_pids, codes4, tok_valid4, params=p
        )
        return pl.finalize_topk(exact, final_pids, p.k)

    def _record(self, stats: TransferStats) -> None:
        self.last_transfer = stats
        tot = self.transfer_totals
        tot["batches"] += 1
        for key, v in stats.as_dict().items():
            tot[key] += v

    def last_copy_ms(self) -> float | None:
        """Device ms of the last batch's host-to-device copy (events on the
        copy stream; waits for it).  None on the CPU."""
        return self._staging.last_copy_ms()

    def last_steps(self) -> dict | None:
        """The last batch's step times (``_StepClock.split``; waits for the
        batch), or None unless it ran with ``time_steps`` set."""
        if self._clock is None or not self._clock.enabled:
            return None
        return self._clock.split(self.last_copy_ms())

    # -- search ------------------------------------------------------------
    def search_batch(self, qs, q_masks=None, t_cs=None, *, funnel: bool = False,
                     alive=None):
        """(B, nq, d) queries -> ((B, k) scores, (B, k) pids[, FunnelStats]).

        Phase A runs on the device against the stripped index; only the
        finalists' pids come to the host, only their CSR slices go back.
        """
        dev = self.tiered.device.device
        qs = plaid._as_queries(qs, dev, 3)
        if q_masks is None:
            q_masks = torch.ones(qs.shape[:2], dtype=torch.float32, device=dev)
        else:
            q_masks = plaid._as_queries(q_masks, dev, 2)
        t = self.params.t_cs if t_cs is None else t_cs
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        clock = self._clock = _StepClock(self.time_steps, self._staging.on_card)
        clock.mark("start", event=True)
        final_pids, codes4, tok_valid4, extras = self._phase_a(
            qs, q_masks, t, funnel=funnel, alive=alive
        )
        clock.mark("phase_a", event=True, wait=True)
        fp = final_pids.cpu().numpy()  # the one device-to-host sync
        clock.mark("d2h")
        slot, staged, stats = self._gather_slices(fp)
        self._record(stats)
        clock.mark("gather")
        moved = self._upload(slot, staged, stats)
        clock.mark("upload", event=True)  # on the card, after the copy
        scores, pids = self._phase_b(
            qs, q_masks, final_pids, codes4, tok_valid4, *moved
        )
        clock.mark("phase_b", event=True)
        if funnel:
            return scores, pids, extras[-1]
        return scores, pids

    def search(self, q, q_mask=None, t_cs=None):
        """One query: the squeeze of a B=1 ``search_batch``."""
        dev = self.tiered.device.device
        qm = None if q_mask is None else plaid._as_queries(q_mask, dev, 1)[None]
        scores, pids = self.search_batch(plaid._as_queries(q, dev, 2)[None], qm, t_cs)
        return scores[0], pids[0]


# --------------------------------------------------------------------------
# Persistence: v2 tiered manifests (payloads as mmap-able .npy files)
# --------------------------------------------------------------------------
def save_tiered(path: str, index) -> None:
    """Write a tiered index directory: a v2 manifest stamped
    ``storage: "tiered"``, the token payloads as raw ``.npy`` files beside
    ``arrays.npz`` (``live.manifest.write_segment``).

    Takes a resident :class:`PlaidIndex` or a :class:`TieredIndex`; for the
    latter the O(Nt) side arrays a full index carries (``tok_pid``,
    ``eivf_eids``, derived data) are rebuilt on the host, as the reference
    does.
    """
    from repro_torch.live import manifest as mf

    if isinstance(index, TieredIndex):
        t = index
        full = dataclasses.replace(
            t.device,
            codes=t.host_codes,
            residuals=t.host_residuals,
            tok_pid=np.repeat(np.arange(t.num_passages, dtype=np.int32), t.host_doc_lens),
            eivf_eids=np.argsort(t.host_codes, kind="stable").astype(np.int32),
        )
    else:
        full = index
    mf.save_segmented(path, [full], [0], tombstones=None, generation=0, storage="tiered")


def load_tiered(path: str, device: str | torch.device = "cuda") -> TieredIndex:
    """Open a tiered index directory: the device tier on ``device``, the
    payloads memory-mapped read-only straight off the manifest (pages
    fault in as slices are gathered).  ``codes`` also goes to the device
    tier (stages 2-3 read it there).  Raises ``live.manifest``'s typed
    errors on a missing or corrupt payload and refuses non-tiered
    layouts."""
    from repro_torch.live import manifest as mf

    man = mf.read_manifest(path)
    if man.get("storage") != "tiered":
        raise ValueError(
            f"{path}: not a tiered index (storage="
            f"{man.get('storage', 'resident')!r}); use the resident loaders"
        )
    segs = man["segments"]
    if len(segs) != 1 or man.get("tombstones"):
        raise ValueError(
            f"{path}: tiered load supports exactly one live segment, found "
            f"{len(segs)} (tombstones={man.get('tombstones')!r}); compact "
            "before demoting to tiered storage"
        )
    arrays, static, payloads = mf.read_tiered_segment(
        os.path.join(path, segs[0]["name"]), segs[0]
    )
    pd = payloads["residuals"].shape[1]
    dev = index_from_numpy(
        dict(
            arrays,
            codes=payloads["codes"],
            residuals=np.zeros((1, pd), np.uint8),
            tok_pid=np.zeros(1, np.int32),
            eivf_eids=np.zeros(1, np.int32),
        ),
        static,
        device,
    )
    return TieredIndex(
        device=dev,
        host_codes=payloads["codes"],
        host_residuals=payloads["residuals"],
        host_doc_offsets=np.asarray(arrays["doc_offsets"], np.int32),
        host_doc_lens=np.asarray(arrays["doc_lens"], np.int32),
    )
