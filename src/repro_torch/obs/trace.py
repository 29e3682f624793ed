"""Span tracing: thread-safe ring buffer -> Chrome trace-event JSON (the
counterpart of ``repro.obs.trace``).

    tracer = obs.get_tracer()
    with tracer.span("tiered.transfer", staged_bytes=n):
        ...

Spans record onto a bounded ring (a deque with ``maxlen``: a long-running
process keeps the most recent ``capacity`` spans at constant memory) under
one lock, and export as Chrome trace-event JSON, which Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` load.

The wall clock is injectable (``clock=`` takes any ``() -> float`` seconds
callable), so a test drives spans with a fake clock and asserts exact
``ts`` / ``dur`` values; the default is ``time.perf_counter`` (monotonic).

:meth:`Tracer.device_trace` wraps ``torch.profiler.profile`` for a device
capture next to the host spans.  Unlike the reference, which degrades to a
no-op where its profiler fails, a profiler failure here raises: a capture
that silently records nothing would hide the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

#: Chrome trace-event "complete event" phase: one event carries ts + dur.
_PH_COMPLETE = "X"
#: Instant-event phase (scope "t": a thread-scoped tick mark).
_PH_INSTANT = "i"


class Span:
    """One recorded span: name, start (s), duration (s), thread, attrs."""

    __slots__ = ("name", "ts", "dur", "tid", "attrs")

    def __init__(self, name, ts, dur, tid, attrs):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.attrs = attrs

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, ts={self.ts:.6f}, dur={self.dur:.6f})"


class Tracer:
    """Bounded, thread-safe span recorder with Chrome-trace export."""

    def __init__(self, capacity: int = 8192, clock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._buf: deque[Span] = deque(maxlen=capacity)

    # ---- recording -------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context manager recording one complete span; a block that raises
        still records it."""
        t0 = self._clock()
        try:
            yield self
        finally:
            t1 = self._clock()
            self._record(name, t0, t1 - t0, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker (a generation bump, a delete, ...)."""
        self._record(name, self._clock(), 0.0, attrs)

    def record(self, name: str, ts: float, dur: float, **attrs) -> None:
        """Record a span after the fact from explicit ``ts`` / ``dur``
        seconds (the clock's domain): a wait known only once it ended."""
        self._record(name, ts, max(dur, 0.0), attrs)

    def _record(self, name, ts, dur, attrs) -> None:
        s = Span(name, ts, dur, threading.get_ident(), attrs or None)
        with self._lock:
            self._buf.append(s)

    # ---- reading ---------------------------------------------------------
    def spans(self, name: str | None = None) -> list[Span]:
        """Snapshot of recorded spans, oldest first (optionally by name)."""
        with self._lock:
            out = list(self._buf)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def durations_ms(self, name: str) -> list[float]:
        """All recorded durations for ``name``, in milliseconds."""
        return [s.dur * 1e3 for s in self.spans(name)]

    def summary(self) -> dict:
        """Per-span-name {count, total_ms, mean_ms} rollup."""
        agg: dict[str, list] = {}
        for s in self.spans():
            agg.setdefault(s.name, []).append(s.dur)
        return {
            name: dict(
                count=len(durs),
                total_ms=sum(durs) * 1e3,
                mean_ms=sum(durs) / len(durs) * 1e3,
            )
            for name, durs in sorted(agg.items())
        }

    # ---- export ----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON object: ``ts`` / ``dur`` in microseconds,
        complete spans ``ph: "X"``, instants ``ph: "i"``."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            ev = dict(
                name=s.name,
                ph=_PH_COMPLETE if s.dur > 0 else _PH_INSTANT,
                ts=s.ts * 1e6,
                pid=pid,
                tid=s.tid,
            )
            if ev["ph"] == _PH_COMPLETE:
                ev["dur"] = s.dur * 1e6
            else:
                ev["s"] = "t"
                ev["dur"] = 0.0
            if s.attrs:
                ev["args"] = {k: _jsonable(v) for k, v in s.attrs.items()}
            events.append(ev)
        return dict(traceEvents=events, displayTimeUnit="ms")

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the number of events."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])

    # ---- device capture --------------------------------------------------
    @contextlib.contextmanager
    def device_trace(self, logdir: str, device="cuda"):
        """``torch.profiler`` capture of the block, written as a Chrome
        trace (``device_trace.json``) into ``logdir``, inside one
        ``device_trace`` span.  ``device="cuda"`` traces the host and the
        card (and raises without one); ``device="cpu"`` the host only."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import resolve_device

        dev = resolve_device(device)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with self.span("device_trace", logdir=logdir):
            with profile(activities=activities) as prof:
                yield prof
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            prof.export_chrome_trace(os.path.join(logdir, "device_trace.json"))


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
    except ImportError:  # pragma: no cover
        pass
    return str(v)


#: The process-wide tracer.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
