"""Process-wide metrics: counters, gauges, log-bucket histograms, windows
(the counterpart of ``repro.obs.metrics``; numpy and the standard library
only).

* :class:`Counter` — monotonic; **strict-by-default** names: a ``Counters``
  bag refuses to increment a name it was not constructed with (a counter
  nothing registered is a counter nothing reads).
* :class:`Gauge` — last-write-wins instantaneous value (queue depth,
  outstanding work, cache hit rate).
* :class:`Histogram` — fixed log-spaced buckets (base-2 by default): O(1)
  observe, constant memory, Prometheus-compatible cumulative export.
* :class:`LatencyWindow` — the exact-percentile ring buffer the serving
  tier reports from (``serving.stats`` re-exports it); ``extend`` takes
  the lock ONCE per batch, not once per element.
* :class:`MetricsRegistry` — named instruments + two exporters:
  ``snapshot()`` (JSON-safe nested dict) and ``to_prometheus()`` (text
  exposition format, scrape-ready).  The default namespace stays
  ``"repro"``, so for the same operations both packages export the same
  text and one dashboard scrapes either.

A process-wide default registry (:func:`get_registry`) exists for code that
wants zero plumbing; components that need isolation (tests, one registry
per server) construct their own — every instrument is also usable
standalone.
"""
from __future__ import annotations

import bisect
import threading

import numpy as np


class LatencyWindow:
    """Fixed-capacity ring of recent latencies (seconds in, ms out).

    ``summary()`` reports exact percentiles over the window and the
    all-time ``n``/mean; thread-safe.
    """

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf = np.zeros(capacity, np.float64)
        self._pos = 0  # next write slot
        self._count = 0  # all-time observations
        self._sum = 0.0  # all-time sum (exact mean over everything)

    def add(self, seconds: float) -> None:
        with self._lock:
            self._add_locked(seconds)

    def _add_locked(self, seconds: float) -> None:
        self._buf[self._pos] = seconds
        self._pos = (self._pos + 1) % self.capacity
        self._count += 1
        self._sum += seconds

    def extend(self, seconds_iter) -> None:
        """Record a batch of observations under ONE lock acquisition.

        Semantically identical to ``add`` in a loop (same ring contents,
        same all-time count/sum), but a bulk replay of a few thousand
        latencies contends for the lock once instead of per element.
        """
        vals = [float(s) for s in seconds_iter]  # materialize outside lock
        if not vals:
            return
        with self._lock:
            for s in vals:
                self._add_locked(s)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def summary(self) -> dict:
        """``{}`` before the first observation, else n / mean / p50 / p99
        (mean is all-time; percentiles are exact over the window)."""
        with self._lock:
            n = self._count
            if not n:
                return {}
            window = self._buf[: min(n, self.capacity)] * 1e3
            mean_ms = self._sum / n * 1e3
        return {
            "n": n,
            "window": int(window.shape[0]),
            "mean_ms": float(mean_ms),
            "p50_ms": float(np.percentile(window, 50)),
            "p99_ms": float(np.percentile(window, 99)),
        }


class Counter:
    """One monotonic counter (thread-safe ``inc`` / ``value``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._v += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value (``set`` / ``value``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, by: float = 1.0) -> None:
        with self._lock:
            self._v += by

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed log-spaced buckets: O(1) observe, constant memory.

    Bucket upper bounds are ``start * factor**i`` for ``i in range(n)``
    plus the implicit +Inf overflow bucket — the classic Prometheus
    exponential layout.  Defaults cover 0.1ms .. ~100s in base-2 steps
    when observations are seconds.
    """

    def __init__(
        self,
        name: str = "",
        *,
        start: float = 1e-4,
        factor: float = 2.0,
        n_buckets: int = 20,
    ):
        if start <= 0 or factor <= 1 or n_buckets < 1:
            raise ValueError(
                f"bad histogram layout: start={start} factor={factor} "
                f"n_buckets={n_buckets}"
            )
        self.name = name
        self.bounds = [start * factor**i for i in range(n_buckets)]
        self._lock = threading.Lock()
        self._counts = [0] * (n_buckets + 1)  # + overflow
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, float(v))
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                count=self._n,
                sum=self._sum,
                bounds=list(self.bounds),
                buckets=list(self._counts),
            )


class Counters:
    """A thread-safe named-counter bag — STRICT by default.

    ``inc``/``__getitem__`` on a name the bag was not constructed with
    raise ``KeyError`` (the legacy bag silently created typo'd counters;
    a counter nothing registered is a counter nothing reads).  Pass
    ``strict=False`` for the old open-ended behaviour.
    """

    def __init__(self, *names: str, strict: bool = True):
        self._lock = threading.Lock()
        self._strict = strict
        self._c = {n: 0 for n in names}

    def _check(self, name: str) -> None:
        if self._strict and name not in self._c:
            raise KeyError(
                f"counter {name!r} was not registered at construction "
                f"(known: {sorted(self._c)}); pass strict=False to allow "
                "ad-hoc names"
            )

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._check(name)
            self._c[name] = self._c.get(name, 0) + by

    def __getitem__(self, name: str) -> int:
        with self._lock:
            self._check(name)
            return self._c.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


class MetricsRegistry:
    """Named instruments + snapshot/Prometheus exporters.

    ``counter``/``gauge``/``histogram``/``window`` are get-or-create:
    repeated calls with one name return the same instrument (asking for an
    existing name as a different kind raises).
    """

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, kind, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = kind(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def window(self, name: str, capacity: int = 2048) -> LatencyWindow:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = LatencyWindow(capacity)
                self._instruments[name] = inst
            elif not isinstance(inst, LatencyWindow):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not LatencyWindow"
                )
            return inst

    # ---- exporters -------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe nested dict of every instrument's current state."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out[name] = dict(type="counter", value=inst.value)
            elif isinstance(inst, Gauge):
                out[name] = dict(type="gauge", value=inst.value)
            elif isinstance(inst, Histogram):
                out[name] = dict(type="histogram", **inst.snapshot())
            elif isinstance(inst, LatencyWindow):
                out[name] = dict(type="window", **inst.summary())
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4), scrape-ready."""
        ns = self.namespace
        lines: list[str] = []

        def metric_name(name: str) -> str:
            safe = "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )
            return f"{ns}_{safe}"

        with self._lock:
            items = list(self._instruments.items())
        for name, inst in sorted(items):
            m = metric_name(name)
            if isinstance(inst, Counter):
                lines += [f"# TYPE {m} counter", f"{m} {inst.value}"]
            elif isinstance(inst, Gauge):
                lines += [f"# TYPE {m} gauge", f"{m} {inst.value}"]
            elif isinstance(inst, Histogram):
                snap = inst.snapshot()
                lines.append(f"# TYPE {m} histogram")
                cum = 0
                for bound, c in zip(snap["bounds"], snap["buckets"]):
                    cum += c
                    lines.append(f'{m}_bucket{{le="{bound:g}"}} {cum}')
                cum += snap["buckets"][-1]
                lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{m}_sum {snap['sum']}")
                lines.append(f"{m}_count {snap['count']}")
            elif isinstance(inst, LatencyWindow):
                s = inst.summary()
                lines.append(f"# TYPE {m} summary")
                if s:
                    lines.append(f'{m}{{quantile="0.5"}} {s["p50_ms"]}')
                    lines.append(f'{m}{{quantile="0.99"}} {s["p99_ms"]}')
                    lines.append(f"{m}_count {s['n']}")
                else:
                    lines.append(f"{m}_count 0")
        return "\n".join(lines) + "\n"


#: The zero-plumbing process-wide registry.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
