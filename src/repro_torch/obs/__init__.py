"""``repro_torch.obs`` — observability (the counterpart of ``repro.obs``).

* :mod:`repro_torch.obs.funnel` — :class:`FunnelStats`, the per-query
  candidate counts through the PLAID funnel;
* :mod:`repro_torch.obs.trace` — :class:`Tracer`, the span ring exported
  as Chrome trace-event JSON, and the process-wide :func:`get_tracer`;
* :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucket
  histograms / latency windows behind a :class:`MetricsRegistry` with
  JSON-snapshot and Prometheus-text exporters.
"""
from repro_torch.obs.funnel import FunnelStats
from repro_torch.obs.metrics import (
    Counter,
    Counters,
    Gauge,
    Histogram,
    LatencyWindow,
    MetricsRegistry,
    get_registry,
)
from repro_torch.obs.trace import Span, Tracer, get_tracer

__all__ = [
    "FunnelStats",
    "Counter",
    "Counters",
    "Gauge",
    "Histogram",
    "LatencyWindow",
    "MetricsRegistry",
    "get_registry",
    "Span",
    "Tracer",
    "get_tracer",
]
