"""``repro_torch.obs`` — observability (the counterpart of ``repro.obs``).

* :mod:`repro_torch.obs.funnel` — :class:`FunnelStats`, the per-query
  candidate counts through the PLAID funnel;
* :mod:`repro_torch.obs.trace` — :class:`Tracer`, the span ring exported
  as Chrome trace-event JSON, and the process-wide :func:`get_tracer`.

The metrics registry (``repro.obs.metrics``) belongs to the serving slice
and is not ported yet.
"""
from repro_torch.obs.funnel import FunnelStats
from repro_torch.obs.trace import Span, Tracer, get_tracer

__all__ = ["FunnelStats", "Span", "Tracer", "get_tracer"]
