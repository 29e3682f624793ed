"""``repro_torch.obs`` — observability (the counterpart of ``repro.obs``).

Ported: :mod:`repro_torch.obs.funnel` (:class:`FunnelStats`, the per-query
candidate counts through the PLAID funnel).  The span tracer and the
metrics registry (``repro.obs.trace`` / ``repro.obs.metrics``) belong to
the serving slice and are not ported yet.
"""
from repro_torch.obs.funnel import FunnelStats

__all__ = ["FunnelStats"]
