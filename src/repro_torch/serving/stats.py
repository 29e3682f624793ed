"""Compatibility re-export (the counterpart of ``repro.serving.stats``): the
serving stats primitives live in ``repro_torch.obs``.

``LatencyWindow`` (the exact-percentile ring buffer) and ``Counters`` (the
named-counter bag, STRICT by default — incrementing a name the bag was not
constructed with raises) live in :mod:`repro_torch.obs.metrics` beside the
rest of the metrics substrate.  Import from ``repro_torch.obs`` in new
code; this module keeps the ``serving.stats`` names of the reference.
"""
from __future__ import annotations

from repro_torch.obs.metrics import Counters, LatencyWindow

__all__ = ["Counters", "LatencyWindow"]
