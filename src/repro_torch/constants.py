"""Numeric constants that must agree with the JAX reference bit for bit.

A sentinel that drifts from the reference's reorders equal-score ties, so
every scoring path and kernel of the port reads these (the values are the
reference's ``repro/constants.py``).
"""
from __future__ import annotations

#: Sentinel score for pruned / invalid entries.  Cosine scores live in
#: ~[-1, 1]; -1e4 is far below any real score yet small enough that
#: ``nq * NEG`` stays finite in float32 accumulations.
NEG = -1e4

#: Default stage-1 candidate bound (C_max): the static cap on the number of
#: unique passages stage 1 may surface.
DEFAULT_CANDIDATE_CAP = 8192
