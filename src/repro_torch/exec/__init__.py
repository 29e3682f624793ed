"""``repro_torch.exec`` — the partition-execution layer (the counterpart of
``repro.exec``).

Ported so far:

* :mod:`repro_torch.exec.bucketed` — pow2-bucketed static-cap dispatch:
  dynamic ``nprobe`` / ``ndocs`` sweeps over a few launch shapes;
* :mod:`repro_torch.exec.segments` — the pow2 bucket rule only.

The plan, stacked-segment, sharded, live and tiered partition groups come
with the live, tiered and multi-GPU slices.
"""
from repro_torch.exec.bucketed import BucketedCapEngine
from repro_torch.exec.segments import ceil_pow2, pow2_bucket

__all__ = ["BucketedCapEngine", "ceil_pow2", "pow2_bucket"]
