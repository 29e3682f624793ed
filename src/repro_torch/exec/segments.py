"""The pow2 padding rule of ``repro.exec.segments``.

Only :func:`pow2_bucket` (and the :func:`ceil_pow2` it rests on) is ported
so far: ``exec.bucketed`` sizes its cap buckets with it.  The stacked
segment execution of the live index belongs to the live slice.
"""
from __future__ import annotations


def ceil_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pow2_bucket(n: int, *, lo: int = 1, hi: int | None = None) -> int:
    """The smallest power of two >= ``n``, clamped to ``[lo, hi]``.

    A non-pow2 ``hi`` is itself a terminal bucket, so the bucket never
    exceeds what the caller configured.
    """
    b = max(ceil_pow2(n), ceil_pow2(lo))
    if hi is not None:
        b = min(b, int(hi))
    return b
