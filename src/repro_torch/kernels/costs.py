"""Host-to-device transfer model of the tiered index (the tiered part of
``repro.kernels.costs``).

The tiered engine (``core.tiered.TieredEngine``) moves only the
finalists' CSR slices to the card each batch; these functions give that
traffic from shapes alone, and the engine's measured ``TransferStats``
must equal them exactly (``tests/test_torch_tiered.py``, phase ``tiered``
of ``chip_smoke.py``).

The reference's per-kernel HBM models (``centroid_interaction_batched_
cost`` and the rest, ``KERNEL_COSTS``) are built on the Pallas launch grids
(``launch.hlo_analysis.pallas_block_traffic``).  They are not ported: the
benchmark work (ROADMAP Queue 1 item 3) re-derives them from the Hopper
kernels' launch grids.
"""
from __future__ import annotations

_I32 = 4


def tiered_transfer_cost(
    *, pool_docs: int, slice_tokens: int, pd: int, n3: int, B: int,
    p_cap: int | None = None, t_cap: int | None = None,
) -> dict:
    """Bus bytes of one tiered batch's candidate-slice copy.

    * ``slice_bytes``: the exact candidate CSR payload, one packed residual
      row and one i32 code a slice token;
    * ``staged_bytes`` (given ``p_cap`` and ``t_cap``): what crosses after
      the pow2 staging padding, codes and residuals at ``t_cap`` tokens,
      offsets and lengths at ``p_cap`` passages, plus the (B, n3) i32
      pool-local position map.
    """
    slice_bytes = slice_tokens * (pd + _I32)
    if p_cap is None or t_cap is None:
        return dict(slice_bytes=slice_bytes)
    staged_bytes = (
        t_cap * (_I32 + pd)  # codes + residuals staging arrays
        + (p_cap + 1) * _I32  # pool-local CSR offsets
        + p_cap * _I32  # pool-local lens
        + B * n3 * _I32  # pos_pids map
    )
    return dict(slice_bytes=slice_bytes, staged_bytes=staged_bytes)


def resident_payload_bytes(*, num_tokens: int, pd: int) -> int:
    """Device bytes the resident engine holds for the token payload: what
    tiering evicts, and the bound a batch's ``slice_bytes`` stays below."""
    return num_tokens * (pd + _I32)
