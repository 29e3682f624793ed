"""K2, K6 and K4 wrappers: residual decompression, with and without the
exact MaxSim of stage 4.

Kernels: ``csrc/decompress.cu``, replacing ``repro/kernels/decompress.py``:

* K2 ``decompress_and_score_batched`` replaces
  ``decompress_and_score_batched_pallas``;
* K6 ``decompress_and_score`` (one query, for the ``_search`` oracle)
  replaces ``decompress_and_score_pallas``: the K2 kernel launched with
  B=1, as the reference's single-query kernel is the B=1 case of the
  batched one;
* K4 ``decompress_residuals`` replaces ``decompress_residuals_pallas``
  (vanilla ColBERTv2's decompressions).

Plain versions: ``ref.decompress_and_score_batched_ref``,
``ref.decompress_and_score_ref``, ``ref.decompress_residuals_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels import ref

#: K2 launches made by this process (CPU calls are not launches)
launches = 0
#: K6 launches (the single-query wrapper), counted apart from K2's
single_launches = 0
#: K4 launches
residual_launches = 0

#: queries per lane the K2/K3 body holds (8 query lanes x 8 accumulators)
MAX_NQ = 64

#: the grid K2/K3 aim for: 132 SMs of the H100, 2 blocks of the body an SM
#: (shared memory), and at least 2 waves of blocks
SMS, BLOCKS_PER_SM, MIN_WAVES = 132, 2, 2
#: finalists a K2/K3 block scores at most, and the bytes K2's list of valid
#: rows may take in shared memory (4 bytes a row of the block's G*L)
MAX_PASSAGES_PER_BLOCK, ROW_LIST_BYTES = 16, 16 * 1024


def passages_per_block(B: int, nd: int, L: int | None = None) -> int:
    """G, the finalists one K2/K3 block scores as one stream of tokens.

    As many as keep ``MIN_WAVES`` waves of blocks on the card (more per
    block fills the last 64-token tile better and loads the lane's queries
    fewer times), at most ``MAX_PASSAGES_PER_BLOCK``; for K2 (``L`` given)
    also as many as K2's row list holds.  At least 1.
    """
    g = B * nd // (SMS * BLOCKS_PER_SM * MIN_WAVES)
    if L:
        g = min(g, ROW_LIST_BYTES // (4 * L))
    return max(1, min(MAX_PASSAGES_PER_BLOCK, g))


def _launch_score(q, q_mask, codes, packed_res, tok_valid, centroids, weights, nbits):
    """Check the (B, ...) arguments and launch the K2 kernel -> (B, nd)."""
    dev = q.device
    B, nq, d = q.shape
    nd, L = codes.shape[1:]
    if nbits not in (1, 2, 4) or d % (8 // nbits) or not 0 < nq <= MAX_NQ:
        raise ValueError(f"unsupported nbits={nbits}, d={d}, nq={nq}")
    _build.check(q, "q", torch.float32, (B, nq, d), dev)
    _build.check(q_mask, "q_mask", torch.float32, (B, nq), dev)
    _build.check(codes, "codes", torch.int32, (B, nd, L), dev)
    _build.check(packed_res, "packed_res", torch.uint8, (B, nd, L, d * nbits // 8), dev)
    _build.check(tok_valid, "tok_valid", torch.bool, (B, nd, L), dev)
    _build.check(centroids, "centroids", torch.float32, (None, d), dev)
    _build.check(weights, "weights", torch.float32, (2**nbits,), dev)
    out = torch.empty((B, nd), dtype=torch.float32, device=dev)
    fn = _build.c_function("decompress", "plaid_decompress_and_score_batched", 8, 7)
    _build.launch(
        fn,
        [q, q_mask, codes, packed_res, tok_valid, centroids, weights, out],
        [B, nq, d, nbits, nd, L, passages_per_block(B, nd, L)],
        dev,
    )
    return out


def _meta_score(name, q, codes, packed_res, centroids, nbits) -> torch.Tensor:
    """The dry-run's K2 / K6 call: the (*lead, nd) f32 scores as an empty
    meta tensor, the model charged."""
    nq, d = q.shape[-2:]
    nd, L = codes.shape[-2:]
    lead = tuple(codes.shape[:-2])
    cost = costs.decompress_and_score_batched_cost(
        B=lead[0] if lead else 1, nd=nd, L=L, pd=packed_res.shape[-1], K=centroids.shape[0],
        d=d, nq=nq, nbits=nbits)
    return _build.dry_launch(name, cost, torch.empty((*lead, nd), device=q.device))


def decompress_and_score_batched(
    q: torch.Tensor,  # (B, nq, d) f32
    q_mask: torch.Tensor,  # (B, nq) f32
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    packed_res: torch.Tensor,  # (B, nd, L, pd) u8
    tok_valid: torch.Tensor,  # (B, nd, L) bool
    centroids: torch.Tensor,  # (K, d) f32
    weights: torch.Tensor,  # (2^nbits,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K2 -> (B, nd) f32 exact scores of pre-gathered finalist blocks."""
    global launches
    args = (q, q_mask, codes, packed_res, tok_valid, centroids, weights)
    if _build.on_meta(q):
        return _meta_score("decompress_and_score_batched", q, codes, packed_res, centroids, nbits)
    if not _build.on_card(q, "decompress_and_score_batched"):
        return ref.decompress_and_score_batched_ref(*args, nbits=nbits)
    out = _launch_score(*args, nbits)
    launches += 1
    return out


def decompress_and_score(
    q: torch.Tensor,  # (nq, d) f32
    q_mask: torch.Tensor,  # (nq,) f32
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    packed_res: torch.Tensor,  # (nd, L, pd) u8
    tok_valid: torch.Tensor,  # (nd, L) bool
    centroids: torch.Tensor,  # (K, d) f32
    weights: torch.Tensor,  # (2^nbits,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K6 -> (nd,) f32: K2 for one query, its arguments viewed as B=1."""
    global single_launches
    if _build.on_meta(q):
        return _meta_score("decompress_and_score", q, codes, packed_res, centroids, nbits)
    if not _build.on_card(q, "decompress_and_score"):
        return ref.decompress_and_score_ref(
            q, q_mask, codes, packed_res, tok_valid, centroids, weights, nbits=nbits
        )
    out = _launch_score(
        q[None], q_mask[None], codes[None], packed_res[None], tok_valid[None],
        centroids, weights, nbits,
    )
    single_launches += 1
    return out[0]


def decompress_residuals(
    packed: torch.Tensor,  # (n, pd) u8
    weights: torch.Tensor,  # (2^nbits,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K4 -> (n, pd * 8 // nbits) f32: ``weights[unpack(packed)]``, fields
    MSB-first."""
    global residual_launches
    if _build.on_meta(packed):
        n, pd = packed.shape
        return _build.dry_launch("decompress_residuals",
                                 costs.decompress_residuals_cost(n=n, pd=pd, nbits=nbits),
                                 torch.empty((n, pd * 8 // nbits), device=packed.device))
    if not _build.on_card(packed, "decompress_residuals"):
        return ref.decompress_residuals_ref(packed, weights, nbits=nbits)
    dev = packed.device
    if nbits not in (1, 2, 4):
        raise ValueError(f"unsupported nbits={nbits}")
    _build.check(packed, "packed", torch.uint8, (None, None), dev)
    n, pd = packed.shape
    if n >= 2**31:
        raise ValueError(f"packed has {n} rows; the kernel takes fewer than 2**31")
    _build.check(weights, "weights", torch.float32, (2**nbits,), dev)
    out = torch.empty((n, pd * 8 // nbits), dtype=torch.float32, device=dev)
    fn = _build.c_function("decompress", "plaid_decompress_residuals", 3, 3)
    _build.launch(fn, [packed, weights, out], [n, pd, nbits], dev)
    residual_launches += 1
    return out
