"""K2 wrapper: batched residual decompression + exact MaxSim (stage 4).

Kernel: ``csrc/decompress.cu``; replaces ``repro/kernels/decompress.py``
``decompress_and_score_batched_pallas``.  Plain version:
``ref.decompress_and_score_batched_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches made by this process (CPU calls are not launches)
launches = 0

#: queries per lane the kernel holds (8 warps x 8 running maxima)
MAX_NQ = 64


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
    """(B, nd) f32 exact scores of pre-gathered finalist blocks."""
    global launches
    dev = q.device
    if dev.type == "cpu":
        return ref.decompress_and_score_batched_ref(
            q, q_mask, codes, packed_res, tok_valid, centroids, weights, nbits=nbits
        )
    if dev.type != "cuda":
        raise ValueError(f"decompress_and_score_batched: unsupported device {dev}")
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
    fn = _build.c_function("decompress", "plaid_decompress_and_score_batched", 8, 6)
    _build.launch(
        fn,
        [q, q_mask, codes, packed_res, tok_valid, centroids, weights, out],
        [B, nq, d, nbits, nd, L],
        dev,
    )
    launches += 1
    return out
