"""K3 wrapper: fused gather -> decompress -> exact MaxSim (stage 3-5 tail).

Kernel: ``csrc/fused_score.cu``; replaces ``repro/kernels/fused_score.py``
``gather_decompress_maxsim_pallas``.  Plain version:
``ref.gather_decompress_maxsim_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels import ref
from repro_torch.kernels.decompress import MAX_NQ, passages_per_block

#: kernel launches made by this process (CPU calls are not launches)
launches = 0


def gather_decompress_maxsim(
    qs: torch.Tensor,  # (B, nq, d) f32
    q_masks: torch.Tensor,  # (B, nq) f32
    final_pids: torch.Tensor,  # (B, n3) i32, -1 pad
    codes_tok: torch.Tensor,  # (Nt,) i32
    residuals_tok: torch.Tensor,  # (Nt, pd) u8
    doc_offsets: torch.Tensor,  # (Nd+1,) i32
    doc_lens: torch.Tensor,  # (Nd,) i32
    centroids: torch.Tensor,  # (K, d) f32
    weights: torch.Tensor,  # (2^nbits,) f32
    *,
    nbits: int,
    doc_maxlen: int,
) -> torch.Tensor:
    """(B, n3) f32 exact scores of the finalists, read straight from the
    CSR token arrays (``doc_maxlen`` sizes only the plain version's block)."""
    global launches
    if _build.on_meta(qs):
        B, nq, d = qs.shape
        n3 = final_pids.shape[1]
        cost = costs.gather_decompress_maxsim_cost(
            B=B, n3=n3, L=doc_maxlen, pd=residuals_tok.shape[1], K=centroids.shape[0], d=d,
            nq=nq, nbits=nbits)
        return _build.dry_launch("gather_decompress_maxsim", cost,
                                 torch.empty((B, n3), device=qs.device))
    if not _build.on_card(qs, "gather_decompress_maxsim"):
        return ref.gather_decompress_maxsim_ref(
            qs, q_masks, final_pids, codes_tok, residuals_tok, doc_offsets,
            doc_lens, centroids, weights, nbits=nbits, doc_maxlen=doc_maxlen,
        )
    dev = qs.device
    B, nq, d = qs.shape
    n3 = final_pids.shape[1]
    nt = codes_tok.shape[0]
    nd = doc_lens.shape[0]
    if nbits not in (1, 2, 4) or d % (8 // nbits) or not 0 < nq <= MAX_NQ:
        raise ValueError(f"unsupported nbits={nbits}, d={d}, nq={nq}")
    _build.check(qs, "qs", torch.float32, (B, nq, d), dev)
    _build.check(q_masks, "q_masks", torch.float32, (B, nq), dev)
    _build.check(final_pids, "final_pids", torch.int32, (B, n3), dev)
    _build.check(codes_tok, "codes_tok", torch.int32, (nt,), dev)
    _build.check(residuals_tok, "residuals_tok", torch.uint8, (nt, d * nbits // 8), dev)
    _build.check(doc_offsets, "doc_offsets", torch.int32, (nd + 1,), dev)
    _build.check(doc_lens, "doc_lens", torch.int32, (nd,), dev)
    _build.check(centroids, "centroids", torch.float32, (None, d), dev)
    _build.check(weights, "weights", torch.float32, (2**nbits,), dev)
    out = torch.empty((B, n3), dtype=torch.float32, device=dev)
    fn = _build.c_function("fused_score", "plaid_gather_decompress_maxsim", 10, 6)
    _build.launch(
        fn,
        [qs, q_masks, final_pids, codes_tok, residuals_tok, doc_offsets,
         doc_lens, centroids, weights, out],
        [B, nq, d, nbits, n3, passages_per_block(B, n3)],
        dev,
    )
    launches += 1
    return out
