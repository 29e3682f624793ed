"""Public kernel entry points with the engine's signatures (the counterpart
of ``repro.kernels.ops``), called by ``core.pipeline`` when
``SearchParams.impl == "cuda"``.

Each adapts the engine's arguments (defaults, dtypes, contiguity) and calls
its kernel wrapper, which dispatches by the tensors' device: the Hopper
kernel for CUDA tensors, the plain version for CPU tensors.  There is
deliberately no environment override: a switch that swapped the kernel for
its plain version on the card would hide the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decompress as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_score as _fs
from repro_torch.kernels import maxsim as _ms

__all__ = [
    "centroid_interaction_batched",
    "decompress_and_score_batched",
    "gather_decompress_maxsim",
    "launch_counts",
    "reset_launch_counts",
]

_WRAPPERS = {
    "centroid_interaction_batched": _ms,
    "decompress_and_score_batched": _dec,
    "gather_decompress_maxsim": _fs,
    "flash_attention": _fa,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel (the search kernels above and the
    encoder's attention, ``kernels.flash_attention``)."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq)
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    q_mask: torch.Tensor | None = None,  # (B, nq)
    keep_centroid: torch.Tensor | None = None,  # (B, K) bool
) -> torch.Tensor:
    """Stages 2/3 interaction; signature of ``pipeline.centroid_interaction_batched``."""
    B, K, nq = s_cq.shape
    dev = s_cq.device
    if q_mask is None:
        q_mask = torch.ones((B, nq), dtype=torch.float32, device=dev)
    if keep_centroid is None:
        keep_centroid = torch.ones((B, K), dtype=torch.bool, device=dev)
    return _ms.centroid_interaction_batched(
        s_cq.float().contiguous(),
        codes.to(torch.int32).contiguous(),
        keep_centroid.contiguous(),
        q_mask.float().contiguous(),
    )


def decompress_and_score_batched(
    q, q_mask, codes, packed_res, tok_valid, centroids, weights, *, nbits: int
) -> torch.Tensor:
    """Stage-4 exact scores of pre-gathered (B, nd, L) finalist blocks."""
    return _dec.decompress_and_score_batched(
        q.float().contiguous(),
        q_mask.float().contiguous(),
        codes.to(torch.int32).contiguous(),
        packed_res.contiguous(),
        tok_valid.contiguous(),
        centroids.float().contiguous(),
        weights.float().contiguous(),
        nbits=nbits,
    )


def gather_decompress_maxsim(
    qs, q_masks, final_pids, codes_tok, residuals_tok, doc_offsets, doc_lens,
    centroids, weights, *, nbits: int, doc_maxlen: int,
) -> torch.Tensor:
    """The fused stage-3-5 tail: (B, n3) exact scores straight off the CSR
    token arrays (``pid == -1`` lanes are the caller's to pin)."""
    return _fs.gather_decompress_maxsim(
        qs.float().contiguous(),
        q_masks.float().contiguous(),
        final_pids.to(torch.int32).contiguous(),
        codes_tok.contiguous(),
        residuals_tok.contiguous(),
        doc_offsets.contiguous(),
        doc_lens.contiguous(),
        centroids.float().contiguous(),
        weights.float().contiguous(),
        nbits=nbits,
        doc_maxlen=doc_maxlen,
    )
