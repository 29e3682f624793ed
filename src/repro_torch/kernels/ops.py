"""Public kernel entry points with the engine's signatures (the counterpart
of ``repro.kernels.ops``), called by ``core.pipeline`` and ``core.plaid``
(``_search``) when ``SearchParams.impl == "cuda"`` and by ``core.vanilla``
when ``VanillaParams.impl == "cuda"``.

Each adapts the engine's arguments (defaults, dtypes, contiguity) and calls
its kernel wrapper, which dispatches by the tensors' device: the Hopper
kernel for CUDA tensors, the plain version for CPU tensors, and, for
``meta`` tensors (the dry-run), the kernel's cost model and an empty
result.  There is
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
    "centroid_interaction",
    "centroid_interaction_batched",
    "decompress_residuals",
    "decompress_and_score",
    "decompress_and_score_batched",
    "gather_decompress_maxsim",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel name -> (wrapper module, its launch counter)
_COUNTERS = {
    "centroid_interaction_batched": (_ms, "launches"),
    "decompress_and_score_batched": (_dec, "launches"),
    "gather_decompress_maxsim": (_fs, "launches"),
    "flash_attention": (_fa, "launches"),
    "decompress_residuals": (_dec, "residual_launches"),
    "centroid_interaction": (_ms, "single_launches"),
    "decompress_and_score": (_dec, "single_launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel (the search kernels above, their
    single-query forms, K4 and the encoder's attention,
    ``kernels.flash_attention``)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def _as(t: torch.Tensor | None, dtype=None) -> torch.Tensor | None:
    """``t`` as a contiguous tensor of ``dtype`` (its own when ``None``):
    ``t`` itself when it already is one, so a call that needs no copy makes
    no call into torch."""
    if t is None or ((dtype is None or t.dtype == dtype) and t.is_contiguous()):
        return t
    return t.to(dtype or t.dtype).contiguous()


def centroid_interaction(
    s_cq: torch.Tensor,  # (K, nq)
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    q_mask: torch.Tensor | None = None,  # (nq,)
    keep_centroid: torch.Tensor | None = None,  # (K,) bool
) -> torch.Tensor:
    """Single-query stages 2/3 (K5); signature of ``scoring.centroid_interaction``.
    ``None`` for ``q_mask`` / ``keep_centroid`` reaches the kernel as a null
    pointer (all ones / keep all): nothing is allocated or filled."""
    return _ms.centroid_interaction(
        _as(s_cq, torch.float32), _as(codes, torch.int32), _as(keep_centroid),
        _as(q_mask, torch.float32),
    )


def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq)
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    q_mask: torch.Tensor | None = None,  # (B, nq)
    keep_centroid: torch.Tensor | None = None,  # (B, K) bool
) -> torch.Tensor:
    """Stages 2/3 interaction; signature of ``pipeline.centroid_interaction_batched``.
    ``None`` for ``q_mask`` / ``keep_centroid`` (stage 3 keeps every
    centroid) reaches the kernel as a null pointer."""
    return _ms.centroid_interaction_batched(
        _as(s_cq, torch.float32), _as(codes, torch.int32), _as(keep_centroid),
        _as(q_mask, torch.float32),
    )


def decompress_residuals(
    packed: torch.Tensor, weights: torch.Tensor, *, nbits: int
) -> torch.Tensor:
    """K4: (..., pd) u8 -> (..., pd * 8 // nbits) f32 residuals; any leading
    dims, flattened into one launch."""
    lead = packed.shape[:-1]
    flat = packed.reshape(-1, packed.shape[-1]).contiguous()
    out = _dec.decompress_residuals(flat, weights.float().contiguous(), nbits=nbits)
    return out.reshape(*lead, out.shape[-1])


def decompress_and_score(
    q, q_mask, codes, packed_res, tok_valid, centroids, weights, *, nbits: int
) -> torch.Tensor:
    """Single-query stage-4 exact scores (K6) of a pre-gathered (nd, L) block."""
    return _dec.decompress_and_score(
        q.float().contiguous(),
        q_mask.float().contiguous(),
        codes.to(torch.int32).contiguous(),
        packed_res.contiguous(),
        tok_valid.contiguous(),
        centroids.float().contiguous(),
        weights.float().contiguous(),
        nbits=nbits,
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
