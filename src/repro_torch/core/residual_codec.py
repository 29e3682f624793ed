"""ColBERTv2 residual codec: b-bit bucket quantization of (vector - centroid).

Each token embedding ``v`` is stored as ``(code, packed_residual)`` where
``code`` is the id of its nearest centroid and the residual ``r = v -
centroids[code]`` is quantized per dimension into ``2**nbits`` buckets.
Bucket boundaries (``cutoffs``) are quantiles of the residual distribution;
reconstruction values (``weights``) are the midpoints-in-probability of each
bucket.  ``8 // nbits`` bucket indices are packed per byte, most-significant
bits first — the layout of ``repro.core.residual_codec``, so payloads are
interchangeable between the two packages.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import ieee_f32_matmul

SUPPORTED_NBITS = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class ResidualCodec:
    """Quantization tables."""

    cutoffs: torch.Tensor  # (2**nbits - 1,) ascending bucket boundaries
    weights: torch.Tensor  # (2**nbits,)     reconstruction value per bucket
    nbits: int = 2


def _linear_quantiles(flat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """numpy/JAX ``method="linear"`` quantiles of a 1-D f32 tensor.

    Computed from one sort with the reference's float32 position arithmetic
    (``q * (f32(n) - 1)``, floor/ceil, complementary weights; above 2**24
    elements ``f32(n)`` rounds, and so does the reference).  ``torch.quantile``
    is not used: it refuses inputs above 2**24 elements.

    The interpolation is rounded as XLA rounds ``jnp.quantile``'s
    ``low * w_low + high * w_high``: ``fma(high, w_high, f32(low * w_low))``.
    The product of two f32 values is exact in f64, so only the final sum is
    rounded twice (f64, then f32).
    """
    a = torch.sort(flat).values
    n = a.shape[0]
    n_f32 = torch.tensor(float(n), dtype=torch.float32, device=q.device)
    pos = q * (n_f32 - 1.0)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low_i = low.clamp(0, n - 1).long()
    high_i = high.clamp(0, n - 1).long()
    low_part = (a[low_i] * low_w).double()
    return (a[high_i].double() * high_w.double() + low_part).float()


def fit_codec(residuals: torch.Tensor, nbits: int) -> ResidualCodec:
    """Estimate bucket cutoffs/weights from a sample of residuals.

    Matches ColBERTv2: cutoffs are the (i/2^b)-quantiles for i in 1..2^b-1;
    weights are the ((i + .5)/2^b)-quantiles for i in 0..2^b-1.
    """
    if nbits not in SUPPORTED_NBITS:
        raise ValueError(f"nbits must be one of {SUPPORTED_NBITS}, got {nbits}")
    flat = residuals.reshape(-1).float()
    nb = 2**nbits
    dev = flat.device
    cut_q = torch.arange(1, nb, dtype=torch.float32, device=dev) / nb
    w_q = (torch.arange(nb, dtype=torch.float32, device=dev) + 0.5) / nb
    return ResidualCodec(
        cutoffs=_linear_quantiles(flat, cut_q),
        weights=_linear_quantiles(flat, w_q),
        nbits=nbits,
    )


def bucketize(codec: ResidualCodec, residuals: torch.Tensor) -> torch.Tensor:
    """Map residual floats -> bucket indices in [0, 2**nbits) (uint8)."""
    cutoffs = codec.cutoffs.to(residuals.device, residuals.dtype)
    return torch.searchsorted(cutoffs, residuals.contiguous(), right=True).to(
        torch.uint8
    )


def _shifts(nbits: int, device) -> torch.Tensor:
    vpb = 8 // nbits
    return torch.arange(vpb - 1, -1, -1, dtype=torch.int32, device=device) * nbits


def pack_indices(indices: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack b-bit indices along the last axis into uint8, MSB-first.

    indices: (..., dim) uint8 with values < 2**nbits; dim % (8//nbits) == 0.
    returns: (..., dim * nbits // 8) uint8.
    """
    vpb = 8 // nbits
    *lead, dim = indices.shape
    if dim % vpb:
        raise ValueError(f"dim {dim} not divisible by values-per-byte {vpb}")
    grouped = indices.reshape(*lead, dim // vpb, vpb).to(torch.int32)
    packed = (grouped << _shifts(nbits, indices.device)).sum(dim=-1)
    return packed.to(torch.uint8)


def unpack_indices(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse of :func:`pack_indices`: (..., pd) uint8 -> (..., pd*8/nbits)."""
    vpb = 8 // nbits
    mask = 2**nbits - 1
    vals = (packed[..., None].to(torch.int32) >> _shifts(nbits, packed.device)) & mask
    return vals.reshape(*packed.shape[:-1], packed.shape[-1] * vpb).to(torch.uint8)


def compress_residuals(codec: ResidualCodec, residuals: torch.Tensor) -> torch.Tensor:
    """residuals (..., dim) float -> packed (..., dim*nbits//8) uint8."""
    return pack_indices(bucketize(codec, residuals), codec.nbits)


def decompress_residuals(codec: ResidualCodec, packed: torch.Tensor) -> torch.Tensor:
    """packed (..., dim*nbits//8) uint8 -> residuals (..., dim) float32."""
    idx = unpack_indices(packed, codec.nbits).long()
    return codec.weights.to(packed.device, torch.float32)[idx]


def compress(
    codec: ResidualCodec, embeddings: torch.Tensor, centroids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full encode: embeddings (n, d) -> (codes (n,) i32, packed (n, d*b/8))."""
    codes = assign_codes(embeddings, centroids)
    residuals = embeddings.float() - centroids.float()[codes.long()]
    return codes, compress_residuals(codec, residuals)


def decompress(
    codec: ResidualCodec,
    codes: torch.Tensor,
    packed: torch.Tensor,
    centroids: torch.Tensor,
) -> torch.Tensor:
    """Reconstruct embeddings: centroids[codes] + dequantized residual."""
    return centroids.float()[codes.long()] + decompress_residuals(codec, packed)


def assign_codes(embeddings: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (true L2), chunk-free: callers chunk.

    ``||e - c||^2 = ||e||^2 - 2 e.c + ||c||^2``; ``||e||^2`` is constant per
    row.  ``argmin`` returns the first minimum, as ``jnp.argmin`` does.
    """
    c = centroids.float()
    with ieee_f32_matmul():
        dots = embeddings.float() @ c.T
    c_sq = (c * c).sum(dim=-1)
    return torch.argmin(c_sq[None, :] - 2.0 * dots, dim=-1).to(torch.int32)
