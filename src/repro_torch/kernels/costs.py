"""Per-kernel cost models of the Hopper kernels, and the tiered index's
host-to-device transfer model (the counterpart of ``repro.kernels.costs``).

Each kernel model has the reference's name and signature and returns a
dict:

* ``flops``: the reference's count for the same geometry (its MXU
  products; the stage-2/3 interaction's mask-weighted sum), so the two
  packages' planners count the same useful work;
* ``hbm_bytes``: the Hopper kernel's compulsory device traffic, the bytes
  its bound in ``chip_smoke.py`` counts: each input the kernel must read
  once and each output written once.  Where that depends on the data
  (the distinct score rows K1 gathers, the valid tokens K2 / K3 read, the
  distinct centroid rows they decompress against), the caller may pass
  what its data needs (``rows``, ``flags``, ``tokens``); left out, the
  model takes the most the shapes allow, as the dry-run's meta tensors
  carry no data;
* ``bound_ops``: the arithmetic that bound counts (one max a kept token
  and query, two operations a multiply-add of the exact MaxSim, ...).

``KERNEL_COSTS`` maps every kernel name of ``kernels.ops.launch_counts()``
to its model; the single-query kernels (K5, K6) take the batched model at
``B = 1``, as they are the batched kernels launched with one lane.  K7,
which the reference leaves unmodelled (its Pallas kernel is off the
retrieval pipeline), has one here: the port launches it on the encoder's
and the LM family's serving paths.  The reference builds its models on
the Pallas grids' block traffic (``launch.hlo_analysis.
pallas_block_traffic``); the Hopper kernels' grids differ, and their
compulsory traffic does not depend on the grid, so that counterpart is
not needed.

The kernels' meta paths (``launch.dryrun``) charge these models to the
active ``launch.meta_cost`` counter.
"""
from __future__ import annotations

_F32 = 4
_I32 = 4
_U8 = 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def decompress_residuals_cost(*, n: int, pd: int, nbits: int, row_block: int = 256) -> dict:
    """K4 (``kernels.decompress.decompress_residuals``): each packed byte
    read once, its ``8 / nbits`` f32 fields written once, the weight table;
    no arithmetic (a lookup), so no flops, as the reference counts."""
    nbytes = n * pd * (_U8 + (8 // nbits) * _F32) + (2**nbits) * _F32
    return dict(hbm_bytes=float(nbytes), flops=0.0, bound_ops=0.0)


def centroid_interaction_batched_cost(
    *, B: int, nd: int, L: int, K: int, nq: int, doc_block: int = 32,
    rows: int | None = None, flags: int | None = None, kept: int | None = None,
) -> dict:
    """K1 (K5 at ``B = 1``): every code slot (pads too), each distinct
    kept score row (``rows``, ``nq`` f32 each) and each distinct keep flag
    (``flags``; 0 for a null keep) once, q_mask and the output.
    ``bound_ops``: one max a (kept token, query) (``kept`` tokens) and the
    query sum of every candidate.  ``flops``: the reference's
    ``2 B nd L nq``, nd padded to its doc block."""
    cap = B * min(K, nd * L)
    rows = cap if rows is None else rows
    flags = cap if flags is None else flags
    kept = B * nd * L if kept is None else kept
    nbytes = B * nd * L * _I32 + rows * nq * _F32 + flags + B * nq * _F32 + B * nd * _F32
    nd_p = _ceil_div(nd, doc_block) * doc_block
    return dict(hbm_bytes=float(nbytes), flops=2.0 * B * nd_p * L * nq,
                bound_ops=float(kept * nq + B * nd * nq * 3))


def _stage4_bytes(tokens: int, rows: int, d: int, pd: int, nq: int, B: int, n_out: int) -> int:
    """The exact MaxSim's compulsory bytes: the valid tokens' codes and
    payload, each distinct centroid row once, the queries (and their mask)
    and the output."""
    return tokens * (_I32 + pd * _U8) + rows * d * _F32 + B * nq * (d + 1) * _F32 + n_out * _F32


def decompress_and_score_batched_cost(
    *, B: int, nd: int, L: int, pd: int, K: int, d: int, nq: int, nbits: int,
    doc_block: int = 8, tokens: int | None = None, rows: int | None = None,
) -> dict:
    """K2 (K6 at ``B = 1``) over pre-gathered (B, nd, L) blocks: the valid
    tokens (``tokens``) and their distinct centroid rows (``rows``), the
    queries, the output, and every slot's validity flag.  ``bound_ops``:
    ``2 nq d + nq`` a valid token.  ``flops``: the reference's
    ``2 B nd L d nq``, nd padded to its doc block."""
    tokens = B * nd * L if tokens is None else tokens
    rows = min(K, tokens) if rows is None else rows
    nbytes = _stage4_bytes(tokens, rows, d, pd, nq, B, B * nd) + B * nd * L
    nd_p = _ceil_div(nd, doc_block) * doc_block
    return dict(hbm_bytes=float(nbytes), flops=2.0 * B * nd_p * L * d * nq,
                bound_ops=2.0 * tokens * nq * d + tokens * nq)


def gather_decompress_maxsim_cost(
    *, B: int, n3: int, L: int, pd: int, K: int, d: int, nq: int, nbits: int,
    tokens: int | None = None, rows: int | None = None,
) -> dict:
    """K3, the fused stage-3-5 tail: K2's bytes read straight from the CSR
    token arrays (``tokens`` valid ones), plus each finalist's pid, start
    and length, and no validity flags.  ``flops``: the reference's
    ``2 B n3 L d nq``."""
    tokens = B * n3 * L if tokens is None else tokens
    rows = min(K, tokens) if rows is None else rows
    nbytes = _stage4_bytes(tokens, rows, d, pd, nq, B, B * n3) + 3 * B * n3 * _I32
    return dict(hbm_bytes=float(nbytes), flops=2.0 * B * n3 * L * d * nq,
                bound_ops=2.0 * tokens * nq * d + tokens * nq)


def unfused_stage345_cost(
    *, B: int, n3: int, L: int, pd: int, K: int, d: int, nq: int, nbits: int,
    doc_block: int = 8,
) -> dict:
    """The materialized stage-3-5 tail: the residual gather (read the
    finalists' CSR bytes, write the routed block), the codes / validity
    take-alongs (read and write each), then K2 reading them back."""
    gather_bytes = (2 * B * n3 * L * pd * _U8 + 2 * B * n3 * L * _I32
                    + 2 * B * n3 * L * _I32)
    kern = decompress_and_score_batched_cost(B=B, nd=n3, L=L, pd=pd, K=K, d=d, nq=nq,
                                             nbits=nbits, doc_block=doc_block)
    return dict(hbm_bytes=gather_bytes + kern["hbm_bytes"], flops=kern["flops"])


def fused_stage345_cost(*, B: int, n3: int, L: int, pd: int, K: int, d: int, nq: int,
                        nbits: int) -> dict:
    """The fused stage-3-5 tail: K3 alone, no intermediate."""
    c = gather_decompress_maxsim_cost(B=B, n3=n3, L=L, pd=pd, K=K, d=d, nq=nq, nbits=nbits)
    return dict(hbm_bytes=c["hbm_bytes"], flops=c["flops"])


def flash_attention_cost(*, B: int, S: int, H: int, Hkv: int, dh: int, causal: bool,
                         itemsize: int) -> dict:
    """K7: q, k, v read once and the output written once (``itemsize``
    bytes a value); ``4 B H S^2 dh`` flops for the two products, half of
    them under a causal mask."""
    nbytes = (2 * B * S * H * dh + 2 * B * S * Hkv * dh) * itemsize
    flops = 4.0 * B * H * S * S * dh * (0.5 if causal else 1.0)
    return dict(hbm_bytes=float(nbytes), flops=flops, bound_ops=flops)


#: every kernel of ``kernels.ops.launch_counts()`` -> its model
KERNEL_COSTS = {
    "centroid_interaction_batched": centroid_interaction_batched_cost,
    "centroid_interaction": centroid_interaction_batched_cost,
    "decompress_and_score_batched": decompress_and_score_batched_cost,
    "decompress_and_score": decompress_and_score_batched_cost,
    "gather_decompress_maxsim": gather_decompress_maxsim_cost,
    "decompress_residuals": decompress_residuals_cost,
    "flash_attention": flash_attention_cost,
}


# --------------------------------------------------------------------------
# host-to-device transfer (the tiered index)
# --------------------------------------------------------------------------
def tiered_transfer_cost(
    *, pool_docs: int, slice_tokens: int, pd: int, n3: int, B: int,
    p_cap: int | None = None, t_cap: int | None = None,
) -> dict:
    """Bus bytes of one tiered batch's candidate-slice copy
    (``core.tiered.TieredEngine``; its measured ``TransferStats`` must
    equal them, ``tests/test_torch_tiered.py``):

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
