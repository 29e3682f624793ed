"""Plain PyTorch versions of every ported kernel, for any device.

Each search kernel's function (K1-K3, and K5/K6, their single-query B=1
forms) computes what its CUDA kernel computes, in the kernel's order of
float32 arithmetic (``scoring.lane_tree_sum``, ``scoring.dot_in_order``),
so that on the card a kernel and its plain version agree bit for bit.  K4
(``decompress_residuals_ref``) is a table lookup and agrees exactly.  K7's
(``flash_attention_ref``) repeats the reference's math on one whole-S tile
and agrees with its kernel to a stated tolerance.  The
wrappers run these for CPU tensors; ``chip_smoke.py`` and the GPU tests call
them directly to hold the kernels against them.

The engine's ``impl="ref"`` path uses the same functions, so the ``plaid``
and ``plaid-cuda`` backends rank identically.  K1's and K7's work is cut
into chunks of lanes so the largest intermediates stay near
``_CHUNK_ELEMS`` elements, and K2's runs one lane at a time over its valid
tokens; results do not depend on the chunking.
"""
from __future__ import annotations

import torch

from repro_torch import ieee_f32_matmul
from repro_torch.constants import NEG
from repro_torch.core import residual_codec as rc
from repro_torch.core import scoring

#: the reference K7's mask value (``repro/kernels/flash_attention.py`` ``NEG``)
FLASH_NEG = -1e30

#: element budget of one chunk's largest intermediate (2^27 f32 = 512 MiB)
_CHUNK_ELEMS = 1 << 27


def _lane_chunks(B: int, elems_per_lane: int):
    step = max(1, _CHUNK_ELEMS // max(elems_per_lane, 1))
    for b0 in range(0, B, step):
        yield slice(b0, min(b0 + step, B))


def centroid_interaction_batched_ref(
    s_cq: torch.Tensor,  # (B, K, nq) f32 or bf16
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    keep: torch.Tensor | None,  # (B, K) bool
    q_mask: torch.Tensor | None,  # (B, nq) f32
) -> torch.Tensor:
    """K1: ``sum_i q_mask[b,i] * max(0, max_t S_cq[b, code_t, i])`` over
    valid, kept tokens -> (B, nd) f32."""
    B, nd, L = codes.shape
    nq = s_cq.shape[2]
    out = torch.empty((B, nd), dtype=torch.float32, device=codes.device)
    for sl in _lane_chunks(B, nd * L * nq):
        c = codes[sl]
        nb = c.shape[0]
        valid = c >= 0
        safe = torch.where(valid, c, 0).long().reshape(nb, nd * L)
        lane = torch.arange(nb, device=c.device)[:, None]
        tok = s_cq[sl][lane, safe].reshape(nb, nd, L, nq)
        if keep is not None:
            valid = valid & keep[sl][lane, safe].reshape(nb, nd, L)
        tok = torch.where(valid[..., None], tok, NEG)
        per_q = tok.amax(dim=2).float().clamp(min=0.0)  # (nb, nd, nq)
        if q_mask is not None:
            per_q = per_q * q_mask[sl][:, None, :]
        out[sl] = scoring.lane_tree_sum(per_q)
    return out


def centroid_interaction_ref(
    s_cq: torch.Tensor,  # (K, nq)
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    keep: torch.Tensor | None,  # (K,) bool
    q_mask: torch.Tensor | None,  # (nq,) f32
) -> torch.Tensor:
    """K5: K1 for one query -> (nd,) f32."""
    return centroid_interaction_batched_ref(
        s_cq[None], codes[None],
        None if keep is None else keep[None],
        None if q_mask is None else q_mask[None],
    )[0]


def decompress_residuals_ref(
    packed: torch.Tensor,  # (..., pd) u8
    weights: torch.Tensor,  # (2^b,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K4: ``weights[unpack(packed)]``, fields MSB-first -> (..., pd*8/b) f32."""
    return weights.float()[rc.unpack_indices(packed, nbits).long()]


def decompress_and_score_batched_ref(
    q: torch.Tensor,  # (B, nq, d) f32
    q_mask: torch.Tensor,  # (B, nq) f32
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    packed_res: torch.Tensor,  # (B, nd, L, pd) u8
    tok_valid: torch.Tensor,  # (B, nd, L) bool
    centroids: torch.Tensor,  # (K, d) f32
    weights: torch.Tensor,  # (2^b,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K2: exact MaxSim over decompressed tokens -> (B, nd) f32.

    ``emb = centroids[code] + weights[idx]``; invalid tokens score ``NEG``;
    max over tokens, then ``sum_i q_mask * max`` (no 0-clamp).  One lane at
    a time, only its valid tokens are decompressed and scored (as the
    kernel streams them); the max is exact, so where they are scored does
    not change a bit.
    """
    B, nd, L = codes.shape
    nq = q.shape[1]
    cents = centroids.float()
    w = weights.float()
    out = torch.empty((B, nd), dtype=torch.float32, device=codes.device)
    for b in range(B):
        rows = tok_valid[b].reshape(-1).nonzero().squeeze(1)  # slot * L + token
        code = codes[b].reshape(-1)[rows]
        resid = decompress_residuals_ref(packed_res[b].reshape(nd * L, -1)[rows], w, nbits=nbits)
        emb_t = (cents[torch.where(code >= 0, code, 0).long()] + resid).T.contiguous()
        # (Nv, d, 1) . (d, nq) over d -> (Nv, nq); dim j's column contiguous
        scores = scoring.dot_in_order(emb_t.T[:, :, None], q[b].float().T)
        full = torch.full((nd * L, nq), NEG, dtype=torch.float32, device=codes.device)
        full[rows] = scores
        per_q = full.view(nd, L, nq).amax(dim=1) * q_mask[b].float()[None, :]
        out[b] = scoring.lane_tree_sum(per_q)
    return out


def decompress_and_score_ref(
    q: torch.Tensor,  # (nq, d) f32
    q_mask: torch.Tensor,  # (nq,) f32
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    packed_res: torch.Tensor,  # (nd, L, pd) u8
    tok_valid: torch.Tensor,  # (nd, L) bool
    centroids: torch.Tensor,  # (K, d) f32
    weights: torch.Tensor,  # (2^b,) f32
    *,
    nbits: int,
) -> torch.Tensor:
    """K6: K2 for one query -> (nd,) f32."""
    return decompress_and_score_batched_ref(
        q[None], q_mask[None], codes[None], packed_res[None], tok_valid[None],
        centroids, weights, nbits=nbits,
    )[0]


def gather_decompress_maxsim_ref(
    qs: torch.Tensor,  # (B, nq, d)
    q_masks: torch.Tensor,  # (B, nq)
    final_pids: torch.Tensor,  # (B, n3) i32, -1 pad
    codes_tok: torch.Tensor,  # (Nt,) i32
    residuals_tok: torch.Tensor,  # (Nt, pd) u8
    doc_offsets: torch.Tensor,  # (Nd+1,)
    doc_lens: torch.Tensor,  # (Nd,)
    centroids: torch.Tensor,  # (K, d)
    weights: torch.Tensor,  # (2^b,)
    *,
    nbits: int,
    doc_maxlen: int,
) -> torch.Tensor:
    """K3: gather each finalist's codes and residual rows from the CSR token
    arrays, then K2's math -> (B, n3) f32.  A ``pid == -1`` lane has no
    tokens and scores ``sum_i NEG * q_mask[b, i]``."""
    B, n3 = final_pids.shape
    flat = final_pids.reshape(-1)
    codes_blk, tok_valid = scoring.gather_doc_tokens(
        codes_tok, doc_offsets, doc_lens, flat, doc_maxlen, fill=-1
    )
    res_blk, _ = scoring.gather_doc_tokens(
        residuals_tok, doc_offsets, doc_lens, flat, doc_maxlen, fill=0
    )
    return decompress_and_score_batched_ref(
        qs,
        q_masks,
        codes_blk.reshape(B, n3, doc_maxlen),
        res_blk.reshape(B, n3, doc_maxlen, -1),
        tok_valid.reshape(B, n3, doc_maxlen),
        centroids,
        weights,
        nbits=nbits,
    )


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, S, Hkv, dh)
    v: torch.Tensor,  # (B, S, Hkv, dh)
    *,
    causal: bool,
) -> torch.Tensor:
    """K7: the reference kernel's online softmax over one whole-S tile, in
    f32 -> (B, S, H, dh) in ``q``'s dtype.

    Query head ``h`` reads KV head ``h // (H // Hkv)``.  With one tile the
    state update is ``m = max(NEG, rowmax s)``, ``p = exp(s - m)``,
    ``l = sum p``, ``acc = p v`` (``p`` in f32); masked keys score ``NEG``
    and the output is ``acc / max(l, 1e-20)``.  The CUDA kernel walks 64-key
    tiles, so its sums are rounded in another order.

    Rows are independent, so the work is split into blocks of lanes, heads
    and query rows of at most ``_CHUNK_ELEMS`` scores each (an LM prefill's
    S = 32,768 takes 4,096 rows of one head a block).  A causal block reads
    the keys up to its last row only: the keys past it score ``NEG`` and
    add ``exp(NEG - m) = 0``, as every row keeps key 0.
    """
    B, S, H, dh = q.shape
    g = H // k.shape[2]
    scale = dh**-0.5
    out = torch.empty_like(q)
    for sl in _lane_chunks(B, H * S * S):
        nb = sl.stop - sl.start
        hs = max(1, min(H, _CHUNK_ELEMS // (nb * S * S)))
        rs = S if nb * hs * S * S <= _CHUNK_ELEMS else max(1, _CHUNK_ELEMS // (nb * hs * S))
        for h0 in range(0, H, hs):
            heads = torch.arange(h0, min(h0 + hs, H), device=q.device)
            for r0 in range(0, S, rs):
                r1 = min(r0 + rs, S)
                n = r1 if causal else S
                qf = q[sl, r0:r1, h0 : h0 + hs].float().transpose(1, 2)  # (nb, hh, R, dh)
                kf = k[sl, :n][:, :, heads // g].float().transpose(1, 2)  # (nb, hh, n, dh)
                vf = v[sl, :n][:, :, heads // g].float().transpose(1, 2)
                with ieee_f32_matmul():
                    s = (qf @ kf.transpose(-1, -2)) * scale  # (nb, hh, R, n)
                if causal:
                    qpos = torch.arange(r0, r1, device=q.device)
                    kpos = torch.arange(n, device=q.device)
                    s = torch.where(qpos[:, None] >= kpos[None, :], s, FLASH_NEG)
                m = s.amax(dim=-1, keepdim=True).clamp(min=FLASH_NEG)
                p = torch.exp(s - m)
                del s
                l = p.sum(dim=-1, keepdim=True)
                with ieee_f32_matmul():
                    acc = p @ vf
                out[sl, r0:r1, h0 : h0 + hs] = (acc / l.clamp(min=1e-20)).transpose(1, 2).to(q.dtype)
    return out
