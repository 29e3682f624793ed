"""Plain PyTorch scoring ops shared by the engine and the kernels' plain
versions (the counterpart of ``repro.core.scoring``).

All shapes are fixed by their callers; the ``-1`` sentinel marks padded
candidate slots / padded tokens.  Every gather indexes in range: masked
slots are pointed at row 0 first and overwritten afterwards (torch, unlike
``jnp``, faults on an out-of-range index).

Two helpers stand in for what ``jax`` gives for free:

* :func:`stable_topk` — ``jax.lax.top_k`` breaks ties toward the lower
  index; ``torch.topk`` leaves tie order unspecified.
* :func:`unique_sized` — ``jnp.unique(size=, fill_value=)``, row-wise.

Two more fix an order of float32 arithmetic so that the CUDA kernels and
their plain versions agree bit for bit (equal scores rank equally, so the
``plaid`` and ``plaid-cuda`` backends return identical pids):

* :func:`lane_tree_sum` — the kernels' 32-lane butterfly sum;
* :func:`dot_in_order` — a dot product accumulated over the feature axis in
  index order, one rounded multiply and one rounded add per term.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import ieee_f32_matmul
from repro_torch.constants import NEG


def maxsim(q, d, q_mask=None, d_mask=None) -> torch.Tensor:
    """Exact late-interaction score, Eq. 1:  sum_i max_j  Q_i . D_j.

    q: (nq, dim); d: (nd, ldoc, dim); masks broadcastable to (nq,)/(nd, ldoc).
    Returns (nd,) scores.
    """
    with ieee_f32_matmul():
        scores = torch.einsum("qd,ntd->nqt", q, d)  # (nd, nq, ldoc)
    if d_mask is not None:
        scores = torch.where(d_mask[:, None, :], scores, NEG)
    per_q = scores.amax(dim=-1)  # (nd, nq)
    if q_mask is not None:
        per_q = per_q * q_mask[None, :]
    return per_q.sum(dim=-1)


def centroid_scores(
    q: torch.Tensor,
    centroids: torch.Tensor,
    dtype=torch.float32,
    *,
    operand_dtype: str = "float32",
    centroids_q: torch.Tensor | None = None,
    centroids_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Stage-1 score matrix ``S_cq = C . Q^T`` for one query, as (K, nq).

    ``operand_dtype`` lowers the matmul operand precision with float32
    accumulation: ``"bfloat16"`` rounds both operands to bf16 (their
    products are exact in f32); ``"int8"`` uses the index's quantized table
    and rescales after the dot.
    """
    qf = q.float()
    if operand_dtype == "int8" and (centroids_q is None or centroids_scale is None):
        raise ValueError(
            "operand_dtype='int8' needs centroids_q/centroids_scale "
            "(index.quantize_centroids tables)"
        )
    with ieee_f32_matmul():
        if operand_dtype == "float32":
            out = centroids.float() @ qf.T
        elif operand_dtype == "bfloat16":
            out = centroids.bfloat16().float() @ qf.bfloat16().float().T
        elif operand_dtype == "int8":
            out = (centroids_q.float() @ qf.T) * centroids_scale[:, None]
        else:
            raise ValueError(f"unknown operand_dtype: {operand_dtype!r}")
    return out.to(dtype)


def centroid_interaction(
    s_cq: torch.Tensor,  # (K, nq)
    codes: torch.Tensor,  # (nd, ldoc) i32, -1 pad
    q_mask: torch.Tensor | None = None,  # (nq,)
    keep_centroid: torch.Tensor | None = None,  # (K,) bool
) -> torch.Tensor:
    """Approximate MaxSim with centroids as token proxies (paper Eq. 3-4);
    with ``keep_centroid``, tokens on pruned centroids are skipped (Eq. 5).
    Returns (nd,) approximate scores."""
    valid = codes >= 0
    safe = torch.where(valid, codes, 0).long()
    tok_scores = s_cq[safe]  # (nd, ldoc, nq)
    if keep_centroid is not None:
        valid = valid & keep_centroid[safe]
    tok_scores = torch.where(valid[..., None], tok_scores, NEG)
    per_q = tok_scores.amax(dim=1).float().clamp(min=0.0)  # (nd, nq)
    if q_mask is not None:
        per_q = per_q * q_mask[None, :]
    return per_q.sum(dim=-1)


def prune_mask(s_cq: torch.Tensor, t_cs) -> torch.Tensor:
    """bool: centroid survives iff its best query-token score >= t_cs.

    The comparison runs in float32 whatever the score dtype, as the
    reference's promotion against its f32 threshold does.
    """
    t = torch.as_tensor(t_cs, dtype=torch.float32, device=s_cq.device)
    return s_cq.amax(dim=-1).float() >= t


def gather_doc_tokens(
    values: torch.Tensor,  # (Nt, ...) packed per-token payload
    doc_offsets: torch.Tensor,  # (Nd+1,)
    doc_lens: torch.Tensor,  # (Nd,)
    pids: torch.Tensor,  # (nd,) candidate ids, -1 = pad
    doc_maxlen: int,
    fill,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather packed per-token payload into a (nd, doc_maxlen, ...) block;
    slots past a passage's length (and whole ``-1`` rows) hold ``fill``.
    Returns ``(block, valid)``."""
    ok = pids >= 0
    safe_pid = torch.where(ok, pids, 0).long()
    start = doc_offsets[safe_pid].long()
    lens = torch.where(ok, doc_lens[safe_pid], 0)
    pos = torch.arange(doc_maxlen, device=pids.device)
    valid = pos[None, :] < lens[:, None]
    tok_idx = torch.where(valid, start[:, None] + pos[None, :], 0)
    out = values[tok_idx]
    mask = valid.reshape(valid.shape + (1,) * (out.ndim - 2))
    return out.masked_fill(~mask, fill), valid


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, ties toward the lower index.

    Exactly ``jax.lax.top_k``'s order: descending value (``+0.0`` above
    ``-0.0``, as there), then ascending index.  Each float is mapped to an
    order-preserving int32 and combined with its reversed position into one
    int64 key, so ``torch.topk`` has no ties left to break (a full stable
    sort of stage 1's (B, nq, K) scores would cost several GB at K = 2^18).
    Returns ``(values, int64 indices)``.
    """
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # float order as int order
    rev_pos = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    key = ordered.long() * (1 << 32) + rev_pos
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return x.gather(-1, idx), idx


def unique_sized(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Row-wise ``jnp.unique(row, size=size, fill_value=fill)``.

    Each row of ``x`` (..., n) becomes its sorted distinct values, truncated
    to the ``size`` smallest and padded with ``fill``.  Output (..., size),
    dtype of ``x``.
    """
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    s = torch.sort(rows, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(first, dim=-1) - 1
    slot = torch.where(first & (rank < size), rank, size)  # `size` = discard
    out = torch.full((rows.shape[0], size + 1), fill, dtype=x.dtype, device=x.device)
    out.scatter_(1, slot, s)
    return out[:, :size].reshape(*lead, size)


def lane_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the CUDA kernels' order.

    The axis is cut into groups of 32 (zero-padded); each group is reduced
    by the warp butterfly ``v[i] + v[i ^ w]`` for w = 16, 8, 4, 2, 1, and the
    group sums are added in group order.  Float32 addition is commutative,
    so this reproduces the kernels' ``__shfl_xor_sync`` reduction exactly.
    """
    n = x.shape[-1]
    groups = -(-n // 32)
    if groups * 32 != n:
        x = F.pad(x, (0, groups * 32 - n))
    x = x.reshape(*x.shape[:-1], groups, 32)
    w = 32
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w : 2 * w]
    x = x[..., 0]
    total = x[..., 0]
    for g in range(1, groups):
        total = total + x[..., g]
    return total


def dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_j a[..., j, :] * b[..., j, :]`` accumulated for j = 0, 1, ...

    ``a`` and ``b`` hold the feature axis second to last and broadcast
    against each other elsewhere.  Each term is one rounded f32 multiply
    and one rounded add (no fused multiply-add), the CUDA kernels' order.
    """
    shape = torch.broadcast_shapes(a[..., 0, :].shape, b[..., 0, :].shape)
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for j in range(a.shape[-2]):
        acc.add_(a[..., j, :] * b[..., j, :])
    return acc
