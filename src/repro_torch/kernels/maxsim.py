"""K1 and K5 wrappers: centroid interaction (stages 2 and 3) on the card.

Kernel: ``csrc/maxsim.cu``.  K1 (``centroid_interaction_batched``) replaces
``repro/kernels/maxsim.py`` ``centroid_interaction_batched_pallas``; K5
(``centroid_interaction``, one query, for the ``_search`` oracle) replaces
``centroid_interaction_pallas`` and is the same kernel launched with B=1,
as the reference's single-query kernel is the B=1 case of the batched one.
Plain versions: ``ref.centroid_interaction_batched_ref`` /
``ref.centroid_interaction_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: K1 launches made by this process (CPU calls are not launches)
launches = 0
#: K5 launches (the single-query wrapper), counted apart from K1's
single_launches = 0


def _launch(s_cq, codes, keep, q_mask) -> torch.Tensor:
    """Check the (B, ...) arguments and launch the kernel -> (B, nd)."""
    dev = s_cq.device
    B, K, nq = s_cq.shape
    nd, L = codes.shape[1:]
    _build.check(s_cq, "s_cq", torch.float32, (B, K, nq), dev)
    _build.check(codes, "codes", torch.int32, (B, nd, L), dev)
    _build.check(keep, "keep", torch.bool, (B, K), dev)
    _build.check(q_mask, "q_mask", torch.float32, (B, nq), dev)
    out = torch.empty((B, nd), dtype=torch.float32, device=dev)
    fn = _build.c_function("maxsim", "plaid_centroid_interaction_batched", 5, 5)
    _build.launch(fn, [s_cq, codes, keep, q_mask, out], [B, K, nq, nd, L], dev)
    return out


def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq) f32
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    keep: torch.Tensor,  # (B, K) bool
    q_mask: torch.Tensor,  # (B, nq) f32
) -> torch.Tensor:
    """K1 -> (B, nd) f32: ``sum_i q_mask * max(0, max over valid kept
    tokens of S_cq[b, code, i])``."""
    global launches
    if not _build.on_card(s_cq, "centroid_interaction_batched"):
        return ref.centroid_interaction_batched_ref(s_cq, codes, keep, q_mask)
    out = _launch(s_cq, codes, keep, q_mask)
    launches += 1
    return out


def centroid_interaction(
    s_cq: torch.Tensor,  # (K, nq) f32
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    keep: torch.Tensor,  # (K,) bool
    q_mask: torch.Tensor,  # (nq,) f32
) -> torch.Tensor:
    """K5 -> (nd,) f32: K1 for one query, its arguments viewed as B=1."""
    global single_launches
    if not _build.on_card(s_cq, "centroid_interaction"):
        return ref.centroid_interaction_ref(s_cq, codes, keep, q_mask)
    out = _launch(s_cq[None], codes[None], keep[None], q_mask[None])
    single_launches += 1
    return out[0]
