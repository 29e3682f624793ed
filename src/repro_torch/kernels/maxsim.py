"""K1 wrapper: batched centroid interaction (stages 2 and 3) on the card.

Kernel: ``csrc/maxsim.cu``; replaces ``repro/kernels/maxsim.py``
``centroid_interaction_batched_pallas``.  Plain version:
``ref.centroid_interaction_batched_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches made by this process (CPU calls are not launches)
launches = 0


def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq) f32
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    keep: torch.Tensor,  # (B, K) bool
    q_mask: torch.Tensor,  # (B, nq) f32
) -> torch.Tensor:
    """(B, nd) f32: ``sum_i q_mask * max(0, max over valid kept tokens of
    S_cq[b, code, i])``."""
    global launches
    dev = s_cq.device
    if dev.type == "cpu":
        return ref.centroid_interaction_batched_ref(s_cq, codes, keep, q_mask)
    if dev.type != "cuda":
        raise ValueError(f"centroid_interaction_batched: unsupported device {dev}")
    B, K, nq = s_cq.shape
    nd, L = codes.shape[1:]
    _build.check(s_cq, "s_cq", torch.float32, (B, K, nq), dev)
    _build.check(codes, "codes", torch.int32, (B, nd, L), dev)
    _build.check(keep, "keep", torch.bool, (B, K), dev)
    _build.check(q_mask, "q_mask", torch.float32, (B, nq), dev)
    out = torch.empty((B, nd), dtype=torch.float32, device=dev)
    fn = _build.c_function("maxsim", "plaid_centroid_interaction_batched", 5, 5)
    _build.launch(fn, [s_cq, codes, keep, q_mask, out], [B, K, nq, nd, L], dev)
    launches += 1
    return out
