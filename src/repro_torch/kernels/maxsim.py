"""K1 and K5 wrappers: centroid interaction (stages 2 and 3) on the card.

Kernel: ``csrc/maxsim.cu``.  K1 (``centroid_interaction_batched``) replaces
``repro/kernels/maxsim.py`` ``centroid_interaction_batched_pallas``; K5
(``centroid_interaction``, one query, for the ``_search`` oracle) replaces
``centroid_interaction_pallas`` and is the same kernel launched with B=1,
as the reference's single-query kernel is the B=1 case of the batched one.
A warp scores ``per_warp`` consecutive candidates: it loads the codes of a
whole passage at once, four to a lane (and the next passage's while it
scores this one), issues all its keep lookups, compacts the live codes,
and gathers their score rows many at a time (16 rows a load round at
nq = 32); a passage with no live token takes the lane's precomputed empty
score.  ``keep`` and ``q_mask`` may be ``None`` (keep every centroid, weigh
every query 1): the kernel then reads no flags and does no multiply.
Plain versions: ``ref.centroid_interaction_batched_ref`` /
``ref.centroid_interaction_ref``, equal to the kernel bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels import ref

#: K1 launches made by this process (CPU calls are not launches)
launches = 0
#: K5 launches (the single-query wrapper), counted apart from K1's
single_launches = 0

#: a warp scores B * nd // WARP_CANDIDATES consecutive candidates, at least
#: 1 and at most MAX_PER_WARP: K5's 8192 candidates take 2 a warp (under
#: one wave of warps), stage 2's 262,144 take 8 (PERF.md)
MAX_PER_WARP, WARP_CANDIDATES = 8, 4096


def per_warp(B: int, nd: int) -> int:
    """Candidates each warp scores (the kernel loads the next one's codes
    while it scores the current one)."""
    return max(1, min(MAX_PER_WARP, B * nd // WARP_CANDIDATES))


def _launch(s_cq, codes, keep, q_mask, lead: tuple) -> torch.Tensor:
    """Check the arguments (``lead`` = (B,) for K1, () for K5's one lane)
    and launch the kernel -> (*lead, nd)."""
    dev = s_cq.device
    if s_cq.dim() != len(lead) + 2:
        raise ValueError(f"s_cq: shape {tuple(s_cq.shape)}, expected {(*lead, 'K', 'nq')}")
    K, nq = s_cq.shape[-2:]
    _build.check(s_cq, "s_cq", torch.float32, (*lead, K, nq), dev)
    _build.check(codes, "codes", torch.int32, (*lead, None, None), dev)
    nd, L = codes.shape[-2:]
    if keep is not None:
        _build.check(keep, "keep", torch.bool, (*lead, K), dev)
    if q_mask is not None:
        _build.check(q_mask, "q_mask", torch.float32, (*lead, nq), dev)
    B = lead[0] if lead else 1
    out = torch.empty((*lead, nd), dtype=torch.float32, device=dev)
    fn = _build.c_function("maxsim", "plaid_centroid_interaction_batched", 5, 6)
    _build.launch(fn, (s_cq, codes, keep, q_mask, out), (B, K, nq, nd, L, per_warp(B, nd)), dev)
    return out


def _meta_path(name, s_cq, codes, keep) -> torch.Tensor:
    """The dry-run's call: the (*lead, nd) f32 result as an empty meta
    tensor, the model charged (a null keep reads no flags)."""
    K, nq = s_cq.shape[-2:]
    nd, L = codes.shape[-2:]
    lead = tuple(codes.shape[:-2])
    B = lead[0] if lead else 1
    cost = costs.centroid_interaction_batched_cost(B=B, nd=nd, L=L, K=K, nq=nq,
                                                   flags=None if keep is not None else 0)
    return _build.dry_launch(name, cost, torch.empty((*lead, nd), dtype=torch.float32,
                                                     device=s_cq.device))


def centroid_interaction_batched(
    s_cq: torch.Tensor,  # (B, K, nq) f32
    codes: torch.Tensor,  # (B, nd, L) i32, -1 pad
    keep: torch.Tensor | None,  # (B, K) bool, None: keep all
    q_mask: torch.Tensor | None,  # (B, nq) f32, None: all ones
) -> torch.Tensor:
    """K1 -> (B, nd) f32: ``sum_i q_mask * max(0, max over valid kept
    tokens of S_cq[b, code, i])``."""
    global launches
    if _build.on_meta(s_cq):
        return _meta_path("centroid_interaction_batched", s_cq, codes, keep)
    if not _build.on_card(s_cq, "centroid_interaction_batched"):
        return ref.centroid_interaction_batched_ref(s_cq, codes, keep, q_mask)
    out = _launch(s_cq, codes, keep, q_mask, tuple(s_cq.shape[:1]))
    launches += 1
    return out


def centroid_interaction(
    s_cq: torch.Tensor,  # (K, nq) f32
    codes: torch.Tensor,  # (nd, L) i32, -1 pad
    keep: torch.Tensor | None,  # (K,) bool, None: keep all
    q_mask: torch.Tensor | None,  # (nq,) f32, None: all ones
) -> torch.Tensor:
    """K5 -> (nd,) f32: K1 for one query, launched with B=1."""
    global single_launches
    if _build.on_meta(s_cq):
        return _meta_path("centroid_interaction", s_cq, codes, keep)
    if not _build.on_card(s_cq, "centroid_interaction"):
        return ref.centroid_interaction_ref(s_cq, codes, keep, q_mask)
    out = _launch(s_cq, codes, keep, q_mask, ())
    single_launches += 1
    return out
