"""Shared neural layers in plain PyTorch (the counterpart of
``repro.models.layers``): the dense parts of the ColBERT backbone.

Conventions are the reference's:

* weights are (in, out) for matmuls and stay float32; ``dtype`` is the
  compute type each product runs in;
* ``dense`` returns the compute type (the reference's
  ``preferred_element_type`` is the compute dtype by default);
* ``rmsnorm`` and RoPE compute in float32 and cast back to the input type;
* ``chunked_attention`` is the reference's pure-JAX online softmax, chunk
  for chunk: ``-inf`` masks, the guarded correction, ``p`` cast to ``v``'s
  type before ``p . v``, and the ``1e-9`` floor on ``l``.

No product here may run in TF32: each sits inside ``ieee_f32_matmul()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import ieee_f32_matmul


def dense(w: torch.Tensor, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (both operands cast), or in ``x``'s type."""
    if dtype is not None:
        w, x = w.to(dtype), x.to(dtype)
    with ieee_f32_matmul():
        return x @ w


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * g).to(dt)


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, dh), RoPE applied
    k: torch.Tensor,  # (B, S, Hkv, dh)
    v: torch.Tensor,  # (B, S, Hkv, dh)
    *,
    causal: bool = True,
    window: int | None = None,  # sliding-window size (None = full)
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Online softmax over KV chunks per Q chunk (the reference's chunk and
    mask schedule): off-diagonal causal chunks skip the mask, a window scans
    only the KV chunks its span can reach, S is padded to chunk multiples
    and the padding masked."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = dh**-0.5
    q_chunk, k_chunk = min(q_chunk, S), min(k_chunk, S)
    n_q, n_k = -(-S // q_chunk), -(-S // k_chunk)
    Sp, Skp = n_q * q_chunk, n_k * k_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, Sp - S)).reshape(B, n_q, q_chunk, Hkv, G, dh)
    kp = F.pad(k, (0, 0, 0, 0, 0, Skp - S))
    vp = F.pad(v, (0, 0, 0, 0, 0, Skp - S))
    dev = q.device
    kv_pos = torch.arange(Skp, device=dev)

    def kv_body(carry, qc, q_pos, ki: int, masked: bool):
        m, l, acc = carry  # (B, Hkv, G, qc), same, (B, Hkv, G, qc, dh)
        ks = kp[:, ki * k_chunk : (ki + 1) * k_chunk]
        vs = vp[:, ki * k_chunk : (ki + 1) * k_chunk]
        with ieee_f32_matmul():
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), ks.float()) * scale
        if masked:
            kpos = kv_pos[ki * k_chunk : (ki + 1) * k_chunk]
            mask = kpos[None, :] < S  # padding
            if causal:
                mask = mask & (q_pos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf rows (no valid kv yet)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if masked:
            p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_new = l * corr + p.sum(dim=-1)
        with ieee_f32_matmul():
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vs.dtype).float(), vs.float())
        return m_new, l_new, acc * corr[..., None] + pv

    outs = []
    for qi in range(n_q):
        qc = qp[:, qi]  # (B, qc, Hkv, G, dh)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        carry = (
            torch.full((B, Hkv, G, q_chunk), -torch.inf, device=dev),
            torch.zeros((B, Hkv, G, q_chunk), device=dev),
            torch.zeros((B, Hkv, G, q_chunk, dh), device=dev),
        )
        if window is not None:
            # static bound on kv chunks a (window + q_chunk) span covers
            span = min((window + q_chunk + k_chunk - 2) // k_chunk + 1, n_k)
            first = min(max(qi * q_chunk // k_chunk - (span - 1), 0), n_k - span)
            schedule = [(ki, True) for ki in range(first, first + span)]
        elif causal:
            n_full = qi * q_chunk // k_chunk  # off-diagonal chunks: mask-free
            diag_hi = min(((qi + 1) * q_chunk + k_chunk - 1) // k_chunk, n_k)
            schedule = [(ki, False) for ki in range(n_full)]
            schedule += [(ki, True) for ki in range(n_full, diag_hi)]
        else:
            schedule = [(ki, Skp != S) for ki in range(n_k)]  # padding only
        for ki, masked in schedule:
            carry = kv_body(carry, qc, q_pos, ki, masked)
        _, l, acc = carry
        out = acc / l.clamp(min=1e-9)[..., None]  # (B, Hkv, G, qc, dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, dh))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :S].to(q.dtype)


def swiglu(wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, x: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    h = dense(wi, x, dtype) * F.silu(dense(wg, x, dtype))
    return dense(wo, h, dtype)
