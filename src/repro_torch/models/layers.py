"""Shared neural layers in plain PyTorch (the counterpart of
``repro.models.layers``): dense layers with and without a bias, norms,
RoPE, attention (chunked prefill and cached decode) and SwiGLU.

Conventions are the reference's:

* weights are (in, out) for matmuls and stay float32; ``dtype`` is the
  compute type each product runs in;
* ``dense`` returns the compute type (the reference's
  ``preferred_element_type`` is the compute dtype by default);
* ``dense_bias`` casts the bias to the compute type with the operands;
* ``rmsnorm``, ``layernorm`` (``eps=1e-6``, not ``torch.nn.LayerNorm``'s
  1e-5) and RoPE compute in float32 and cast back to the input type;
* ``chunked_attention`` is the reference's pure-JAX online softmax, chunk
  for chunk: ``-inf`` masks, the guarded correction, ``p`` cast to ``v``'s
  type before ``p . v``, and the ``1e-9`` floor on ``l``.

No product here may run in TF32: each sits inside ``ieee_f32_matmul()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import ieee_f32_matmul
from repro_torch.launch import mesh as mesh_mod


def dense(w: torch.Tensor, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (both operands cast), or in ``x``'s type."""
    if dtype is not None:
        w, x = w.to(dtype), x.to(dtype)
    with ieee_f32_matmul():
        return x @ w


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> dict:
    """``{"w": (d_in, d_out)}`` normal at the reference's scale
    ``sqrt(2 / (d_in + d_out))`` (not its numbers), on the generator's
    device."""
    scale = scale if scale is not None else (2.0 / (d_in + d_out)) ** 0.5
    return {"w": torch.randn((d_in, d_out), generator=generator, device=generator.device) * scale}


def dense_bias_init(generator: torch.Generator, d_in: int, d_out: int,
                    scale: float | None = None) -> dict:
    """:func:`dense_init` and a zero bias ``"b"`` (d_out,)."""
    p = dense_init(generator, d_in, d_out, scale)
    p["b"] = torch.zeros((d_out,), device=generator.device)
    return p


def dense_bias(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w + b``, all three cast to ``dtype`` when it is given."""
    if dtype is not None:
        b = b.to(dtype)
    return dense(w, x, dtype) + b


def layernorm_init(d: int, device=None) -> dict:
    return {"g": torch.ones((d,), device=device), "b": torch.zeros((d,), device=device)}


def layernorm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's layernorm: statistics in f32 (the biased variance),
    ``(x - mean) * rsqrt(var + eps) * g + b``, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (((x - mu) * torch.rsqrt(var + eps)) * g + b).to(dt)


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


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, dh) -> (B, S, Hkv, G, dh): GQA without repeating K/V."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) accumulated and returned in f32.  On the card a
    bf16 / f16 pair runs the ``out_dtype`` overload (the operands stay as
    they are: no f32 copy of a cache is made); elsewhere both are read as
    f32, whose products of bf16 values are exact."""
    with ieee_f32_matmul():
        if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, dh)
    k_cache: torch.Tensor,  # (B, S, Hkv, dh)
    v_cache: torch.Tensor,  # (B, S, Hkv, dh)
    cache_len,  # int, or (B,): valid prefix length
    mesh=None,
) -> torch.Tensor:
    """One query token a row against a KV cache, the reference's grouped
    ``decode_attention``: scores and ``p . v`` accumulate in f32 from the
    cache's own dtype, ``p`` is cast to the cache's dtype, slots at or past
    ``cache_len`` are masked.  Slots past the largest ``cache_len`` are not
    read (they would add ``exp(-inf) = 0``).  Each KV head is one batched
    product over B whose operands are strided views of the cache (a
    product batched over (B, Hkv) at once would copy the cache first).

    With ``mesh`` (a ``launch.mesh.Mesh``) the cache's sequence axis is
    split over its processes: ``k_cache`` / ``v_cache`` are this process's
    slots, ``cache_len`` (an int) the valid ones among them, and ``q`` every
    head.  The softmax keeps the reference's order over the whole
    sequence: the global max and the global sum of ``exp(s - max)`` (two
    small all-reduces), then ``p`` cast to the cache's dtype, then the
    local ``p . v`` summed over the processes."""
    B, S, Hkv, dh = k_cache.shape
    H = q.shape[2]
    split = mesh is not None and mesh.world_size > 1
    if isinstance(cache_len, int) or split:  # every slot read is valid: no mask
        n, lens = max(min(int(cache_len), S), 0), None
    else:
        lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
        n = min(int(lens.max()), S)
    qg = _group_q(q, Hkv)[:, 0]  # (B, Hkv, G, dh)
    s = torch.stack([_bmm_f32(qg[:, h].to(k_cache.dtype), k_cache[:, :n, h].transpose(1, 2))
                     for h in range(Hkv)], dim=1)  # (B, Hkv, G, n) f32
    s = s * dh**-0.5
    if lens is not None:
        mask = torch.arange(n, device=q.device)[None, :] < lens[:, None]  # (B or 1, n)
        s = torch.where(mask[:, None, None, :], s, -torch.inf)
    if not split:
        p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    else:  # a process without a valid slot adds exp(-inf) = 0
        top = s.amax(dim=-1) if n else torch.full(s.shape[:-1], -torch.inf, device=q.device)
        e = torch.exp(s - mesh_mod.all_reduce_max(mesh, top)[..., None])
        p = (e / mesh_mod.all_reduce_sum(mesh, e.sum(dim=-1))[..., None]).to(v_cache.dtype)
    out = torch.stack([_bmm_f32(p[:, h], v_cache[:, :n, h]) for h in range(Hkv)], dim=1)
    if split:
        out = mesh_mod.all_reduce_sum(mesh, out)
    return out.reshape(B, 1, H, dh).to(q.dtype)


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
