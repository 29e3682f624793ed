"""K7 wrapper: attention with an online softmax (flash attention) on the card.

Kernel: ``csrc/flash_attention.cu`` (bf16: wgmma and TMA; f32: CUDA cores);
replaces ``repro/kernels/flash_attention.py`` ``flash_attention``.  Plain
version: ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches made by this process (CPU calls are not launches)
launches = 0

_C_NAMES = {torch.float32: "plaid_flash_attention_f32", torch.bfloat16: "plaid_flash_attention_bf16"}


def flash_attention(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, S, Hkv, dh)
    v: torch.Tensor,  # (B, S, Hkv, dh)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """(B, S, H, dh) in ``q``'s dtype: ``softmax(q k^T dh^-0.5) v`` per head,
    query head ``h`` reading KV head ``h // (H // Hkv)``; ``causal`` masks
    keys after the query.  bf16 or f32; dh a multiple of 8 up to 128."""
    global launches
    if not _build.on_card(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    dev = q.device
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    if q.dtype not in _C_NAMES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected bfloat16 or float32")
    if dh % 8 or not 0 < dh <= 128:
        raise ValueError(f"flash_attention: head dim {dh} is not a multiple of 8 in [8, 128]")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads do not group over {Hkv} KV heads")
    _build.check(q, "q", q.dtype, (B, S, H, dh), dev)
    _build.check(k, "k", q.dtype, (B, S, Hkv, dh), dev)
    _build.check(v, "v", q.dtype, (B, S, Hkv, dh), dev)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    fn = _build.c_function("flash_attention", _C_NAMES[q.dtype], 4, 6)
    _build.launch(fn, [q, k, v, out], [B, S, H, Hkv, dh, int(causal)], dev)
    launches += 1
    return out
