"""K7 wrapper: attention with an online softmax (flash attention) on the card.

Kernel: ``csrc/flash_attention.cu`` (bf16: wgmma and TMA; f32: CUDA cores);
replaces ``repro/kernels/flash_attention.py`` ``flash_attention``.  Plain
version: ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels import ref

#: kernel launches made by this process (CPU calls are not launches)
launches = 0

_C_NAMES = {torch.float32: "plaid_flash_attention_f32", torch.bfloat16: "plaid_flash_attention_bf16"}


def _readable(t, dtype, dev):
    """``t`` itself if the kernel can read it, else a copy it can: the body
    reads contiguous rows, and the bf16 body's TMA needs 16-byte-aligned
    addresses.  A fresh allocation is contiguous and 256-byte aligned.  A
    tensor of another device or dtype is left for ``_build.check`` to refuse."""
    if not isinstance(t, torch.Tensor) or t.device != dev or t.dtype != dtype:
        return t
    if t.is_contiguous() and not (dtype == torch.bfloat16 and t.data_ptr() % 16):
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, S, Hkv, dh)
    v: torch.Tensor,  # (B, S, Hkv, dh)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """(B, S, H, dh) in ``q``'s dtype: ``softmax(q k^T dh^-0.5) v`` per head,
    query head ``h`` reading KV head ``h // (H // Hkv)``; ``causal`` masks
    keys after the query.  bf16 or f32; dh a multiple of 8 up to 128.  Any
    strides and offsets: a view the kernel cannot read is copied first."""
    global launches
    if _build.on_meta(q):
        B, S, H, dh = q.shape
        cost = costs.flash_attention_cost(B=B, S=S, H=H, Hkv=k.shape[2], dh=dh, causal=causal,
                                          itemsize=q.element_size())
        return _build.dry_launch("flash_attention", cost, torch.empty_like(q), q.dtype)
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
    q, k, v = (_readable(t, q.dtype, dev) for t in (q, k, v))
    _build.check(q, "q", q.dtype, (B, S, H, dh), dev)
    _build.check(k, "k", q.dtype, (B, S, Hkv, dh), dev)
    _build.check(v, "v", q.dtype, (B, S, Hkv, dh), dev)
    out = torch.empty_like(q)
    fn = _build.c_function("flash_attention", _C_NAMES[q.dtype], 4, 6)
    _build.launch(fn, [q, k, v, out], [B, S, H, Hkv, dh, int(causal)], dev)
    launches += 1
    return out
