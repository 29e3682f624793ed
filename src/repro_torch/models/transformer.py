"""Dense transformer backbone in PyTorch (the counterpart of the dense part
of ``repro.models.transformer``): the ColBERT encoder's forward pass.

Layouts are the reference's, so weights cross between the two packages as
numpy (:func:`params_from_numpy` / :meth:`Transformer.numpy_params`):

* query heads are kv-group-major and padded per group so the flat head
  count divides ``tp_multiple``: ``wq (d, Hp, dh)``, ``wo (Hp, dh, d)``;
  padded heads have zero ``wq`` columns and zero ``wo`` rows, so they are
  inert;
* the embedding table is padded to ``padded_vocab`` rows.

Parameters are float32, as in the reference; each product runs in
``cfg.dtype``.  The reference casts each weight at each use; the port
keeps one cast per weight (:meth:`Transformer.compute_weight`), the same
values.  ``attn_impl="flash"`` without a window runs the hand-written
attention kernel (``kernels.flash_attention``, K7); everything else runs
``layers.chunked_attention``.

Not ported yet (later slices): MoE layers (``n_experts > 0`` raises),
decode with a KV cache, ``prefill``, ``logits_fn`` and ``lm_loss``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import ieee_f32_matmul, resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 128
    vocab: int = 256
    # MoE layers (n_experts > 0) are not ported: the model refuses them
    n_experts: int = 0
    # attention
    window: int | None = None  # sliding-window size (None = full)
    rope_theta: float = 10000.0
    causal: bool = True
    # padding multiple for tensor-parallel alignment (1 = no padding)
    tp_multiple: int = 1
    # compute dtype (params stay f32)
    dtype: torch.dtype = torch.bfloat16
    # "chunked" (plain torch online softmax) or "flash" (the K7 kernel)
    attn_impl: str = "chunked"
    q_chunk: int = 1024
    k_chunk: int = 1024

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def group_pad(self) -> int:
        """Padded queries per KV group so n_kv_heads * Gp % tp_multiple == 0."""
        gp = self.n_heads // self.n_kv_heads
        while (self.n_kv_heads * gp) % self.tp_multiple:
            gp += 1
        return gp

    @property
    def padded_heads(self) -> int:
        return self.n_kv_heads * self.group_pad

    @property
    def padded_vocab(self) -> int:
        m = self.tp_multiple
        return (self.vocab + m - 1) // m * m


def _layer_leaves(cfg: TransformerConfig) -> dict[tuple[str, ...], tuple[int, ...]]:
    """A layer's leaves: {path in the reference's ``dense_layers`` tree: shape}."""
    d, dh, hp, hkv, dff = cfg.d_model, cfg.d_head, cfg.padded_heads, cfg.n_kv_heads, cfg.d_ff
    return {
        ("attn", "wq"): (d, hp, dh),
        ("attn", "wk"): (d, hkv, dh),
        ("attn", "wv"): (d, hkv, dh),
        ("attn", "wo"): (hp, dh, d),
        ("ln1", "g"): (d,),
        ("ln2", "g"): (d,),
        ("ffn", "wi", "w"): (d, dff),
        ("ffn", "wg", "w"): (d, dff),
        ("ffn", "wo", "w"): (dff, d),
    }


def _param_name(path: tuple[str, ...]) -> str:
    return "_".join(p for p in path if p != "w")


class DenseLayer(nn.Module):
    """One pre-norm block: RMSNorm -> attention -> residual -> RMSNorm ->
    SwiGLU -> residual.  Parameter ``attn_wq`` is leaf ``attn/wq``, and so on."""

    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for path, shape in _layer_leaves(cfg).items():
            self.register_parameter(
                _param_name(path),
                nn.Parameter(torch.zeros(shape, device=device), requires_grad=False),
            )

    def attention(self, x: torch.Tensor, positions: torch.Tensor, cast) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = x.shape
        hp, hkv, dh = cfg.padded_heads, cfg.n_kv_heads, cfg.d_head
        x = x.to(cfg.dtype)
        with ieee_f32_matmul():
            q = (x @ cast(self.attn_wq).reshape(d, hp * dh)).view(B, S, hp, dh)
            k = (x @ cast(self.attn_wk).reshape(d, hkv * dh)).view(B, S, hkv, dh)
            v = (x @ cast(self.attn_wv).reshape(d, hkv * dh)).view(B, S, hkv, dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if cfg.attn_impl == "flash" and cfg.window is None:
            # grouped: query head h reads KV head h // group_pad, no repeat
            o = fa.flash_attention(q, k, v, causal=cfg.causal)
        else:
            gp = cfg.group_pad
            o = L.chunked_attention(
                q, k.repeat_interleave(gp, dim=2), v.repeat_interleave(gp, dim=2),
                causal=cfg.causal, window=cfg.window,
                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            )
        with ieee_f32_matmul():
            return o.reshape(B, S, hp * dh).to(cfg.dtype) @ cast(self.attn_wo).reshape(hp * dh, d)

    def forward(self, h: torch.Tensor, positions: torch.Tensor, cast) -> torch.Tensor:
        x1 = L.rmsnorm(self.ln1_g, h)
        h = h + self.attention(x1, positions, cast).to(h.dtype)
        x2 = L.rmsnorm(self.ln2_g, h)
        ffn = L.swiglu(cast(self.ffn_wi), cast(self.ffn_wg), cast(self.ffn_wo), x2, self.cfg.dtype)
        return h + ffn.to(h.dtype)


class Transformer(nn.Module):
    """Embedding -> ``n_layers`` dense layers -> final RMSNorm."""

    def __init__(self, cfg: TransformerConfig, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (n_experts={cfg.n_experts}) are not ported yet "
                "(ROADMAP Queue 1 item 13)"
            )
        if cfg.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got {cfg.attn_impl!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros((cfg.padded_vocab, cfg.d_model), device=dev), requires_grad=False
        )
        self.final_norm_g = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        self.layers = nn.ModuleList(DenseLayer(cfg, dev) for _ in range(cfg.n_layers))
        self._casts: dict[int, tuple[tuple, torch.Tensor]] = {}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def compute_weight(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` in the compute dtype, cast once and reused until ``p``
        changes (in place, or by ``.to()``)."""
        if p.dtype == self.cfg.dtype:
            return p
        stamp = (p._version, p.data_ptr(), p.device)
        hit = self._casts.get(id(p))
        if hit is None or hit[0] != stamp:
            hit = (stamp, p.detach().to(self.cfg.dtype))
            self._casts[id(p)] = hit
        return hit[1]

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S) -> hidden states (B, S, d) in ``cfg.dtype``."""
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
        h = self.compute_weight(self.embed)[tokens.long()]
        for layer in self.layers:
            h = layer(h, positions, self.compute_weight)
        return L.rmsnorm(self.final_norm_g, h)

    def numpy_params(self) -> dict:
        """The reference's param tree as numpy (``lm_head`` excepted);
        each layer's leaves stacked on a leading ``L`` axis."""
        layers: dict = {}
        for path in _layer_leaves(self.cfg):
            stacked = np.stack([getattr(lay, _param_name(path)).cpu().numpy() for lay in self.layers])
            node = layers
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = stacked
        return {
            "embed": self.embed.cpu().numpy(),
            "final_norm": {"g": self.final_norm_g.cpu().numpy()},
            "dense_layers": layers,
        }


def _leaf(tree: Mapping, path: tuple[str, ...]):
    node = tree
    for key in path:
        node = node[key]
    return node


def _fill(p: torch.Tensor, value, name: str) -> None:
    a = np.asarray(value)
    if tuple(a.shape) != tuple(p.shape) or a.dtype != np.float32:
        raise ValueError(f"{name}: {a.dtype}{tuple(a.shape)}, expected float32{tuple(p.shape)}")
    p.copy_(torch.from_numpy(np.array(a)))  # a writable copy


@torch.no_grad()
def params_from_numpy(
    tree: Mapping, cfg: TransformerConfig, device: str | torch.device = "cuda"
) -> Transformer:
    """A :class:`Transformer` holding the reference's ``init_params`` tree
    (converted to numpy) value for value.  ``lm_head`` is not used by the
    encoder and is dropped."""
    model = Transformer(cfg, device)
    _fill(model.embed, tree["embed"], "embed")
    _fill(model.final_norm_g, tree["final_norm"]["g"], "final_norm/g")
    stacked = tree["dense_layers"]
    for path in _layer_leaves(cfg):
        arr = np.asarray(_leaf(stacked, path))
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"dense_layers/{'/'.join(path)}: {arr.shape[0]} layers, expected {cfg.n_layers}")
        for i, lay in enumerate(model.layers):
            _fill(getattr(lay, _param_name(path)), arr[i], "/".join(path))
    return model


def _normal(shape, scale: float, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * scale


@torch.no_grad()
def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Transformer:
    """Random weights with the reference's shapes, scales and zero padding
    (not its numbers: ``torch.Generator`` is not ``jax.random``)."""
    model = Transformer(cfg, device)
    dev = model.device
    d, dh, hkv, dff = cfg.d_model, cfg.d_head, cfg.n_kv_heads, cfg.d_ff
    g, gp = cfg.n_heads // hkv, cfg.group_pad
    model.embed[: cfg.vocab] = _normal((cfg.vocab, d), 0.02, generator).to(dev)
    scale = (2.0 / (d + cfg.n_heads * dh)) ** 0.5
    fscale = (2.0 / (d + dff)) ** 0.5
    for lay in model.layers:
        # kv-group-major: head (kvh, j) lives at flat index kvh * gp + j;
        # padded slots (j >= g) stay zero
        lay.attn_wq.view(d, hkv, gp, dh)[:, :, :g] = _normal((d, hkv, g, dh), scale, generator).to(dev)
        lay.attn_wo.view(hkv, gp, dh, d)[:, :g] = _normal((hkv, g, dh, d), scale, generator).to(dev)
        lay.attn_wk.copy_(_normal((d, hkv, dh), scale, generator))
        lay.attn_wv.copy_(_normal((d, hkv, dh), scale, generator))
        lay.ln1_g.fill_(1.0)
        lay.ln2_g.fill_(1.0)
        for p in (lay.ffn_wi, lay.ffn_wg, lay.ffn_wo):
            p.copy_(_normal(tuple(p.shape), fscale, generator))
    return model
