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
``cfg.dtype``.  The reference casts each weight at each use; on the serving
path (no weight requires grad, or grad mode off) the port keeps one cast
per weight (:meth:`Transformer.compute_weight`), the same values.  A
forward pass that builds a graph (grad mode on and a weight that requires
grad, e.g. the training state's tensors bound by ``torch.func.
functional_call``) casts each weight inside the graph instead, so the
compute-dtype gradient flows back into the f32 weight as the transpose of
the reference's ``astype`` does; with ``cfg.remat`` each layer is then
recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` per layer).  Parameters are created frozen
(``requires_grad=False``); ``requires_grad_()`` makes them trainable.

``attn_impl="flash"`` without a window runs the hand-written attention
kernel (``kernels.flash_attention``, K7); everything else runs
``layers.chunked_attention``.  K7 has no backward (the reference's Pallas
kernel defines none), so a forward pass that builds a graph through it
raises.

Not ported yet (later slices): MoE layers (``n_experts > 0`` raises),
decode with a KV cache, ``prefill``, ``logits_fn`` and ``lm_loss``
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import ieee_f32_matmul, resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.training import tree as tree_lib


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
    # recompute each layer in the backward pass (training only)
    remat: bool = True

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


#: a layer's parameter names, in the order ``DenseLayer.block`` takes them
LAYER_PARAMS = tuple(_param_name(p) for p in _layer_leaves(TransformerConfig()))


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

    def attention(self, x, positions, cast, wq, wk, wv, wo) -> torch.Tensor:
        cfg = self.cfg
        B, S, d = x.shape
        hp, hkv, dh = cfg.padded_heads, cfg.n_kv_heads, cfg.d_head
        x = x.to(cfg.dtype)
        with ieee_f32_matmul():
            q = (x @ cast(wq).reshape(d, hp * dh)).view(B, S, hp, dh)
            k = (x @ cast(wk).reshape(d, hkv * dh)).view(B, S, hkv, dh)
            v = (x @ cast(wv).reshape(d, hkv * dh)).view(B, S, hkv, dh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if cfg.attn_impl == "flash" and cfg.window is None:
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
                raise NotImplementedError(
                    "attn_impl='flash' has no backward pass: the reference's Pallas "
                    "flash_attention (K7) defines none, so the port adds none; train "
                    "with attn_impl='chunked' (the reference's default)"
                )
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
            return o.reshape(B, S, hp * dh).to(cfg.dtype) @ cast(wo).reshape(hp * dh, d)

    def block(self, h, positions, cast, wq, wk, wv, wo, ln1, ln2, wi, wg, wo2) -> torch.Tensor:
        """The layer as a function of its weights (passed in, so that a
        recomputation in the backward pass reads the tensors the forward
        pass read)."""
        x1 = L.rmsnorm(ln1, h)
        h = h + self.attention(x1, positions, cast, wq, wk, wv, wo).to(h.dtype)
        x2 = L.rmsnorm(ln2, h)
        ffn = L.swiglu(cast(wi), cast(wg), cast(wo2), x2, self.cfg.dtype)
        return h + ffn.to(h.dtype)

    def forward(self, h: torch.Tensor, positions: torch.Tensor, cast) -> torch.Tensor:
        w = [getattr(self, n) for n in LAYER_PARAMS]
        if (self.cfg.remat and torch.is_grad_enabled()
                and (h.requires_grad or any(t.requires_grad for t in w))):
            return checkpoint(self.block, h, positions, cast, *w,
                              use_reentrant=False, preserve_rng_state=False)
        return self.block(h, positions, cast, *w)


class Transformer(nn.Module):
    """Embedding -> ``n_layers`` dense layers -> final RMSNorm."""

    def __init__(self, cfg: TransformerConfig, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (n_experts={cfg.n_experts}; the reference's "
                "layers.moe_init / moe_apply) are not ported"
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

    def cast(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` in the compute dtype: inside the graph when a forward pass
        builds one through ``p``, else the cached :meth:`compute_weight`."""
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(self.cfg.dtype)
        return self.compute_weight(p)

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

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S) -> hidden states (B, S, d) in ``cfg.dtype``."""
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
        h = self.cast(self.embed)[tokens.long()]
        for layer in self.layers:
            h = layer(h, positions, self.cast)
        return L.rmsnorm(self.final_norm_g, h)

    def numpy_params(self) -> dict:
        """The reference's param tree as numpy (``lm_head`` excepted);
        each layer's leaves stacked on a leading ``L`` axis."""
        return tree_lib.to_numpy(params_tree(self, param_paths(self.cfg)))


def param_paths(cfg: TransformerConfig) -> dict[str, tuple[tuple[str, ...], int | None]]:
    """Each parameter's name in :class:`Transformer` -> (its path in the
    reference's tree, its index in the layer stack or None)."""
    out = {"embed": (("embed",), None), "final_norm_g": (("final_norm", "g"), None)}
    for i in range(cfg.n_layers):
        for path in _layer_leaves(cfg):
            out[f"layers.{i}.{_param_name(path)}"] = (("dense_layers",) + path, i)
    return out


#: each layer leaf's logical axes, the reference's ``_layer_axes`` without
#: its leading "layers" axis (a layer stack is a list here)
_LAYER_AXES = {
    ("attn", "wq"): ("embed_fsdp", "heads", "head_dim"),
    ("attn", "wk"): ("embed_fsdp", "kv_heads", "head_dim"),
    ("attn", "wv"): ("embed_fsdp", "kv_heads", "head_dim"),
    ("attn", "wo"): ("heads", "head_dim", "embed_fsdp"),
    ("ln1", "g"): (None,),
    ("ln2", "g"): (None,),
    ("ffn", "wi", "w"): ("embed_fsdp", "mlp"),
    ("ffn", "wg", "w"): ("embed_fsdp", "mlp"),
    ("ffn", "wo", "w"): ("mlp", "embed_fsdp"),
}


def param_axes(cfg: TransformerConfig) -> dict:
    """Logical axes of each parameter (``distributed.sharding``), in the
    training tree's layout (``param_paths``: each layer stack a list of
    per-layer tuples); the reference's ``param_axes`` for the dense
    encoder, ``lm_head`` excepted."""
    names = {"embed": ("vocab", "embed_fsdp"), "final_norm_g": (None,)}
    for i in range(cfg.n_layers):
        names.update({f"layers.{i}.{_param_name(p)}": a for p, a in _LAYER_AXES.items()})
    return tree_lib.gather(names, param_paths(cfg))


def params_tree(module: nn.Module, paths: Mapping) -> dict:
    """``module``'s parameters as a tree in the reference's layout
    (``paths`` as :func:`param_paths` gives them), each layer stack a list:
    detached aliases, which share the parameters' storage."""
    return tree_lib.gather({n: p.detach() for n, p in module.named_parameters()}, paths)


@torch.no_grad()
def assign_params(module: nn.Module, paths: Mapping, tree: Mapping) -> None:
    """Copy the tree's leaves into ``module``'s parameters; a leaf whose
    shape or dtype is not its parameter's raises, naming the parameter."""
    named = dict(module.named_parameters())
    for name, t in tree_lib.scatter(tree, paths).items():
        p = named[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, expected {p.dtype}{tuple(p.shape)}")
        p.copy_(t)


def params_from_numpy(
    tree: Mapping, cfg: TransformerConfig, device: str | torch.device = "cuda"
) -> Transformer:
    """A :class:`Transformer` holding the reference's ``init_params`` tree
    (converted to numpy) value for value.  ``lm_head`` is not used by the
    encoder and is dropped."""
    model = Transformer(cfg, device)
    paths = param_paths(cfg)
    assign_params(model, paths, tree_lib.from_numpy(tree, params_tree(model, paths)))
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
