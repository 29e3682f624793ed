"""Decoder-only LM family and the ColBERT encoder's backbone in PyTorch (the
counterpart of ``repro.models.transformer``): dense / GQA / MQA /
sliding-window / MoE layers, the LM head, training (``lm_loss``, with the
MoE router and its load-balance aux loss under grad) and serving
(``prefill``, and ``decode_step`` with a KV cache).

Layouts are the reference's, so weights cross between the two packages as
numpy (:func:`params_from_numpy` / :meth:`Transformer.numpy_params`):

* query heads are kv-group-major and padded per group so the flat head
  count divides ``tp_multiple``: ``wq (d, Hp, dh)``, ``wo (Hp, dh, d)``;
  padded heads have zero ``wq`` columns and zero ``wo`` rows, so they are
  inert;
* the embedding table (and ``lm_head``'s columns) are padded to
  ``padded_vocab``; the logits of padded slots are -1e9;
* the ``first_dense`` dense layers come before the MoE layers
  (``dense_layers`` then ``moe_layers`` in the tree; one list of layers
  here, dense first, as the reference's decode offsets them);
* the KV cache is ``{"k", "v"}`` of ``(n_layers, B, Sc, Hkv, dh)`` in
  ``cfg.dtype``; a sliding-window model's cache is a ring of ``window``
  slots.

The encoder (``models.colbert``) holds float32 parameters and no LM head,
as the reference's training tree does (its ``lm_head`` is left out); each
product runs in ``cfg.dtype``.  The reference casts each weight at each
use; on the serving path (no weight requires grad, or grad mode off) the
port keeps one cast per weight (:meth:`Transformer.compute_weight`), the
same values.  An LM for serving holds its parameters in ``cfg.dtype``
(``param_dtype``), as the reference's serving cells cast the tree; then
there is no cast to keep.  A forward pass that builds a graph (grad mode
on and a weight that requires grad, e.g. the training state's tensors
bound by ``torch.func.functional_call``) casts each weight inside the
graph instead, so the compute-dtype gradient flows back into the f32
weight as the transpose of the reference's ``astype`` does; with
``cfg.remat`` each layer is then recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` per layer).
Parameters are created frozen (``requires_grad=False``);
``requires_grad_()`` makes them trainable.

``attn_impl="flash"`` without a window runs the hand-written attention
kernel (``kernels.flash_attention``, K7) in ``forward`` and ``prefill``;
everything else runs ``layers.chunked_attention``, and ``decode_step`` runs
``layers.decode_attention``.  K7 has no backward (the reference's Pallas
kernel defines none), so a forward pass that builds a graph through it
raises.

Training: ``lm_loss(model, tokens, targets, mask)`` is the reference's
next-token cross-entropy over the real vocabulary plus ``0.01`` times the
MoE layers' aux total; ``loss_fn(model)`` binds it to a training tree (the
reference's ``init_params`` tree with ``lm_head``, ``dense_layers`` and
``moe_layers``, each layer stack a list; :func:`train_params`,
:func:`train_state_from_numpy`).  An MoE block runs under
``torch.utils.checkpoint`` with ``cfg.remat`` as a dense one does; its
router statistics leave the block beside ``h`` and the aux is formed from
them outside it (:func:`moe_aux`), so that under a data-parallel mesh
(``distributed.sharding.data_mesh``) the first-choice counts are summed
over the processes by one forward all-reduce, never in a recomputation.

Tensor and expert parallelism: a model built under a mesh with a
``"model"`` axis above 1 (one device a process, ``launch.mesh``) holds
this process's slice of each weight, as the reference's rules split the
leaf (``param_axes``): query heads, KV heads where they divide the axis,
the SwiGLU's ``"mlp"`` width, the experts and the padded vocabulary.  The
reference's GSPMD places its collectives implicitly; here each one is
explicit: a column-split product's input takes ``launch.mesh.copy_to``
and a row-split product's partial sum ``launch.mesh.reduce_from`` (one
all-reduce, in the compute dtype as the reference's ``_pref`` psums),
the embedding is a masked lookup of the rows held here plus one
all-reduce, and ``lm_loss`` a vocab-parallel cross-entropy.  The KV cache
is split as the reference's ``_cache_axes`` lays it out: by KV head where
they divide the axis, else by sequence (``_cache_seq_sharded``), whose
update is the reference's masked select (``_cache_write_``) and whose decode
attention reduces the softmax over the processes
(``layers.decode_attention`` with ``mesh``).  The batch stays whole on
every process of a model group.  Not ported: the FSDP rules
(``ZERO3_RULES``), a model axis over several devices of one process
(ROADMAP Queue 1 items 8.5.2 and 8.5.6; ``distributed.sharding`` refuses
both).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import ieee_f32_matmul, resolve_device
from repro_torch.core import scoring
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as mesh_mod
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
    # MoE (n_experts == 0 -> dense SwiGLU)
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    first_dense: int = 0  # leading layers that stay dense (DeepSeekMoE)
    d_ff_dense: int = 0  # ffn width of those dense layers (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_group: int = 256  # dispatch group size (tokens)
    # attention
    window: int | None = None  # sliding-window size (None = full)
    rope_theta: float = 10000.0
    causal: bool = True
    # padding multiple for tensor-parallel alignment (1 = no padding)
    tp_multiple: int = 1
    # compute dtype
    dtype: torch.dtype = torch.bfloat16
    # "chunked" (plain torch online softmax) or "flash" (the K7 kernel)
    attn_impl: str = "chunked"
    q_chunk: int = 1024
    k_chunk: int = 1024
    # recompute each layer in the backward pass (training only)
    remat: bool = True
    tied_embeddings: bool = False

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

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_dense if self.n_experts else 0

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.d_head
        return d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2

    def _emb_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tied_embeddings else 2)

    def num_params(self) -> int:
        """Exact (unpadded) parameter count, the reference's (its model
        FLOPs use it)."""
        d = self.d_model
        if self.n_experts:
            ffn_moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.n_shared:
                ffn_moe += 3 * d * self.d_ff * self.n_shared
            ffn_dense = 3 * d * (self.d_ff_dense or self.d_ff)
            ffn = ffn_moe * (self.n_layers - self.first_dense) + ffn_dense * self.first_dense
        else:
            ffn = 3 * d * self.d_ff * self.n_layers
        norms = self.n_layers * 2 * d + d
        return self._attn_params() * self.n_layers + ffn + norms + self._emb_params()

    def active_params(self) -> int:
        """Parameters a token activates (MoE: top_k plus the shared experts;
        the router is not counted, as in the reference)."""
        if not self.n_experts:
            return self.num_params()
        d = self.d_model
        ffn_act = 3 * d * self.d_ff * (self.top_k + self.n_shared)
        ffn_dense = 3 * d * (self.d_ff_dense or self.d_ff)
        ffn = ffn_act * (self.n_layers - self.first_dense) + ffn_dense * self.first_dense
        return (self._attn_params() * self.n_layers + ffn + self.n_layers * 2 * d + d
                + self._emb_params())


def _layer_leaves(cfg: TransformerConfig, moe: bool) -> dict[tuple[str, ...], tuple[int, ...]]:
    """A layer's leaves: {path in the reference's layer tree: shape}."""
    d, dh, hp, hkv = cfg.d_model, cfg.d_head, cfg.padded_heads, cfg.n_kv_heads
    out = {
        ("attn", "wq"): (d, hp, dh),
        ("attn", "wk"): (d, hkv, dh),
        ("attn", "wv"): (d, hkv, dh),
        ("attn", "wo"): (hp, dh, d),
        ("ln1", "g"): (d,),
        ("ln2", "g"): (d,),
    }
    if moe:
        e, dff = cfg.n_experts, cfg.d_ff
        out.update({("moe", "router"): (d, e), ("moe", "wi"): (e, d, dff),
                    ("moe", "wg"): (e, d, dff), ("moe", "wo"): (e, dff, d)})
        if cfg.n_shared:
            ds = dff * cfg.n_shared
            out.update({("moe", "shared", "wi", "w"): (d, ds), ("moe", "shared", "wg", "w"): (d, ds),
                        ("moe", "shared", "wo", "w"): (ds, d)})
    else:
        dff = (cfg.d_ff_dense or cfg.d_ff) if cfg.n_experts else cfg.d_ff
        out.update({("ffn", "wi", "w"): (d, dff), ("ffn", "wg", "w"): (d, dff),
                    ("ffn", "wo", "w"): (dff, d)})
    return out


def _param_name(path: tuple[str, ...]) -> str:
    return "_".join(p for p in path if p != "w")


class Layer(nn.Module):
    """One pre-norm block: RMSNorm -> attention -> residual -> RMSNorm ->
    SwiGLU (dense) or routed experts (MoE) -> residual.  Parameter
    ``attn_wq`` is leaf ``attn/wq``, ``moe_shared_wi`` is
    ``moe/shared/wi/w``, and so on.

    Under tensor parallelism (``tp``, the ``"model"`` sub-mesh) each
    parameter is this process's slice (``local``: name -> its shape here):
    ``wq`` / ``wk`` / ``wv`` split by column (heads), ``attn/wo`` by row,
    the SwiGLU's ``wi`` / ``wg`` by column and ``wo`` by row (``"mlp"``),
    the experts by expert; a split product's partial sums are summed over
    ``tp`` once (:func:`launch.mesh.reduce_from`), and a replicated tensor
    that enters one takes :func:`launch.mesh.copy_to` (its gradient summed
    over ``tp``)."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, moe: bool,
                 param_dtype: torch.dtype, local: Mapping | None = None, tp=None):
        super().__init__()
        self.cfg, self.moe, self.tp = cfg, moe, tp
        self.rank = 0 if tp is None else tp.rank
        leaves = _layer_leaves(cfg, moe)
        #: parameter names, in the order ``block`` takes them
        self.names = tuple(_param_name(p) for p in leaves)
        local = local or {}
        #: name -> True where this process holds a slice of the weight
        self.split = {}
        for path, shape in leaves.items():
            name = _param_name(path)
            here = tuple(local.get(name, shape))
            self.split[name] = here != tuple(shape)
            self.register_parameter(
                name, nn.Parameter(torch.zeros(here, device=device, dtype=param_dtype),
                                   requires_grad=False))

    def _tp(self, name: str):
        """``tp`` when this process holds a slice of ``name``, else None."""
        return self.tp if self.split[name] else None

    @property
    def local_heads(self) -> int:
        return self.attn_wq.shape[1]

    def project_qkv(self, x, positions, cast, w) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q (B, S, heads here, dh), k and v (B, S, KV heads here, dh) in
        ``cfg.dtype``, RoPE applied to q and k at ``positions``."""
        cfg = self.cfg
        B, S, d = x.shape
        hq, hkv, dh = w["attn_wq"].shape[1], w["attn_wk"].shape[1], cfg.d_head
        x = x.to(cfg.dtype)
        xq = mesh_mod.copy_to(self._tp("attn_wq"), x)
        xk = xq if self.split["attn_wk"] else x
        with ieee_f32_matmul():
            q = (xq @ cast(w["attn_wq"]).reshape(d, hq * dh)).view(B, S, hq, dh)
            k = (xk @ cast(w["attn_wk"]).reshape(d, hkv * dh)).view(B, S, hkv, dh)
            v = (xk @ cast(w["attn_wv"]).reshape(d, hkv * dh)).view(B, S, hkv, dh)
        return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta), v

    def kv_for_heads(self, k, v, grad: bool = True):
        """(k, v, query heads a KV head): the KV heads this process's query
        heads read, grouped as K7 and the chunked attention take them.  A
        process holding a slice of the query heads but every KV head
        (kv_heads not split: MQA, or fewer KV heads than processes) takes
        the ones its heads read; with ``grad`` their gradient is summed
        over ``tp`` first (each process's heads feed only some of them)."""
        hl, gp = self.local_heads, self.cfg.group_pad
        if self.split["attn_wk"] or not self.split["attn_wq"]:
            return k, v, hl // k.shape[2]
        if grad:
            k, v = mesh_mod.copy_to(self.tp, k), mesh_mod.copy_to(self.tp, v)
        a = self.rank * hl  # this process's first query head
        if hl % gp == 0 or gp % hl == 0:  # whole groups, or within one
            sl = slice(a // gp, a // gp + max(hl // gp, 1))
            k, v = k[:, :, sl], v[:, :, sl]
        else:
            idx = torch.arange(a, a + hl, device=k.device) // gp
            k, v = k[:, :, idx], v[:, :, idx]
        return k, v, hl // k.shape[2]

    def out_proj(self, o, cast, w) -> torch.Tensor:
        cfg = self.cfg
        B, S = o.shape[:2]
        with ieee_f32_matmul():
            out = (o.reshape(B, S, -1).to(cfg.dtype) @ cast(w["attn_wo"]).reshape(-1, cfg.d_model))
        return mesh_mod.reduce_from(self._tp("attn_wo"), out)

    def attention(self, x, positions, cast, w) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.project_qkv(x, positions, cast, w)
        k, v, groups = self.kv_for_heads(k, v)
        if cfg.attn_impl == "flash" and cfg.window is None:
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
                raise NotImplementedError(
                    "attn_impl='flash' has no backward pass: the reference's Pallas "
                    "flash_attention (K7) defines none, so the port adds none; train "
                    "with attn_impl='chunked' (the reference's default)"
                )
            # grouped: query head h reads KV head h // groups, no repeat
            o = fa.flash_attention(q, k.contiguous(), v.contiguous(), causal=cfg.causal)
        else:
            o = L.chunked_attention(
                q, k.repeat_interleave(groups, dim=2), v.repeat_interleave(groups, dim=2),
                causal=cfg.causal, window=cfg.window,
                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
            )
        return self.out_proj(o, cast, w)

    def ffn(self, x2, cast, w) -> tuple[torch.Tensor, tuple]:
        """The feed-forward half: (out, router statistics): an MoE layer's
        (probability sums, first-choice counts, tokens), as
        :func:`moe_ffn` returns them; none for a dense layer."""
        if self.moe:
            out, *stats = moe_ffn(w, x2, self.cfg, cast, tp=self.tp)
            return out, tuple(stats)
        tp = self._tp("ffn_wi")
        out = L.swiglu(cast(w["ffn_wi"]), cast(w["ffn_wg"]), cast(w["ffn_wo"]),
                       mesh_mod.copy_to(tp, x2), self.cfg.dtype)
        return mesh_mod.reduce_from(tp, out), ()

    def block(self, h, positions, cast, *weights) -> tuple[torch.Tensor, tuple]:
        """The layer as a function of its weights (passed in, so that a
        recomputation in the backward pass reads the tensors the forward
        pass read): (h, router statistics)."""
        w = dict(zip(self.names, weights))
        x1 = L.rmsnorm(w["ln1_g"], h)
        h = h + self.attention(x1, positions, cast, w).to(h.dtype)
        f, stats = self.ffn(L.rmsnorm(w["ln2_g"], h), cast, w)
        return h + f.to(h.dtype), stats

    def forward(self, h: torch.Tensor, positions: torch.Tensor, cast) -> tuple[torch.Tensor, tuple]:
        w = [getattr(self, n) for n in self.names]
        graph = torch.is_grad_enabled() and (h.requires_grad or any(t.requires_grad for t in w))
        if graph and self.cfg.remat:
            return checkpoint(self.block, h, positions, cast, *w,
                              use_reentrant=False, preserve_rng_state=False)
        return self.block(h, positions, cast, *w)

    def decode(self, h, positions, cast, ck, cv, cache: "_CacheLayout") -> torch.Tensor:
        """One token a row (h (B, 1, d)): writes its k and v into this
        layer's cache (ck, cv: (B, slots here, KV heads here, dh)) at the
        step's slot, in place, and attends to the valid slots."""
        w = {n: getattr(self, n) for n in self.names}
        q, k, v = self.project_qkv(L.rmsnorm(w["ln1_g"], h), positions, cast, w)
        _cache_write_(ck, k, cache.slot, cache.seq_sharded, cache.offset)
        _cache_write_(cv, v, cache.slot, cache.seq_sharded, cache.offset)
        if cache.seq_split:  # every head against this process's slots
            hl = self.local_heads
            qa = mesh_mod.gather_along(self._tp("attn_wq"), q, dim=2)
            o = L.decode_attention(qa, ck, cv, cache.n_valid, mesh=self.tp)
            if self.split["attn_wq"]:
                o = o[:, :, self.rank * hl:(self.rank + 1) * hl]
        else:
            kk, vv, _ = self.kv_for_heads(ck, cv, grad=False)
            o = L.decode_attention(q, kk, vv, cache.n_valid)
        h = h + self.out_proj(o, cast, w).to(h.dtype)
        f, _ = self.ffn(L.rmsnorm(w["ln2_g"], h), cast, w)
        return h + f.to(h.dtype)


class Transformer(nn.Module):
    """Embedding -> ``n_layers`` layers (the ``first_dense`` dense ones,
    then the MoE ones; all dense without experts) -> final RMSNorm, and,
    with ``head``, the LM head (``lm_head``; a tied model reads the
    embedding instead).  Parameters are ``param_dtype``: float32 for
    training and the encoder, ``cfg.dtype`` for serving.

    Built under a mesh with a ``"model"`` axis above 1
    (``distributed.sharding.use_mesh``), the model holds this process's
    slice of each weight, as ``sharding.logical_to_spec`` gives its leaf
    (:func:`param_axes`, the whole leaf's shape for the divisibility
    fallback): ``tp`` is the ``"model"`` sub-mesh its products reduce
    over, ``placements`` each parameter's ``sharding.Placement``.  The
    embedding and the head split the (padded) vocabulary: a lookup takes
    the rows held here and sums over ``tp``."""

    def __init__(self, cfg: TransformerConfig, device: str | torch.device = "cuda", *,
                 head: bool = False, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got {cfg.attn_impl!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp = sharding.model_mesh()
        axes, shapes = _flat_leaves(cfg, head)
        self.placements = {} if self.tp is None else sharding.tree_shardings(axes, shapes)
        local = {n: p.local_shape(shapes[n]) for n, p in self.placements.items()}

        def param(name, fill=0.0):
            return nn.Parameter(torch.full(local.get(name, shapes[name]), fill, device=dev,
                                           dtype=param_dtype), requires_grad=False)

        self.embed = param("embed")
        self.final_norm_g = param("final_norm_g", 1.0)
        if head and not cfg.tied_embeddings:
            self.lm_head = param("lm_head")
        self.head = head
        n_dense = cfg.n_layers - cfg.n_moe_layers
        self.layers = nn.ModuleList(
            Layer(cfg, dev, i >= n_dense, param_dtype,
                  {n.split(".", 2)[2]: sh for n, sh in local.items() if n.startswith(f"layers.{i}.")},
                  self.tp)
            for i in range(cfg.n_layers))
        self._casts: dict[int, tuple[tuple, torch.Tensor]] = {}

    @property
    def vocab_tp(self):
        """``tp`` when the vocabulary is split over it, else None."""
        return self.tp if self.embed.shape[0] != self.cfg.padded_vocab else None

    def placement_tree(self):
        """Each parameter's placement in the training tree's layout, or
        None without a ``"model"`` axis."""
        if self.tp is None:
            return None
        return tree_lib.gather(self.placements, param_paths(self.cfg, self.head))

    def embed_lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the compute dtype: with a
        split vocabulary, the rows held here (others zero) summed over
        ``tp``."""
        emb = self.cast(self.embed)
        tp = self.vocab_tp
        if tp is None:
            return emb[tokens.long()]
        n = emb.shape[0]
        t = tokens.long() - tp.rank * n
        here = (t >= 0) & (t < n)
        rows = torch.where(here[..., None], emb[t.clamp(0, n - 1)], 0.0)
        return mesh_mod.reduce_from(tp, rows)

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
        changes (in place, or by ``.to()``); ``p`` itself when it is held
        in the compute dtype."""
        if p.dtype == self.cfg.dtype:
            return p
        stamp = (p._version, p.data_ptr(), p.device)
        hit = self._casts.get(id(p))
        if hit is None or hit[0] != stamp:
            hit = (stamp, p.detach().to(self.cfg.dtype))
            self._casts[id(p)] = hit
        return hit[1]

    def hidden(self, tokens: torch.Tensor, positions: torch.Tensor | None = None, *,
               aux_mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (hidden states (B, S, d) in ``cfg.dtype``, the
        MoE layers' aux values summed in layer order, f32; 0 without MoE
        layers).  With ``aux_mesh`` the tokens are this process's rows of
        a batch split over the mesh's processes, and the aux is this
        process's share of the whole batch's (:func:`moe_aux`)."""
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
        h = self.embed_lookup(tokens)
        stats = []
        for layer in self.layers:
            h, st = layer(h, positions, self.cast)
            if st:
                stats.append(st)
        aux = (moe_aux(stats, self.cfg.n_experts, aux_mesh) if stats
               else torch.zeros((), device=h.device))
        return L.rmsnorm(self.final_norm_g, h), aux

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        """tokens (B, S) -> hidden states (B, S, d) in ``cfg.dtype``."""
        return self.hidden(tokens, positions)[0]

    def numpy_params(self) -> dict:
        """The reference's param tree as numpy (``lm_head`` when the model
        holds one); each layer stack's leaves stacked on a leading ``L``
        axis.  Under tensor parallelism the whole leaves, gathered over
        ``tp`` (a collective)."""
        tree = params_tree(self, param_paths(self.cfg, self.head))
        if self.tp is not None:
            tree = sharding.gather_tree(tree, self.placement_tree())
        return tree_lib.to_numpy(tree)


# --------------------------------------------------------------------------
# MoE: GShard dispatch with group-blocked capacity
# --------------------------------------------------------------------------
def moe_route(router: torch.Tensor, xg: torch.Tensor, cfg: TransformerConfig, cap: int):
    """The router of the reference's ``moe_einsum`` over groups xg (G, g, d):
    f32 scores, softmax, top-k (ties to the lower expert, as
    ``jax.lax.top_k``), gates renormalized over the k choices, and each
    choice's slot in its expert's queue of ``cap``, the choices taken in
    priority order (all first choices of the group, then all second, ...).
    Returns (probs (G, g, E), gates (G, g, k), expert ids (G, g, k) int64,
    slots (G, g, k) int64, keep (G, g, k) bool: the slot is below ``cap``)."""
    k = cfg.top_k
    with ieee_f32_matmul():
        logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = scoring.stable_topk(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    slots = moe_slots(ids, cfg.n_experts)
    return probs, gates, ids, slots, slots < cap


def moe_slots(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each choice's place in its expert's queue (G, g, k): the choices of
    a group in priority order, all first choices by token, then all
    second, and so on (GShard)."""
    counts = torch.zeros((ids.shape[0], n_experts), dtype=torch.int64, device=ids.device)
    slots = []
    for j in range(ids.shape[-1]):
        oh = F.one_hot(ids[:, :, j], n_experts)  # (G, g, E)
        pos = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        slots.append((pos * oh).sum(-1))
        counts = counts + oh.sum(dim=1)
    return torch.stack(slots, dim=-1)


def moe_aux(stats, n_experts: int, mesh=None) -> torch.Tensor:
    """The MoE layers' Switch aux values, ``E * sum(me * ce)`` a layer,
    summed in layer order, from each layer's ``(probability sums (E,),
    first-choice counts (E,), tokens)`` (:func:`moe_ffn`): ``me`` the mean
    router probability of each expert, ``ce`` the share of first choices
    it got, over every token of the groups (padding included, as the
    reference's means are).

    With ``mesh`` the statistics are this process's rows of a batch split
    over the mesh's processes: the counts are summed over the processes by
    one all-reduce (forward only; they carry no gradient), the token count
    is the whole batch's, and ``me`` is this process's probability sum
    over it, so that the processes' values sum to the whole batch's aux
    (it is a product of two batch means, not a mean itself)."""
    counts = torch.stack([c for _, c, _ in stats])  # (layers, E)
    n = stats[0][2]
    if mesh is not None and mesh.world_size > 1:
        counts = mesh_mod.all_reduce_sum(mesh, counts)
        n = n * mesh.world_size
    aux = torch.zeros((), device=counts.device)
    for (p_sum, _, _), c in zip(stats, counts):
        aux = aux + n_experts * torch.sum((p_sum / n) * (c / n))
    return aux


def moe_ffn(w: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: TransformerConfig, cast,
            tp=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, each expert's router
    probability summed over the tokens (E,) f32, each expert's count of
    first choices (E,) f32, the tokens counted), the routed half of the
    reference's ``moe_einsum``: tokens in groups of ``moe_group`` (the last
    one zero-padded), each expert taking at most ``ceil(g k
    capacity_factor / E)`` choices of a group and dropping the rest; plus
    the shared experts when the config has them.

    The reference dispatches and combines with one-hot einsums; here each
    kept choice's row is gathered into its expert's slot (the same values:
    a one-hot product adds zeros), the experts run as one batched product,
    and each token sums its k gated outputs in f32 (gates rounded to the
    compute dtype first, as the reference's ``combine.astype``).

    Under grad it is the reference's einsums' gradient: the router's comes
    through the gates of the kept choices and the probability sums alone
    (the choices, slots, keep masks and counts carry none), and an
    expert's weights get theirs through the rows dispatched to it.  The
    scatter into the slots and the gathers back are ``index_put`` /
    ``index_add`` in the backward pass, atomic f32 sums on the card.

    Expert parallelism (``tp``, and ``w`` holding this process's experts,
    a contiguous run of ``E / tp`` of them): the router runs whole on
    every process; each runs its experts' share of the dispatch, and its
    combine's partial sum (in the compute dtype, the reference's bf16 psum)
    is summed over ``tp``; the shared experts split over ``"mlp"`` join
    that one sum.  The gates and the rows that enter the experts take
    ``copy_to``, so their gradients are summed over ``tp``."""
    B, S, d = x.shape
    E, k, dt = cfg.n_experts, cfg.top_k, cfg.dtype
    g = min(cfg.moe_group, S)
    ng = (S + g - 1) // g
    xg = F.pad(x, (0, 0, 0, ng * g - S)).reshape(B * ng, g, d)
    G = B * ng
    cap = max(int(math.ceil(g * k * cfg.capacity_factor / E)), 1)
    probs, gates, ids, slots, keep = moe_route(w["moe_router"], xg, cfg, cap)

    El = w["moe_wi"].shape[0]  # the experts held here
    etp = tp if El != E else None
    here, keep_here = ids, keep
    if etp is not None:
        first = tp.rank * El
        keep_here = keep & (ids >= first) & (ids < first + El)
        here, gates, xg = ids - first, mesh_mod.copy_to(tp, gates), mesh_mod.copy_to(tp, xg)
    # expert-major slots: row e * G * cap + n * cap + slot of (El, G * cap, d)
    group = torch.arange(G, device=x.device)[:, None, None]
    dest = ((here * G + group) * cap + slots.clamp(max=cap - 1)).clamp(0, El * G * cap - 1)
    token = (group * g + torch.arange(g, device=x.device)[None, :, None]).expand_as(ids)
    xe = torch.zeros((El * G * cap, d), dtype=dt, device=x.device)
    sel = keep_here & (gates > 0)  # the reference dispatches where combine > 0
    xe[dest[sel]] = xg.reshape(G * g, d).to(dt)[token[sel]]
    xe = xe.view(El, G * cap, d)
    with ieee_f32_matmul():
        hid = torch.bmm(xe, cast(w["moe_wi"])) * F.silu(torch.bmm(xe, cast(w["moe_wg"])))
        ye = torch.bmm(hid, cast(w["moe_wo"])).view(El * G * cap, d)
    wgt = torch.where(keep_here, gates, 0.0).to(dt).float()  # (G, g, k)
    out = torch.zeros((G, g, d), device=x.device)
    for j in range(k):  # a dropped choice weighs 0 (its clamped slot is another's)
        out += ye[dest[:, :, j]].float() * wgt[:, :, j, None]
    out = out.to(dt)
    out = out.reshape(B, ng * g, d)[:, :S]
    if "moe_shared_wi" in w:
        stp = tp if w["moe_shared_wi"].shape[1] != cfg.d_ff * cfg.n_shared else None
        shared = L.swiglu(cast(w["moe_shared_wi"]), cast(w["moe_shared_wg"]),
                          cast(w["moe_shared_wo"]), mesh_mod.copy_to(stp, x), dt).to(out.dtype)
        if stp is not None and etp is not None:  # one sum over tp for both
            out = mesh_mod.reduce_from(tp, out + shared)
        else:
            out = mesh_mod.reduce_from(etp, out) + mesh_mod.reduce_from(stp, shared)
    else:
        out = mesh_mod.reduce_from(etp, out)
    counts = F.one_hot(ids[..., 0], E).sum(dim=(0, 1)).float()
    return out.to(x.dtype), probs.sum(dim=(0, 1)), counts, G * g


# --------------------------------------------------------------------------
# LM head, the training loss, and serving: prefill, single-token decode
# with a KV cache
# --------------------------------------------------------------------------
def logits_fn(model: Transformer, h: torch.Tensor, gather: bool = True) -> torch.Tensor:
    """h (B, S, d) -> (B, S, padded_vocab) logits in ``cfg.dtype``; padded
    vocab slots are -1e9.  With the vocabulary split over ``model.tp`` the
    head's columns held here make this process's logits, and ``gather``
    concatenates every process's (else they are returned as they are)."""
    cfg = model.cfg
    if cfg.tied_embeddings:
        head = model.cast(model.embed).t()
    elif model.head:
        head = model.cast(model.lm_head)
    else:
        raise ValueError(f"{cfg.name}: the model holds no LM head (built with head=False)")
    tp = model.vocab_tp
    with ieee_f32_matmul():
        logits = mesh_mod.copy_to(tp, h).to(cfg.dtype) @ head
    n = logits.shape[-1]
    first = 0 if tp is None else tp.rank * n
    if first + n > cfg.vocab:
        real = torch.arange(first, first + n, device=logits.device) < cfg.vocab
        logits = torch.where(real, logits, -1e9)
    return mesh_mod.gather_along(tp, logits, -1) if gather else logits


def lm_loss(model: Transformer, tokens, targets, mask=None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The reference's ``lm_loss``: tokens and targets (B, S) ->
    ``(nll + 0.01 * aux, {"nll", "aux"})``.  Logits in ``cfg.dtype`` (padded
    vocab slots at -1e9), then f32; each position's ``logsumexp`` minus its
    target's logit; the mean over ``mask`` (B, S) (all positions without
    one), its denominator at least 1; ``aux`` the MoE layers' total.

    Under a data-parallel mesh of W processes (``sharding.data_mesh``)
    ``tokens``, ``targets`` and ``mask`` are the global batch on every
    process, and process r takes rows ``[r B/W, (r+1) B/W)``: its nll is
    the sum over its rows divided by the global batch's mask count, and its
    aux its share of the global aux (:func:`moe_aux`), so the processes'
    losses (and gradients) sum to the global batch's.  The processes of a
    ``"model"`` group take the same rows and return the same loss.

    With the vocabulary split over ``model.tp`` the cross-entropy is
    vocab-parallel: the max over the logits held here (a constant shift,
    without gradient), the sum of their exponentials and the target's
    logit (on the process that holds it) are each reduced over ``tp``, and
    no process gathers the logits."""
    dev = model.device
    tokens, targets = torch.as_tensor(tokens, device=dev), torch.as_tensor(targets, device=dev)
    B, S = tokens.shape
    mesh = sharding.data_mesh()
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    if B % world:
        raise ValueError(f"batch {B} does not split over {world} processes")
    b = B // world
    rows = slice(rank * b, (rank + 1) * b)
    h, aux = model.hidden(tokens[rows], aux_mesh=mesh)
    tp = model.vocab_tp
    logits = logits_fn(model, h, gather=False).float()
    tgt_ids = targets[rows].long()
    if tp is None:
        tgt = logits.gather(-1, tgt_ids[..., None])[..., 0]
        nll = torch.logsumexp(logits, dim=-1) - tgt
    else:
        n = logits.shape[-1]
        top = mesh_mod.all_reduce_max(tp, logits.detach().amax(dim=-1))
        t = tgt_ids - tp.rank * n
        here = (t >= 0) & (t < n)
        tgt = torch.where(here, logits.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0], 0.0)
        sum_exp, tgt = mesh_mod.reduce_from(
            tp, torch.stack([torch.exp(logits - top[..., None]).sum(dim=-1), tgt]))
        nll = top + torch.log(sum_exp) - tgt
    mask = (torch.ones((B, S), device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).to(nll.dtype))
    loss = (nll * mask[rows]).sum() / mask.sum().clamp(min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> the last position's logits (B, padded_vocab), the
    reference's ``prefill`` (which writes no cache)."""
    h, _ = model.hidden(tokens)
    return logits_fn(model, h[:, -1:])[:, 0]


def cache_seq_len(cfg: TransformerConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def _cache_seq_sharded(cfg: TransformerConfig, model: int) -> bool:
    """The reference's: on a ``"model"`` axis of extent ``model`` whose
    extent the KV heads do not divide, the cache splits its sequence."""
    return model > 1 and cfg.n_kv_heads % model != 0


def _cache_axes(cfg: TransformerConfig):
    """The KV cache's logical axes (B, Sc, Hkv, dh) under the active mesh,
    the reference's: head-sharded when the KV heads divide the ``"model"``
    extent, else sequence-sharded (decode attention's softmax reductions
    become small all-reduces)."""
    mesh = sharding.active_mesh()
    if _cache_seq_sharded(cfg, 1 if mesh is None else mesh.shape.get("model", 1)):
        return ("batch", "cache_seq", None, "head_dim")
    return ("batch", None, "kv_heads", "head_dim")


def _cache_write_(cache, new_kv, slot: int, seq_sharded: bool, offset: int = 0) -> None:
    """The reference's ``_cache_update`` in place, the same bits: (B, 1,
    Hkv, dh) written into (B, S, Hkv, dh) at sequence index ``slot``.
    Unsharded, its ``dynamic_update_slice`` (the slot clamped into the
    cache); sequence-sharded, its masked select ``where(arange(S) == slot,
    new, cache)`` (a slot outside the cache writes nothing), over the slots
    ``offset ..`` that a process holds."""
    S = cache.shape[1]
    i = min(max(slot, 0), S - 1) if not seq_sharded else slot - offset
    if 0 <= i < S:
        cache[:, i] = new_kv[:, 0].to(cache.dtype)


class KVCache(dict):
    """``{"k", "v"}``: (n_layers, B, slots held here, KV heads held here,
    dh) each, and ``slots``, the whole cache's slot count (the reference's
    Sc).  A piece's shape cannot tell whether its slots were split: over
    two processes, Sc = 10 leaves 5 slots a process, and Sc = 5 (which the
    axis does not divide) 5 whole ones."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, slots: int):
        super().__init__(k=k, v=v)
        self.slots = slots

    def map(self, fn) -> "KVCache":
        """``fn`` over k and v (a layer range, a dtype), the layout kept."""
        return KVCache(fn(self["k"]), fn(self["v"]), self.slots)


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device: str | torch.device = "cuda") -> KVCache:
    """Zeros ``{"k", "v"}`` of (n_layers, batch, Sc, Hkv, dh) in ``cfg.dtype``.
    Under a mesh with a ``"model"`` axis above 1, this process's piece of
    the cache ``_cache_axes`` lays out: its KV heads, or its run of
    ``Sc / model`` slots (the batch stays whole on every process)."""
    slots = cache_seq_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.d_head)
    tp = sharding.model_mesh()
    if tp is not None:
        spec = sharding.logical_to_spec((None,) + _cache_axes(cfg), shape)
        spec = tuple(p if p == "model" else None for p in spec)
        shape = sharding.Placement(None, spec, tp).local_shape(shape)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), slots)


@dataclasses.dataclass(frozen=True)
class _CacheLayout:
    """One decode step's view of the cache on this process: the slot the
    new k and v go to, whether it is the reference's sequence-sharded
    update (no clamp), the first slot held here, whether the slots are
    split over ``tp`` (``seq_split``), and the valid slots held here."""

    slot: int
    seq_sharded: bool
    offset: int
    seq_split: bool
    n_valid: int


def _cache_layout(model: Transformer, cache: Mapping, cache_len: int) -> _CacheLayout:
    cfg, tp = model.cfg, model.tp
    seq_sharded = _cache_seq_sharded(cfg, 1 if tp is None else tp.world_size)
    here = cache["k"].shape[2]
    Sc = getattr(cache, "slots", None)
    if Sc is None:
        if seq_sharded:
            raise ValueError("a sequence-sharded cache must be init_cache's KVCache, "
                             "which records its whole slot count")
        Sc = here
    seq_split = here != Sc
    if seq_split and (not seq_sharded or here * tp.world_size != Sc):
        raise ValueError(f"{here} slots here are no piece of a {Sc}-slot cache")
    slot = cache_len % Sc if cfg.window else cache_len
    offset = tp.rank * here if seq_split else 0
    n_valid = min(cache_len + 1, Sc)
    if seq_split:
        n_valid = min(max(n_valid - offset, 0), here)
    return _CacheLayout(slot, seq_sharded, offset, seq_split, n_valid)


@torch.no_grad()
def decode_step(model: Transformer, cache: dict[str, torch.Tensor], tokens: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: tokens (B,), ``cache_len`` tokens already in the
    cache.  Returns (logits (B, padded_vocab), cache): the cache is updated
    in place and is the reference's returned cache.

    The new k and v go to slot ``cache_len % Sc`` of a sliding-window
    model's ring and to slot ``cache_len`` otherwise (clamped to the last
    slot, as the reference's ``dynamic_update_slice`` clamps, unless the
    cache is sequence-sharded: its masked select writes no slot past the
    end); attention reads ``min(cache_len + 1, Sc)`` slots; RoPE takes the
    absolute position ``cache_len``.  Under tensor parallelism the cache
    is :func:`init_cache`'s piece (a :class:`KVCache`: a sequence-sharded
    one's layout is read from its whole slot count), and a sequence-split
    cache's attention runs every head against this process's slots
    (``layers.decode_attention`` with ``mesh``)."""
    cache_len = int(cache_len)
    B = tokens.shape[0]
    layout = _cache_layout(model, cache, cache_len)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=tokens.device)
    h = model.embed_lookup(tokens)[:, None, :]
    for i, layer in enumerate(model.layers):
        h = layer.decode(h, pos, model.cast, cache["k"][i], cache["v"][i], layout)
    h = L.rmsnorm(model.final_norm_g, h)
    return logits_fn(model, h)[:, 0], cache


def gather_cache(model: Transformer, cache: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The whole cache (the reference's layout) from every process's piece
    (a collective over ``model.tp``; ``cache`` a :class:`KVCache`, or
    ``KVCache.map``'s of some layers); the cache itself without one."""
    tp = model.tp
    if tp is None:
        return cache
    if model.layers[0].split["attn_wk"]:
        dim = 3
    elif _cache_layout(model, cache, 0).seq_split:
        dim = 2
    else:
        return cache
    return {k: mesh_mod.gather_along(tp, cache[k], dim) for k in ("k", "v")}


# --------------------------------------------------------------------------
# the reference's tree
# --------------------------------------------------------------------------
def param_paths(cfg: TransformerConfig, head: bool = False
                ) -> dict[str, tuple[tuple[str, ...], int | None]]:
    """Each parameter's name in :class:`Transformer` -> (its path in the
    reference's tree, its index in the layer stack or None)."""
    out = {"embed": (("embed",), None), "final_norm_g": (("final_norm", "g"), None)}
    if head and not cfg.tied_embeddings:
        out["lm_head"] = (("lm_head",), None)
    n_dense = cfg.n_layers - cfg.n_moe_layers
    for i in range(cfg.n_layers):
        moe = i >= n_dense
        stack, j = ("moe_layers", i - n_dense) if moe else ("dense_layers", i)
        for path in _layer_leaves(cfg, moe):
            out[f"layers.{i}.{_param_name(path)}"] = ((stack,) + path, j)
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
    ("moe", "router"): ("embed_fsdp", None),
    ("moe", "wi"): ("experts", "embed_fsdp", None),
    ("moe", "wg"): ("experts", "embed_fsdp", None),
    ("moe", "wo"): ("experts", None, "embed_fsdp"),
    ("moe", "shared", "wi", "w"): ("embed_fsdp", "mlp"),
    ("moe", "shared", "wg", "w"): ("embed_fsdp", "mlp"),
    ("moe", "shared", "wo", "w"): ("mlp", "embed_fsdp"),
}


def _flat_leaves(cfg: TransformerConfig, head: bool = False) -> tuple[dict, dict]:
    """({parameter name: logical axes}, {parameter name: whole shape}),
    the names of :func:`param_paths`."""
    d, vp = cfg.d_model, cfg.padded_vocab
    axes = {"embed": ("vocab", "embed_fsdp"), "final_norm_g": (None,),
            "lm_head": ("embed_fsdp", "vocab")}
    shapes = {"embed": (vp, d), "final_norm_g": (d,), "lm_head": (d, vp)}
    n_dense = cfg.n_layers - cfg.n_moe_layers
    for i in range(cfg.n_layers):
        for path, shape in _layer_leaves(cfg, i >= n_dense).items():
            axes[f"layers.{i}.{_param_name(path)}"] = _LAYER_AXES[path]
            shapes[f"layers.{i}.{_param_name(path)}"] = shape
    names = param_paths(cfg, head)
    return {n: axes[n] for n in names}, {n: shapes[n] for n in names}


def param_axes(cfg: TransformerConfig, head: bool = False) -> dict:
    """Logical axes of each parameter (``distributed.sharding``), in the
    training tree's layout (``param_paths``: each layer stack a list of
    per-layer tuples); the reference's ``param_axes``."""
    return tree_lib.gather(_flat_leaves(cfg, head)[0], param_paths(cfg, head))


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


def _host_pieces(tree: Mapping, like, placements):
    """The numpy tree ``tree`` (the reference's layout) in ``like``'s
    structure as host arrays, each cut to this process's piece where
    ``placements`` (a tree of ``sharding.Placement`` in ``like``'s
    structure, or None) splits its leaf."""
    host = tree_lib.from_numpy(tree, tree_lib.tree_map(lambda _: None, like))
    if placements is None:
        return host
    return tree_lib.tree_map(lambda a, p: p.piece(a), host, placements)


def params_from_numpy(
    tree: Mapping, cfg: TransformerConfig, device: str | torch.device = "cuda", *,
    param_dtype: torch.dtype = torch.float32,
) -> Transformer:
    """A :class:`Transformer` holding the reference's ``init_params`` tree
    (converted to numpy): ``embed``, ``final_norm``, ``lm_head`` (when the
    tree has one; the model then has an LM head) and the stacked
    ``dense_layers`` / ``moe_layers``.  ``param_dtype`` float32 keeps the
    values bit for bit; another dtype rounds them once.  Under a mesh with
    a ``"model"`` axis above 1, each process takes its piece of each leaf."""
    head = "lm_head" in tree or cfg.tied_embeddings
    model = Transformer(cfg, device, head=head, param_dtype=param_dtype)
    paths = param_paths(cfg, head)
    like = params_tree(model, paths)
    pieces = _host_pieces(tree, like, model.placement_tree())
    assign_params(model, paths, tree_lib.tree_map(
        lambda a, t: torch.from_numpy(np.array(a)).to(t.device, param_dtype),
        pieces, like))
    return model


# --------------------------------------------------------------------------
# the training tree
# --------------------------------------------------------------------------
def train_params(model: Transformer) -> dict:
    """The model's parameters as a training tree, the reference's
    ``init_params`` layout (``lm_head`` when the model holds one, each
    layer stack a list): detached aliases, which a functional train step
    reads and never writes."""
    return params_tree(model, param_paths(model.cfg, model.head))


class _Loss(nn.Module):
    def __init__(self, model: Transformer):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return lm_loss(self.model, batch["tokens"], batch["targets"], batch.get("mask"))


def loss_fn(model: Transformer):
    """``(params, batch) -> lm_loss(model with params, batch["tokens"],
    batch["targets"], batch.get("mask"))``, the loss function
    ``training.loop.make_train_step`` takes; ``params`` is a training tree
    (:func:`train_params`)."""
    bound = _Loss(model)
    paths = param_paths(model.cfg, model.head)

    def fn(params, batch):
        named = {f"model.{k}": v for k, v in tree_lib.scatter(params, paths).items()}
        return torch.func.functional_call(bound, named, (batch,))

    return fn


def train_state_from_numpy(
    tree: Mapping, cfg: TransformerConfig, device: str | torch.device = "cuda"
) -> tuple[Transformer, dict]:
    """The reference's LM training state ``{"params": ..., "opt": {"mu",
    "nu", "step"[, "ef"]}}`` (as numpy; ``opt`` may be left out) -> (a
    float32 model holding ``params``, the port's state with every leaf on
    ``device``); ``training.tree.to_numpy`` is its inverse.  Under a mesh
    with a ``"model"`` axis above 1 each process holds its piece of every
    leaf (``state_placements``)."""
    model = params_from_numpy(tree["params"], cfg, device)
    like = train_params(model)
    state = {"params": like}
    if "opt" in tree:
        state["opt"] = {k: (model.embed if k == "step" else like) for k in tree["opt"]}
    place = state_placements(model, state)
    pieces = _host_pieces(tree, state, place)
    return model, tree_lib.tree_map(lambda a, t: torch.from_numpy(np.array(a)).to(t.device),
                                    pieces, state)


def state_placements(model: Transformer, state: Mapping):
    """Each leaf's ``sharding.Placement`` in a training state ``{"params",
    "opt": {"mu", "nu", "step"[, "ef"]}}`` of ``model`` (the moments
    placed as the parameters, the step replicated), or None without a
    ``"model"`` axis."""
    return sharding.state_placements(model.placement_tree(), state)


def _normal(shape, scale: float, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * scale


@torch.no_grad()
def init_params(
    cfg: TransformerConfig, generator: torch.Generator, device: str | torch.device = "cuda",
    *, head: bool = False, param_dtype: torch.dtype = torch.float32,
) -> Transformer:
    """Random weights with the reference's shapes, scales and zero padding
    (not its numbers: ``torch.Generator`` is not ``jax.random``), drawn
    one tensor at a time in float32 and stored in ``param_dtype``: a
    serving model in ``cfg.dtype`` never holds a float32 copy of more than
    one weight.  Under tensor parallelism every process draws each whole
    tensor in the same order and keeps its piece, so the pieces are those
    of the one-process model drawn from the same generator."""
    model = Transformer(cfg, device, head=head, param_dtype=param_dtype)
    dev = model.device
    params = dict(model.named_parameters())

    def draw(shape, scale):
        return _normal(shape, scale, generator).to(dev)

    def put(name, whole):  # this process's piece of the whole tensor
        p = model.placements.get(name)
        params[name].copy_(whole if p is None else p.piece(whole))

    def padded(shape, real, scale):  # zeros but for ``real``, drawn
        whole = torch.zeros(shape, device=dev)
        whole[real] = draw(whole[real].shape, scale)
        return whole

    d, dh, hkv, dff = cfg.d_model, cfg.d_head, cfg.n_kv_heads, cfg.d_ff
    g, gp = cfg.n_heads // hkv, cfg.group_pad
    put("embed", padded((cfg.padded_vocab, d), slice(0, cfg.vocab), 0.02))
    scale = (2.0 / (d + cfg.n_heads * dh)) ** 0.5
    for i, lay in enumerate(model.layers):
        leaves = {_param_name(k): v for k, v in _layer_leaves(cfg, lay.moe).items()}
        name = f"layers.{i}.".__add__
        # kv-group-major: head (kvh, j) lives at flat index kvh * gp + j;
        # padded slots (j >= g) stay zero
        put(name("attn_wq"), padded((d, hkv, gp, dh), (slice(None), slice(None), slice(0, g)),
                                    scale).view(leaves["attn_wq"]))
        put(name("attn_wo"), padded((hkv, gp, dh, d), (slice(None), slice(0, g)),
                                    scale).view(leaves["attn_wo"]))
        put(name("attn_wk"), draw(leaves["attn_wk"], scale))
        put(name("attn_wv"), draw(leaves["attn_wv"], scale))
        lay.ln1_g.fill_(1.0)
        lay.ln2_g.fill_(1.0)
        if lay.moe:  # experts and the shared SwiGLU: (2 / (d + its width)) ** 0.5
            put(name("moe_router"), draw(leaves["moe_router"], 0.02))
            ffn = [(n, dff) for n in ("moe_wi", "moe_wg", "moe_wo")]
            if cfg.n_shared:
                ffn += [(n, dff * cfg.n_shared)
                        for n in ("moe_shared_wi", "moe_shared_wg", "moe_shared_wo")]
        else:
            fdim = (cfg.d_ff_dense or dff) if cfg.n_experts else dff
            ffn = [(n, fdim) for n in ("ffn_wi", "ffn_wg", "ffn_wo")]
        for n, width in ffn:
            put(name(n), draw(leaves[n], (2.0 / (d + width)) ** 0.5))
    if head and not cfg.tied_embeddings:
        put("lm_head", padded((d, cfg.padded_vocab), (slice(None), slice(0, cfg.vocab)), 0.02))
    return model
