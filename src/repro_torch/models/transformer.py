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

Not ported yet: a mesh with a ``"model"`` axis above 1 (tensor and expert
parallelism, the FSDP rules) and the sequence-sharded cache update
(``_cache_update`` with ``seq_sharded``), ROADMAP Queue 1 item 8.3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

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
    ``moe/shared/wi/w``, and so on."""

    def __init__(self, cfg: TransformerConfig, device: torch.device, moe: bool,
                 param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.moe = cfg, moe
        leaves = _layer_leaves(cfg, moe)
        #: parameter names, in the order ``block`` takes them
        self.names = tuple(_param_name(p) for p in leaves)
        for path, shape in leaves.items():
            self.register_parameter(
                _param_name(path),
                nn.Parameter(torch.zeros(shape, device=device, dtype=param_dtype),
                             requires_grad=False),
            )

    def project_qkv(self, x, positions, cast, w) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q (B, S, Hp, dh), k and v (B, S, Hkv, dh) in ``cfg.dtype``, RoPE
        applied to q and k at ``positions``."""
        cfg = self.cfg
        B, S, d = x.shape
        hp, hkv, dh = cfg.padded_heads, cfg.n_kv_heads, cfg.d_head
        x = x.to(cfg.dtype)
        with ieee_f32_matmul():
            q = (x @ cast(w["attn_wq"]).reshape(d, hp * dh)).view(B, S, hp, dh)
            k = (x @ cast(w["attn_wk"]).reshape(d, hkv * dh)).view(B, S, hkv, dh)
            v = (x @ cast(w["attn_wv"]).reshape(d, hkv * dh)).view(B, S, hkv, dh)
        return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta), v

    def out_proj(self, o, cast, w) -> torch.Tensor:
        cfg = self.cfg
        B, S = o.shape[:2]
        with ieee_f32_matmul():
            return (o.reshape(B, S, cfg.padded_heads * cfg.d_head).to(cfg.dtype)
                    @ cast(w["attn_wo"]).reshape(-1, cfg.d_model))

    def attention(self, x, positions, cast, w) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.project_qkv(x, positions, cast, w)
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
        return self.out_proj(o, cast, w)

    def ffn(self, x2, cast, w) -> tuple[torch.Tensor, tuple]:
        """The feed-forward half: (out, router statistics): an MoE layer's
        (probability sums, first-choice counts, tokens), as
        :func:`moe_ffn` returns them; none for a dense layer."""
        if self.moe:
            out, *stats = moe_ffn(w, x2, self.cfg, cast)
            return out, tuple(stats)
        out = L.swiglu(cast(w["ffn_wi"]), cast(w["ffn_wg"]), cast(w["ffn_wo"]), x2, self.cfg.dtype)
        return out, ()

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

    def decode(self, h, positions, cast, ck, cv, slot: int, n_valid: int) -> torch.Tensor:
        """One token a row (h (B, 1, d)): writes its k and v into this
        layer's cache (ck, cv: (B, Sc, Hkv, dh)) at ``slot``, in place, and
        attends to the first ``n_valid`` slots."""
        w = {n: getattr(self, n) for n in self.names}
        q, k, v = self.project_qkv(L.rmsnorm(w["ln1_g"], h), positions, cast, w)
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        o = L.decode_attention(q, ck, cv, n_valid)
        h = h + self.out_proj(o, cast, w).to(h.dtype)
        f, _ = self.ffn(L.rmsnorm(w["ln2_g"], h), cast, w)
        return h + f.to(h.dtype)


class Transformer(nn.Module):
    """Embedding -> ``n_layers`` layers (the ``first_dense`` dense ones,
    then the MoE ones; all dense without experts) -> final RMSNorm, and,
    with ``head``, the LM head (``lm_head``; a tied model reads the
    embedding instead).  Parameters are ``param_dtype``: float32 for
    training and the encoder, ``cfg.dtype`` for serving."""

    def __init__(self, cfg: TransformerConfig, device: str | torch.device = "cuda", *,
                 head: bool = False, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl must be 'chunked' or 'flash', got {cfg.attn_impl!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.zeros((cfg.padded_vocab, cfg.d_model), device=dev, dtype=param_dtype),
            requires_grad=False,
        )
        self.final_norm_g = nn.Parameter(torch.ones(cfg.d_model, device=dev, dtype=param_dtype),
                                         requires_grad=False)
        if head and not cfg.tied_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.padded_vocab), device=dev, dtype=param_dtype),
                requires_grad=False,
            )
        self.head = head
        n_dense = cfg.n_layers - cfg.n_moe_layers
        self.layers = nn.ModuleList(Layer(cfg, dev, i >= n_dense, param_dtype)
                                    for i in range(cfg.n_layers))
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
        h = self.cast(self.embed)[tokens.long()]
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
        axis."""
        return tree_lib.to_numpy(params_tree(self, param_paths(self.cfg, self.head)))


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


def moe_ffn(w: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: TransformerConfig, cast
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
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
    ``index_add`` in the backward pass, atomic f32 sums on the card."""
    B, S, d = x.shape
    E, k, dt = cfg.n_experts, cfg.top_k, cfg.dtype
    g = min(cfg.moe_group, S)
    ng = (S + g - 1) // g
    xg = F.pad(x, (0, 0, 0, ng * g - S)).reshape(B * ng, g, d)
    G = B * ng
    cap = max(int(math.ceil(g * k * cfg.capacity_factor / E)), 1)
    probs, gates, ids, slots, keep = moe_route(w["moe_router"], xg, cfg, cap)

    # expert-major slots: row e * G * cap + n * cap + slot of (E, G * cap, d)
    group = torch.arange(G, device=x.device)[:, None, None]
    dest = (ids * G + group) * cap + slots.clamp(max=cap - 1)
    token = (group * g + torch.arange(g, device=x.device)[None, :, None]).expand_as(ids)
    xe = torch.zeros((E * G * cap, d), dtype=dt, device=x.device)
    sel = keep & (gates > 0)  # the reference dispatches where combine > 0
    xe[dest[sel]] = xg.reshape(G * g, d).to(dt)[token[sel]]
    xe = xe.view(E, G * cap, d)
    with ieee_f32_matmul():
        hid = torch.bmm(xe, cast(w["moe_wi"])) * F.silu(torch.bmm(xe, cast(w["moe_wg"])))
        ye = torch.bmm(hid, cast(w["moe_wo"])).view(E * G * cap, d)
    wgt = torch.where(keep, gates, 0.0).to(dt).float()  # (G, g, k)
    out = torch.zeros((G, g, d), device=x.device)
    for j in range(k):  # a dropped choice weighs 0 (its clamped slot is another's)
        out += ye[dest[:, :, j]].float() * wgt[:, :, j, None]
    out = out.to(dt)
    out = out.reshape(B, ng * g, d)[:, :S]
    if "moe_shared_wi" in w:
        out = out + L.swiglu(cast(w["moe_shared_wi"]), cast(w["moe_shared_wg"]),
                             cast(w["moe_shared_wo"]), x, dt).to(out.dtype)
    counts = F.one_hot(ids[..., 0], E).sum(dim=(0, 1)).float()
    return out.to(x.dtype), probs.sum(dim=(0, 1)), counts, G * g


# --------------------------------------------------------------------------
# LM head, the training loss, and serving: prefill, single-token decode
# with a KV cache
# --------------------------------------------------------------------------
def logits_fn(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, d) -> (B, S, padded_vocab) logits in ``cfg.dtype``; padded
    vocab slots are -1e9."""
    cfg = model.cfg
    if cfg.tied_embeddings:
        head = model.cast(model.embed).t()
    elif model.head:
        head = model.cast(model.lm_head)
    else:
        raise ValueError(f"{cfg.name}: the model holds no LM head (built with head=False)")
    with ieee_f32_matmul():
        logits = h.to(cfg.dtype) @ head
    if cfg.padded_vocab != cfg.vocab:
        real = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(real, logits, -1e9)
    return logits


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
    losses (and gradients) sum to the global batch's."""
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
    logits = logits_fn(model, h).float()
    tgt = logits.gather(-1, targets[rows, :, None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - tgt
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


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Zeros ``{"k", "v"}`` of (n_layers, batch, Sc, Hkv, dh) in ``cfg.dtype``."""
    shape = (cfg.n_layers, batch, cache_seq_len(cfg, seq_len), cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


@torch.no_grad()
def decode_step(model: Transformer, cache: dict[str, torch.Tensor], tokens: torch.Tensor,
                cache_len: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: tokens (B,), ``cache_len`` tokens already in the
    cache.  Returns (logits (B, padded_vocab), cache): the cache is updated
    in place and is the reference's returned cache.

    The new k and v go to slot ``cache_len % Sc`` of a sliding-window
    model's ring and to slot ``cache_len`` otherwise (clamped to the last
    slot, as the reference's ``dynamic_update_slice`` clamps); attention
    reads ``min(cache_len + 1, Sc)`` slots; RoPE takes the absolute
    position ``cache_len``."""
    cfg = model.cfg
    cache_len = int(cache_len)
    B = tokens.shape[0]
    Sc = cache["k"].shape[2]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=tokens.device)
    slot = cache_len % Sc if cfg.window else min(cache_len, Sc - 1)
    n_valid = min(cache_len + 1, Sc)
    h = model.cast(model.embed)[tokens.long()][:, None, :]
    for i, layer in enumerate(model.layers):
        h = layer.decode(h, pos, model.cast, cache["k"][i], cache["v"][i], slot, n_valid)
    h = L.rmsnorm(model.final_norm_g, h)
    return logits_fn(model, h)[:, 0], cache


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


def param_axes(cfg: TransformerConfig, head: bool = False) -> dict:
    """Logical axes of each parameter (``distributed.sharding``), in the
    training tree's layout (``param_paths``: each layer stack a list of
    per-layer tuples); the reference's ``param_axes``."""
    names = {"embed": ("vocab", "embed_fsdp"), "final_norm_g": (None,),
             "lm_head": ("embed_fsdp", "vocab")}
    paths = param_paths(cfg, head)
    for name, (path, _) in paths.items():
        if name.startswith("layers."):
            names[name] = _LAYER_AXES[path[1:]]
    return tree_lib.gather(names, paths)


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
    tree: Mapping, cfg: TransformerConfig, device: str | torch.device = "cuda", *,
    param_dtype: torch.dtype = torch.float32,
) -> Transformer:
    """A :class:`Transformer` holding the reference's ``init_params`` tree
    (converted to numpy): ``embed``, ``final_norm``, ``lm_head`` (when the
    tree has one; the model then has an LM head) and the stacked
    ``dense_layers`` / ``moe_layers``.  ``param_dtype`` float32 keeps the
    values bit for bit; another dtype rounds them once."""
    head = "lm_head" in tree or cfg.tied_embeddings
    model = Transformer(cfg, device, head=head, param_dtype=param_dtype)
    paths = param_paths(cfg, head)
    arrays = tree_lib.from_numpy(tree, params_tree(model, paths))
    assign_params(model, paths, tree_lib.tree_map(lambda t: t.to(param_dtype), arrays))
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
    ``device``); ``training.tree.to_numpy`` is its inverse."""
    model = params_from_numpy(tree["params"], cfg, device)
    like = train_params(model)
    state = {"params": like}
    if "opt" in tree:
        state["opt"] = {k: (model.embed if k == "step" else like) for k in tree["opt"]}
    return model, tree_lib.from_numpy(tree, state)


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
    one weight."""
    model = Transformer(cfg, device, head=head, param_dtype=param_dtype)
    dev = model.device

    def draw(shape, scale):
        return _normal(shape, scale, generator).to(dev)

    d, dh, hkv, dff = cfg.d_model, cfg.d_head, cfg.n_kv_heads, cfg.d_ff
    g, gp = cfg.n_heads // hkv, cfg.group_pad
    model.embed[: cfg.vocab] = draw((cfg.vocab, d), 0.02)
    scale = (2.0 / (d + cfg.n_heads * dh)) ** 0.5
    for lay in model.layers:
        # kv-group-major: head (kvh, j) lives at flat index kvh * gp + j;
        # padded slots (j >= g) stay zero
        lay.attn_wq.view(d, hkv, gp, dh)[:, :, :g] = draw((d, hkv, g, dh), scale)
        lay.attn_wo.view(hkv, gp, dh, d)[:, :g] = draw((hkv, g, dh, d), scale)
        lay.attn_wk.copy_(draw((d, hkv, dh), scale))
        lay.attn_wv.copy_(draw((d, hkv, dh), scale))
        lay.ln1_g.fill_(1.0)
        lay.ln2_g.fill_(1.0)
        if lay.moe:  # experts and the shared SwiGLU: (2 / (d + its width)) ** 0.5
            lay.moe_router.copy_(draw(tuple(lay.moe_router.shape), 0.02))
            ffn = [(p, dff) for p in (lay.moe_wi, lay.moe_wg, lay.moe_wo)]
            if cfg.n_shared:
                ffn += [(p, dff * cfg.n_shared)
                        for p in (lay.moe_shared_wi, lay.moe_shared_wg, lay.moe_shared_wo)]
        else:
            fdim = (cfg.d_ff_dense or dff) if cfg.n_experts else dff
            ffn = [(p, fdim) for p in (lay.ffn_wi, lay.ffn_wg, lay.ffn_wo)]
        for p, width in ffn:
            p.copy_(draw(tuple(p.shape), (2.0 / (d + width)) ** 0.5))
    if head and not cfg.tied_embeddings:
        model.lm_head[:, : cfg.vocab] = draw((d, cfg.vocab), 0.02)
    return model
