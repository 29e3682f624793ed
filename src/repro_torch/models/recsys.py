"""The recsys family in plain PyTorch (the counterpart of
``repro.models.recsys``): xDeepFM, BST, BERT4Rec and Wide&Deep.

Every categorical field lives in ONE row-major table of shape (n_fields *
hash_size, dim); a lookup is a gather from it (``field_lookup``) and
``embedding_bag`` is a gather followed by a segment sum (``index_add``).
The parameters are a tree in the reference's layout (nested dicts, an
MLP's layers and the encoder blocks Python lists of dicts), so the
reference's ``init_params`` tree carries across as numpy
(``params_from_numpy`` / ``numpy_params``) and ``training.loop`` takes the
functions below as they are.

Each model implements:

* ``train_loss(params, cfg, batch)``: the pointwise CTR log loss, or
  BERT4Rec's masked-item cross-entropy over the whole catalog, gathered
  first to the masked positions (logits (B, M, V), never (B, S, V));
* ``serve_scores(params, cfg, batch)``: batched pointwise scoring;
* ``retrieval_scores(params, cfg, batch)``: one user against
  ``candidate_ids``, then the top-k (ties toward the lower index, as
  ``jax.lax.top_k``: ``core.scoring.stable_topk``).

Conventions kept from the reference: the attention softmax runs in f32,
the FFN's GELU is the tanh approximation (``jax.nn.gelu``'s default),
layernorm's ``eps`` is 1e-6, the BCE is written term for term as the
reference writes it, and the tables' gradients are dense f32 (no sparse
gradients).  No product runs in TF32 (``ieee_f32_matmul``).

The family runs on one device.  On a mesh of several devices (the
reference shards its tables over ``"table_rows"``, its batch and its
candidates over the mesh) ``train_loss`` and ``retrieval_scores`` raise,
naming ROADMAP Queue 1 item 8.5.8; ``serve_scores`` scores the rows it is
handed, whole tables on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch import ieee_f32_matmul
from repro_torch.core.scoring import stable_topk
from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.training import tree as tree_lib


# --------------------------------------------------------------------------
# EmbeddingBag substrate
# --------------------------------------------------------------------------
def embedding_bag(
    table: torch.Tensor,  # (rows, dim)
    ids: torch.Tensor,  # (n,) row ids
    bag_ids: torch.Tensor,  # (n,) output bag per id
    n_bags: int,
    weights: torch.Tensor | None = None,  # (n,) per-id weights
    mode: str = "sum",
) -> torch.Tensor:
    """PyTorch-EmbeddingBag semantics as the reference builds them: a
    gather, then a segment sum over ``bag_ids`` (``index_add``: on the card
    an atomic sum in no fixed order)."""
    vecs = F.embedding(ids.long(), table)  # (n, dim)
    if weights is not None:
        vecs = vecs * weights[:, None]
    bags = bag_ids.long()
    out = vecs.new_zeros((n_bags, vecs.shape[1])).index_add(0, bags, vecs)
    if mode == "mean":
        cnt = vecs.new_zeros((n_bags,)).index_add(0, bags, torch.ones_like(vecs[:, 0]))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def field_lookup(table: torch.Tensor, ids: torch.Tensor, hash_size: int) -> torch.Tensor:
    """ids (B, F) per-field local ids -> (B, F, dim) from the unified table."""
    B, nf = ids.shape
    offsets = torch.arange(nf, device=ids.device, dtype=torch.int64) * hash_size
    rows = ids.long() + offsets[None, :]
    return F.embedding(rows.reshape(-1), table).reshape(B, nf, -1)


def mlp_init(generator: torch.Generator, dims) -> list:
    return [L.dense_bias_init(generator, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def mlp_apply(params: list, x: torch.Tensor, dtype=None, final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(params):
        x = L.dense_bias(p["w"], p["b"], x, dtype)
        if final_act or i < len(params) - 1:
            x = torch.relu(x)
    return x


def _mlp_axes(dims):
    return [{"w": ("embed_fsdp", "mlp"), "b": ("mlp",)} for _ in range(len(dims) - 1)]


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str = "wide-deep"
    interaction: str = "concat"  # cin | transformer-seq | bidir-seq | concat
    n_sparse: int = 40
    embed_dim: int = 32
    hash_size: int = 1 << 20  # rows per categorical field
    mlp: tuple[int, ...] = (1024, 512, 256)
    n_dense: int = 13  # continuous features
    # CIN (xDeepFM)
    cin_layers: tuple[int, ...] = ()
    # sequence models (BST / BERT4Rec)
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    item_vocab: int = 0
    mask_frac: float = 0.15  # BERT4Rec masking
    dtype: torch.dtype = torch.float32

    def num_params(self) -> int:
        n = 0
        if self.interaction in ("cin", "concat"):
            n += self.n_sparse * self.hash_size * self.embed_dim
            n += self.n_sparse * self.hash_size  # wide/linear weights
        if self.item_vocab:
            n += (self.item_vocab + 2) * self.embed_dim
        d_in = self._mlp_in()
        for a, b in zip((d_in,) + self.mlp, self.mlp + (1,)):
            n += a * b + b
        if self.cin_layers:
            h_prev = self.n_sparse
            for h in self.cin_layers:
                n += h_prev * self.n_sparse * h
                h_prev = h
            n += sum(self.cin_layers)
        if self.n_blocks:
            d = self.embed_dim
            n += self.n_blocks * (4 * d * d + 8 * d * d + 4 * d)
        return n

    def _mlp_in(self) -> int:
        if self.interaction in ("cin", "concat"):
            return self.n_sparse * self.embed_dim + self.n_dense
        if self.interaction == "transformer-seq":
            return (self.seq_len + 1) * self.embed_dim + self.n_dense
        if self.interaction == "bidir-seq":
            return self.embed_dim
        raise ValueError(self.interaction)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def _normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device).mul_(scale)


def _encoder_block_init(generator: torch.Generator, d: int, d_ff: int) -> dict:
    dev = generator.device
    return {
        "attn": {name: L.dense_init(generator, d, d) for name in ("wq", "wk", "wv", "wo")},
        "ln1": L.layernorm_init(d, dev),
        "ffn": {"w1": L.dense_bias_init(generator, d, d_ff),
                "w2": L.dense_bias_init(generator, d_ff, d)},
        "ln2": L.layernorm_init(d, dev),
    }


@torch.no_grad()
def init_params(cfg: RecSysConfig, generator: torch.Generator) -> dict:
    """Random weights with the reference's tree, shapes and scales (not its
    numbers: ``torch.Generator`` is not ``jax.random``), f32 on the
    generator's device."""
    g = generator
    p = {}
    if cfg.interaction in ("cin", "concat"):
        rows = cfg.n_sparse * cfg.hash_size
        p["table"] = _normal(g, (rows, cfg.embed_dim), 0.01)
        p["wide"] = _normal(g, (rows, 1), 0.01)
    if cfg.item_vocab:
        p["items"] = _normal(g, (cfg.item_vocab + 2, cfg.embed_dim), 0.02)
        p["pos"] = _normal(g, (cfg.seq_len + 1, cfg.embed_dim), 0.02)
    if cfg.cin_layers:
        h_prev, cin = cfg.n_sparse, []
        for h in cfg.cin_layers:
            fan = h_prev * cfg.n_sparse
            cin.append({"w": _normal(g, (fan, h), (2.0 / fan) ** 0.5)})
            h_prev = h
        p["cin"] = cin
        p["cin_out"] = L.dense_bias_init(g, sum(cfg.cin_layers), 1)
    if cfg.n_blocks:
        p["blocks"] = [_encoder_block_init(g, cfg.embed_dim, 4 * cfg.embed_dim)
                       for _ in range(cfg.n_blocks)]
    if cfg.interaction != "bidir-seq":
        p["mlp"] = mlp_init(g, (cfg._mlp_in(),) + cfg.mlp + (1,))
    return p


def param_axes(cfg: RecSysConfig) -> dict:
    """Logical axes of each parameter (``distributed.sharding``), the
    reference's ``param_axes``."""
    ax = {}
    if cfg.interaction in ("cin", "concat"):
        ax["table"] = ("table_rows", None)
        ax["wide"] = ("table_rows", None)
    if cfg.item_vocab:
        ax["items"] = ("table_rows", None)
        ax["pos"] = (None, None)
    if cfg.cin_layers:
        ax["cin"] = [{"w": (None, "mlp")} for _ in cfg.cin_layers]
        ax["cin_out"] = {"w": ("mlp", None), "b": (None,)}
    if cfg.n_blocks:
        blk = {
            "attn": {"wq": {"w": (None, "mlp")}, "wk": {"w": (None, "mlp")},
                     "wv": {"w": (None, "mlp")}, "wo": {"w": ("mlp", None)}},
            "ln1": {"g": (None,), "b": (None,)},
            "ffn": {"w1": {"w": (None, "mlp"), "b": ("mlp",)},
                    "w2": {"w": ("mlp", None), "b": (None,)}},
            "ln2": {"g": (None,), "b": (None,)},
        }
        ax["blocks"] = [blk for _ in range(cfg.n_blocks)]
    if cfg.interaction != "bidir-seq":
        ax["mlp"] = _mlp_axes((cfg._mlp_in(),) + cfg.mlp + (1,))
    return ax


def params_from_numpy(tree: Mapping, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_params`` tree (as numpy) as the port's tree on
    ``device``, value for value."""
    return tree_lib.tensors(tree, device)


def numpy_params(params: Mapping) -> dict:
    """The port's tree as the reference's numpy tree."""
    return tree_lib.to_numpy(params)


# --------------------------------------------------------------------------
# Interactions
# --------------------------------------------------------------------------
def cin_apply(params: Mapping, emb: torch.Tensor, dtype=None) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM eq. 6-8).

    emb: (B, m, D).  Layer k: z = outer(X_k, X_0) over fields, 1x1 conv.
    Sum-pool each layer over D, concat, project to a logit -> (B,)."""
    x0 = xk = emb
    pooled = []
    with ieee_f32_matmul():
        for lp in params["cin"]:
            z = torch.einsum("bhd,bmd->bhmd", xk, x0)  # (B, Hk, m, D)
            B, Hk, m, D = z.shape
            # (B, Hnext, D): the 1x1 "conv" over field pairs
            xk = torch.relu(torch.einsum("bqd,qh->bhd", z.reshape(B, Hk * m, D),
                                         lp["w"].to(z.dtype)))
            pooled.append(xk.sum(dim=-1))  # (B, Hnext)
    feats = torch.cat(pooled, dim=-1)
    return L.dense_bias(params["cin_out"]["w"], params["cin_out"]["b"], feats)[:, 0]


def encoder_block(p: Mapping, x: torch.Tensor, n_heads: int, dtype=None) -> torch.Tensor:
    """Post-LN transformer encoder block (BST / BERT4Rec style)."""
    B, S, d = x.shape
    dh = d // n_heads
    a = p["attn"]
    q = L.dense(a["wq"]["w"], x, dtype).reshape(B, S, -1, dh)
    k = L.dense(a["wk"]["w"], x, dtype).reshape(B, S, -1, dh)
    v = L.dense(a["wv"]["w"], x, dtype).reshape(B, S, -1, dh)
    with ieee_f32_matmul():
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh**-0.5
        w = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, -1)
    x = L.layernorm(p["ln1"]["g"], p["ln1"]["b"], x + L.dense(a["wo"]["w"], o, dtype))
    f = p["ffn"]
    h = F.gelu(L.dense_bias(f["w1"]["w"], f["w1"]["b"], x, dtype), approximate="tanh")
    return L.layernorm(p["ln2"]["g"], p["ln2"]["b"],
                       x + L.dense_bias(f["w2"]["w"], f["w2"]["b"], h, dtype))


def seq_encode(params: Mapping, cfg: RecSysConfig, seq_ids: torch.Tensor,
               extra_emb: torch.Tensor | None = None) -> torch.Tensor:
    """Embed + position + transformer blocks.  seq_ids (B, S) -> (B, S', d)."""
    x = F.embedding(seq_ids.long(), params["items"])  # (B, S, d)
    if extra_emb is not None:
        x = torch.cat([x, extra_emb], dim=1)
    x = x + params["pos"][None, : x.shape[1], :]
    for blk in params["blocks"]:
        x = encoder_block(blk, x.to(cfg.dtype), cfg.n_heads, cfg.dtype)
    return x


# --------------------------------------------------------------------------
# Pointwise scoring (train / serve_p99 / serve_bulk)
# --------------------------------------------------------------------------
def pointwise_logits(params: Mapping, cfg: RecSysConfig, batch: Mapping) -> torch.Tensor:
    """One logit an example -> (B,)."""
    if cfg.interaction in ("cin", "concat"):
        ids = batch["sparse_ids"]
        emb = field_lookup(params["table"], ids, cfg.hash_size)
        flat = emb.reshape(emb.shape[0], -1)
        if cfg.n_dense:
            flat = torch.cat([flat, batch["dense_feats"]], dim=-1)
        deep = mlp_apply(params["mlp"], flat.to(cfg.dtype), cfg.dtype)[:, 0]
        B, nf = ids.shape
        fields = torch.arange(nf, device=ids.device, dtype=torch.int64)[None, :] * cfg.hash_size
        wide = embedding_bag(
            params["wide"], (ids.long() + fields).reshape(-1),
            torch.arange(B, device=ids.device).repeat_interleave(nf), B,
        )[:, 0]
        logit = deep + wide
        if cfg.interaction == "cin":
            logit = logit + cin_apply(params, emb.to(cfg.dtype), cfg.dtype)
        return logit
    if cfg.interaction == "transformer-seq":  # BST
        tgt = F.embedding(batch["target_id"].long(), params["items"])[:, None]
        x = seq_encode(params, cfg, batch["seq_ids"], extra_emb=tgt)
        flat = x.reshape(x.shape[0], -1)
        if cfg.n_dense:
            flat = torch.cat([flat, batch["dense_feats"]], dim=-1)
        return mlp_apply(params["mlp"], flat.to(cfg.dtype), cfg.dtype)[:, 0]
    if cfg.interaction == "bidir-seq":  # BERT4Rec: score the target at the last position
        state = seq_encode(params, cfg, batch["seq_ids"])[:, -1]  # (B, d)
        tgt = F.embedding(batch["target_id"].long(), params["items"])
        return (state * tgt.to(state.dtype)).sum(dim=-1)
    raise ValueError(cfg.interaction)


#: the refusal of the family on a mesh of several devices
MESH_ITEM = "ROADMAP Queue 1 item 8.5.8 (the recsys family over several processes)"


def refuse_mesh(what: str) -> None:
    """Raise when the active mesh has several devices (module docstring)."""
    mesh = sharding.active_mesh()
    n = 1 if mesh is None else math.prod(mesh.shape.values())
    if n > 1:
        raise NotImplementedError(f"{what} on a mesh of {n} devices is not ported ({MESH_ITEM})")


def train_loss(params: Mapping, cfg: RecSysConfig, batch: Mapping,
               max_masked: int | None = None):
    """``(loss, {"loss": loss})``.  BERT4Rec: cross-entropy over the whole
    catalog at the first ``M = max(int(2 * mask_frac * S), 1)`` masked
    positions of each row (a stable partition; masked positions past M are
    dropped, as the reference drops them); the others: the mean BCE of the
    logits against ``labels``."""
    refuse_mesh("recsys training")
    if cfg.interaction == "bidir-seq":
        x = seq_encode(params, cfg, batch["seq_ids"])
        labels = batch["labels"]  # (B, S) original ids, -1 unmasked
        B, S = labels.shape
        M = max_masked or max(int(2 * cfg.mask_frac * S), 1)
        is_masked = labels >= 0
        # the first M masked slots of each row, in order, then unmasked ones
        order = torch.argsort((~is_masked).to(torch.uint8), dim=1, stable=True)[:, :M]
        sel_valid = torch.gather(is_masked, 1, order)
        xm = torch.gather(x, 1, order[..., None].expand(B, M, x.shape[-1]))  # (B, M, d)
        lab = torch.gather(labels, 1, order)
        with ieee_f32_matmul():
            logits = xm.float() @ params["items"].t()  # (B, M, V)
        lmask = sel_valid.float()
        safe = torch.where(lab >= 0, lab, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
        loss = ((logz - tgt) * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)
        return loss, {"loss": loss}
    logit = pointwise_logits(params, cfg, batch)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit))))
    return loss, {"loss": loss}


def serve_scores(params: Mapping, cfg: RecSysConfig, batch: Mapping) -> torch.Tensor:
    return torch.sigmoid(pointwise_logits(params, cfg, batch))


# --------------------------------------------------------------------------
# Retrieval scoring: 1 user x n_candidates
# --------------------------------------------------------------------------
def candidate_scores(params: Mapping, cfg: RecSysConfig, batch: Mapping) -> torch.Tensor:
    """One user's score of each of ``batch["candidate_ids"]`` (n,): the
    scores :func:`retrieval_scores` ranks.  BERT4Rec encodes the user once
    and takes a dot product with each item; BST runs its encoder once a
    candidate (the target attends to the history), batched; the CTR
    models vary field 0 over the candidates, the user's other fields
    fixed."""
    cand = batch["candidate_ids"]
    if cfg.interaction == "bidir-seq":
        state = seq_encode(params, cfg, batch["seq_ids"])[0, -1]
        emb = F.embedding(cand.long(), params["items"])  # (n, d)
        with ieee_f32_matmul():
            return emb.float() @ state.float()
    n = cand.shape[0]
    if cfg.interaction == "transformer-seq":
        pb = {"seq_ids": batch["seq_ids"][0].expand(n, cfg.seq_len), "target_id": cand}
        if cfg.n_dense:
            pb["dense_feats"] = batch["dense_feats"][0].expand(n, cfg.n_dense)
        return pointwise_logits(params, cfg, pb)
    ids = batch["sparse_ids"][0].expand(n, cfg.n_sparse).clone()
    ids[:, 0] = cand % cfg.hash_size
    dense = batch["dense_feats"][0].expand(n, cfg.n_dense)
    return pointwise_logits(params, cfg, {"sparse_ids": ids, "dense_feats": dense})


def retrieval_scores(params: Mapping, cfg: RecSysConfig, batch: Mapping, top_k: int = 100):
    """batch: one user's context and ``candidate_ids`` (n,) -> the top-k
    ``(scores, positions in candidate_ids)``, ties toward the lower
    position (``jax.lax.top_k``'s order); positions int32 as there."""
    refuse_mesh("recsys candidate retrieval")
    scores, idx = stable_topk(candidate_scores(params, cfg, batch), top_k)
    return scores, idx.to(torch.int32)
