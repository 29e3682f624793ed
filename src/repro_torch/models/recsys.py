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

On a mesh of several processes (``distributed.sharding.use_mesh``, one
device a process) each process holds the piece of every leaf that
``sharding.logical_to_spec`` gives it under the rules (:func:`param_axes`,
the whole leaf's shape for the divisibility fallback; :func:`place_params`):

* ``table``, ``wide`` and ``items`` split by rows over ``"model"``
  (``"table_rows"``): a lookup gathers the rows held here, zero elsewhere,
  and sums the pieces over the model group (``launch.mesh.reduce_from``),
  so a table's gradient stays in the process that holds its rows;
* the columns of every MLP layer and CIN layer, of ``wq`` / ``wk`` /
  ``wv`` and of ``ffn.w1`` (``"mlp"``), and the rows of ``cin_out.w``,
  ``attn.wo`` and ``ffn.w2``: a replicated input enters a split product
  through ``copy_to`` (its gradient summed over the group), a column-split
  result is gathered (``gather_along``) where the next product needs it
  whole, and a row-split product is summed (``reduce_from``);
* BERT4Rec's masked-item cross-entropy is vocab-split as ``items`` is:
  the max over the logits held here (``all_reduce_max``), their sum of
  exponentials and the target's logit (``reduce_from``); no process
  gathers the logits.

A leaf whose split dimension its mesh extent does not divide stays whole
(BERT4Rec's 1,000,002 items on a 16-way axis); where a process's columns
of ``wq`` cut a head, the processes gather ``q`` and ``k`` and score every
head.  The batch splits over the other axes (``sharding.data_mesh``):
``train_loss`` is handed the global batch, takes this process's rows and
returns its share of the global mean, so the processes' losses and
gradients sum to the global batch's (``training.loop``).
``serve_scores`` scores the rows it is handed.  ``retrieval_scores``
splits the candidates over the data axes (a model group scores its piece
together) and merges the pieces' top-k (``distributed.topk.merge_topk``,
ties toward the lower position); the reference also splits them over
``"model"`` (ROADMAP Queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch import ieee_f32_matmul
from repro_torch.core.scoring import stable_topk
from repro_torch.distributed import sharding
from repro_torch.distributed.topk import merge_topk
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.training import tree as tree_lib


# --------------------------------------------------------------------------
# the "model" axis
# --------------------------------------------------------------------------
def _split(local: int, whole: int):
    """The ``"model"`` sub-mesh when a leaf's dimension of ``whole`` is held
    here as a piece of ``local``, else None (a whole leaf)."""
    if local == whole:
        return None
    tp = sharding.model_mesh()
    if tp is None or local * tp.world_size != whole:
        raise ValueError(f"a dimension of {local} is no piece of {whole} on this mesh")
    return tp


def _held_rows(table: torch.Tensor, rows: torch.Tensor, tp) -> torch.Tensor:
    """``table``'s rows ``rows`` (global int64 ids): with the rows split
    over ``tp``, the ones held here and zero for the others."""
    if tp is None:
        return F.embedding(rows, table)
    n = table.shape[0]
    t = rows - tp.rank * n
    here = (t >= 0) & (t < n)
    return torch.where(here[..., None], F.embedding(t.clamp(0, n - 1), table), 0.0)


def _rows(table: torch.Tensor, rows: torch.Tensor, whole_rows: int) -> torch.Tensor:
    """``table``'s rows ``rows`` (global ids), summed over the model group
    where the rows are split."""
    tp = _split(table.shape[0], whole_rows)
    return mesh_mod.reduce_from(tp, _held_rows(table, rows, tp))


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
    whole_rows: int | None = None,  # the whole table's rows (a row-split table)
) -> torch.Tensor:
    """PyTorch-EmbeddingBag semantics as the reference builds them: a
    gather, then a segment sum over ``bag_ids`` (``index_add``: on the card
    an atomic sum in no fixed order).  A row-split table sums each bag over
    the rows held here, then the bags over the model group."""
    tp = None if whole_rows is None else _split(table.shape[0], whole_rows)
    vecs = _held_rows(table, ids.long(), tp)  # (n, dim)
    if weights is not None:
        vecs = vecs * weights[:, None]
    bags = bag_ids.long()
    out = mesh_mod.reduce_from(tp, vecs.new_zeros((n_bags, vecs.shape[1])).index_add(0, bags, vecs))
    if mode == "mean":
        cnt = vecs.new_zeros((n_bags,)).index_add(0, bags, torch.ones_like(vecs[:, 0]))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def field_lookup(table: torch.Tensor, ids: torch.Tensor, hash_size: int) -> torch.Tensor:
    """ids (B, F) per-field local ids -> (B, F, dim) from the unified table."""
    B, nf = ids.shape
    offsets = torch.arange(nf, device=ids.device, dtype=torch.int64) * hash_size
    rows = ids.long() + offsets[None, :]
    return _rows(table, rows.reshape(-1), nf * hash_size).reshape(B, nf, -1)


def mlp_init(generator: torch.Generator, dims) -> list:
    return [L.dense_bias_init(generator, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def mlp_apply(params: list, x: torch.Tensor, dtype=None, final_act: bool = False,
              widths=None) -> torch.Tensor:
    """The MLP on ``x`` (whole).  ``widths``, the layers' whole output
    widths, marks the column-split layers: each takes its input through
    ``copy_to`` and its output is gathered whole."""
    for i, p in enumerate(params):
        tp = None if widths is None else _split(p["w"].shape[1], widths[i])
        x = mesh_mod.gather_along(tp, L.dense_bias(p["w"], p["b"], mesh_mod.copy_to(tp, x), dtype), -1)
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
    generator's device, every leaf whole (:func:`place_params` cuts a
    mesh's pieces)."""
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


def param_shapes(cfg: RecSysConfig) -> dict:
    """The whole leaves' shapes, in :func:`init_params`' tree."""
    d = cfg.embed_dim
    dense = lambda a, b: {"w": (a, b), "b": (b,)}  # noqa: E731
    p = {}
    if cfg.interaction in ("cin", "concat"):
        rows = cfg.n_sparse * cfg.hash_size
        p["table"], p["wide"] = (rows, d), (rows, 1)
    if cfg.item_vocab:
        p["items"], p["pos"] = (cfg.item_vocab + 2, d), (cfg.seq_len + 1, d)
    if cfg.cin_layers:
        fans = (cfg.n_sparse,) + cfg.cin_layers[:-1]
        p["cin"] = [{"w": (h0 * cfg.n_sparse, h)} for h0, h in zip(fans, cfg.cin_layers)]
        p["cin_out"] = dense(sum(cfg.cin_layers), 1)
    if cfg.n_blocks:
        ln = {"g": (d,), "b": (d,)}
        blk = {"attn": {n: {"w": (d, d)} for n in ("wq", "wk", "wv", "wo")}, "ln1": ln,
               "ffn": {"w1": dense(d, 4 * d), "w2": dense(4 * d, d)}, "ln2": ln}
        p["blocks"] = [blk for _ in range(cfg.n_blocks)]
    if cfg.interaction != "bidir-seq":
        dims = (cfg._mlp_in(),) + cfg.mlp + (1,)
        p["mlp"] = [dense(a, b) for a, b in zip(dims[:-1], dims[1:])]
    return p


def placements(cfg: RecSysConfig):
    """Each leaf's ``sharding.Placement`` under the active mesh, or None
    without a ``"model"`` axis above 1."""
    if sharding.model_mesh() is None:
        return None
    return sharding.tree_shardings(param_axes(cfg), param_shapes(cfg))


def place_params(whole: Mapping, cfg: RecSysConfig):
    """``(params, placements)``: this process's piece of each of ``whole``'s
    leaves (tensors), on the mesh's device, and their placements
    (:func:`placements`); ``(whole, None)`` without a ``"model"`` axis."""
    place = placements(cfg)
    if place is None:
        return whole, None
    return sharding.place_tree(whole, place), place


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
def cin_apply(params: Mapping, emb: torch.Tensor, dtype=None, widths=None) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM eq. 6-8).

    emb: (B, m, D).  Layer k: z = outer(X_k, X_0) over fields, 1x1 conv.
    Sum-pool each layer over D, concat, project to a logit -> (B,).
    ``widths`` (the config's ``cin_layers``) marks the split layers: a
    layer's inputs enter through ``copy_to``, its columns and pooled sums
    are gathered whole, and ``cin_out``'s rows take this process's slice of
    the pooled features, summed over the group."""
    xk = emb
    x0 = {}  # X_0 as it enters a split layer (its gradient summed once) or a whole one
    pooled = []
    n = len(params["cin"])
    for i, lp in enumerate(params["cin"]):
        tp = None if widths is None else _split(lp["w"].shape[1], widths[i])
        if (tp is None) not in x0:
            x0[tp is None] = mesh_mod.copy_to(tp, emb)
        x0c = x0[tp is None]
        with ieee_f32_matmul():
            z = torch.einsum("bhd,bmd->bhmd", x0c if i == 0 else mesh_mod.copy_to(tp, xk), x0c)
            B, Hk, m, D = z.shape
            # (B, Hnext, D): the 1x1 "conv" over field pairs
            xk = torch.relu(torch.einsum("bqd,qh->bhd", z.reshape(B, Hk * m, D),
                                         lp["w"].to(z.dtype)))
        pooled.append(mesh_mod.gather_along(tp, xk.sum(dim=-1), -1))  # (B, Hnext)
        if i < n - 1:
            xk = mesh_mod.gather_along(tp, xk, 1)
    feats = torch.cat(pooled, dim=-1)
    w, b = params["cin_out"]["w"], params["cin_out"]["b"]
    tp = _split(w.shape[0], feats.shape[-1])
    if tp is not None:
        r = w.shape[0]
        feats = mesh_mod.copy_to(tp, feats)[:, tp.rank * r:(tp.rank + 1) * r]
    return (mesh_mod.reduce_from(tp, L.dense(w, feats)) + b)[:, 0]


def _attend(q, k, v, dh: int, tp) -> torch.Tensor:
    """Softmax attention of this process's columns (B, S, c) of q, k and v:
    on whole heads where its columns hold them; else every head scored from
    the gathered q and k, and this process's columns of the output."""
    B, S, c = q.shape
    with ieee_f32_matmul():
        if c % dh == 0:
            q, k, v = (t.reshape(B, S, -1, dh) for t in (q, k, v))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh**-0.5
            w = torch.softmax(s.float(), dim=-1).to(q.dtype)
            return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, c)
        qg, kg = (mesh_mod.copy_to(tp, mesh_mod.gather_along(tp, t, -1)).reshape(B, S, -1, dh)
                  for t in (q, k))
        s = torch.einsum("bqhd,bkhd->bhqk", qg, kg) * dh**-0.5
        w = torch.softmax(s.float(), dim=-1).to(q.dtype)
        heads = torch.arange(tp.rank * c, (tp.rank + 1) * c, device=q.device) // dh
        return torch.einsum("bjqk,bkj->bqj", w[:, heads], v)


def encoder_block(p: Mapping, x: torch.Tensor, n_heads: int, dtype=None) -> torch.Tensor:
    """Post-LN transformer encoder block (BST / BERT4Rec style); ``x`` whole,
    the attention's and the FFN's products split where their leaves are."""
    B, S, d = x.shape
    dh = d // n_heads
    a, f = p["attn"], p["ffn"]
    tp = _split(a["wq"]["w"].shape[1], d)
    xin = mesh_mod.copy_to(tp, x)
    q, k, v = (L.dense(a[n]["w"], xin, dtype) for n in ("wq", "wk", "wv"))
    o = mesh_mod.reduce_from(tp, L.dense(a["wo"]["w"], _attend(q, k, v, dh, tp), dtype))
    x = L.layernorm(p["ln1"]["g"], p["ln1"]["b"], x + o)
    tp = _split(f["w1"]["w"].shape[1], 4 * d)
    h = F.gelu(L.dense_bias(f["w1"]["w"], f["w1"]["b"], mesh_mod.copy_to(tp, x), dtype),
               approximate="tanh")
    b2 = f["w2"]["b"] if dtype is None else f["w2"]["b"].to(dtype)
    y = mesh_mod.reduce_from(tp, L.dense(f["w2"]["w"], h, dtype)) + b2
    return L.layernorm(p["ln2"]["g"], p["ln2"]["b"], x + y)


def seq_encode(params: Mapping, cfg: RecSysConfig, seq_ids: torch.Tensor,
               extra_emb: torch.Tensor | None = None) -> torch.Tensor:
    """Embed + position + transformer blocks.  seq_ids (B, S) -> (B, S', d)."""
    x = _rows(params["items"], seq_ids.long(), cfg.item_vocab + 2)  # (B, S, d)
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
    widths = cfg.mlp + (1,)
    if cfg.interaction in ("cin", "concat"):
        ids = batch["sparse_ids"]
        emb = field_lookup(params["table"], ids, cfg.hash_size)
        flat = emb.reshape(emb.shape[0], -1)
        if cfg.n_dense:
            flat = torch.cat([flat, batch["dense_feats"]], dim=-1)
        deep = mlp_apply(params["mlp"], flat.to(cfg.dtype), cfg.dtype, widths=widths)[:, 0]
        B, nf = ids.shape
        fields = torch.arange(nf, device=ids.device, dtype=torch.int64)[None, :] * cfg.hash_size
        wide = embedding_bag(
            params["wide"], (ids.long() + fields).reshape(-1),
            torch.arange(B, device=ids.device).repeat_interleave(nf), B,
            whole_rows=nf * cfg.hash_size,
        )[:, 0]
        logit = deep + wide
        if cfg.interaction == "cin":
            logit = logit + cin_apply(params, emb.to(cfg.dtype), cfg.dtype, cfg.cin_layers)
        return logit
    if cfg.interaction == "transformer-seq":  # BST
        tgt = _rows(params["items"], batch["target_id"].long(), cfg.item_vocab + 2)[:, None]
        x = seq_encode(params, cfg, batch["seq_ids"], extra_emb=tgt)
        flat = x.reshape(x.shape[0], -1)
        if cfg.n_dense:
            flat = torch.cat([flat, batch["dense_feats"]], dim=-1)
        return mlp_apply(params["mlp"], flat.to(cfg.dtype), cfg.dtype, widths=widths)[:, 0]
    if cfg.interaction == "bidir-seq":  # BERT4Rec: score the target at the last position
        state = seq_encode(params, cfg, batch["seq_ids"])[:, -1]  # (B, d)
        tgt = _rows(params["items"], batch["target_id"].long(), cfg.item_vocab + 2)
        return (state * tgt.to(state.dtype)).sum(dim=-1)
    raise ValueError(cfg.interaction)


def _my_rows(B: int) -> slice:
    """This process's rows of a global batch of B split over the data axes
    (``sharding.data_mesh``); all of them without one."""
    mesh = sharding.data_mesh()
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    if B % world:
        raise ValueError(f"batch {B} does not split over {world} processes")
    b = B // world
    return slice(rank * b, (rank + 1) * b)


def _masked_ce(params: Mapping, cfg: RecSysConfig, x: torch.Tensor, labels: torch.Tensor,
               M: int) -> torch.Tensor:
    """BERT4Rec's cross-entropy summed over the first M masked positions of
    each row of ``labels`` (B, S), the encoder's output ``x`` (B, S, d);
    vocab-split where ``items`` is."""
    B = labels.shape[0]
    is_masked = labels >= 0
    # the first M masked slots of each row, in order, then unmasked ones
    order = torch.argsort((~is_masked).to(torch.uint8), dim=1, stable=True)[:, :M]
    lmask = torch.gather(is_masked, 1, order).float()
    xm = torch.gather(x, 1, order[..., None].expand(B, M, x.shape[-1]))  # (B, M, d)
    lab = torch.gather(labels, 1, order)
    safe = torch.where(lab >= 0, lab, 0).long()
    items = params["items"]
    tp = _split(items.shape[0], cfg.item_vocab + 2)
    with ieee_f32_matmul():
        logits = mesh_mod.copy_to(tp, xm.float()) @ items.t()  # (B, M, V or a piece)
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        top = mesh_mod.all_reduce_max(tp, logits.detach().amax(dim=-1))
        t = safe - tp.rank * n
        here = (t >= 0) & (t < n)
        tgt = torch.where(here, torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0], 0.0)
        sum_exp, tgt = mesh_mod.reduce_from(
            tp, torch.stack([torch.exp(logits - top[..., None]).sum(dim=-1), tgt]))
        logz = top + torch.log(sum_exp)
    return ((logz - tgt) * lmask).sum()


def train_loss(params: Mapping, cfg: RecSysConfig, batch: Mapping,
               max_masked: int | None = None):
    """``(loss, {"loss": loss})``.  BERT4Rec: cross-entropy over the whole
    catalog at the first ``M = max(int(2 * mask_frac * S), 1)`` masked
    positions of each row (a stable partition; masked positions past M are
    dropped, as the reference drops them), over their count; the others:
    the mean BCE of the logits against ``labels``.

    Under a mesh that splits the batch (``sharding.data_mesh``) ``batch`` is
    the global batch and this process takes its rows: its loss is their
    sum over the global batch's count (examples, or masked positions), so
    the processes' losses sum to the global mean."""
    labels = batch["labels"]
    rows = _my_rows(labels.shape[0])
    mine = {k: v[rows] for k, v in batch.items()}
    if cfg.interaction == "bidir-seq":
        S = labels.shape[1]
        M = max_masked or max(int(2 * cfg.mask_frac * S), 1)
        x = seq_encode(params, cfg, mine["seq_ids"])
        count = torch.clamp((labels >= 0).sum(dim=1), max=M).sum().float()
        loss = _masked_ce(params, cfg, x, mine["labels"], M) / torch.clamp(count, min=1.0)
        return loss, {"loss": loss}
    logit = pointwise_logits(params, cfg, mine)
    y = mine["labels"].float()
    bce = torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit)))
    loss = bce.sum() / labels.shape[0]
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
        emb = _rows(params["items"], cand.long(), cfg.item_vocab + 2)  # (n, d)
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
    position (``jax.lax.top_k``'s order); positions int32 as there.

    Under a mesh that splits the batch over W processes
    (``sharding.data_mesh``) with n a multiple of W, each process scores
    its contiguous piece of the candidates, takes its top-k with the
    positions made global, and the pieces merge over those processes
    (``merge_topk``: by score, then the lower position)."""
    cand = batch["candidate_ids"]
    n = cand.shape[0]
    mesh = sharding.data_mesh()
    world = 1 if mesh is None else mesh.world_size
    if world == 1 or n % world:
        scores, idx = stable_topk(candidate_scores(params, cfg, batch), top_k)
        return scores, idx.to(torch.int32)
    c = n // world
    first = mesh.rank * c
    piece = dict(batch, candidate_ids=cand[first:first + c])
    scores, idx = stable_topk(candidate_scores(params, cfg, piece), min(top_k, c))
    scores, idx = merge_topk([scores], [idx + first], top_k, mesh=mesh)
    return scores, idx.to(torch.int32)
