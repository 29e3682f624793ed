"""Cell builder of the port (the counterpart of ``repro.launch.cells``): one
(arch x input-shape) cell -> a callable and its inputs.

Ported: smoke mode (the reduced config, seeded weights and tensors, one
real step) of the LM family's ``train``, ``prefill`` and ``decode``
cells, the recsys family's ``train``, ``serve`` and ``retrieval`` cells
and SchNet's ``full_graph``, ``minibatch`` and ``molecule`` cells, with
the reference's model FLOPs and, for recsys and SchNet, the reference's
numpy draws (the same batches bit for bit).  A train cell's callable is
a ``make_train_step`` over ``_default_optimizer()`` with the cell's
``n_micro`` (an LM's with ``cast_dtype=cfg.dtype``), and its arguments
``(params, opt_state, batch)``; the step updates the first two in place,
as the reference's cell donates them (``donate_argnums`` ``(0, 1)``).
``recsys_cell`` / ``gnn_cell`` take any config and parameters, so a
caller builds a cell at full width too.  Not yet: dry mode (the full
config lowered for the multi-pod dry-run) and the retrieval family's
cells, ROADMAP Queue 1 item 8.5.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.configs.common import ShapeCell
from repro_torch.data import graphs as graph_data
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import schnet as schnet_lib
from repro_torch.models import transformer as T
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass
class BuiltCell:
    arch: str
    cell: str
    kind: str
    fn: typing.Callable
    args: tuple
    model_flops: float = 0.0


def _lm_attn_flops(cfg: T.TransformerConfig, B, Sq, Skv_avg) -> float:
    return cfg.n_layers * 4.0 * B * Sq * Skv_avg * cfg.n_heads * cfg.d_head


def _default_optimizer() -> opt_lib.Optimizer:
    return opt_lib.adamw(
        opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(3e-4, 100, 10000))
    )


def _train_pieces(loss_fn, params, n_micro: int, batch: dict, cast_dtype=None):
    """A train cell's step and arguments, the reference's smoke-mode
    ``_train_pieces``: AdamW on the default schedule, fresh state, the
    parameters and state donated to the step."""
    optimizer = _default_optimizer()
    step = train_loop.make_train_step(loss_fn, optimizer, n_micro=n_micro,
                                      cast_dtype=cast_dtype, donate=True)
    return step, (params, optimizer.init(params), batch)


def lm_model_flops(cfg: T.TransformerConfig, kind: str, seq_len: int, batch: int) -> float:
    """The reference's model FLOPs of one LM step: a train step of
    ``batch`` x ``seq_len`` tokens (6 N per token plus three times the
    prefill's attention), a prefill (2 N per token plus causal attention
    over half the keys, or the window), or one decode step against a cache
    of ``cache_seq_len`` slots (2 N per row plus attention over the
    cache)."""
    if kind == "train":
        s_eff = min(seq_len, cfg.window) if cfg.window else seq_len
        return 6.0 * cfg.active_params() * batch * seq_len + 3 * _lm_attn_flops(
            cfg, batch, seq_len, s_eff / 2)
    if kind == "prefill":
        s_eff = min(seq_len, cfg.window) if cfg.window else seq_len
        return 2.0 * cfg.active_params() * batch * seq_len + _lm_attn_flops(
            cfg, batch, seq_len, s_eff / 2)
    if kind == "decode":
        Sc = T.cache_seq_len(cfg, seq_len)
        return 2.0 * cfg.active_params() * batch + cfg.n_layers * 4.0 * batch * Sc * (
            cfg.n_heads * cfg.d_head)
    raise ValueError(kind)


def _lm_cell(arch, cfg: T.TransformerConfig, cell: ShapeCell, p, device) -> BuiltCell:
    S, B = p["seq_len"], p["global_batch"]
    kind = cell.kind
    flops = lm_model_flops(cfg, kind, S, B)
    if kind == "train":
        model = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device, head=True)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32,
                                    device=device) for k in ("tokens", "targets")}
        fn, args = _train_pieces(T.loss_fn(model), T.train_params(model), p.get("n_micro", 1),
                                 batch, cast_dtype=cfg.dtype)
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    model = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                          head=True, param_dtype=cfg.dtype)
    if kind == "prefill":
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)),
                                 dtype=torch.int32, device=device)
        return BuiltCell(arch, cell.name, kind, T.prefill, (model, tokens), flops)
    if kind == "decode":
        cache = T.init_cache(cfg, B, S, device)
        tokens = torch.zeros((B,), dtype=torch.int32, device=device)
        return BuiltCell(arch, cell.name, kind, T.decode_step,
                         (model, cache, tokens, min(S - 1, 5)), flops)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# GNN family (SchNet)
# --------------------------------------------------------------------------
def schnet_flops(cfg: schnet_lib.SchNetConfig, N, E, train: bool = True) -> float:
    """The reference's model FLOPs of one SchNet step over N nodes and E
    edges (a train step counts the forward three times)."""
    d, r = cfg.d_hidden, cfg.n_rbf
    per_edge = 2 * r * d + 2 * d * d + 2 * d  # filter mlp + mult
    per_node = 3 * 2 * d * d  # w_in/w_out/w_post
    inter = cfg.n_interactions * (E * per_edge + N * per_node)
    head = N * (2 * d * (d // 2) + 2 * (d // 2) * max(cfg.n_classes, 1))
    fwd = inter + head + E * r * 3
    return (3.0 if train else 1.0) * fwd


def gnn_shape(base_cfg: schnet_lib.SchNetConfig, kind: str, p: dict):
    """A SchNet cell's config and its step's (N, E): the graph regime's
    config carries the cell's ``d_feat`` / ``n_classes``; a minibatch's N
    and E are the sampler's padded caps."""
    if kind == "molecule":
        return base_cfg, p["batch"] * p["n_nodes"], p["batch"] * p["n_edges"]
    cfg = dataclasses.replace(base_cfg, d_feat=p["d_feat"], n_classes=p["n_classes"])
    if kind == "full_graph":
        return cfg, p["n_nodes"], p["n_edges"]
    N = f_cum = p["batch_nodes"]
    E = 0
    for f in p["fanout"]:
        E += f_cum * f
        f_cum *= f
        N += f_cum
    return cfg, N, E


def gnn_batch(kind: str, p: dict, graph=None, block=None) -> dict:
    """A SchNet cell's batch (numpy), the reference's smoke draws: the
    seeded graph (``graph``, or drawn here) and, for a minibatch, its
    fanout block around nodes ``0..batch_nodes-1`` (``block``, or sampled
    here) with features, labels and the seeds' label mask; edge distances
    uniform in [0.5, 9.5) from ``default_rng(0)``; or ``molecule_batch``."""
    if kind == "molecule":
        return graph_data.molecule_batch(p["batch"], p["n_nodes"], p["n_edges"])
    rng = np.random.default_rng(0)
    g = graph if graph is not None else graph_data.random_graph(
        p["n_nodes"], p["n_edges"], p["d_feat"], p["n_classes"])
    if kind == "full_graph":
        return {
            "feat": g.feat, "edge_src": g.edge_src.astype(np.int32),
            "edge_dst": g.edge_dst.astype(np.int32),
            "edge_dist": rng.uniform(0.5, 9.5, p["n_edges"]).astype(np.float32),
            "edge_mask": np.ones((p["n_edges"],), np.float32),
            "labels": g.labels.astype(np.int32),
            "label_mask": np.ones((p["n_nodes"],), np.float32),
        }
    blk = block if block is not None else graph_data.neighbor_sample(
        g, np.arange(p["batch_nodes"]), tuple(p["fanout"]))
    lmask = np.zeros(len(blk["nodes"]), np.float32)
    lmask[: p["batch_nodes"]] = 1.0
    return {
        "feat": g.feat[blk["nodes"]], "edge_src": blk["edge_src"], "edge_dst": blk["edge_dst"],
        "edge_dist": rng.uniform(0.5, 9.5, len(blk["edge_src"])).astype(np.float32),
        "edge_mask": blk["edge_mask"], "labels": g.labels[blk["nodes"]].astype(np.int32),
        "label_mask": lmask,
    }


def gnn_cell(arch, base_cfg: schnet_lib.SchNetConfig, cell: ShapeCell, p: dict, device,
             batch=None) -> BuiltCell:
    """A SchNet train cell at the values ``p`` (``cell.reduced`` in smoke
    mode): one donating AdamW step of seeded weights over ``batch``
    (``gnn_batch``'s, drawn here when None)."""
    cfg, N, E = gnn_shape(base_cfg, cell.kind, p)
    if batch is None:
        batch = gnn_batch(cell.kind, p)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    params = schnet_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    loss_fn = lambda prm, b: schnet_lib.train_loss(prm, cfg, b)
    fn, args = _train_pieces(loss_fn, params, 1, batch)
    return BuiltCell(arch, cell.name, cell.kind, fn, args, schnet_flops(cfg, N, E))


# --------------------------------------------------------------------------
# RecSys family
# --------------------------------------------------------------------------
def recsys_example_flops(cfg: recsys_lib.RecSysConfig) -> float:
    """The reference's model FLOPs of scoring one example."""
    f = 0.0
    dims = (cfg._mlp_in(),) + cfg.mlp + (1,)
    if cfg.interaction != "bidir-seq":
        f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.cin_layers:
        h_prev = cfg.n_sparse
        for h in cfg.cin_layers:
            f += h_prev * cfg.n_sparse * cfg.embed_dim  # outer products
            f += 2 * h_prev * cfg.n_sparse * cfg.embed_dim * h  # 1x1 conv
            h_prev = h
    if cfg.n_blocks:
        S, d = cfg.seq_len + (1 if cfg.interaction == "transformer-seq" else 0), cfg.embed_dim
        f += cfg.n_blocks * (8 * S * d * d + 4 * S * S * d + 16 * S * d * d)
    return f


def recsys_flops(cfg: recsys_lib.RecSysConfig, kind: str, p: dict) -> float:
    """The reference's model FLOPs of a recsys cell: a train step (3x the
    examples', BERT4Rec's masked positions scoring the whole catalog), a
    served batch, or one user against ``n_candidates``."""
    if kind == "train":
        per = recsys_example_flops(cfg)
        if cfg.interaction == "bidir-seq":
            m_pos = max(int(2 * cfg.mask_frac * cfg.seq_len), 1)
            per += 2 * m_pos * (cfg.item_vocab + 2) * cfg.embed_dim
        return 3.0 * p["batch"] * per
    if kind == "serve":
        return p["batch"] * recsys_example_flops(cfg)
    if kind == "retrieval":
        per = 2 * cfg.embed_dim if cfg.interaction == "bidir-seq" else recsys_example_flops(cfg)
        return float(p["n_candidates"]) * per
    raise ValueError(kind)


def recsys_batch(cfg: recsys_lib.RecSysConfig, B: int, rng, with_labels: bool = True) -> dict:
    """The reference's smoke batch of B examples (numpy), drawn from
    ``rng`` in its order: ids uniform below each field's range, dense
    features standard normal, click labels."""
    spec = {}
    if cfg.interaction in ("cin", "concat"):
        spec["sparse_ids"] = ((B, cfg.n_sparse), cfg.hash_size)
        spec["dense_feats"] = ((B, cfg.n_dense), None)
    if cfg.seq_len:
        spec["seq_ids"] = ((B, cfg.seq_len), cfg.item_vocab)
        spec["target_id"] = ((B,), cfg.item_vocab)
        if cfg.n_dense:
            spec["dense_feats"] = ((B, cfg.n_dense), None)
    if with_labels:
        spec["labels"] = ((B,), 2)
    return {k: (rng.integers(0, hi, shape).astype(np.int32) if hi is not None
                else rng.standard_normal(shape).astype(np.float32))
            for k, (shape, hi) in spec.items()}


def recsys_cell(arch, cfg: recsys_lib.RecSysConfig, cell: ShapeCell, p: dict, device,
                params=None) -> BuiltCell:
    """A recsys cell at the values ``p`` (``cell.reduced`` in smoke mode),
    its batch from ``default_rng(0)`` as the reference draws it: a train
    step (``n_micro`` microbatches, BERT4Rec's labels masked at
    ``mask_frac``), ``serve_scores`` over a batch, or ``retrieval_scores``
    of one user against ``n_candidates`` ids.  ``params`` defaults to
    seeded weights."""
    kind = cell.kind
    rng = np.random.default_rng(0)
    if params is None:
        params = recsys_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    flops = recsys_flops(cfg, kind, p)
    put = lambda b: {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    if kind == "train":
        B = p["batch"]
        batch = recsys_batch(cfg, B, rng)
        if cfg.interaction == "bidir-seq":
            mask = rng.random((B, cfg.seq_len)) < cfg.mask_frac
            batch["labels"] = np.where(mask, batch["seq_ids"], -1).astype(np.int32)
        loss_fn = lambda prm, b: recsys_lib.train_loss(prm, cfg, b)
        fn, args = _train_pieces(loss_fn, params, p.get("n_micro", 1), put(batch))
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    if kind == "serve":
        batch = recsys_batch(cfg, p["batch"], rng, with_labels=False)
        fn = lambda prm, b: recsys_lib.serve_scores(prm, cfg, b)
        return BuiltCell(arch, cell.name, kind, fn, (params, put(batch)), flops)
    if kind == "retrieval":
        batch = recsys_batch(cfg, 1, rng, with_labels=False)
        batch["candidate_ids"] = rng.integers(
            0, cfg.item_vocab or cfg.hash_size, (p["n_candidates"],)).astype(np.int32)
        top_k = p["top_k"]
        fn = lambda prm, b: recsys_lib.retrieval_scores(prm, cfg, b, top_k=top_k)
        return BuiltCell(arch, cell.name, kind, fn, (params, put(batch)), flops)
    raise ValueError(kind)


def build_cell(arch_id: str, cell_name: str, *, mode: str = "smoke",
               device: str | torch.device = "cuda") -> BuiltCell:
    """The cell's callable and inputs: ``fn(*args)`` runs one step."""
    if mode != "smoke":
        raise NotImplementedError(
            f"mode {mode!r}: the dry-run cells are not ported (ROADMAP Queue 1 item 8.5)")
    mod = config_registry.get(arch_id)
    if mod.FAMILY == "retrieval":
        raise NotImplementedError(
            f"{arch_id}: the retrieval family's cells are not ported (ROADMAP Queue 1 item 8.5)")
    cell = config_registry.cells_of(arch_id)[cell_name]
    dev = resolve_device(device)
    build = {"lm": _lm_cell, "recsys": recsys_cell, "gnn": gnn_cell}[mod.FAMILY]
    return build(arch_id, mod.reduced_config(), cell, cell.reduced, dev)
