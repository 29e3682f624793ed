"""Cell builder of the port (the counterpart of ``repro.launch.cells``): one
(arch x input-shape) cell -> a callable and its inputs, for all four
families, in two modes.

Smoke mode (``mode="smoke"``, the default): the reduced config, seeded
weights and tensors, one real step on ``device``.  The LM family's
``train``, ``prefill`` and ``decode`` cells, the recsys family's
``train``, ``serve`` and ``retrieval`` cells, SchNet's ``full_graph``,
``minibatch`` and ``molecule`` cells and the retrieval family's
``train_triples`` (ColBERTv2 training), ``encode_corpus`` (the encoder,
K7 with ``attn_impl="flash"``) and ``search_9m`` / ``search_140m`` (an
index built as the reference builds it, searched through
``exec.sharded.make_sharded_search`` over a one-device mesh with the
reference's ``SearchParams``; ``impl="cuda"`` on the card, so stages 2/3
run K1 and stage 4 K2, ``"ref"`` on the host), with the reference's
model FLOPs and numpy draws.  A train cell's callable is a
``make_train_step`` over ``_default_optimizer()`` with the cell's
``n_micro`` (an LM's and the encoder's with ``cast_dtype`` the compute
dtype), and its arguments ``(params, opt_state, batch)``; the step
updates the first two in place, as the reference's cell donates them
(``donate_argnums`` ``(0, 1)``).  ``recsys_cell`` / ``gnn_cell`` /
``retrieval_cell`` take any config and values, so a caller builds a cell
at full width too.

Dry mode (``mode="dry"``, for ``launch.dryrun``): the full config and
``cell.full``, every tensor on ``meta``, under ``sharding.use_mesh`` of a
dry mesh (``launch.mesh.make_dry_mesh``) and the cell's rules, one rank
(rank 0) of the reference's production mesh.  Each argument is the piece
the port's runtime holds on that rank: a parameter sliced along
``"model"`` by its ``Placement`` and whole over ``"data"``, the optimizer
state as its parameter, the serving batch, cache and index the
reference's leading-axis pieces (``"batch"`` over ``("pod", "data")``,
``"docs"`` one shard a rank, the cache by ``T._cache_axes``), a train
cell's batch global (every process is handed it and takes its rows,
``training.loop``) with ``n_micro = max(B // batch_shards, 1)`` for the
LM family as the reference sets it.  An LM cell may be built at another
depth (``layers``) and a train cell at another microbatch count
(``n_micro``, each microbatch the full cell's rows): the planner traces
small ones and extrapolates (``launch.dryrun``).  The serving cells of a
model without a window run attention through K7 (``attn_impl="flash"``),
as the card serves them.  ``cell_plan`` is the reference's plan of the
same cell: each leaf's per-rank shape under the rules, as
``sharding.logical_to_spec`` gives it, ``"data"`` included; ``BuiltCell.
plan`` carries it.  Cells the port cannot run on such a mesh raise its
``NotImplementedError`` naming the ROADMAP item, when they are built or
run.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.configs.common import ShapeCell
from repro_torch.core import engine_sharded, plaid
from repro_torch.core import index as index_mod
from repro_torch.data import graphs as graph_data
from repro_torch.data import synthetic
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import colbert as colbert_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import schnet as schnet_lib
from repro_torch.models import transformer as T
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree as tree_lib

META = torch.device("meta")


@dataclasses.dataclass
class BuiltCell:
    arch: str
    cell: str
    kind: str
    fn: typing.Callable | None
    args: tuple
    model_flops: float = 0.0
    skip: str | None = None
    #: dry mode: the reference's plan, {leaf: (per-rank shape, dtype)}
    plan: dict | None = None

    @property
    def plan_bytes(self) -> int | None:
        """Bytes a rank holds under the plan (the reference's mem_args)."""
        return None if self.plan is None else plan_bytes(self.plan)


def _lm_attn_flops(cfg: T.TransformerConfig, B, Sq, Skv_avg) -> float:
    return cfg.n_layers * 4.0 * B * Sq * Skv_avg * cfg.n_heads * cfg.d_head


#: a train cell's schedule, the reference's: (peak lr, warm-up, total steps)
DEFAULT_SCHEDULE = (3e-4, 100, 10000)


def _default_optimizer() -> opt_lib.Optimizer:
    return opt_lib.adamw(
        opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(*DEFAULT_SCHEDULE))
    )


def _train_pieces(loss_fn, params, n_micro: int, batch: dict, cast_dtype=None,
                  placements=None):
    """A train cell's step and arguments, the reference's smoke-mode
    ``_train_pieces``: AdamW on the default schedule, fresh state, the
    parameters and state donated to the step (``placements``: the
    parameters' on a ``"model"`` axis above 1)."""
    optimizer = _default_optimizer()
    step = train_loop.make_train_step(loss_fn, optimizer, n_micro=n_micro,
                                      cast_dtype=cast_dtype, donate=True, placements=placements)
    return step, (params, optimizer.init(params), batch)


def _on_mesh(mesh, fn):
    """``fn`` run under ``sharding.use_mesh(mesh)`` (``fn`` itself without a
    mesh)."""
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with sharding.use_mesh(mesh):
            return fn(*args, **kwargs)

    return run


def _data_rows(B: int) -> slice:
    """This process's rows of a served batch of B under the active mesh:
    its piece over the data axes (``sharding.data_mesh``), or all of them
    where the processes do not divide B (the reference's fallback)."""
    data = sharding.data_mesh()
    n = 1 if data is None else data.world_size
    if n == 1 or B % n:
        return slice(0, B)
    return slice(data.rank * (B // n), (data.rank + 1) * (B // n))


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
             batch=None, params=None, mesh=None) -> BuiltCell:
    """A SchNet train cell at the values ``p`` (``cell.reduced`` in smoke
    mode): one donating AdamW step of ``params`` (seeded weights when
    None) over ``batch`` (``gnn_batch``'s, drawn here when None).  Under
    ``mesh`` (one device a process; or the active mesh) the step splits
    the edges over it (``models.schnet``)."""
    if mesh is not None:
        with sharding.use_mesh(mesh):
            built = gnn_cell(arch, base_cfg, cell, p, device, batch, params)
        built.fn = _on_mesh(mesh, built.fn)
        return built
    cfg, N, E = gnn_shape(base_cfg, cell.kind, p)
    if batch is None:
        batch = gnn_batch(cell.kind, p)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if params is None:
        params = schnet_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    place = None
    if sharding.model_mesh() is not None:  # every leaf whole: the norm counts each once
        place = sharding.tree_shardings(schnet_lib.param_axes(cfg),
                                        tree_lib.tree_map(lambda x: tuple(x.shape), params))
    loss_fn = lambda prm, b: schnet_lib.train_loss(prm, cfg, b)
    fn, args = _train_pieces(loss_fn, params, 1, batch, placements=place)
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


def recsys_batch_spec(cfg: recsys_lib.RecSysConfig, B: int, with_labels: bool = True) -> dict:
    """{field: (shape, bound)} of a batch of B examples, in the reference's
    draw order: an int32 id field drawn below ``bound``, a float32 one
    (``bound`` None) standard normal."""
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
    return spec


def recsys_batch(cfg: recsys_lib.RecSysConfig, B: int, rng, with_labels: bool = True) -> dict:
    """The reference's smoke batch of B examples (numpy), drawn from
    ``rng`` in its order: ids uniform below each field's range, dense
    features standard normal, click labels."""
    return {k: (rng.integers(0, hi, shape).astype(np.int32) if hi is not None
                else rng.standard_normal(shape).astype(np.float32))
            for k, (shape, hi) in recsys_batch_spec(cfg, B, with_labels).items()}


def recsys_cell(arch, cfg: recsys_lib.RecSysConfig, cell: ShapeCell, p: dict, device,
                params=None, mesh=None) -> BuiltCell:
    """A recsys cell at the values ``p`` (``cell.reduced`` in smoke mode),
    its batch from ``default_rng(0)`` as the reference draws it: a train
    step (``n_micro`` microbatches, BERT4Rec's labels masked at
    ``mask_frac``), ``serve_scores`` over a batch, or ``retrieval_scores``
    of one user against ``n_candidates`` ids.  ``params`` (whole) defaults
    to seeded weights.  Under ``mesh`` (one device a process; or the active
    mesh) each process holds its piece of every leaf
    (``recsys.place_params``), a served batch is cut to its rows over the
    data axes, and the callable runs under the mesh."""
    if mesh is not None:
        with sharding.use_mesh(mesh):
            built = recsys_cell(arch, cfg, cell, p, device, params)
        built.fn = _on_mesh(mesh, built.fn)
        return built
    kind = cell.kind
    rng = np.random.default_rng(0)
    if params is None:
        params = recsys_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    params, place = recsys_lib.place_params(params, cfg)
    flops = recsys_flops(cfg, kind, p)
    put = lambda b: {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    if kind == "train":
        B = p["batch"]
        batch = recsys_batch(cfg, B, rng)
        if cfg.interaction == "bidir-seq":
            mask = rng.random((B, cfg.seq_len)) < cfg.mask_frac
            batch["labels"] = np.where(mask, batch["seq_ids"], -1).astype(np.int32)
        loss_fn = lambda prm, b: recsys_lib.train_loss(prm, cfg, b)
        fn, args = _train_pieces(loss_fn, params, p.get("n_micro", 1), put(batch),
                                 placements=place)
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    if kind == "serve":
        batch = recsys_batch(cfg, p["batch"], rng, with_labels=False)
        rows = _data_rows(p["batch"])
        fn = lambda prm, b: recsys_lib.serve_scores(prm, cfg, b)
        return BuiltCell(arch, cell.name, kind, fn,
                         (params, put({k: v[rows] for k, v in batch.items()})), flops)
    if kind == "retrieval":
        batch = recsys_batch(cfg, 1, rng, with_labels=False)
        batch["candidate_ids"] = rng.integers(
            0, cfg.item_vocab or cfg.hash_size, (p["n_candidates"],)).astype(np.int32)
        top_k = p["top_k"]
        fn = lambda prm, b: recsys_lib.retrieval_scores(prm, cfg, b, top_k=top_k)
        return BuiltCell(arch, cell.name, kind, fn, (params, put(batch)), flops)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Retrieval family (the paper's arch: ColBERTv2 + PLAID)
# --------------------------------------------------------------------------
def colbert_fwd_flops(cfg: colbert_lib.ColBERTConfig, n_tokens: int) -> float:
    """The reference's ``_colbert_fwd_flops``: 2 N a token plus attention
    over min(n_tokens, 512) keys."""
    bb = cfg.backbone
    return 2.0 * bb.active_params() * n_tokens + _lm_attn_flops(bb, 1, n_tokens, min(n_tokens, 512))


def plaid_search_flops(p: dict, n_shards: int) -> float:
    """The reference's ``_plaid_search_flops``: per query the stage-1
    product once, stages 2-4 on every shard."""
    K, nq = p["n_centroids"], p["q_len"]
    dim = 128
    s1 = 2.0 * K * nq * dim
    cand, L = p["candidate_cap"], p["doc_maxlen"]
    ndocs = min(4096, cand)
    s23 = (cand + ndocs) * L * nq
    s4 = (ndocs // 4) * L * (2.0 * dim * nq + dim)
    return p["n_queries"] * (s1 + n_shards * (s23 + s4))


def retrieval_flops(cfg: colbert_lib.ColBERTConfig, kind: str, p: dict, n_shards: int = 1) -> float:
    """The reference's model FLOPs of a retrieval cell: a ColBERTv2 train
    step (three forward passes over the triples' tokens), an encode, or a
    search batch over ``n_shards`` shards."""
    if kind == "train":
        tokens = p["global_batch"] * (p["q_len"] + p["nway"] * p["d_len"])
        return 3.0 * colbert_fwd_flops(dataclasses.replace(cfg, nway=p["nway"]), tokens)
    if kind == "encode":
        return colbert_fwd_flops(cfg, p["batch"] * p["d_len"])
    if kind == "search":
        return plaid_search_flops(p, n_shards)
    raise ValueError(kind)


def search_params(p: dict, impl: str) -> plaid.SearchParams:
    """The reference's search-cell params: nprobe 4, t_cs 0.4, ndocs
    min(4096, cap), unfused."""
    return plaid.SearchParams(k=p["k"], nprobe=4, t_cs=0.4, ndocs=min(4096, p["candidate_cap"]),
                              candidate_cap=p["candidate_cap"], impl=impl)


def clamped_search_params(p: dict, impl: str, n_passages: int) -> plaid.SearchParams:
    """:func:`search_params` with both caps clamped to an index of
    ``n_passages``, as the reference's smoke cell clamps them
    (``cells.py:656-660``)."""
    sp = search_params(p, impl)
    return dataclasses.replace(sp, candidate_cap=min(sp.candidate_cap, max(n_passages, 2)),
                               ndocs=min(sp.ndocs, max(n_passages, 2)))


def search_corpus(p: dict, n_shards: int = 1):
    """The search cell's corpus and queries, the reference's draws:
    ``docs_per_shard * n_shards`` passages of 4..avg_doclen tokens
    (``embedding_corpus``, seed 0) and ``n_queries`` of ``q_len`` tokens
    (``queries_from_docs``) -> (embeddings (Nt, 128) f32 packed, lengths
    (Nd,) i32, queries (n_queries, q_len, 128) f32), numpy."""
    docs, _ = synthetic.embedding_corpus(p["docs_per_shard"] * n_shards, dim=128, min_len=4,
                                         max_len=p["avg_doclen"], seed=0)
    qs, _ = synthetic.queries_from_docs(docs, p["n_queries"], q_len=p["q_len"])
    return np.concatenate(docs), np.array([len(d) for d in docs], np.int32), qs


def search_index(p: dict, device, n_shards: int = 1, corpus=None):
    """The search cell's index, built as the reference builds it
    (``build_index`` with K centroids, the cell's nbits, 3 k-means
    iterations) on ``device`` from ``corpus`` (:func:`search_corpus`'s,
    drawn here when None); returns (index, queries)."""
    packed, lens, qs = search_corpus(p, n_shards) if corpus is None else corpus
    idx = index_mod.build_index(packed, lens, num_centroids=p["n_centroids"],
                                nbits=p.get("nbits", 2), kmeans_iters=3, device=device)
    return idx, qs


def retrieval_cell(arch, cfg: colbert_lib.ColBERTConfig, cell: ShapeCell, p: dict, device,
                   mesh=None, index=None, impl: str | None = None) -> BuiltCell:
    """A retrieval cell at the values ``p`` (``cell.reduced`` in smoke
    mode) on ``device``: a ColBERTv2 train step over ``colbert_batches``
    (AdamW, the cell's ``n_micro``, cast to the compute dtype), the
    encoder over seeded tokens, or a search batch over an index built as
    the reference builds it (``index``: :func:`search_index`'s pair when
    built already) on a one-device ``mesh`` (the device's when None), with
    ``impl`` ``"cuda"`` on the card and ``"ref"`` on the host unless given
    (``"ref"`` on the card: the kernels' plain versions there).  A train or
    encode cell under ``mesh`` (one device a process) holds this process's
    piece of every weight (``models.colbert`` on a ``"model"`` axis),
    encodes its rows of the batch over the data axes (a model group the
    same rows), and its callable runs under the mesh."""
    kind = cell.kind
    if mesh is not None and kind in ("train", "encode"):
        with sharding.use_mesh(mesh):
            built = retrieval_cell(arch, cfg, cell, p, device)
        built.fn = _on_mesh(mesh, built.fn)
        return built
    bb = cfg.backbone
    dev = resolve_device(device)
    if kind == "train":
        ccfg = dataclasses.replace(cfg, nway=p["nway"])
        B = p["global_batch"]
        model = colbert_lib.init_params(ccfg, torch.Generator(device=dev).manual_seed(0), dev)
        b = next(synthetic.colbert_batches(bb.vocab, B, q_len=p["q_len"], d_len=p["d_len"],
                                           nway=p["nway"]))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        fn, args = _train_pieces(colbert_lib.loss_fn(model), colbert_lib.train_params(model),
                                 p.get("n_micro", 1), batch, cast_dtype=bb.dtype,
                                 placements=model.placement_tree())
        return BuiltCell(arch, cell.name, kind, fn, args, retrieval_flops(cfg, kind, p))
    if kind == "encode":
        ecfg = dataclasses.replace(cfg, backbone=dataclasses.replace(bb, attn_impl="flash"))
        model = colbert_lib.init_params(ecfg, torch.Generator(device=dev).manual_seed(0), dev)
        toks = np.random.default_rng(0).integers(0, bb.vocab, (p["batch"], p["d_len"]))
        tokens = torch.as_tensor(toks[_data_rows(p["batch"])], dtype=torch.int32, device=dev)
        return BuiltCell(arch, cell.name, kind, colbert_lib.encode, (model, tokens),
                         retrieval_flops(cfg, kind, p))
    if kind == "search":
        mesh = mesh or mesh_mod.make_local_mesh(dev)
        n_shards = mesh.n_shards
        idx, qs = index if index is not None else search_index(p, dev, n_shards)
        impl = impl or ("cuda" if dev.type == "cuda" else "ref")
        sp = clamped_search_params(p, impl, idx.num_passages)
        search = engine_sharded.make_sharded_search(
            mesh, sp, docs_per_shard=idx.num_passages,
            static_meta=engine_sharded.static_meta_of(idx))
        masks = torch.ones((p["n_queries"], p["q_len"]), device=dev)
        args = (engine_sharded.index_as_dict(idx), torch.as_tensor(qs, device=dev), masks)
        return BuiltCell(arch, cell.name, kind, search, args,
                         retrieval_flops(cfg, kind, p, n_shards))
    raise ValueError(kind)


# --------------------------------------------------------------------------
# dry mode: one rank's pieces on meta
# --------------------------------------------------------------------------
class _OnMeta(TorchDispatchMode):
    """Every factory lands on ``meta`` and draws nothing: a family's
    ``init_params`` (which takes a host generator) builds its tree as
    shapes alone."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
        if "generator" in kwargs:
            kwargs["generator"] = None
        return func(*args, **kwargs)


def _meta_tree(init, cfg):
    with _OnMeta():
        return init(cfg, torch.Generator())


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch_shards() -> int:
    """Mesh shards the batch axis spans under the ACTIVE rules."""
    mesh = sharding.active_mesh()
    if mesh is None:
        return 1
    phys = sharding.active_rules().get("batch") or ()
    axes = (phys,) if isinstance(phys, str) else phys
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def _rows_here(B: int) -> int:
    """A serving batch's rows on one rank: its ``"batch"`` piece, or all of
    it where the shards do not divide it (the reference's fallback)."""
    n = _batch_shards()
    return B // n if B % n == 0 else B


def _lm_dry(arch, cfg: T.TransformerConfig, cell: ShapeCell, p, layers=None,
            n_micro=None, device=META) -> BuiltCell:
    """An LM cell's dry step (``device``: the same step's tensors on another
    device, zeros, for a check against a real process group)."""
    S, B = p["seq_len"], p["global_batch"]
    empty = lambda shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    kind = cell.kind
    flops = lm_model_flops(cfg, kind, S, B)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if kind == "train":
        model = T.Transformer(cfg, device, head=True)
        full_micro = max(B // _batch_shards(), 1)
        n = n_micro or full_micro
        rows = n * (B // full_micro)  # each microbatch the full cell's rows
        batch = {k: empty((rows, S), torch.int32) for k in ("tokens", "targets")}
        optimizer = _default_optimizer()
        params = T.train_params(model)
        step = train_loop.make_train_step(
            T.loss_fn(model), optimizer, n_micro=n, cast_dtype=cfg.dtype, donate=True,
            placements=model.placement_tree())
        return BuiltCell(arch, cell.name, kind, step, (params, optimizer.init(params), batch),
                         flops)
    if kind == "prefill" and cfg.window is None:
        cfg = dataclasses.replace(cfg, attn_impl="flash")  # K7, as the card serves
    model = T.Transformer(cfg, device, head=True, param_dtype=cfg.dtype)
    Bh = _rows_here(B)
    if kind == "prefill":
        return BuiltCell(arch, cell.name, kind, T.prefill, (model, empty((Bh, S), torch.int32)),
                         flops)
    if kind == "decode":
        cache = T.init_cache(cfg, Bh, S, device)
        return BuiltCell(arch, cell.name, kind, T.decode_step,
                         (model, cache, empty((Bh,), torch.int32), S - 1), flops)
    raise ValueError(kind)


def _colbert_dry(cfg: colbert_lib.ColBERTConfig, param_dtype=torch.float32) -> colbert_lib.ColBERT:
    return colbert_lib.ColBERT(cfg, T.Transformer(cfg.backbone, META, param_dtype=param_dtype))


#: a search cell's index arrays: (leading rows, trailing shape, dtype, doc-partitioned)
def _index_leaves(p: dict) -> dict:
    nbits = p.get("nbits", 2)
    K, Nd = p["n_centroids"], p["docs_per_shard"]
    Nt = Nd * p["avg_doclen"]
    pd = 128 * nbits // 8
    return {
        "centroids": ((K, 128), torch.float32, False),
        "centroids_q": ((K, 128), torch.int8, False),
        "centroids_scale": ((K,), torch.float32, False),
        "codes": ((Nt,), torch.int32, True), "residuals": ((Nt, pd), torch.uint8, True),
        "tok_pid": ((Nt,), torch.int32, True), "doc_offsets": ((Nd + 1,), torch.int32, True),
        "doc_lens": ((Nd,), torch.int32, True), "ivf_pids": ((Nt,), torch.int32, True),
        "ivf_offsets": ((K + 1,), torch.int32, True), "ivf_lens": ((K,), torch.int32, True),
        "eivf_eids": ((Nt,), torch.int32, True), "eivf_offsets": ((K + 1,), torch.int32, True),
        "eivf_lens": ((K,), torch.int32, True),
        "cutoffs": ((2**nbits - 1,), torch.float32, False),
        "weights": ((2**nbits,), torch.float32, False),
    }


def _retrieval_dry(arch, cfg: colbert_lib.ColBERTConfig, cell: ShapeCell, p) -> BuiltCell:
    kind = cell.kind
    bb = cfg.backbone
    mesh = sharding.active_mesh()
    n_shards = 1 if mesh is None else math.prod(mesh.shape.values())
    flops = retrieval_flops(cfg, kind, p, n_shards)
    if kind == "train":
        ccfg = dataclasses.replace(cfg, nway=p["nway"])
        model = _colbert_dry(ccfg)
        B, nway, qL, dL = p["global_batch"], p["nway"], p["q_len"], p["d_len"]
        batch = {"q_tokens": _meta((B, qL), torch.int32), "q_mask": _meta((B, qL)),
                 "d_tokens": _meta((B, nway, dL), torch.int32), "d_mask": _meta((B, nway, dL)),
                 "target_scores": _meta((B, nway))}
        fn, args = _train_pieces(colbert_lib.loss_fn(model), colbert_lib.train_params(model),
                                 p.get("n_micro", 1), batch, cast_dtype=bb.dtype,
                                 placements=model.placement_tree())
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    if kind == "encode":  # the weights in the compute dtype, as the reference's cell casts them
        model = _colbert_dry(dataclasses.replace(
            cfg, backbone=dataclasses.replace(bb, attn_impl="flash")), bb.dtype)
        tokens = _meta((_rows_here(p["batch"]), p["d_len"]), torch.int32)
        return BuiltCell(arch, cell.name, kind, colbert_lib.encode, (model, tokens), flops)
    if kind == "search":
        # one shard a rank ("docs" over every axis), the centroid space whole
        index = {f: _meta(shape, dt) for f, (shape, dt, _) in _index_leaves(p).items()}
        meta = dict(dim=128, nbits=p.get("nbits", 2), doc_maxlen=p["doc_maxlen"],
                    ivf_list_cap=p["ivf_list_cap"], eivf_list_cap=2 * p["ivf_list_cap"])
        search = engine_sharded.make_sharded_search(
            mesh, search_params(p, "cuda"), docs_per_shard=p["docs_per_shard"], static_meta=meta)
        qs = _meta((p["n_queries"], p["q_len"], 128))
        return BuiltCell(arch, cell.name, kind, search,
                         (index, qs, _meta((p["n_queries"], p["q_len"]))), flops)
    raise ValueError(kind)


def _recsys_dry(arch, cfg: recsys_lib.RecSysConfig, cell: ShapeCell, p) -> BuiltCell:
    kind = cell.kind
    # each leaf at this rank's piece, in a storage of its own
    params, place = recsys_lib.place_params(_meta_tree(recsys_lib.init_params, cfg), cfg)
    flops = recsys_flops(cfg, kind, p)
    meta_batch = lambda spec: {k: _meta(shape, torch.int32 if hi is not None else torch.float32)  # noqa: E731
                               for k, (shape, hi) in spec.items()}
    if kind == "train":
        B = p["batch"]
        n_micro = p.get("n_micro", 1)
        if cfg.interaction == "bidir-seq":  # the reference bounds the logits
            n_micro = max(B // (_batch_shards() * 32), 1)
        batch = meta_batch(recsys_batch_spec(cfg, B))
        if cfg.interaction == "bidir-seq":
            batch["labels"] = _meta((B, cfg.seq_len), torch.int32)
        loss_fn = lambda prm, b: recsys_lib.train_loss(prm, cfg, b)  # noqa: E731
        fn, args = _train_pieces(loss_fn, params, n_micro, batch, placements=place)
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    if kind == "serve":
        batch = meta_batch(recsys_batch_spec(cfg, _rows_here(p["batch"]), with_labels=False))
        fn = lambda prm, b: recsys_lib.serve_scores(prm, cfg, b)  # noqa: E731
        return BuiltCell(arch, cell.name, kind, fn, (params, batch), flops)
    if kind == "retrieval":
        batch = meta_batch(recsys_batch_spec(cfg, 1, with_labels=False))
        batch["candidate_ids"] = _meta((p["n_candidates"],), torch.int32)
        top_k = p["top_k"]
        fn = lambda prm, b: recsys_lib.retrieval_scores(prm, cfg, b, top_k=top_k)  # noqa: E731
        return BuiltCell(arch, cell.name, kind, fn, (params, batch), flops)
    raise ValueError(kind)


def _gnn_batch_spec(cfg, kind: str, p: dict) -> dict:
    """{field: (shape, dtype, logical axes)} of a SchNet cell's batch at
    full size, the reference's dry leaves (a full graph's edges padded to
    a multiple of 512, the most shards)."""
    _, N, E = gnn_shape(cfg, kind, p)
    f32, i32 = torch.float32, torch.int32
    if kind == "molecule":
        return {"z": ((N,), i32, ("nodes",)), "pos": ((N, 3), f32, ("nodes", None)),
                "edge_src": ((E,), i32, ("edges",)), "edge_dst": ((E,), i32, ("edges",)),
                "edge_mask": ((E,), f32, ("edges",)), "node_mask": ((N,), f32, ("nodes",)),
                "graph_id": ((N,), i32, ("nodes",)), "energy": ((p["batch"],), f32, ("batch",))}
    if kind == "full_graph":
        E = -(-E // 512) * 512
    return {"feat": ((N, p["d_feat"]), f32, ("nodes", None)),
            "edge_src": ((E,), i32, ("edges",)), "edge_dst": ((E,), i32, ("edges",)),
            "edge_dist": ((E,), f32, ("edges",)), "edge_mask": ((E,), f32, ("edges",)),
            "labels": ((N,), i32, ("nodes",)), "label_mask": ((N,), f32, ("nodes",))}


def _gnn_dry(arch, base_cfg: schnet_lib.SchNetConfig, cell: ShapeCell, p) -> BuiltCell:
    cfg = gnn_shape(base_cfg, cell.kind, p)[0]
    batch = {k: _meta(shape, dt) for k, (shape, dt, _) in _gnn_batch_spec(cfg, cell.kind, p).items()}
    params = _meta_tree(schnet_lib.init_params, cfg)
    return gnn_cell(arch, base_cfg, cell, p, META, batch=batch, params=params)


# --------------------------------------------------------------------------
# the reference's plan: each leaf's per-rank shape under the rules
# --------------------------------------------------------------------------
def _names(phys) -> tuple:
    return () if phys is None else (phys,) if isinstance(phys, str) else tuple(phys)


def per_rank_shape(axes: tuple, shape: tuple) -> tuple:
    """``shape`` cut by ``logical_to_spec(axes, shape)`` on the active mesh:
    the reference's ``NamedSharding.shard_shape``."""
    mesh = sharding.active_mesh()
    spec = sharding.logical_to_spec(tuple(axes), tuple(shape))
    if mesh is None:
        return tuple(shape)
    return tuple(n // math.prod(mesh.shape[a] for a in _names(ph)) for n, ph in zip(shape, spec))


def plan_bytes(plan: dict) -> int:
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for shape, dt in plan.values())


def _named(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": leaf} of a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _named(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _named(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _tree_leaves(axes_tree, value_tree, prefix: str, dtype=None) -> dict:
    """{key: (axes, whole shape, dtype)} of a parameter tree (tensors, or
    ``(shape, dtype)``) and its logical axes, in the same layout."""
    axes, vals = _named(axes_tree, prefix), _named(value_tree, prefix)
    out = {}
    for k, v in vals.items():
        shape, dt = (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v
        out[k] = (axes[k], shape, dtype or dt)
    return out


def _lm_leaves(cfg: T.TransformerConfig, head: bool, dtype, prefix: str = "") -> dict:
    """The LM tree's leaves in the reference's layout: each layer stack one
    leaf with a leading (unsplit) layer axis."""
    axes, shapes = T._flat_leaves(cfg, head)
    out, stacks = {}, {}
    for name, (path, layer) in T.param_paths(cfg, head).items():
        key = prefix + "/".join(path)
        if layer is None:
            out[key] = (axes[name], shapes[name], dtype)
        else:
            stacks.setdefault(key, [axes[name], shapes[name], 0])[2] += 1
    for key, (ax, shape, n) in stacks.items():
        out[key] = ((None,) + ax, (n,) + shape, dtype)
    return out


def _with_opt(params: dict) -> dict:
    """Parameters plus AdamW's state (``opt_state_axes``): f32 moments
    placed as their parameters, and the step."""
    out = {f"params/{k}": v for k, v in params.items()}
    for m in ("mu", "nu"):
        out.update({f"opt/{m}/{k}": (ax, shape, torch.float32) for k, (ax, shape, _) in params.items()})
    out["opt/step"] = ((), (), torch.int32)
    return out


def _batch_leaves(spec: dict, prefix: str = "batch/") -> dict:
    """{field: (shape, dtype)} as leaves split on their leading axis over
    ``"batch"`` (the reference's ``_batch_axes_like``)."""
    return {prefix + k: (("batch",) + (None,) * (len(shape) - 1), tuple(shape), dt)
            for k, (shape, dt) in spec.items()}


def _plan_leaves(fam: str, cfg, cell: ShapeCell, p: dict) -> dict:
    kind = cell.kind
    i32, f32 = torch.int32, torch.float32
    if fam == "lm":
        S, B = p["seq_len"], p["global_batch"]
        if kind == "train":
            return {**_with_opt(_lm_leaves(cfg, True, f32)),
                    **_batch_leaves({"tokens": ((B, S), i32), "targets": ((B, S), i32)})}
        out = {f"params/{k}": v for k, v in _lm_leaves(cfg, True, cfg.dtype).items()}
        if kind == "prefill":
            out.update(_batch_leaves({"tokens": ((B, S), i32)}, ""))
        else:
            cshape = (cfg.n_layers, B, T.cache_seq_len(cfg, S), cfg.n_kv_heads, cfg.d_head)
            cax = (None,) + T._cache_axes(cfg)
            out.update({"cache/k": (cax, cshape, cfg.dtype), "cache/v": (cax, cshape, cfg.dtype),
                        "tokens": (("batch",), (B,), i32), "n": ((), (), i32)})
        return out
    if fam == "retrieval":
        bb = cfg.backbone
        params = dict(_lm_leaves(bb, False, f32, "backbone/"),
                      proj=(("embed_fsdp", None), (bb.d_model, cfg.out_dim), f32))
        if kind == "train":
            B, nw, qL, dL = p["global_batch"], p["nway"], p["q_len"], p["d_len"]
            return {**_with_opt(params), **_batch_leaves({
                "q_tokens": ((B, qL), i32), "q_mask": ((B, qL), f32),
                "d_tokens": ((B, nw, dL), i32), "d_mask": ((B, nw, dL), f32),
                "target_scores": ((B, nw), f32)})}
        if kind == "encode":
            out = {f"params/{k}": (ax, shape, bb.dtype) for k, (ax, shape, _) in params.items()}
            out.update(_batch_leaves({"tokens": ((p["batch"], p["d_len"]), i32)}, ""))
            return out
        mesh = sharding.active_mesh()
        ns = 1 if mesh is None else math.prod(mesh.shape.values())
        out = {}
        for f, (shape, dt, docs) in _index_leaves(p).items():
            if docs:  # the shards stacked: "docs" over every axis
                out[f"index/{f}"] = (("docs",) + (None,) * (len(shape) - 1),
                                     (shape[0] * ns,) + shape[1:], dt)
            else:
                out[f"index/{f}"] = ((None,) * len(shape), shape, dt)
        nq, qL = p["n_queries"], p["q_len"]
        out["qs"] = ((None, None, None), (nq, qL, 128), f32)
        out["masks"] = ((None, None), (nq, qL), f32)
        return out
    if fam == "recsys":
        tree = _meta_tree(recsys_lib.init_params, cfg)
        params = _tree_leaves(recsys_lib.param_axes(cfg), tree, "")
        spec = lambda B, labels=True: {k: (shape, i32 if hi is not None else f32)  # noqa: E731
                                       for k, (shape, hi) in recsys_batch_spec(cfg, B, labels).items()}
        if kind == "train":
            b = spec(p["batch"])
            if cfg.interaction == "bidir-seq":
                b["labels"] = ((p["batch"], cfg.seq_len), i32)
            return {**_with_opt(params), **_batch_leaves(b)}
        out = {f"params/{k}": v for k, v in params.items()}
        if kind == "serve":
            out.update(_batch_leaves(spec(p["batch"], False)))
        else:
            out.update(_batch_leaves(spec(1, False)))
            out["batch/candidate_ids"] = (("candidates",), (p["n_candidates"],), i32)
        return out
    if fam == "gnn":
        gcfg = gnn_shape(cfg, kind, p)[0]
        tree = _meta_tree(schnet_lib.init_params, gcfg)
        params = _tree_leaves(schnet_lib.param_axes(gcfg), tree, "")
        batch = {f"batch/{k}": (ax, shape, dt)
                 for k, (shape, dt, ax) in _gnn_batch_spec(gcfg, kind, p).items()}
        return {**_with_opt(params), **batch}
    raise ValueError(fam)


def cell_plan(arch_id: str, cell_name: str) -> dict:
    """The reference's plan of a full cell under the active mesh and rules:
    {leaf: (per-rank shape, dtype)} for the parameters (``params/...``; the
    LM layer stacks as the reference stacks them), the optimizer state
    (``opt/...``) of a train cell, and the batch, cache or index.  The
    parameters are the port's (the encoder's tree has no ``lm_head``)."""
    mod = config_registry.get(arch_id)
    cell = config_registry.cells_of(arch_id)[cell_name]
    leaves = _plan_leaves(mod.FAMILY, mod.full_config(), cell, cell.full)
    return {k: (per_rank_shape(ax, shape), dt) for k, (ax, shape, dt) in leaves.items()}


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------
def build_cell(arch_id: str, cell_name: str, *, mode: str = "smoke",
               device: str | torch.device = "cuda", mesh=None, layers: int | None = None,
               n_micro: int | None = None) -> BuiltCell:
    """The cell's callable and inputs: ``fn(*args)`` runs one step.

    ``mode="smoke"``: the reduced config on ``device`` (``mesh``: a search
    cell's one-device mesh).  ``mode="dry"``: the full config on ``meta``,
    called (and its ``fn`` run) under ``sharding.use_mesh`` of a dry mesh
    and the cell's rules (``launch.dryrun``); ``layers`` / ``n_micro``
    build an LM cell at another depth and a train cell at another
    microbatch count (module docstring).  A skipped cell comes back with
    ``skip`` set and no callable."""
    if mode not in ("smoke", "dry"):
        raise ValueError(f"mode must be 'smoke' or 'dry', got {mode!r}")
    mod = config_registry.get(arch_id)
    cell = config_registry.cells_of(arch_id)[cell_name]
    if mode == "smoke":
        dev = resolve_device(device)
        build = {"lm": _lm_cell, "recsys": recsys_cell, "gnn": gnn_cell,
                 "retrieval": retrieval_cell}[mod.FAMILY]
        kw = {"mesh": mesh} if mod.FAMILY == "retrieval" else {}
        return build(arch_id, mod.reduced_config(), cell, cell.reduced, dev, **kw)
    if cell.skip:
        return BuiltCell(arch_id, cell_name, cell.kind, None, (), skip=cell.skip)
    if sharding.active_mesh() is None:
        raise ValueError("a dry cell is built under sharding.use_mesh(<a dry mesh>, rules)")
    cfg, p = mod.full_config(), cell.full
    if mod.FAMILY == "lm":
        built = _lm_dry(arch_id, cfg, cell, p, layers, n_micro)
    else:
        built = {"retrieval": _retrieval_dry, "recsys": _recsys_dry,
                 "gnn": _gnn_dry}[mod.FAMILY](arch_id, cfg, cell, p)
    built.plan = cell_plan(arch_id, cell_name)
    return built
