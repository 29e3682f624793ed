"""ColBERT late-interaction encoder in PyTorch (the counterpart of
``repro.models.colbert``).

A bidirectional transformer backbone (``models.transformer`` with
``causal=False``), a linear projection to ``out_dim`` and L2 normalisation:
the token vectors PLAID indexes and searches.  ``encode`` is the serving
path (no graph); calling the model builds one when a weight requires grad.

Training follows ColBERTv2 supervision (``train_loss``): per query one
positive (slot 0) and ``nway - 1`` negatives scored with MaxSim, cross-
entropy over the candidates (with in-batch negatives, every passage of the
batch), and KL distillation against teacher scores.  Under a data-parallel
mesh (``distributed.sharding.data_mesh``) the loss is still the global
batch's: each process encodes its rows and gathers every process's passage
vectors, differentiably, for its queries' in-batch negatives.

On a mesh with a ``"model"`` axis above 1 (tensor parallelism, as the LM
family's) the backbone holds this process's piece of each split weight
(``models.transformer``) and returns the hidden states whole on every
process of a model group; ``proj`` (``("embed_fsdp", None)``, whole on
every process: the port keeps ``"embed_fsdp"`` whole over ``"data"``) and
the normalisation then run on them, so each process's vectors are one
process's.  The batch splits over the other axes alone
(``sharding.data_mesh``): the processes of a model group take the same
rows and compute the same loss.  :meth:`ColBERT.placement_tree` gives the
leaves' placements (the reference's unused ``lm_head`` split over the
vocabulary, as an LM's head).

The training state is a tree in the reference's layout (``{"backbone":
{"embed", "final_norm", "dense_layers", ...}, "proj"}``, each layer stack a
list of per-layer tensors, see ``repro_torch.training.tree``);
``loss_fn(model)`` runs the model on such a tree through
``torch.func.functional_call``.  ``train_state_from_numpy`` /
``numpy_train_state`` carry the whole state (``params`` and ``opt``) across
as the reference's numpy trees.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import ieee_f32_matmul
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.training import tree as tree_lib

@dataclasses.dataclass(frozen=True)
class ColBERTConfig:
    backbone: T.TransformerConfig = dataclasses.field(
        default_factory=lambda: T.TransformerConfig(causal=False)
    )
    out_dim: int = 128
    nway: int = 4  # passages scored per query in training (1 positive + negatives)
    use_ib_negatives: bool = True
    distill: bool = True

    @property
    def name(self):
        return "colbertv2"


class ColBERT(nn.Module):
    """The backbone and its ``(d_model, out_dim)`` float32 projection."""

    def __init__(self, cfg: ColBERTConfig, backbone: T.Transformer):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.proj = nn.Parameter(
            torch.zeros((cfg.backbone.d_model, cfg.out_dim), device=backbone.device,
                        dtype=backbone.embed.dtype),
            requires_grad=False,
        )

    @property
    def device(self) -> torch.device:
        return self.backbone.device

    def placement_tree(self, head: bool = False):
        """Each training leaf's ``sharding.Placement`` in the training
        tree's layout (with ``head``, the reference's ``backbone/lm_head``
        too, split over the vocabulary as an LM's head), or None without a
        ``"model"`` axis: the backbone's placements and ``proj``'s, whose
        spec splits it over ``"data"`` alone, so every process holds it
        whole."""
        if self.backbone.tp is None:
            return None
        axes, shapes = T._flat_leaves(self.cfg.backbone, head=True)
        own = sharding.tree_shardings(
            {"proj": param_axes(self.cfg)["proj"], "lm_head": axes["lm_head"]},
            {"proj": tuple(self.proj.shape), "lm_head": shapes["lm_head"]})
        out = {"backbone": self.backbone.placement_tree(), "proj": own["proj"]}
        if head:
            out["backbone"]["lm_head"] = own["lm_head"]
        return out

    def forward(self, tokens, mask=None) -> torch.Tensor:
        """tokens (B, S) -> unit-norm token vectors (B, S, out_dim) f32, on
        the model's device (tokens and mask are moved there).

        The projection runs in the compute dtype, then ``.float()``; rows
        are divided by ``max(norm, 1e-6)``; ``mask`` (B, S) zeroes padded
        tokens.
        """
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev)
        h = self.backbone(tokens)
        dt = self.cfg.backbone.dtype
        with ieee_f32_matmul():
            e = (h.to(dt) @ self.backbone.cast(self.proj)).float()
        e = e / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)
        if mask is not None:
            e = e * torch.as_tensor(mask, device=dev).to(e.dtype)[..., None]
        return e

    def numpy_params(self) -> dict:
        """The reference's ``colbert.init_params`` tree as numpy (``lm_head``
        excepted); on a ``"model"`` axis the whole leaves, gathered (a
        collective)."""
        tree = train_params(self)
        if self.backbone.tp is not None:
            tree = sharding.gather_tree(tree, self.placement_tree())
        return tree_lib.to_numpy(tree)


@torch.no_grad()
def encode(model: ColBERT, tokens, mask=None) -> torch.Tensor:
    """The serving encode: ``model(tokens, mask)`` without a graph (one
    cached compute-dtype cast per weight)."""
    return model(tokens, mask)


def maxsim_scores(q_emb: torch.Tensor, d_emb: torch.Tensor, d_mask=None) -> torch.Tensor:
    """q (B, Lq, D) vs d (N, Ld, D) -> (B, N) late-interaction scores."""
    with ieee_f32_matmul():
        s = torch.einsum("bqd,ntd->bnqt", q_emb, d_emb)
    if d_mask is not None:
        s = torch.where(d_mask[None, :, None, :] > 0, s, -1e4)
    return s.amax(dim=-1).sum(dim=-1)  # max over doc tokens, sum over q


def params_from_numpy(
    tree: Mapping, cfg: ColBERTConfig, device: str | torch.device = "cuda"
) -> ColBERT:
    """A :class:`ColBERT` holding the reference's ``colbert.init_params``
    tree (converted to numpy) value for value; ``backbone/lm_head`` is
    dropped (``encode`` does not use it).  On a ``"model"`` axis each
    process takes its piece of each leaf."""
    model = ColBERT(cfg, T.Transformer(cfg.backbone, device))
    like = train_params(model)
    return assign_params(model, _on_devices(
        T._host_pieces(tree, like, model.placement_tree()), like))


def _on_devices(arrays, like):
    """Host arrays as tensors on the devices of ``like``'s leaves (a tree
    of the same structure), each a writable copy."""
    return tree_lib.tree_map(lambda a, t: torch.from_numpy(np.array(a)).to(t.device), arrays, like)


@torch.no_grad()
def init_params(
    cfg: ColBERTConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> ColBERT:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` (not ``jax.random``'s numbers)."""
    model = ColBERT(cfg, T.init_params(cfg.backbone, generator, device))
    scale = (2.0 / (cfg.backbone.d_model + cfg.out_dim)) ** 0.5
    model.proj.copy_(T._normal(tuple(model.proj.shape), scale, generator))
    return model


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
def train_loss(model: ColBERT, cfg: ColBERTConfig, batch: Mapping):
    """batch: ``q_tokens`` (B, Lq), ``d_tokens`` (B, nway, Ld), ``d_mask``,
    ``q_mask``, ``target_scores`` (B, nway) teacher scores (optional).
    Returns ``(ce + kd, {"ce", "kd"})``.

    Under a data-parallel mesh of W processes ``batch`` is the global batch
    on every process, and process r takes rows ``[r B/W, (r+1) B/W)``: it
    encodes its queries and their passages, gathers every process's passage
    vectors (``launch.mesh.all_gather_rows``: the gradient of each flows
    back to the process that encoded it) for the in-batch negatives, and
    returns its queries' share of the global means, so the processes'
    losses (and gradients) sum to the global batch's.  The KD term reads a
    query's own passages and teacher scores, which are in its rows.  On a
    ``"model"`` axis above 1 the rows split over the other axes alone: a
    model group's processes encode the same rows and return the same
    loss, and the backbone's ``copy_to`` / ``reduce_from`` pairs give each
    split leaf its piece's gradient and each whole leaf its whole gradient
    once."""
    B, nway, Ld = batch["d_tokens"].shape
    dev = model.device
    mesh = sharding.data_mesh()
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    if B % world:
        raise ValueError(f"batch {B} does not split over {world} processes")
    b = B // world
    rows, d_rows = slice(rank * b, (rank + 1) * b), slice(rank * b * nway, (rank + 1) * b * nway)
    q_mask = batch.get("q_mask")
    q = model(torch.as_tensor(batch["q_tokens"], device=dev)[rows],
              None if q_mask is None else torch.as_tensor(q_mask, device=dev)[rows])
    d_tok = torch.as_tensor(batch["d_tokens"], device=dev).reshape(B * nway, Ld)
    d_msk = torch.as_tensor(batch["d_mask"], device=dev).reshape(B * nway, Ld)
    d = model(d_tok[d_rows], d_msk[d_rows])  # this process's passages
    ar = torch.arange(b, device=dev)
    all_scores = None  # (b, B * nway): every query against every passage
    if cfg.use_ib_negatives:
        if mesh is not None:
            d = mesh_mod.all_gather_rows(mesh, d)
        scores = all_scores = maxsim_scores(q, d, d_msk)
        own = rank * b + ar  # the queries' rows in the global batch
        labels = own * nway  # positives in slot 0
    else:
        dg = d.reshape(b, nway, Ld, -1)
        with ieee_f32_matmul():
            s = torch.einsum("bqd,bntd->bnqt", q, dg)
        s = torch.where(d_msk[d_rows].reshape(b, nway, Ld)[:, :, None, :] > 0, s, -1e4)
        scores = s.amax(dim=-1).sum(dim=-1)
        labels = torch.zeros(b, dtype=torch.long, device=dev)
    share = b / B  # 1.0 on one process: the means are the global batch's
    logz = torch.logsumexp(scores, dim=-1)
    pos = scores.gather(-1, labels[:, None])[:, 0]
    ce = (logz - pos).mean() * share

    kd = torch.zeros((), device=dev)
    if cfg.distill and "target_scores" in batch:
        if all_scores is None:  # no in-batch negatives: this process's passages
            all_scores, own = maxsim_scores(q, d, d_msk[d_rows]), ar
        way = all_scores.reshape(b, -1, nway)[ar, own]  # (b, nway) own candidates
        logp = torch.log_softmax(way, dim=-1)
        tgt = torch.softmax(torch.as_tensor(batch["target_scores"], device=dev)[rows].float(), dim=-1)
        kd = -(tgt * logp).sum(dim=-1).mean() * share
    return ce + kd, {"ce": ce, "kd": kd}


def param_paths(cfg: ColBERTConfig) -> dict[str, tuple[tuple[str, ...], int | None]]:
    """Each parameter's name in :class:`ColBERT` -> (its path in the
    reference's tree, its index in the layer stack or None)."""
    out = {f"backbone.{name}": (("backbone",) + path, layer)
           for name, (path, layer) in T.param_paths(cfg.backbone).items()}
    out["proj"] = (("proj",), None)
    return out


def param_axes(cfg: ColBERTConfig) -> dict:
    """Logical axes of each training parameter (``distributed.sharding``),
    in the training tree's layout; the reference's ``param_axes``,
    ``lm_head`` excepted."""
    return {"backbone": T.param_axes(cfg.backbone), "proj": ("embed_fsdp", None)}


def train_params(model: ColBERT) -> dict:
    """The model's parameters as a training tree (the reference's layout,
    each layer stack a list): detached aliases, which a functional train
    step reads and never writes (``assign_params`` into the same model
    does)."""
    return T.params_tree(model, param_paths(model.cfg))


def module_params(params: Mapping, cfg: ColBERTConfig) -> dict[str, torch.Tensor]:
    """A training tree's tensors under the module's parameter names (leaves
    the model does not read, such as the reference's ``lm_head``, are
    left out)."""
    return tree_lib.scatter(params, param_paths(cfg))


class _Loss(nn.Module):
    def __init__(self, model: ColBERT):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return train_loss(self.model, self.model.cfg, batch)


def loss_fn(model: ColBERT):
    """``(params, batch) -> train_loss(model with params, batch)``, the loss
    function ``training.loop.make_train_step`` takes."""
    bound = _Loss(model)

    def fn(params, batch):
        named = {f"model.{k}": v for k, v in module_params(params, model.cfg).items()}
        return torch.func.functional_call(bound, named, (batch,))

    return fn


def assign_params(model: ColBERT, params: Mapping) -> ColBERT:
    """Copy a training tree's parameters into ``model`` (e.g. trained
    weights into a model that serves); returns ``model``."""
    T.assign_params(model, param_paths(model.cfg), params)
    return model


def train_state_from_numpy(
    tree: Mapping, cfg: ColBERTConfig, device: str | torch.device = "cuda"
) -> tuple[ColBERT, dict]:
    """The reference's training state ``{"params": ..., "opt": {"mu", "nu",
    "step"[, "ef"]}}`` (as numpy) -> (a model holding ``params``, the port's
    state with every leaf on ``device``).  Leaves the encoder does not read
    (the reference's ``lm_head``) stay in the state, so the optimizer
    updates them (weight decay) as the reference's does.  On a ``"model"``
    axis each process holds its piece of every leaf
    (:func:`state_placements`)."""
    model = params_from_numpy(tree["params"], cfg, device)
    like = train_params(model)
    if "lm_head" in tree["params"]["backbone"]:
        like["backbone"]["lm_head"] = model.proj  # a plain leaf on the device
    state = {"params": like}
    if "opt" in tree:
        state["opt"] = {k: (model.proj if k == "step" else like) for k in tree["opt"]}
    return model, _on_devices(T._host_pieces(tree, state, state_placements(model, state)), state)


def state_placements(model: ColBERT, state: Mapping):
    """Each leaf's ``sharding.Placement`` in a training state ``{"params",
    "opt": {"mu", "nu", "step"[, "ef"]}}`` of ``model`` (``lm_head`` placed
    where the state holds it), or None without a ``"model"`` axis."""
    head = "lm_head" in state["params"]["backbone"]
    return sharding.state_placements(model.placement_tree(head), state)


def numpy_train_state(state: Mapping) -> dict:
    """The port's training state (or any training tree) as the reference's
    numpy tree: each layer list stacked on a leading ``L`` axis."""
    return tree_lib.to_numpy(state)
