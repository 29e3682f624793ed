"""SchNet (Schütt et al. 2017): continuous-filter convolutions in plain
PyTorch (the counterpart of ``repro.models.schnet``).

Message passing is a gather over an edge list and a segment sum
(``index_add``) into the destination nodes.  On the card ``index_add`` is
an f32 atomic sum in no fixed order, so a card run equals a host run to
rounding, not bit for bit.

Two input regimes:

* molecules: atomic numbers and 3-D positions -> RBF-expanded distances
  (the faithful SchNet, the ``molecule`` cell, energy regression);
* generic graphs (cora / products-style shapes): node features are
  projected into the hidden space, edge distances come as an edge feature,
  and the output is a per-node classification.

The parameters are the reference's tree, the interaction blocks stacked on
a leading axis (one tensor a leaf, ``n_interactions`` long); ``forward``
loops over that axis where the reference scans it.

On a mesh whose axes ``"edges"`` maps to hold several processes (one
device a process, ``distributed.sharding.use_mesh``) the edges split as
the reference's ``shard_map`` splits them: each process takes its
contiguous slice of the edge arrays (E padded to a multiple of the
processes with ``edge_mask`` 0), computes the radial basis and every
interaction's edge work (the filter MLP, the gather, the multiply and the
segment sum) on that slice, and one all-reduce a block sums the (N, d)
partial aggregates (``launch.mesh.reduce_from``).  ``xw`` and the filter
layers enter through ``copy_to``, so their gradients, partial in each
process, are summed too.  The nodes and every node-space product are
whole on each process, so each process's loss and gradients are the
whole graph's: ``train_loss`` returns its share over the processes that
split the batch (``sharding.data_mesh``), which ``training.loop`` sums
back to the whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.training import tree as tree_lib

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    max_z: int = 100  # atomic-number vocabulary (molecule regime)
    d_feat: int = 0  # node-feature dim (graph regime; 0 = molecule regime)
    n_classes: int = 0  # per-node classes (graph regime; 0 = energy head)
    dtype: torch.dtype = torch.float32

    def num_params(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        inter = self.n_interactions * (d * d * 3 + r * d + d * d)
        head = d * (d // 2) + (d // 2) * max(self.n_classes, 1)
        inp = self.d_feat * d if self.d_feat else self.max_z * d
        return inp + inter + head


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log 2`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))`` at every x, and
    the gradient ``sigmoid(x)``, 0.5 at 0).  ``F.softplus`` would return x
    itself above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - math.log(2.0)


def rbf_centers(n_rbf: int, cutoff: float, device=None) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` as the reference gets it under
    XLA: ``i * f32(cutoff / (n_rbf - 1))`` in f32 (XLA folds the
    reference's ``cutoff * (i / (n_rbf - 1))`` into one product), the last
    point ``cutoff`` itself.  Equal value for value at the configs' (300,
    10) and (20, 10); ``torch.linspace`` rounds a third of them
    otherwise."""
    div = n_rbf - 1
    if div < 1:
        return torch.zeros((n_rbf,), device=device)
    step = torch.tensor(cutoff / div, dtype=torch.float32, device=device)
    mu = torch.arange(div, dtype=torch.float32, device=device) * step
    return torch.cat([mu, torch.full((1,), cutoff, device=device)])


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """(E,) distances -> (E, n_rbf) Gaussian radial basis (SchNet eq. 5)."""
    mu = rbf_centers(n_rbf, cutoff, dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


@torch.no_grad()
def init_params(cfg: SchNetConfig, generator: torch.Generator) -> dict:
    """Random weights with the reference's tree, shapes and scales (not its
    numbers), f32 on the generator's device; each interaction leaf stacked
    on a leading ``n_interactions`` axis."""
    g, d = generator, cfg.d_hidden
    if cfg.d_feat:
        inp = L.dense_init(g, cfg.d_feat, d)
    else:
        inp = {"embed": torch.randn((cfg.max_z, d), generator=g, device=g.device) * 0.1}
    inters = [
        {"w_in": L.dense_init(g, d, d), "filter1": L.dense_bias_init(g, cfg.n_rbf, d),
         "filter2": L.dense_bias_init(g, d, d), "w_out": L.dense_bias_init(g, d, d),
         "w_post": L.dense_bias_init(g, d, d)}
        for _ in range(cfg.n_interactions)
    ]
    stacked = tree_lib.tree_map(lambda *xs: torch.stack(xs), *inters)
    head = {"h1": L.dense_bias_init(g, d, d // 2),
            "h2": L.dense_bias_init(g, d // 2, max(cfg.n_classes, 1))}
    return {"input": inp, "interactions": stacked, "head": head}


def param_axes(cfg: SchNetConfig) -> dict:
    """Logical axes of each parameter, the reference's ``param_axes``."""
    dd = {"w": (None, None), "b": (None,)}
    stacked = {"w": (None, None, None), "b": (None, None)}
    return {
        "input": {"w": (None, None)} if cfg.d_feat else {"embed": (None, None)},
        "interactions": {"w_in": {"w": (None, None, None)}, "filter1": stacked,
                         "filter2": stacked, "w_out": stacked, "w_post": stacked},
        "head": {"h1": dd, "h2": dd},
    }


def params_from_numpy(tree: Mapping, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_params`` tree (as numpy) on ``device``."""
    return tree_lib.tensors(tree, device)


def numpy_params(params: Mapping) -> dict:
    return tree_lib.to_numpy(params)


def edge_mesh():
    """The sub-mesh of the active mesh's axes that ``"edges"`` maps to under
    the active rules when it holds several processes, else None."""
    mesh = sharding.active_mesh()
    if mesh is None:
        return None
    phys = sharding.active_rules().get("edges") or ()
    axes = tuple(a for a in ((phys,) if isinstance(phys, str) else phys) if a in mesh.axis_names)
    if math.prod(mesh.shape[a] for a in axes) <= 1:
        return None
    return mesh.sub(*axes)


def _edge_slice(batch: Mapping, mesh) -> dict:
    """This process's contiguous slice of ``batch``'s edge arrays (E padded
    to a multiple of ``mesh``'s processes, padding masked out)."""
    names = [k for k in ("edge_src", "edge_dst", "edge_dist", "edge_mask") if k in batch]
    E = batch["edge_src"].shape[0]
    c = -(-E // mesh.world_size)
    lo, hi = mesh.rank * c, min((mesh.rank + 1) * c, E)
    out = {}
    for k in names:
        x = batch[k][lo:hi]
        pad = c - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        out[k] = x
    if "edge_mask" not in batch:
        mask = torch.zeros((c,), device=batch["edge_src"].device)
        mask[: max(hi - lo, 0)] = 1.0
        out["edge_mask"] = mask
    return out


def _dense_bias(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    return L.dense_bias(p["w"], p["b"], x)


def _cfconv_aggregate(p: Mapping, xw, edge_src, edge_dst, rbf, n_nodes: int, edge_mask):
    """The filter MLP, the gather, the multiply and the segment sum."""
    w = shifted_softplus(_dense_bias(p["filter2"], shifted_softplus(_dense_bias(p["filter1"], rbf))))
    msg = xw[edge_src.long()] * w * edge_mask[:, None]  # (E, d)
    return msg.new_zeros((n_nodes, msg.shape[1])).index_add(0, edge_dst.long(), msg)


def interaction(p: Mapping, x, edge_src, edge_dst, rbf, n_nodes: int, edge_mask, mesh=None):
    """One continuous-filter convolution block (cfconv + atom-wise), ``p``
    one block's leaves; with ``mesh`` (:func:`edge_mesh`) the edge arrays
    are this process's slice and the aggregates are summed over it."""
    xw = L.dense(p["w_in"]["w"], x)  # (N, d)
    filt = {k: {n: mesh_mod.copy_to(mesh, t) for n, t in p[k].items()} for k in ("filter1", "filter2")}
    agg = mesh_mod.reduce_from(mesh, _cfconv_aggregate(
        filt, mesh_mod.copy_to(mesh, xw), edge_src, edge_dst, rbf, n_nodes, edge_mask))
    v = shifted_softplus(_dense_bias(p["w_out"], agg))
    return x + _dense_bias(p["w_post"], v)


def forward(params: Mapping, cfg: SchNetConfig, batch: Mapping) -> torch.Tensor:
    """batch: the molecule regime {z (N,), pos (N, 3), edge_src / edge_dst
    (E,), graph_id (N,), edge_mask (E,), node_mask (N,)} or the graph
    regime {feat (N, d_feat), edge_src / edge_dst (E,), edge_dist (E,),
    ...} -> (N, n_classes or 1)."""
    mesh = edge_mesh()
    edges = batch if mesh is None else _edge_slice(batch, mesh)
    src, dst = edges["edge_src"], edges["edge_dst"]
    edge_mask = edges.get("edge_mask")
    if edge_mask is None:
        edge_mask = torch.ones(src.shape[0], device=src.device)
    if cfg.d_feat:
        x = L.dense(params["input"]["w"], batch["feat"].to(cfg.dtype))
        dist = edges["edge_dist"]
    else:
        x = params["input"]["embed"][batch["z"].long()]
        pos = batch["pos"]
        diff = pos[src.long()] - pos[dst.long()]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    n_nodes = x.shape[0]
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    inters = params["interactions"]
    for i in range(cfg.n_interactions):
        p = tree_lib.tree_map(lambda a: a[i], inters)
        x = interaction(p, x, src, dst, rbf, n_nodes, edge_mask, mesh)
    h = shifted_softplus(_dense_bias(params["head"]["h1"], x))
    return _dense_bias(params["head"]["h2"], h)


def train_loss(params: Mapping, cfg: SchNetConfig, batch: Mapping):
    """``(loss, {"loss": loss})``: the masked mean node NLL (graph regime)
    or the mean squared error of each molecule's summed atom energies;
    under a mesh that splits the batch over W processes
    (``sharding.data_mesh``) each process's share, 1 / W of it (module
    docstring)."""
    out = forward(params, cfg, batch)
    if cfg.n_classes:
        labels = batch["labels"].long()
        lmask = batch.get("label_mask")
        if lmask is None:
            lmask = torch.ones(labels.shape, device=labels.device)
        logp = torch.log_softmax(out.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
        loss = (nll * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)
    else:
        node_mask = batch.get("node_mask")
        if node_mask is None:
            node_mask = torch.ones(out.shape[0], device=out.device)
        atom_e = out[:, 0] * node_mask
        n_graphs = batch["energy"].shape[0]
        energy = atom_e.new_zeros((n_graphs,)).index_add(0, batch["graph_id"].long(), atom_e)
        loss = torch.mean((energy - batch["energy"]) ** 2)
    data = sharding.data_mesh()
    if data is not None:
        loss = loss / data.world_size
    return loss, {"loss": loss}
