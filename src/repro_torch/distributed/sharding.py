"""Logical-axis sharding rules (the counterpart of
``repro.distributed.sharding``).

Models name tensor axes *logically* ("batch", "seq", "heads", "embed",
"mlp", "vocab", ...); a rule table maps each name to physical mesh axes,
and :func:`logical_to_spec` turns a tuple of logical names into a spec, a
tuple of physical axis names (``None`` where an axis is not split), as the
reference's ``PartitionSpec`` holds them: axes the active mesh lacks are
dropped, and an axis whose size its mesh extent does not divide falls back
to replication.  The rule tables are the reference's.

The port's meshes are :class:`repro_torch.launch.mesh.Mesh` (any object
with ``shape`` and ``axis_names`` serves :func:`logical_to_spec`), one
device a process.  Eager PyTorch places every collective explicitly, so
:func:`constrain` is the identity.

* A ``"model"`` extent of 1: one replica of the weights a process, the
  batch split over the rest (``"batch"`` -> ``("pod", "data")``;
  :func:`data_mesh`, ``models.colbert.train_loss``, ``training.loop``),
  and a "sharding" (:func:`tree_shardings`) is the device of this
  process's replica.
* A ``"model"`` extent above 1 (tensor and expert parallelism, the LM
  family): each process holds the slice of each weight that
  :func:`logical_to_spec` gives its leaf under the rules, with the
  divisibility fallback (granite-34b's one KV head is replicated); a
  sharding is then a :class:`Placement` (device, spec, the slice).
  :func:`model_mesh` is the ``"model"`` sub-mesh the models reduce over,
  :func:`data_mesh` the sub-mesh over the other axes, which splits the
  batch and sums the gradients.

Refused, naming their ROADMAP items: a mesh with a ``"model"`` axis above
1 whose process holds several devices (Queue 1 item 8.5.6), and the FSDP
rules (``"embed_fsdp"`` over ``"model"``, ``ZERO3_RULES``) on such a mesh
(item 8.5.2).
Under ``DEFAULT_RULES`` ``"embed_fsdp"`` maps to ``"data"``: the reference
would shard weights over the data axis there, the port keeps a whole
replica on every data index (the same values; ROADMAP Queue 3 records the
divergence, item 8.5.2 ports the split), and a :class:`Placement` slices
along ``"model"`` alone.  ``launch.dryrun`` reports both per rank.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, NamedTuple

from repro_torch.launch import mesh as mesh_mod
from repro_torch.training import tree as T

#: ROADMAP items that port a "model" axis over several devices of one
#: process, and the FSDP weight split
_DEVICES_ITEM = "ROADMAP Queue 1 item 8.5.6 (a model axis over several devices of one process)"
_FSDP_ITEM = "ROADMAP Queue 1 item 8.5.2 (the FSDP weight split, ZERO3_RULES)"

# Default physical rules for the ("pod", "data", "model") production mesh.
# "batch" spans pod+data (pure DP across pods), "model-ish" axes span "model".
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": "model",
    "cache_seq": "model",
    "heads": "model",
    "kv_heads": "model",
    "qgroups": None,
    "embed": None,
    "embed_fsdp": "data",
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "head_dim": None,
    # retrieval engine
    "docs": ("pod", "data", "model"),
    "centroids": None,
    # gnn / recsys
    "edges": ("pod", "data", "model"),
    "nodes": None,
    "table_rows": "model",
    "candidates": ("pod", "data", "model"),
}

#: Serve-mode overrides: no FSDP (weights replicated across data).
SERVE_RULES = {"embed_fsdp": None}

#: The reference's pure-FSDP / ZeRO-3 strategy for dense LM training.
ZERO3_RULES = {
    "batch": ("data", "model"),
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "experts": None,
    "embed_fsdp": ("pod", "data", "model"),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict | None = None


_CTX = _Ctx()


def active_rules() -> dict:
    return dict(_CTX.rules or DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Activate a mesh and logical rules (``DEFAULT_RULES`` updated by
    ``rules``) for this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def _divisible(mesh, phys, dim_size: int) -> bool:
    if phys is None:
        return True
    axes = (phys,) if isinstance(phys, str) else phys
    return dim_size % math.prod(mesh.shape[a] for a in axes) == 0


def _filter_axes(mesh, phys):
    """Drop physical axes absent from the mesh (e.g. 'pod' on single-pod)."""
    if phys is None or mesh is None:
        return phys
    axes = (phys,) if isinstance(phys, str) else tuple(phys)
    kept = tuple(a for a in axes if a in mesh.axis_names)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def logical_to_spec(logical_axes: tuple, shape=None) -> tuple:
    """Logical axis names -> a spec (a tuple of physical axes, ``None``
    where an axis is not split) under the active rules and mesh.

    If ``shape`` is given, axes whose size doesn't divide the mesh extent
    fall back to replication.  Physical axes not present in the active mesh
    are dropped."""
    rules = _CTX.rules or DEFAULT_RULES
    mesh = _CTX.mesh
    spec = []
    for i, name in enumerate(logical_axes):
        phys = rules.get(name) if name else None
        phys = _filter_axes(mesh, phys)
        if phys is not None and mesh is not None and shape is not None:
            if not _divisible(mesh, phys, shape[i]):
                phys = None
        spec.append(phys)
    return tuple(spec)


def _model_extent(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def _refuse_model_axis(mesh) -> None:
    """Refuse a ``"model"`` axis above 1 where the port does not lay it
    over processes: several devices in one process, or the FSDP rules."""
    m = _model_extent(mesh)
    if m == 1:
        return
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"a mesh with a 'model' extent of {m} whose process holds {len(mesh.devices)} "
            f"devices; the port lays the model axis over processes, one device each "
            f"({_DEVICES_ITEM})"
        )
    fsdp = _filter_axes(mesh, (_CTX.rules or DEFAULT_RULES).get("embed_fsdp"))
    if fsdp is not None and "model" in ((fsdp,) if isinstance(fsdp, str) else fsdp):
        raise NotImplementedError(
            f"'embed_fsdp' over the 'model' axis (FSDP, ZERO3_RULES) is not ported "
            f"({_FSDP_ITEM})"
        )


def _several_devices(mesh) -> bool:
    return mesh is not None and math.prod(mesh.shape.values()) > 1


def data_mesh():
    """The mesh that splits the batch over several processes (a
    data-parallel step), else None: the active mesh, or with a ``"model"``
    axis above 1 its sub-mesh over the other axes.  Refuses a mesh with
    several devices in one process."""
    mesh = _CTX.mesh
    if not _several_devices(mesh):
        return None
    _refuse_model_axis(mesh)
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"a training mesh holds one device a process, not {len(mesh.devices)}"
        )
    if _model_extent(mesh) > 1:
        mesh = mesh.sub(*(a for a in mesh.axis_names if a != "model"))
        return mesh if mesh.world_size > 1 else None
    return mesh


def model_mesh():
    """The active mesh's ``"model"`` sub-mesh when its extent is above 1
    (the processes a layer's split products reduce over), else None."""
    mesh = _CTX.mesh
    if _model_extent(mesh) == 1:
        return None
    _refuse_model_axis(mesh)
    return mesh.sub("model")


def constrain(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity (see the module docstring); refuses what
    :func:`model_mesh` refuses."""
    mesh = _CTX.mesh
    if _several_devices(mesh):
        _refuse_model_axis(mesh)
    return x


def constrain_tree(tree, axes_tree):
    """Apply ``constrain`` leaf-wise from a logical-axes tree (a tuple is a
    leaf)."""
    return T.tree_map(lambda ax, x: constrain(x, *ax), axes_tree, tree)


def _names(phys) -> tuple:
    return () if phys is None else (phys,) if isinstance(phys, str) else tuple(phys)


class Placement(NamedTuple):
    """Where a leaf lives on a mesh with a ``"model"`` axis above 1: this
    process's device, the leaf's spec (:func:`logical_to_spec`, the
    reference's ``PartitionSpec``), and the ``"model"`` sub-mesh whose
    rank picks this process's slice along the dimension the spec splits
    over ``"model"``."""

    device: Any
    spec: tuple
    model: Any

    @property
    def dim(self) -> int | None:
        """The dimension split over ``"model"``, or None (replicated)."""
        return next((i for i, p in enumerate(self.spec) if "model" in _names(p)), None)

    @property
    def split(self) -> bool:
        return self.dim is not None

    def piece(self, x):
        """This process's slice of the whole leaf ``x`` (numpy or torch)."""
        if self.dim is None:
            return x
        m, r = self.model.world_size, self.model.rank
        n = x.shape[self.dim] // m
        return x[(slice(None),) * self.dim + (slice(r * n, (r + 1) * n),)]

    def local_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if self.dim is None:
            return shape
        return shape[: self.dim] + (shape[self.dim] // self.model.world_size,) + shape[self.dim + 1:]

    def gather(self, x):
        """The whole leaf from every process's slice ``x`` (a collective
        over ``"model"``), on ``x``'s device."""
        if self.dim is None:
            return x
        return mesh_mod.gather_along(self.model, x.detach(), self.dim)


def tree_shardings(tree_axes, tree_shapes=None):
    """A tree of logical-axis tuples -> a tree of placements under the
    active mesh.  With a ``"model"`` extent of 1, the device of this
    process's replica for every leaf; above 1, a :class:`Placement` a leaf
    (``tree_shapes``, a tree of the whole leaves' shapes in the same
    structure, gives the reference's divisibility fallback)."""
    mesh = _CTX.mesh
    if mesh is None:
        raise ValueError("tree_shardings requires an active mesh")
    _refuse_model_axis(mesh)
    if _model_extent(mesh) == 1:
        return T.tree_map(lambda ax: mesh.devices[0], tree_axes)
    model = mesh.sub("model")
    if tree_shapes is None:
        tree_shapes = T.tree_map(lambda ax: None, tree_axes)
    return T.tree_map(lambda ax, shp: Placement(mesh.devices[0], logical_to_spec(ax, shp), model),
                      tree_axes, tree_shapes)


def state_placements(place, state):
    """The placements of a training state ``{"params", "opt": {"mu", "nu",
    "step"[, "ef"]}}`` whose parameters ``place`` places (the moments as
    their parameters, the step replicated), or None when ``place`` is
    None."""
    if place is None:
        return None
    first = T.leaves(place)[0]
    out = {"params": place}
    if "opt" in state:
        step = Placement(first.device, (), first.model)
        out["opt"] = {k: (step if k == "step" else place) for k in state["opt"]}
    return out


def place_tree(tree, shardings):
    """``tree``'s whole leaves (tensors or numpy) as tensors where
    ``shardings`` (:func:`tree_shardings`'s tree, or one device) puts
    them: each cut to this process's piece where a :class:`Placement`
    splits it, a piece of a tensor copied into a storage of its own (so
    the whole leaf can be freed; ``training.tree.place``)."""
    if not isinstance(shardings, (dict, list)):
        return T.place(tree, shardings)

    def cut(x, p):
        if not (isinstance(p, Placement) and p.split):
            return x
        piece = p.piece(x)
        return piece.clone() if hasattr(piece, "clone") else piece

    cut = T.tree_map(cut, tree, shardings)
    return T.place(cut, T.tree_map(lambda p: p.device if isinstance(p, Placement) else p,
                                   shardings))


def gather_tree(tree, shardings):
    """``tree`` with each split leaf gathered whole over ``"model"`` (a
    collective: every process of the model group calls it); ``shardings``
    from :func:`tree_shardings`, devices or placements."""
    return T.tree_map(lambda x, p: p.gather(x) if isinstance(p, Placement) else x,
                      tree, shardings)
