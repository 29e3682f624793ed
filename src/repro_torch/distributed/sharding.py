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
with ``shape`` and ``axis_names`` serves :func:`logical_to_spec`).  Training
runs on a mesh whose ``"model"`` extent is 1: one replica of the weights a
process, the batch split over the rest (``"batch"`` -> ``("pod",
"data")``).  Eager PyTorch splits the batch explicitly
(:func:`data_mesh`, ``models.colbert.train_loss``, ``training.loop``), so
:func:`constrain` has nothing to act on there and is the identity, and a
"sharding" (:func:`tree_shardings`) is the device of this process's
replica.  A ``"model"`` extent above 1 means tensor parallelism (heads,
MLP and vocab over ``"model"``) or the FSDP rules that put weights on it;
neither is ported, and every entry point here refuses such a mesh rather
than replicate what the rules would split.  Under ``DEFAULT_RULES``
``"embed_fsdp"`` maps to ``"data"``: the reference would shard weights over
the data axis there, the port keeps a whole replica on every process (the
same values; ROADMAP Queue 3 records the divergence).
"""
from __future__ import annotations

import contextlib
import math
import threading

from repro_torch.training import tree as T

#: ROADMAP item that ports a "model" axis above 1
_MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 8.3 (tensor-parallel and FSDP rules)"

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


def _refuse_model_axis(mesh) -> None:
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a mesh with a 'model' extent of {mesh.shape['model']} splits weights or "
            f"activations over devices; the port trains data-parallel only ({_MODEL_AXIS_ITEM})"
        )


def _several_devices(mesh) -> bool:
    return mesh is not None and math.prod(mesh.shape.values()) > 1


def data_mesh():
    """The active mesh when it splits the batch over several processes (a
    data-parallel step), else None.  Refuses a ``"model"`` extent above 1
    and a mesh with several devices in one process."""
    mesh = _CTX.mesh
    if not _several_devices(mesh):
        return None
    _refuse_model_axis(mesh)
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"a training mesh holds one device a process, not {len(mesh.devices)}"
        )
    return mesh


def constrain(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity (see the module docstring); refuses a ``"model"`` extent above
    1."""
    mesh = _CTX.mesh
    if _several_devices(mesh):
        _refuse_model_axis(mesh)
    return x


def constrain_tree(tree, axes_tree):
    """Apply ``constrain`` leaf-wise from a logical-axes tree (a tuple is a
    leaf)."""
    return T.tree_map(lambda ax, x: constrain(x, *ax), axes_tree, tree)


def tree_shardings(tree_axes):
    """A tree of logical-axis tuples -> a tree of placements: the device of
    this process's replica under the active mesh, for every leaf (the
    reference's ``tree_shapes``, for its divisibility fallback, has no
    counterpart: a replica's placement does not depend on shapes)."""
    mesh = _CTX.mesh
    if mesh is None:
        raise ValueError("tree_shardings requires an active mesh")
    _refuse_model_axis(mesh)
    return T.tree_map(lambda ax: mesh.devices[0], tree_axes)
