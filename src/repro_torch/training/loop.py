"""The train step: microbatched gradient accumulation and the optimizer's
update (the counterpart of ``repro.training.loop``).

``make_train_step(loss_fn, optimizer, n_micro)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``,
functional as the reference's: it returns new tensors and changes none it
was given.  ``loss_fn(params, batch) -> (loss, metrics)`` reads the
parameters from the tree it is handed (``models.colbert.loss_fn`` binds a
model to one), so gradients are taken with respect to that tree's leaves.

* The global batch splits into ``n_micro`` microbatches along axis 0, run
  one after the other: peak activation memory is one microbatch's.  Their
  gradients are summed in f32 in microbatch order, then divided by
  ``n_micro``; so is the loss, and the metrics then hold only ``loss`` and
  ``step``, as the reference's do.
* ``compression="int8"`` passes the gradients through
  ``distributed.compression``'s quantize / dequantize with error feedback
  between accumulation and the update; the feedback rides in
  ``opt_state["ef"]``.
* ``cast_dtype`` casts every floating parameter once before the forward
  pass, and gradients are taken with respect to the cast (the reference's
  bf16 C5 path).
* ``donate=True`` lets the step overwrite the parameters and optimizer
  state it is handed, as the reference's ``launch.train`` and train cells
  donate theirs to ``jit`` (``launch.train`` and ``launch.cells`` pass it):
  AdamW's moments and the parameters are updated in place (the same
  bits), and a step holds about 20 bytes a float32 parameter (weights,
  two moments, the f32 gradient and the update) where a functional one
  holds 32.
* The backward pass runs with TF32 off (``ieee_f32_matmul``), as the
  forward's products do.

Data parallelism: under a mesh that splits the batch over W processes
(``distributed.sharding.use_mesh``; ``sharding.data_mesh``) the step is
still the global batch's step.  Every process is handed the global batch;
the microbatches are cut from it as the reference's ``_split_micro`` cuts
them (microbatch m is the global block m, whose rows the processes then
split), and ``loss_fn`` returns this process's share of each
microbatch's loss (``models.colbert.train_loss`` does).  The shares'
gradients, accumulated over the microbatches, are summed over the
processes by ONE all-reduce a step, in f32, with the loss and metrics in
the same buffer; int8 compression and AdamW then run on every replica
alike, so the replicas stay bit-identical (:func:`assert_replicas_agree`
checks it).  ``param_axes`` is accepted and names each leaf's logical axes
(``models.colbert.param_axes``); it constrains nothing
(``sharding.constrain_tree``).

Tensor parallelism: under a mesh with a ``"model"`` axis above 1 each
process holds its slice of each leaf (``models.transformer``); the batch
splits over the other axes (``sharding.data_mesh``), so the gradient
all-reduce runs over those alone, and the processes of a model group
take the same rows.  The step then needs ``placements``, the leaves'
``sharding.Placement`` objects (``Transformer.placement_tree()``): the
optimizer's global norm sums the squares of split leaves over
``"model"`` and counts a replicated leaf once.  int8 compression on such
a mesh quantizes each split leaf whole, as the reference does: its blocks
of 256 values run across the whole leaf (a layer stack's across its
layers), which no process holds, so each split gradient and its error
feedback are gathered over ``"model"`` (one gather of each a split leaf a
step), compressed, and cut back to this process's piece
(``compression.compress_decompress_with_feedback(placements=)``); the
error feedback is stored as pieces, placed as its parameters.
"""
from __future__ import annotations

import torch

from repro_torch import ieee_f32_matmul
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.training import tree as T
from repro_torch.training.optimizer import Optimizer, apply_updates, apply_updates_


def _split_micro(batch: dict, n_micro: int) -> list[dict]:
    out = [{} for _ in range(n_micro)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} % n_micro {n_micro} != 0")
        for i, part in enumerate(x.reshape(n_micro, b // n_micro, *x.shape[1:])):
            out[i][k] = part
    return out


def value_and_grad(loss_fn, params, batch, cast_dtype=None):
    """((loss, metrics), grads): the gradients of ``loss_fn(params, batch)``
    with respect to ``params``' floating leaves (cast to ``cast_dtype``
    first when it is given), zeros for a leaf the loss does not read."""
    def leaf(p):
        p = p.detach()
        if p.is_floating_point():
            if cast_dtype is not None:
                p = p.to(cast_dtype)
            p.requires_grad_(True)
        return p

    flat = [leaf(p) for p in T.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(T.unflatten(params, flat), batch)
        wrt = [p for p in flat if p.requires_grad]
        with ieee_f32_matmul():
            gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True))
    grads = [next(gs) if p.requires_grad else torch.zeros_like(p) for p in flat]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), T.unflatten(params, grads)


def make_train_step(
    loss_fn,  # (params, batch) -> (loss, metrics)
    optimizer: Optimizer,
    n_micro: int = 1,
    compression: str | None = None,
    param_axes=None,
    cast_dtype: torch.dtype | None = None,
    donate: bool = False,
    placements=None,  # the params' sharding.Placement tree (a "model" axis above 1)
):
    if compression not in (None, "int8"):
        raise ValueError(f"compression must be None or 'int8', got {compression!r}")
    # the optimizer sees the placements only on a model axis: an Optimizer's
    # update is (grads, state, params) elsewhere
    norm = {} if placements is None else {"placements": T.leaves(placements)}

    def train_step(params, opt_state, batch):
        mesh = sharding.data_mesh()
        if param_axes is not None:
            params = sharding.constrain_tree(params, param_axes)
        if sharding.model_mesh() is not None and not norm:
            raise ValueError("a 'model' axis above 1 needs the step's placements "
                             "(Transformer.placement_tree())")
        dev = T.leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_micro == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch, cast_dtype)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in T.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in _split_micro(batch, n_micro):
                (l, _), g = value_and_grad(loss_fn, params, mb, cast_dtype)
                torch._foreach_add_(acc, [x.float() for x in T.leaves(g)])
                loss = loss + l
            torch._foreach_div_(acc, n_micro)
            grads = T.unflatten(params, acc)
            loss = loss / n_micro
            metrics = {}
        if mesh is not None:
            grads, loss, metrics = _sum_over_replicas(mesh, grads, loss, metrics)

        if compression == "int8":
            split = placements if sharding.model_mesh() is not None else None
            grads, ef = comp.compress_decompress_with_feedback(grads, opt_state.get("ef"), split)
            opt_state = dict(opt_state, ef=ef)

        inner = {k: v for k, v in opt_state.items() if k != "ef"}
        if donate:
            updates, inner = optimizer.update(grads, inner, params, inplace=True, **norm)
            del grads
            new_params = apply_updates_(params, updates)
        else:
            updates, inner = optimizer.update(grads, inner, params, **norm)
            new_params = apply_updates(params, updates)
        new_state = dict(inner)
        if "ef" in opt_state:
            new_state["ef"] = opt_state["ef"]
        metrics = dict(metrics, loss=loss, step=new_state["step"])
        return new_params, new_state, metrics

    return train_step


def _sum_over_replicas(mesh, grads, loss, metrics):
    """Every process's gradients, loss and metrics summed in f32 by one
    all-reduce of one flat buffer."""
    gs = T.leaves(grads)
    names = sorted(metrics)
    flat = torch.cat([g.float().reshape(-1) for g in gs]
                     + [x.float().reshape(1) for x in [loss] + [metrics[k] for k in names]])
    flat = mesh_mod.all_reduce_sum(mesh, flat)
    parts = list(torch.split(flat, [g.numel() for g in gs] + [1] * (1 + len(names))))
    out = [p.view(g.shape) for p, g in zip(parts, gs)]
    loss, *ms = (p[0] for p in parts[len(gs):])
    return T.unflatten(grads, out), loss, dict(zip(names, ms))


def replica_checksums(params) -> torch.Tensor:
    """One int64 a leaf: the sum of the leaf's bit patterns (a leaf viewed
    as integers of its width), which any changed bit moves."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.stack([p.detach().contiguous().view(ints[p.element_size()]).sum(dtype=torch.int64)
                        for p in T.leaves(params)])


def assert_replicas_agree(params, mesh, shardings=None) -> None:
    """Raise unless every process of ``mesh`` holds the same bits in
    ``params`` (compared by :func:`replica_checksums`).  On a mesh with a
    ``"model"`` axis above 1 (``shardings`` the leaves' placements,
    ``sharding.tree_shardings``): the processes of each data group, which
    hold the same slices, in every leaf, and those of each model group in
    the replicated leaves."""
    if mesh is None or mesh.world_size == 1:
        return
    sums = replica_checksums(params)
    if mesh.shape.get("model", 1) == 1:
        return _agree(sums, mesh, None, "data-parallel replicas")
    _agree(sums, mesh, tuple(a for a in mesh.axis_names if a != "model"), "data-parallel replicas")
    whole = [i for i, p in enumerate(T.leaves(shardings)) if not p.split]
    _agree(sums[whole], mesh, "model", "a model group's replicated leaves")


def _agree(sums, mesh, axis, what: str) -> None:
    sums = mesh_mod.all_gather(mesh, sums, axis=axis)
    if not bool((sums == sums[0]).all()):
        bad = (sums != sums[0]).any(dim=0).nonzero().flatten().tolist()
        raise RuntimeError(f"{what} differ in leaves {bad}")


def init_opt_state(optimizer: Optimizer, params, compression: str | None = None):
    state = optimizer.init(params)
    if compression == "int8":
        state["ef"] = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
    return state
