"""Device meshes for document sharding, and multi-process bring-up (the
counterpart of ``repro.launch.mesh``).

The reference is single-controller: one process drives every device of a
``jax`` mesh, and ``shard_map`` runs the per-shard pipeline on each.  The
port keeps that shape with a small frozen :class:`Mesh`:

* ``devices`` — this process's shard devices, in shard order;
* ``group`` — a ``torch.distributed`` process group spanning several
  processes, or ``None`` for one process.

Global shard ``s = rank * len(devices) + i`` lives on ``devices[i]`` of
rank ``rank``, so ``n_shards = len(devices) * world_size``.  Every
process runs its own shards one after another and joins the others
through ONE collective, :func:`gather_shards`.

A ``Mesh`` built explicitly may repeat a device: several shards then share
one card (or the host), as the reference's tests place several shards on
one host with ``--xla_force_host_platform_device_count``.  The factories
never fall back to the CPU: a CPU mesh is what a caller gets who asks for
``device="cpu"``.

Multi-process: launch one process per card with ``torchrun`` (it sets
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK``), call :func:`init_distributed` in each, then build the
mesh with :func:`make_multihost_mesh` (or let a sharded backend build it
from ``n_shards``).  Like the reference's, ``init_distributed`` is a
no-op returning ``False`` when those variables are absent, and repeat
calls are no-ops.

Training meshes carry the reference's axis names in ``axes``:
:func:`make_local_mesh` is its 1 x 1 ``("data", "model")`` mesh and
:func:`make_production_mesh` lays every process of the group out as
``("data", "model")`` or ``("pod", "data", "model")``, one device a
process, row-major (the model index varies fastest).  Its model extent
defaults to 1 (data parallelism over the whole group); ``model=m`` lays
the reference's ``"model"`` axis (tensor and expert parallelism) over
groups of ``m`` processes, and the mesh then holds one process group a
named axis: :meth:`Mesh.sub` is the sub-mesh along some axes (its ranks
are the processes that differ only there), :func:`axis_index` this
process's coordinate.

Training's collectives are here too: :func:`all_reduce_sum`,
:func:`all_reduce_max`, :func:`all_gather_rows` (differentiable),
:func:`all_to_all` and :func:`all_gather`, each over the whole group or,
with ``axis=``, over one named axis; and the tensor-parallel pair
:func:`copy_to` (identity forward, all-reduce backward) and
:func:`reduce_from` (all-reduce forward, identity backward), with
:func:`gather_along` (a differentiable all-gather along a dimension).  On
an NCCL group their tensors stay on the card; on a gloo group (the CPU, or
two processes sharing one card) each crosses to the host and back
explicitly, so no collective relies on gloo's support for CUDA tensors.
A gloo sum of bf16 or f16 values is taken in f32 and rounded once, as one
rounding of the exact sum: gloo has no bf16 sum of its own everywhere,
and one that rounded at each of its adds would depend on the ranks'
order.

A dry mesh (:func:`make_dry_mesh`) is one rank of the reference's
production mesh, 16 x 16 ``("data", "model")`` or 2 x 16 x 16 ``("pod",
"data", "model")``, with no process group and no peer started: its group
and sub-groups are :class:`DryGroup` records of a rank and a size, its one
device is ``meta``.  :meth:`Mesh.sub`, :func:`axis_index` and
``distributed.sharding``'s ``data_mesh`` / ``model_mesh`` / ``Placement``
read it as they read a real mesh.  Its collectives compute nothing: each
returns a meta tensor of the shape the real collective gives and charges
its bytes to the active ``launch.meta_cost`` counter (the dry-run).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.launch import meta_cost


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A dry mesh's process group: this rank's index among ``size`` ranks
    that are never started."""

    rank: int
    size: int


def is_dry(mesh) -> bool:
    return mesh is not None and isinstance(mesh.group, DryGroup)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices and the group joining its peers."""

    devices: tuple
    group: Any = None  # torch.distributed ProcessGroup, or None
    #: named axes ``((name, extent), ...)`` whose extents multiply to
    #: ``n_shards``; empty for a document-sharding mesh (one ``"data"`` axis)
    axes: tuple = ()
    #: ``((axis names, process group), ...)``: this process's group along
    #: those axes, for the sub-meshes :meth:`sub` hands out
    subgroups: tuple = ()

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        axes = tuple((str(a), int(n)) for a, n in self.axes)
        if axes and math.prod(n for _, n in axes) != self.n_shards:
            raise ValueError(f"mesh axes {axes} do not multiply to {self.n_shards} shard(s)")
        object.__setattr__(self, "axes", axes)

    @property
    def rank(self) -> int:
        if isinstance(self.group, DryGroup):
            return self.group.rank
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        if isinstance(self.group, DryGroup):
            return self.group.size
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def n_shards(self) -> int:
        return len(self.devices) * self.world_size

    def shard_ids(self) -> range:
        """Global ids of this process's shards, in ``devices`` order."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    @property
    def shape(self) -> dict:
        """The reference's ``dict(mesh.shape)``: ``axes``, or one flat docs
        axis."""
        return dict(self.axes) if self.axes else {"data": self.n_shards}

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def coords(self) -> dict:
        """This process's index along each named axis (row-major over
        ``axes``, the last axis fastest; one device a process)."""
        return _coords(self.rank, self.shape)

    def sub(self, *names: str) -> "Mesh":
        """The sub-mesh along ``names``: this process and the processes
        whose coordinates differ from its own only along those axes, in
        row-major order (its ``rank`` is this process's index there)."""
        shape = self.shape
        axes = tuple((n, shape[n]) for n in shape if n in names)
        extent = math.prod(n for _, n in axes)
        if extent == self.world_size:
            group = self.group
        elif extent == 1:
            group = None
        else:
            group = dict(self.subgroups).get(tuple(n for n, _ in axes))
            if group is None:
                raise ValueError(f"the mesh {shape} holds no process group along {names}")
        return Mesh(self.devices, group, axes or (("data", 1),))


def _coords(rank: int, shape: dict) -> dict:
    out = {}
    for name, n in reversed(shape.items()):
        out[name] = rank % n
        rank //= n
    return {name: out[name] for name in shape}


def make_local_mesh(device: str | torch.device = "cuda") -> Mesh:
    """A one-device 1 x 1 ``("data", "model")`` mesh (tests and smoke runs)."""
    return Mesh((resolve_device(device),), axes=(("data", 1), ("model", 1)))


def _world_group():
    """The default group when this process is one of several, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
) -> bool:
    """Join (or bootstrap) a process group; True if this call made it.

    Arguments default to torchrun's environment (``MASTER_ADDR`` +
    ``MASTER_PORT`` as ``env://``, ``WORLD_SIZE``, ``RANK``); with neither
    arguments nor variables this is a single-process no-op returning
    ``False``, so one binary runs alone and under ``torchrun``.  A process
    already in a group returns ``False``.  ``backend`` defaults to
    ``"nccl"`` when CUDA is available, else ``"gloo"``; two processes
    sharing one card need ``"gloo"`` (NCCL refuses them).
    """
    if not dist.is_available() or dist.is_initialized():
        return False
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None or world_size is None or rank is None:
        return False  # single-process run: nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def is_multihost() -> bool:
    """True when this process is one of several in a process group."""
    return _world_group() is not None


def _local_devices(n_local: int, device: torch.device) -> tuple:
    """``n_local`` shard devices of this process: the host repeated, or
    the cards from ``LOCAL_RANK * n_local`` on (torchrun's one block of
    cards a process)."""
    if device.type != "cuda":
        return (device,) * n_local
    start = int(os.environ.get("LOCAL_RANK", 0)) * n_local if is_multihost() else 0
    visible = torch.cuda.device_count()
    if start + n_local > visible:
        raise ValueError(
            f"{n_local} shard(s) a process from cuda:{start} exceed the {visible} "
            "visible card(s); join more processes (init_distributed) or lower n_shards"
        )
    return tuple(torch.device("cuda", start + i) for i in range(n_local))


def mesh_for_shards(n_shards: int, device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``n_shards`` over the process group (if any) and this
    process's devices: ``cuda:0..n-1`` in one process, raising when that
    exceeds the visible cards; the host repeated when ``device`` is the
    CPU.  Never falls back to the CPU."""
    dev = resolve_device(device)
    group = _world_group()
    world = 1 if group is None else dist.get_world_size(group)
    if n_shards < 1 or n_shards % world:
        raise ValueError(
            f"n_shards={n_shards} must be a positive multiple of the {world} "
            "process(es) in the group"
        )
    return Mesh(_local_devices(n_shards // world, dev), group)


def make_multihost_mesh(device: str | torch.device = "cuda") -> Mesh:
    """A mesh over every process of the group, one device each
    (``cuda:LOCAL_RANK``, torchrun's convention; the host on the CPU).
    Call :func:`init_distributed` first."""
    return Mesh(_local_devices(1, resolve_device(device)), _world_group())


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda",
                         model: int = 1) -> Mesh:
    """The training mesh over every process of the group, one device each
    (:func:`make_multihost_mesh`), named as the reference's production
    mesh: ``("data", "model")``, or ``("pod", "data", "model")`` with one
    pod a host (``LOCAL_WORLD_SIZE`` processes, torchrun's variable).  The
    model extent is ``model`` (the reference's is 16), each run of
    ``model`` consecutive ranks one model group; at the default 1 the
    batch splits over every process.  Above 1 every process must call
    this (the axes' process groups are made here, by all of them)."""
    mesh = make_multihost_mesh(device)
    world = mesh.world_size
    if model < 1 or world % model:
        raise ValueError(f"a model extent of {model} does not divide {world} process(es)")
    if not multi_pod:
        axes = (("data", world // model), ("model", model))
    else:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % per_host or per_host % model:
            raise ValueError(f"{world} processes do not fill hosts of {per_host} "
                             f"in model groups of {model}")
        axes = (("pod", world // per_host), ("data", per_host // model), ("model", model))
    mesh = dataclasses.replace(mesh, axes=axes)
    if model == 1:
        return mesh
    return dataclasses.replace(mesh, subgroups=_make_subgroups(mesh))


def _make_subgroups(mesh: Mesh) -> tuple:
    """One process group along each named axis, and along all of them but
    ``"model"`` (the batch's), for every process; ``dist.new_group`` is
    called by every process for every group, in one order."""
    shape = mesh.shape
    names = tuple(shape)
    world = mesh.world_size
    wanted = [(n,) for n in names] + [tuple(n for n in names if n != "model")]
    out = {}
    for along in wanted:
        extent = math.prod(shape[n] for n in along)
        if along in out or extent in (1, world):
            continue
        blocks: dict = {}
        for r in range(world):
            c = _coords(r, shape)
            blocks.setdefault(tuple(c[n] for n in names if n not in along), []).append(r)
        for ranks in blocks.values():
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                out[along] = g
    return tuple(out.items())


def make_dry_mesh(*, multi_pod: bool = False, rank: int = 0, shape: dict | None = None) -> Mesh:
    """Rank ``rank`` of the reference's production mesh (16 x 16 ``("data",
    "model")``, or 2 x 16 x 16 ``("pod", "data", "model")``; ``shape``,
    e.g. ``{"data": 1, "model": 2}``, for another), on the ``meta``
    device: no process group, no rank started.  It holds a
    :class:`DryGroup` along every set of its axes, so :meth:`Mesh.sub`
    gives any sub-mesh."""
    if shape is None:
        shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    world = math.prod(shape.values())
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a mesh of {world}")
    names = tuple(shape)
    coords = _coords(rank, shape)
    subgroups = []
    for mask in range(1, 2 ** len(names) - 1):
        along = tuple(n for i, n in enumerate(names) if mask >> i & 1)
        sub = {n: shape[n] for n in along}
        extent = math.prod(sub.values())
        if extent not in (1, world):
            r = 0
            for n in along:
                r = r * shape[n] + coords[n]
            subgroups.append((along, DryGroup(r, extent)))
    return Mesh((torch.device("meta"),), DryGroup(rank, world), tuple(shape.items()),
                tuple(subgroups))


def _dry(kind: str, mesh: Mesh, t: torch.Tensor, copies: int = 1) -> None:
    """Charge a dry mesh's collective whose result on this rank is
    ``copies`` tensors like ``t`` (``meta_cost``)."""
    meta_cost.charge_collective(kind, mesh.axis_names, mesh.world_size,
                                copies * t.numel() * t.element_size())


def axis_index(mesh: Mesh | None, name: str) -> int:
    """This process's index along ``name`` (0 without a mesh, or along an
    axis the mesh lacks)."""
    if mesh is None or name not in mesh.shape:
        return 0
    return mesh.coords()[name]


def visible_shards(device: str | torch.device = "cuda") -> int | None:
    """How many shards the group can hold at one shard per device: the
    cards of every process, or ``None`` (no bound) on the host."""
    dev = torch.device(device)
    world = 1 if _world_group() is None else dist.get_world_size()
    if dev.type != "cuda":
        return None
    return torch.cuda.device_count() * world


def num_chips(mesh: Mesh) -> int:
    return mesh.n_shards


def gather_shards(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """THE collective of sharded execution: this process's per-shard
    tensors (``parts``, in shard order) concatenated along ``dim`` on
    ``mesh.devices[0]``, then, across a group of several processes,
    all-gathered in rank order, so the result holds every shard's part in
    global shard order on every process.

    On an NCCL group the tensors stay on the card; on a gloo group (the
    CPU, or two processes sharing one card) they cross to the host and
    back explicitly.  Every process's ``parts`` must have one shape.
    """
    home = mesh.devices[0]
    local = torch.cat([p.to(home) for p in parts], dim=dim)
    if mesh.world_size == 1:
        return local
    return torch.cat(_all_gather_list(mesh, local), dim=dim).to(home)


# --------------------------------------------------------------------------
# training's collectives (a group of several processes; identity for one)
# --------------------------------------------------------------------------
def _along(mesh: Mesh, axis) -> Mesh:
    """``mesh``, or its sub-mesh along ``axis`` (a name or a tuple)."""
    if axis is None:
        return mesh
    return mesh.sub(*((axis,) if isinstance(axis, str) else axis))


def _gloo(mesh: Mesh) -> bool:
    return dist.get_backend(mesh.group) != "nccl"


def _wire(mesh: Mesh, t: torch.Tensor, dtype=None) -> torch.Tensor:
    """A contiguous copy of ``t`` (in ``dtype`` if given) where the group's
    backend takes it: on the card for NCCL, on the host for gloo."""
    where = torch.device("cpu") if _gloo(mesh) else t.device
    return t.detach().to(where, dtype or t.dtype, copy=True).contiguous()


def _all_gather_list(mesh: Mesh, t: torch.Tensor) -> list:
    if is_dry(mesh):
        _dry("all-gather", mesh, t, mesh.world_size)
        return [torch.empty_like(t) for _ in range(mesh.world_size)]
    buf = _wire(mesh, t)
    out = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(out, buf, group=mesh.group)
    return out


def _all_reduce(mesh: Mesh, t: torch.Tensor, op, axis) -> torch.Tensor:
    mesh = _along(mesh, axis)
    if mesh.world_size == 1:
        return t
    if is_dry(mesh):
        _dry("all-reduce", mesh, t)
        return torch.empty_like(t)
    half = t.dtype in (torch.bfloat16, torch.float16) and _gloo(mesh)
    buf = _wire(mesh, t, torch.float32 if half else None)
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device, t.dtype)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, axis=None) -> torch.Tensor:
    """The sum of ``t`` over the group's processes (with ``axis``, over
    the processes along that named axis), a new tensor on ``t``'s device.
    Every process gets the same bits: the collective computes each
    element's sum once and hands it to all."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM, axis)


def all_reduce_max(mesh: Mesh, t: torch.Tensor, axis=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the processes, as
    :func:`all_reduce_sum` takes them."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX, axis)


def all_gather(mesh: Mesh, t: torch.Tensor, axis=None) -> torch.Tensor:
    """Every process's ``t`` stacked on a new leading axis in rank order
    (the reference's ``all_gather(axis=0)``), on ``t``'s device."""
    mesh = _along(mesh, axis)
    if mesh.world_size == 1:
        return t[None]
    return torch.stack(_all_gather_list(mesh, t)).to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor, axis=None) -> torch.Tensor:
    """``t`` (world, ...): process ``i`` sends ``t[j]`` to process ``j`` and
    receives every process's ``t[i]``, stacked in rank order (the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    mesh = _along(mesh, axis)
    if mesh.world_size == 1:
        return t
    if t.shape[0] != mesh.world_size:
        raise ValueError(f"all_to_all: leading axis {t.shape[0]} != {mesh.world_size} processes")
    if is_dry(mesh):
        _dry("all-to-all", mesh, t)
        return torch.empty_like(t)
    buf = _wire(mesh, t)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=mesh.group)
    return out.to(t.device)


class _GatherRows(torch.autograd.Function):
    """All-gather along axis 0 forward; backward, the gradient of the
    gathered tensor summed over the processes, this process's rows kept."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return torch.cat(_all_gather_list(mesh, x)).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(ctx.mesh, grad)
        r, n = ctx.mesh.rank, ctx.rows
        return total[r * n : (r + 1) * n], None


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (n, ...) concatenated along axis 0 in rank
    order, differentiably: the gradient reaching a process's rows is the
    sum over the processes of the gradient each one's loss gave them (so
    data-parallel in-batch negatives train as the global batch does).
    Every process's ``x`` must have one shape."""
    if mesh.world_size == 1:
        return x
    return _GatherRows.apply(x, mesh)


# --------------------------------------------------------------------------
# tensor parallelism: the collectives around a split product (Megatron's f
# and g), on a mesh whose processes hold one slice each of the weights
# --------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the processes
    (a replicated tensor entering a product split over them)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(ctx.mesh, grad), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the processes forward (the partial results of a split
    product); backward, the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherAlong(torch.autograd.Function):
    """Every process's ``x`` concatenated along ``dim`` in rank order;
    backward, this process's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return torch.cat(_all_gather_list(mesh, x), dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


def copy_to(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``mesh``'s processes."""
    return x if mesh is None or mesh.world_size == 1 else _CopyTo.apply(x, mesh)


def reduce_from(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``mesh``'s processes; its gradient passed as it is."""
    return x if mesh is None or mesh.world_size == 1 else _ReduceFrom.apply(x, mesh)


def gather_along(mesh: Mesh | None, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``dim`` in rank order,
    differentiably (each process's slice of the gradient returns to it)."""
    if mesh is None or mesh.world_size == 1:
        return x
    return _GatherAlong.apply(x, mesh, dim % x.dim())
