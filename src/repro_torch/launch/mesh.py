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
``("data", "model")`` or ``("pod", "data", "model")`` with a model extent
of 1, one device a process: data parallelism over the whole group.  The
reference's 16-way model axis (tensor parallelism) is not ported
(``distributed.sharding`` refuses a model extent above 1).  Training's
collectives are here too: :func:`all_reduce_sum`, :func:`all_gather_rows`
(differentiable), :func:`all_to_all` and :func:`all_gather`.  On an NCCL
group their tensors stay on the card; on a gloo group (the CPU, or two
processes sharing one card) each crosses to the host and back explicitly,
so no collective relies on gloo's support for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices and the group joining its peers."""

    devices: tuple
    group: Any = None  # torch.distributed ProcessGroup, or None
    #: named axes ``((name, extent), ...)`` whose extents multiply to
    #: ``n_shards``; empty for a document-sharding mesh (one ``"data"`` axis)
    axes: tuple = ()

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
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
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


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda") -> Mesh:
    """The training mesh over every process of the group, one device each
    (:func:`make_multihost_mesh`), named as the reference's production
    mesh: ``("data", "model")``, or ``("pod", "data", "model")`` with one
    pod a host (``LOCAL_WORLD_SIZE`` processes, torchrun's variable).  The
    model extent is 1 (the reference's is 16: tensor parallelism, not
    ported), so the batch splits over every process."""
    mesh = make_multihost_mesh(device)
    world = mesh.world_size
    if not multi_pod:
        return dataclasses.replace(mesh, axes=(("data", world), ("model", 1)))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} processes do not fill hosts of {per_host}")
    return dataclasses.replace(
        mesh, axes=(("pod", world // per_host), ("data", per_host), ("model", 1)))


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
def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the group's backend takes it: on the
    card for NCCL, on the host for gloo."""
    where = t.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    return t.detach().to(where, copy=True).contiguous()


def _all_gather_list(mesh: Mesh, t: torch.Tensor) -> list:
    buf = _wire(mesh, t)
    out = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(out, buf, group=mesh.group)
    return out


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group's processes, a new tensor on ``t``'s
    device.  Every process gets the same bits: the collective computes each
    element's sum once and hands it to all."""
    if mesh.world_size == 1:
        return t
    buf = _wire(mesh, t)
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` stacked on a new leading axis in rank order
    (the reference's ``all_gather(axis=0)``), on ``t``'s device."""
    if mesh.world_size == 1:
        return t[None]
    return torch.stack(_all_gather_list(mesh, t)).to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` (world, ...): process ``i`` sends ``t[j]`` to process ``j`` and
    receives every process's ``t[i]``, stacked in rank order (the
    reference's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    if mesh.world_size == 1:
        return t
    if t.shape[0] != mesh.world_size:
        raise ValueError(f"all_to_all: leading axis {t.shape[0]} != {mesh.world_size} processes")
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
