"""What one rank's step costs, counted on the ``meta`` device (the port's
replacement of ``repro.launch.hlo_analysis``).

The reference lowers each cell for 512 fake XLA devices and parses the
partitioned HLO.  The port has no compiler to ask: a step built on
``meta`` tensors (``launch.cells.build_cell(mode="dry")``) runs eagerly
under :class:`MetaCounter`, a ``TorchDispatchMode`` that sees every aten
op the rank would run on the card, computes nothing (``meta`` tensors
carry shapes only) and records:

* ``flops``, by dtype: the matmul family through ``torch.utils.
  flop_counter``'s registry (ops outside it are decomposed first, as
  ``FlopCounterMode`` does, so the two count the same products), plus
  what the hand-written kernels' meta paths charge (``charge_kernel``,
  their ``kernels.costs`` models);
* ``hbm_bytes``: operand plus result bytes of every op that moves data.
  Views and metadata ops (``aten.view``, ``aten.t``, ``aten.detach``, ...)
  and allocations (``aten.empty*``) count zero.  Eager PyTorch does not
  fuse, so this is what the port's eager step moves, plus the kernels';
* a boolean mask on ``meta`` selects every element (torch's
  ``meta_nonzero_assume_all_nonzero``, set while counting): the MoE
  dispatch counts every choice kept, the most it can move;
* ``mem_temp``: the peak bytes of live storages the step made, beyond its
  arguments, tracked through the lifetimes of the tensors that hold them
  (a storage lives while any tensor over it does: autograd keeps a
  detached alias of what it saves for the backward pass);
* ``coll_bytes``, ``coll_detail`` (by kind), ``coll_axes`` (by the mesh
  axes a collective runs over) and ``coll_counts``, charged by the dry
  mesh's collectives (``launch.mesh.make_dry_mesh``), each counted as
  ``hlo_analysis.analyze`` counts XLA's: an all-reduce at twice its
  result bytes, a reduce-scatter at its result times the group, any other
  at its result bytes.

:func:`roofline_terms` turns a rank's counts into times with one H100
SXM's datasheet rates (NVIDIA H100 Tensor Core GPU datasheet, SXM5, dense):
989 TFLOP/s bf16 / fp16 in the tensor cores, 67 TFLOP/s f32 outside them
(the port keeps TF32 off, ``repro_torch.ieee_f32_matmul``), HBM3 at 3.35
TB/s.  Links: NVLink 4 at 450 GB/s a direction between the 8 cards of a
DGX H100 / HGX H100 node (NVIDIA DGX H100 datasheet: 900 GB/s a card in
both directions); a collective over more than 8 ranks crosses nodes and
runs at one 400 Gb/s ConnectX-7 NIC a card, 50 GB/s (the same datasheet:
eight 400 Gb/s OSFP ports, one a GPU).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import torch
from torch.fx.experimental import _config as _fx_config
from torch.utils._python_dispatch import TorchDispatchMode

#: H100 SXM peaks (see the module docstring)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
#: the peak a useful FLOP is measured against (``roofline_fraction``): bf16
PEAK_FLOPS_USEFUL = 989e12
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction, within a node
NIC_BW = 50e9  # bytes/s a card, across nodes (400 Gb/s)
NODE_GPUS = 8

#: ops that move no data: allocations and queries (views are told apart by
#: their schema, ``OpOverload.is_view``)
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_contiguous", "size", "stride", "numel",
    "dim", "storage_offset", "_local_scalar_dense", "set_",
}


def _flop_registry() -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False).flop_registry


def _pure(func) -> bool:
    """True when ``func``'s results are fresh tensors that depend on its
    arguments' shapes alone: no view or alias, no argument written, not a
    factory of random or uninitialized bits that a caller might read."""
    schema = func._schema
    if func.is_view or any(r.alias_info is not None for r in schema.returns):
        return False
    if any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments):
        return False
    return not schema.is_mutable and bool(schema.returns)


def _flat(x, out: list) -> list:
    """The leaves of an op's arguments or result (tuples, lists and dicts
    opened, a module's parameters), in order: a faster ``tree_flatten``
    for aten's argument types."""
    if isinstance(x, (tuple, list)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, torch.nn.Module):
        out.extend(x.parameters())
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    else:
        out.append(x)
    return out


def tensors_of(tree) -> list:
    """The tensors of a step's arguments or results: any nesting of dicts,
    lists and tuples; a module's parameters."""
    return [t for t in _flat(tree, []) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def link_bw(extent: int) -> float:
    """Bytes/s a rank moves over a collective among ``extent`` ranks:
    NVLink within a node of ``NODE_GPUS``, one NIC across nodes."""
    return NVLINK_BW if extent <= NODE_GPUS else NIC_BW


class _Active(threading.local):
    def __init__(self):
        self.stack: list = []


_ACTIVE = _Active()


def active():
    """The innermost :class:`MetaCounter` counting on this thread, or None."""
    return _ACTIVE.stack[-1] if _ACTIVE.stack else None


def charge_kernel(name: str, flops: float, hbm_bytes: float, dtype=torch.float32) -> None:
    """A hand-written kernel's meta path: its cost model's flops and bytes
    (the counter sees none of its own ops)."""
    c = active()
    if c is not None:
        c.flops[dtype] += flops
        c.hbm_bytes += hbm_bytes
        k = c.kernels[name]
        k["launches"] += 1
        k["flops"] += flops
        k["hbm_bytes"] += hbm_bytes


def charge_collective(kind: str, axes: tuple, extent: int, result_bytes: int) -> None:
    """A dry mesh's collective over ``axes`` (``extent`` ranks) with
    ``result_bytes`` of result on this rank, counted as the module
    docstring says."""
    c = active()
    if c is None:
        return
    wire = {"all-reduce": 2.0 * result_bytes,
            "reduce-scatter": float(result_bytes) * extent}.get(kind, float(result_bytes))
    c.coll_detail[kind] += wire
    c.coll_counts[kind] += 1
    c.coll_axes[",".join(axes)] += wire


class MetaCounter(TorchDispatchMode):
    """Counts one rank's step on ``meta`` tensors (the module docstring).
    ``args``: the step's arguments, whose storages are not temporaries."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = collections.defaultdict(float)
        self.hbm_bytes = 0.0
        self.kernels = collections.defaultdict(lambda: dict(launches=0, flops=0.0, hbm_bytes=0.0))
        self.coll_detail = collections.defaultdict(float)
        self.coll_counts = collections.defaultdict(int)
        self.coll_axes = collections.defaultdict(float)
        self.ops = 0
        self._registry = _flop_registry()
        self._plain: dict = {}  # op -> its result may be memoized by shapes
        self._memo: dict = {}  # (op, argument shapes) -> result shapes and counts
        self._refs: dict = {}  # storage -> (bytes, tensors alive over it)
        self._live = 0
        self.mem_temp = 0
        self._args = {t.untyped_storage()._cdata for t in tensors_of(args)}

    # -- totals -----------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_detail.values()))

    # -- storage lifetimes --------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        if key in self._args:
            return
        n, alive = self._refs.get(key, (t.untyped_storage().nbytes(), 0))
        if alive == 0:
            self._live += n
            self.mem_temp = max(self.mem_temp, self._live)
        self._refs[key] = (n, alive + 1)
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        n, alive = self._refs[key]
        if alive == 1:
            del self._refs[key]
            self._live -= n
        else:
            self._refs[key] = (n, alive - 1)

    # -- the mode -------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.stack.append(self)
        self._nonzero = _fx_config.meta_nonzero_assume_all_nonzero
        _fx_config.meta_nonzero_assume_all_nonzero = True
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.stack.remove(self)
        _fx_config.meta_nonzero_assume_all_nonzero = self._nonzero
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._plain:
            if func is not torch.ops.prim.device.default:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            self._plain[func] = _pure(func)
        self.ops += 1
        flat = _flat(kwargs, _flat(args, []))
        key = None
        if self._plain[func]:
            key = (func, len(args), tuple(kwargs), *[(t.shape, t.stride(), t.dtype)
                                      if isinstance(t, torch.Tensor) else t for t in flat])
            try:
                hit = self._memo.get(key)
            except TypeError:  # an unhashable argument
                hit, key = None, None
            if hit is not None:
                specs, single, flops, nbytes, dtype = hit
                outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                        for shape, stride, dt in specs]
                self._count(flops, nbytes, dtype, outs)
                return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        outs = [t for t in _flat(out, []) if isinstance(t, torch.Tensor)]
        flops, dtype = 0.0, torch.float32
        if packet in self._registry:
            dtype = ins[0].dtype if ins else torch.float32
            flops = float(self._registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if key is not None and all(t.device.type == "meta" for t in outs) and (
                isinstance(out, torch.Tensor) or (isinstance(out, tuple) and len(outs) == len(out))):
            self._memo[key] = ([(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                               isinstance(out, torch.Tensor), flops, nbytes, dtype)
        self._count(flops, nbytes, dtype, outs)
        return out

    def _count(self, flops, nbytes, dtype, outs) -> None:
        if flops:
            self.flops[dtype] += flops
        self.hbm_bytes += nbytes
        for t in outs:
            self._track(t)

    def record(self) -> dict:
        """The counts as the dry-run's record keys."""
        return dict(
            flops=self.total_flops,
            flops_by_dtype={str(k).replace("torch.", ""): v for k, v in self.flops.items()},
            hbm_bytes=self.hbm_bytes,
            mem_temp=self.mem_temp,
            coll_bytes=self.coll_bytes,
            coll_detail={k: round(v) for k, v in self.coll_detail.items()},
            coll_axes={k: round(v) for k, v in self.coll_axes.items()},
            coll_counts=dict(self.coll_counts),
            kernels={k: dict(v) for k, v in self.kernels.items()},
            ops=self.ops,
        )


# --------------------------------------------------------------------------
# Roofline (the reference's ``hlo_analysis.Roofline`` with H100 rates)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float  # per chip

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Share of the bf16 peak the USEFUL flops reach at the bound time."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops / (self.bound_s * PEAK_FLOPS_USEFUL)


def roofline_terms(*, per_chip_flops, per_chip_bytes: float, per_chip_coll_bytes,
                   model_flops: float, n_chips: int) -> Roofline:
    """The three times of one rank's step: ``per_chip_flops`` a {dtype:
    flops} dict (each at its peak, f32 for a dtype without one) or a float
    (at the bf16 peak, as the reference counts); ``per_chip_coll_bytes`` a
    {ranks in the collective: bytes} dict (each at :func:`link_bw`) or a
    float (at the NVLink rate)."""
    if isinstance(per_chip_flops, dict):
        compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS[torch.float32])
                      for dt, f in per_chip_flops.items())
        flops = float(sum(per_chip_flops.values()))
    else:
        flops = float(per_chip_flops)
        compute = flops / PEAK_FLOPS[torch.bfloat16]
    if isinstance(per_chip_coll_bytes, dict):
        coll = sum(b / link_bw(n) for n, b in per_chip_coll_bytes.items())
        coll_bytes = float(sum(per_chip_coll_bytes.values()))
    else:
        coll_bytes = float(per_chip_coll_bytes)
        coll = coll_bytes / NVLINK_BW
    return Roofline(compute_s=compute, memory_s=per_chip_bytes / HBM_BW, collective_s=coll,
                    hlo_flops=flops, hlo_bytes=per_chip_bytes, coll_bytes=coll_bytes,
                    model_flops=model_flops / n_chips)
