"""Multi-pod dry-run of the port (the counterpart of ``repro.launch.dryrun``):
what one rank of the reference's production mesh holds, computes and
moves, for every (arch x input-shape x mesh) cell, on a machine with no
GPU.

For each cell this builds rank 0's piece of the step on the ``meta``
device (``launch.cells.build_cell(mode="dry")`` under a dry mesh,
``launch.mesh.make_dry_mesh``: 16 x 16 ``("data", "model")``, or 2 x 16 x
16 with ``--multi-pod``) and runs it under ``launch.meta_cost.
MetaCounter``: nothing is computed, no rank is started.  The record holds
what the port's rank holds (``mem_args``) beside the rules' plan
(``mem_args_plan``, the reference's per-rank bytes), the step's result
and peak temporary bytes, its flops, device bytes and collective bytes,
and their roofline on one H100 (``meta_cost.roofline_terms``).  A cell
the port cannot run there records ``status: "fail"`` with its error (the
port's ``NotImplementedError`` names the ROADMAP item, kept in ``item``).

An LM cell is traced at two depths (1 and 2 layers past the dense ones)
and a train cell of more than 3 microbatches at 2 and 3 of them, each of
the full cell's rows, and every count is extrapolated to the full depth
and microbatch count: the layers of a stack are identical, and so are the
microbatches, so each count is affine in either (bilinear in both);
``tests/test_torch_dryrun.py`` holds the extrapolation to a whole trace
(a whole trace of a 60-layer model takes minutes).  ``traced`` records
the points.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --jobs 8
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import re
import time
import traceback

import torch

from repro_torch import configs as config_registry
from repro_torch.distributed import sharding
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import meta_cost

SERVE_KINDS = {"prefill", "decode", "serve", "retrieval", "search", "encode"}
_ITEM = re.compile(r"Queue 1 item (\d+(?:\.\d+)*)")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def dry_rules(kind: str, strategy: str | None = None) -> dict:
    """The reference's rules for a cell: ``SERVE_RULES`` for the serving
    kinds, ``ZERO3_RULES`` on top under the ``zero3`` strategy."""
    rules = dict(sharding.SERVE_RULES) if kind in SERVE_KINDS else {}
    if strategy == "zero3":
        rules.update(sharding.ZERO3_RULES)
    return rules


def storage_bytes(tree, exclude=()) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors
    (``meta_cost.tensors_of``), those of ``exclude``'s left out."""
    seen = {t.untyped_storage()._cdata for t in meta_cost.tensors_of(exclude)}
    total = 0
    for t in meta_cost.tensors_of(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def count(built) -> dict:
    """Run a dry cell's step under the counter (inside the cell's
    ``use_mesh``): its counts (``MetaCounter.record``) with ``mem_args``
    and ``mem_out``."""
    with meta_cost.MetaCounter(built.args) as c:
        out = built.fn(*built.args)
    rec = c.record()
    rec["mem_args"] = storage_bytes(built.args)
    rec["mem_out"] = storage_bytes(out, exclude=built.args)
    return rec


def trace(arch: str, shape: str, mesh, rules: dict, layers=None, n_micro=None) -> dict | str:
    """Rank ``mesh.rank``'s step of the cell at ``layers`` / ``n_micro``
    (the full cell's when None) counted on ``meta`` (:func:`count`, with
    ``model_flops``); the skip reason of a skipped cell."""
    with sharding.use_mesh(mesh, rules):
        built = cells_mod.build_cell(arch, shape, mode="dry", mesh=mesh, layers=layers,
                                     n_micro=n_micro)
        if built.skip:
            return built.skip
        return dict(count(built), model_flops=built.model_flops)


def extrapolation_points(first: int, n_layers: int, n_micro: int | None) -> tuple[list, list]:
    """The (layers, n_micro) points to trace and the weights whose sum of
    their counts is the full cell's: depths ``first + 1`` and ``first + 2``
    (``first``, the dense layers before an MoE stack) extrapolated to
    ``n_layers``, and, for ``n_micro`` above 3, 2 and 3 microbatches
    extrapolated to ``n_micro`` (``None`` keeps the cell's own).  Exact
    for counts affine in each (bilinear in both)."""
    L1, L2 = first + 1, first + 2
    t = (n_layers - L1) / (L2 - L1)
    micro = [(None, 1.0)]
    if n_micro is not None and n_micro > 3:
        u = (n_micro - 2) / (3 - 2)
        micro = [(2, 1 - u), (3, u)]
    pts, ws = [], []
    for nm, wu in micro:
        for Lx, wl in ((L1, 1 - t), (L2, t)):
            pts.append((Lx, nm))
            ws.append(wl * wu)
    return pts, ws


def _points(arch: str, shape: str) -> tuple[list, list]:
    """A cell's trace points and weights under the active mesh and rules:
    an LM cell's (:func:`extrapolation_points`), else the whole cell."""
    mod = config_registry.get(arch)
    cell = config_registry.cells_of(arch)[shape]
    if mod.FAMILY != "lm":
        return [(None, None)], [1.0]
    cfg = mod.full_config()
    first = cfg.n_layers - cfg.n_moe_layers if cfg.n_experts else 0
    n = None
    if cell.kind == "train":
        n = max(cell.full["global_batch"] // cells_mod._batch_shards(), 1)
    return extrapolation_points(first, cfg.n_layers, n)


def combine(recs: list, weights: list):
    """``sum_i weights[i] * recs[i]`` over every number of the records
    (nested dicts; a key missing from one counts 0 there)."""
    first = recs[0]
    if isinstance(first, dict):
        keys = {k for r in recs for k in r}
        return {k: combine([r.get(k, 0) for r in recs], weights) for k in keys}
    return sum(w * r for w, r in zip(weights, recs))


def _rounded_counts(rec: dict) -> dict:
    rec["coll_counts"] = {k: int(round(v)) for k, v in rec["coll_counts"].items()}
    rec["ops"] = int(round(rec["ops"]))
    for k in rec["kernels"].values():
        k["launches"] = int(round(k["launches"]))
    for key in ("mem_args", "mem_out", "mem_temp"):
        rec[key] = int(round(rec[key]))
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, strategy: str | None = None,
             verbose: bool = True) -> dict:
    """One cell's record (the module docstring)."""
    mesh = mesh_mod.make_dry_mesh(multi_pod=multi_pod)
    cell = config_registry.cells_of(arch)[shape]
    rules = dry_rules(cell.kind, strategy)
    chips = mesh.n_shards
    rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": chips, "kind": cell.kind, "strategy": strategy or "default"}
    t0 = time.perf_counter()
    try:
        with sharding.use_mesh(mesh, rules):
            if cell.skip:
                rec.update(status="skip", skip_reason=cell.skip)
                return rec
            plan = cells_mod.cell_plan(arch, shape)
            rec["mem_args_plan"] = cells_mod.plan_bytes(plan)
            pts, ws = _points(arch, shape)
        got = [trace(arch, shape, mesh, rules, L, n) for L, n in pts]
        model_flops = got[0]["model_flops"]
        counts = _rounded_counts(combine(
            [{k: v for k, v in g.items() if k != "model_flops"} for g in got], ws))
        rl = meta_cost.roofline_terms(
            per_chip_flops={_DTYPES.get(k, torch.float32): v
                            for k, v in counts["flops_by_dtype"].items()},
            per_chip_bytes=counts["hbm_bytes"],
            per_chip_coll_bytes=_coll_by_extent(counts["coll_axes"], mesh),
            model_flops=model_flops, n_chips=chips)
        rec.update(
            status="ok", trace_s=round(time.perf_counter() - t0, 2),
            traced=[dict(layers=L, n_micro=n) for L, n in pts] if pts[0] != (None, None) else "whole",
            mem_args=counts["mem_args"], mem_args_plan=rec.pop("mem_args_plan"),
            mem_out=counts["mem_out"], mem_temp=counts["mem_temp"],
            flops=counts["flops"], flops_by_dtype=counts["flops_by_dtype"],
            hbm_bytes=counts["hbm_bytes"], coll_bytes=counts["coll_bytes"],
            coll_detail=counts["coll_detail"], coll_axes=counts["coll_axes"],
            coll_counts=counts["coll_counts"], kernels=counts["kernels"], ops=counts["ops"],
            compute_s=rl.compute_s, memory_s=rl.memory_s, collective_s=rl.collective_s,
            dominant=rl.dominant, model_flops=model_flops, model_flops_per_chip=rl.model_flops,
            useful_ratio=round(rl.useful_ratio, 4),
            roofline_fraction=round(rl.roofline_fraction, 4),
        )
    except Exception as e:  # a failure is recorded, with its ROADMAP item
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        m = _ITEM.search(str(e))
        rec["item"] = m.group(1) if isinstance(e, NotImplementedError) and m else None
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        if verbose and rec["item"] is None:
            traceback.print_exc()
    return rec


def _coll_by_extent(coll_axes: dict, mesh) -> dict:
    """{ranks in the collective: bytes} from the bytes by axes."""
    out: dict = {}
    for axes, b in coll_axes.items():
        n = 1
        for a in axes.split(","):
            n *= mesh.shape[a]
        out[n] = out.get(n, 0.0) + b
    return out


def _run(job):
    return run_cell(*job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--strategy", choices=("default", "zero3"), default="default",
                    help="zero3: the reference's ZERO3_RULES on top (REPRO_STRATEGY=zero3)")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced in parallel processes")
    args = ap.parse_args(argv)

    archs = config_registry.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    pairs = [(a, c) for a in archs for c in config_registry.cells_of(a)
             if not args.shape or c == args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    strategy = None if args.strategy == "default" else args.strategy
    jobs = [(a, c, mp, strategy) for a, c in pairs for mp in meshes]
    if args.jobs > 1:
        # the LM cells first, train cells before them: the slowest go first
        order = sorted(range(len(jobs)), key=lambda i: _cost_rank(*jobs[i][:2]))
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            done = dict(zip(order, pool.imap(_run, [jobs[i] for i in order])))
        _emit((done[i] for i in range(len(jobs))), args.out)
    else:
        _emit(map(_run, jobs), args.out)
    return 0


def _cost_rank(arch: str, shape: str) -> int:
    """0 for an LM train cell, 1 for another LM cell, 2 for the rest."""
    if config_registry.get(arch).FAMILY != "lm":
        return 2
    return 0 if config_registry.cells_of(arch)[shape].kind == "train" else 1


def _emit(recs, out) -> None:
    for rec in recs:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    raise SystemExit(main())
