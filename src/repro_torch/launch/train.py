"""Training driver: ``python -m repro_torch.launch.train --arch plaid-colbertv2
[--reduced] [--mesh none|local|single|multi]`` (the counterpart of
``repro.launch.train``).

Trains ColBERTv2 on ``colbert_batches`` (the reference's driver's 8-token
queries and 16-token passages) with AdamW on the cosine schedule (20
warm-up steps), microbatched gradient accumulation, optional int8 gradient
compression with error feedback, rolling checkpoints, the straggler
watchdog and supervised restart.  Weights are random, drawn from seed 0.
Runs on the card unless ``--device cpu``.  ``params`` counts the encoder's
parameters (the reference's count also holds its unused ``lm_head``).

``--mesh none`` and ``local`` train on one device.  ``single`` and
``multi`` train data-parallel over every process of a ``torchrun`` launch
(one card a process, NCCL; gloo with ``--device cpu``), laid out as the
reference's ``("data", "model")`` / ``("pod", "data", "model")`` meshes
with a model extent of 1 (``launch.mesh.make_production_mesh``):
``--batch`` is the global batch, split over the processes, and each step is
the global batch's.  Only rank 0 prints and writes checkpoints; the
replicas are checked bit-identical at the end.

    torchrun --nproc_per_node=8 -m repro_torch.launch.train \
        --arch plaid-colbertv2 --mesh single --batch 32

Only ``plaid-colbertv2`` is ported; the registry names the ROADMAP item of
every other arch.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.data import synthetic as syn
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import colbert as colbert_lib
from repro_torch.training import fault_tolerance as ft
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compression", choices=["none", "int8"], default="none")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "local", "single", "multi"], default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = config_registry.get(args.arch)
    cfg = mod.reduced_config() if args.reduced else mod.full_config()
    dev = resolve_device(args.device)
    joined = False
    if args.mesh in ("single", "multi"):
        joined = mesh_mod.init_distributed(backend="gloo" if dev.type == "cpu" else None)
        mesh = mesh_mod.make_production_mesh(multi_pod=args.mesh == "multi", device=dev)
        dev = mesh.devices[0]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's device for this process
    else:
        mesh = mesh_mod.make_local_mesh(dev) if args.mesh == "local" else None
    try:
        with sharding.use_mesh(mesh):
            return _train(args, cfg, dev, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, cfg, dev, mesh) -> int:
    world = 1 if mesh is None else mesh.world_size
    if args.batch % (world * args.n_micro):
        raise SystemExit(f"--batch {args.batch} does not split into {args.n_micro} "
                         f"microbatch(es) over {world} process(es)")
    lead = mesh is None or mesh.rank == 0
    it = syn.colbert_batches(cfg.backbone.vocab, args.batch, q_len=8, d_len=16, nway=cfg.nway)
    optimizer = opt_lib.adamw(
        opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(args.lr, 20, args.steps))
    )
    comp = None if args.compression == "none" else args.compression
    model = colbert_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = train_loop.make_train_step(
        colbert_lib.loss_fn(model), optimizer, n_micro=args.n_micro, compression=comp
    )
    params = colbert_lib.train_params(model)
    train_loop.assert_replicas_agree(params, mesh)
    opt_state = train_loop.init_opt_state(optimizer, params, comp)
    n_params = sum(p.numel() for p in tree.leaves(params))
    if lead:
        mesh_note = "" if mesh is None else f" mesh={mesh.shape}"
        print(f"arch={args.arch} params={n_params:,} steps={args.steps}{mesh_note}", flush=True)

    watchdog = ft.StepWatchdog()
    losses = []

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    batches = (next(it) for _ in range(args.steps))
    t0 = time.perf_counter()
    state, final, restarts = ft.run_supervised(
        step_fn, {"params": params, "opt": opt_state}, batches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, watchdog=watchdog,
        write_checkpoints=lead,
    )
    dt = time.perf_counter() - t0
    train_loop.assert_replicas_agree(state["params"], mesh)
    if lead:
        print(
            f"done: {final} steps in {dt:.1f}s "
            f"({dt / max(final, 1) * 1e3:.1f} ms/step), restarts={restarts}, "
            f"stragglers={len(watchdog.stragglers)}"
        )
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
