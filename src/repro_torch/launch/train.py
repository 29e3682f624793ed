"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--mesh none|local|single|multi]`` (the counterpart of
``repro.launch.train``).

Trains a registry arch on the reference's synthetic data (``data_for``):
an LM (``lm_batches``, 64 tokens a row, ``lm_loss``; a full config in
float32, as the reference trains it), ColBERTv2 (``colbert_batches``,
8-token queries and 16-token passages) or a recsys arch
(``recsys_batches``, ``models.recsys.train_loss``), with AdamW on the cosine schedule
(20 warm-up steps), microbatched gradient accumulation, optional int8
gradient compression with error feedback, rolling checkpoints, the
straggler watchdog and supervised restart; each step updates the
parameters and optimizer state in place, as the reference's jitted step
donates them.  Weights are random, drawn from seed 0.  Runs on the card unless ``--device cpu``.  ``params`` counts
the training tree's leaves: an LM's as the reference's (padded slots
included), ColBERTv2's encoder without the ``lm_head`` the reference's
count also holds.

``--mesh none`` and ``local`` train on one device.  ``single`` and
``multi`` train over every process of a ``torchrun`` launch (one card a
process, NCCL; gloo with ``--device cpu``), laid out as the reference's
``("data", "model")`` / ``("pod", "data", "model")`` meshes
(``launch.mesh.make_production_mesh``) with a model extent of ``--model``
(default 1: data parallelism over every process).  ``--model m`` (an LM,
recsys or retrieval arch) splits the weights over groups of ``m``
processes, the reference's tensor and expert parallelism on its 16-way
axis laid over fewer processes (a recsys arch's tables by rows, its dense
layers by ``"mlp"``: ``models.recsys``; ColBERTv2's backbone as an LM's,
its projection whole: ``models.colbert``); ``--compression int8``
quantizes each split gradient whole (``training.loop``); checkpoints hold
the whole leaves.
``--batch`` is the global batch, split over the data axis, and each step
is the global batch's.  Only rank 0 prints and writes checkpoints; the
replicas are checked bit-identical at the end (a model group's in its
replicated leaves).

    torchrun --nproc_per_node=8 -m repro_torch.launch.train \
        --arch plaid-colbertv2 --mesh single --batch 32
    torchrun --nproc_per_node=2 -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --mesh single --model 2
    torchrun --nproc_per_node=2 -m repro_torch.launch.train \
        --arch wide-deep --mesh single --model 2
    torchrun --nproc_per_node=2 -m repro_torch.launch.train \
        --arch plaid-colbertv2 --mesh single --model 2 [--compression int8]

``run(argv)`` does ``main``'s work and returns what it trained (the
final state, the config, the losses, and on a model axis the
parameters' placements).  The LM, recsys and ``plaid-colbertv2`` ids
train; SchNet, as in the reference, trains through its cells
(``launch.cells``), and ``data_for`` refuses the GNN family.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as T
from repro_torch.training import fault_tolerance as ft
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import tree


def data_for(cfg, batch: int, family: str, device):
    """``(batches, loss_fn, params, model)`` of a family: the reference's
    ``data_for``, with the model drawn from seed 0 on ``device`` (``params``
    is its training tree; a recsys family's ``model`` is None, its
    functions read the tree, whose leaves are this process's pieces under
    a ``"model"`` axis: ``recsys.place_params``).  Another family raises,
    as there."""
    gen = torch.Generator(device=device).manual_seed(0)
    if family == "lm":
        model = T.init_params(cfg, gen, device, head=True)
        return syn.lm_batches(cfg.vocab, batch, 64), T.loss_fn(model), T.train_params(model), model
    if family == "retrieval":
        it = syn.colbert_batches(cfg.backbone.vocab, batch, q_len=8, d_len=16, nway=cfg.nway)
        model = colbert_lib.init_params(cfg, gen, device=device)
        return it, colbert_lib.loss_fn(model), colbert_lib.train_params(model), model
    if family == "recsys":
        loss = lambda p, b: recsys_lib.train_loss(p, cfg, b)
        params, _ = recsys_lib.place_params(recsys_lib.init_params(cfg, gen), cfg)
        return syn.recsys_batches(cfg, batch), loss, params, None
    raise ValueError(f"use examples/ for family {family}")


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> dict:
    """``main``'s work: ``{"state", "cfg", "losses", "steps", "restarts",
    "seconds"}``; the trained weights are ``state["params"]`` (a training
    tree)."""
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
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model extent (--mesh single|multi; an LM, recsys or "
                         "retrieval arch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mod = config_registry.get(args.arch)
    cfg = mod.reduced_config() if args.reduced else mod.full_config()
    if mod.FAMILY == "lm" and not args.reduced:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    dev = resolve_device(args.device)
    if args.model > 1 and (args.mesh not in ("single", "multi")
                           or mod.FAMILY not in ("lm", "recsys", "retrieval")):
        raise SystemExit("--model above 1 takes an LM, recsys or retrieval arch and "
                         "--mesh single or multi")
    joined = False
    if args.mesh in ("single", "multi"):
        joined = mesh_mod.init_distributed(backend="gloo" if dev.type == "cpu" else None)
        mesh = mesh_mod.make_production_mesh(multi_pod=args.mesh == "multi", device=dev,
                                             model=args.model)
        dev = mesh.devices[0]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's device for this process
    else:
        mesh = mesh_mod.make_local_mesh(dev) if args.mesh == "local" else None
    try:
        with sharding.use_mesh(mesh):
            return _train(args, cfg, mod.FAMILY, dev, mesh)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, cfg, family, dev, mesh) -> dict:
    data = sharding.data_mesh()
    world = 1 if data is None else data.world_size
    if args.batch % (world * args.n_micro):
        raise SystemExit(f"--batch {args.batch} does not split into {args.n_micro} "
                         f"microbatch(es) over {world} process(es)")
    lead = mesh is None or mesh.rank == 0
    it, loss_fn, params, model = data_for(cfg, args.batch, family, dev)
    optimizer = opt_lib.adamw(
        opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(args.lr, 20, args.steps))
    )
    comp = None if args.compression == "none" else args.compression
    # None without a model axis
    place = recsys_lib.placements(cfg) if family == "recsys" else model.placement_tree()
    step = train_loop.make_train_step(loss_fn, optimizer, n_micro=args.n_micro, compression=comp,
                                      donate=True, placements=place)
    train_loop.assert_replicas_agree(params, mesh, place)
    opt_state = train_loop.init_opt_state(optimizer, params, comp)
    state_place = sharding.state_placements(place, {"params": params, "opt": opt_state})
    n_params = sum(x.numel() for x in tree.leaves(params)) if place is None else sum(
        x.numel() * (p.model.world_size if p.split else 1)
        for x, p in zip(tree.leaves(params), tree.leaves(place)))
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
        write_checkpoints=lead, shardings=state_place,
    )
    dt = time.perf_counter() - t0
    train_loop.assert_replicas_agree(state["params"], mesh, place)
    if lead:
        print(
            f"done: {final} steps in {dt:.1f}s "
            f"({dt / max(final, 1) * 1e3:.1f} ms/step), restarts={restarts}, "
            f"stragglers={len(watchdog.stragglers)}"
        )
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return dict(state=state, cfg=cfg, losses=losses, steps=final, restarts=restarts,
                seconds=dt, placements=place)


if __name__ == "__main__":
    raise SystemExit(main())
