"""Training driver: ``python -m repro_torch.launch.train --arch plaid-colbertv2
[--reduced]`` (the counterpart of ``repro.launch.train``).

Trains ColBERTv2 on ``colbert_batches`` (the reference's driver's 8-token
queries and 16-token passages) with AdamW on the cosine schedule (20
warm-up steps), microbatched gradient accumulation, optional int8 gradient
compression with error feedback, rolling checkpoints, the straggler
watchdog and supervised restart.  Weights are random, drawn from seed 0.
Runs on the card unless ``--device cpu``.  ``params`` counts the encoder's
parameters (the reference's count also holds its unused ``lm_head``).

Only ``plaid-colbertv2`` is ported; the registry names the ROADMAP item of
every other arch.  ``--mesh`` other than ``none`` raises: data-parallel
training is not ported (ROADMAP Queue 1 item 8).
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
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: data-parallel training is not ported "
                         "(ROADMAP Queue 1 item 8)")

    mod = config_registry.get(args.arch)
    cfg = mod.reduced_config() if args.reduced else mod.full_config()
    dev = resolve_device(args.device)
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
    opt_state = train_loop.init_opt_state(optimizer, params, comp)
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"arch={args.arch} params={n_params:,} steps={args.steps}", flush=True)

    watchdog = ft.StepWatchdog()
    losses = []

    def step_fn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    batches = (next(it) for _ in range(args.steps))
    t0 = time.perf_counter()
    _, final, restarts = ft.run_supervised(
        step_fn, {"params": params, "opt": opt_state}, batches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, watchdog=watchdog,
    )
    dt = time.perf_counter() - t0
    print(
        f"done: {final} steps in {dt:.1f}s "
        f"({dt / max(final, 1) * 1e3:.1f} ms/step), restarts={restarts}, "
        f"stragglers={len(watchdog.stragglers)}"
    )
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
