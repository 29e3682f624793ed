"""End-to-end serving driver (the paper's deployment shape), the port's
counterpart of ``examples/serve_retrieval.py``:

  ColBERT encoder -> offline corpus encoding -> PLAID index build ->
  batched online retrieval through ``plaid-cuda`` (``plaid`` on the CPU)
  with latency percentiles, then the vanilla ColBERTv2 baseline on the
  same index: its ms per query, PLAID's speedup and top-1 agreement.

    PYTHONPATH=src python -m repro_torch.launch.serve_retrieval [--full] [--docs 3000]

Reduced-width encoder by default; ``--full`` runs ColBERTv2's widths with
the hand-written attention kernel (``attn_impl="flash"``).  Weights are
random, drawn from ``--seed`` (the repository holds no trained weights),
so the numbers say how fast the engine serves, not how well it retrieves.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device, retrieval
from repro_torch.configs import colbertv2 as colbert_cfg
from repro_torch.core import index as index_mod
from repro_torch.models import colbert

QUERY_BATCH = 32
ENCODE_BATCH = 256


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=3000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = colbert_cfg.full_config() if args.full else colbert_cfg.reduced_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_impl="flash"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = colbert.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(args.seed)

    # --- offline: encode the corpus (batched) and build the index
    d_len = 24
    corpus_tokens = rng.integers(0, cfg.backbone.vocab, (args.docs, d_len)).astype(np.int32)
    t0 = time.perf_counter()
    embs = torch.cat([
        colbert.encode(model, corpus_tokens[i : i + ENCODE_BATCH])
        for i in range(0, args.docs, ENCODE_BATCH)
    ])
    _sync(dev)
    print(f"encoded {args.docs} passages in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    index = index_mod.build_index(
        embs.reshape(-1, cfg.out_dim),
        doc_lens=torch.full((args.docs,), d_len, dtype=torch.int32),
        seed=args.seed, device=dev,
    )
    _sync(dev)
    print(f"index: {index.num_tokens} tokens, {index.num_centroids} centroids, "
          f"built in {time.perf_counter() - t0:.2f}s")

    # --- online: queries are prefixes of corpus passages (gold = source doc)
    q_len = 8
    gold = rng.integers(0, args.docs, args.queries)
    q_embs = colbert.encode(model, corpus_tokens[gold][:, :q_len])
    backend = "plaid-cuda" if dev.type == "cuda" else "plaid"
    searcher = retrieval.from_index(index, backend=backend, params=retrieval.params_for_k(args.k))
    searcher.search_batch(q_embs[:QUERY_BATCH])  # warm-up
    lat, hits, pids = [], 0, []
    for i in range(0, args.queries, QUERY_BATCH):
        res = searcher.search_batch(q_embs[i : i + QUERY_BATCH])
        lat.append(res.latency_ms)
        pids.append(res.pids.cpu().numpy())
        hits += int((pids[-1] == gold[i : i + QUERY_BATCH, None]).any(1).sum())
    pids = np.concatenate(pids)
    plaid_ms_q = sum(lat) / args.queries
    print(
        f"{backend} k={args.k} B<={QUERY_BATCH}: p50 {np.percentile(lat, 50):.2f} ms/batch, "
        f"p99 {np.percentile(lat, 99):.2f} ms/batch, {plaid_ms_q:.2f} ms/q, "
        f"success@{args.k} {hits / args.queries:.0%} on {dev}"
    )

    # --- the vanilla ColBERTv2 baseline on the same index and queries
    vs = retrieval.from_index(
        index, backend="vanilla",
        params=retrieval.SearchParams(k=args.k, nprobe=4, candidate_cap=4096, ndocs=4096),
    )
    vs.search_batch(q_embs[:QUERY_BATCH])  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    v_pids = vs.search_batch(q_embs).pids.cpu().numpy()
    v_ms_q = (time.perf_counter() - t0) / args.queries * 1e3
    # engine fidelity: agreement of PLAID's top-1 with the vanilla baseline
    # (random weights give no retrieval quality, but the engine must agree
    # with the exhaustive-ish baseline on whatever geometry they produce)
    agree = float((pids[:, 0] == v_pids[:, 0]).mean())
    print(
        f"vanilla: {v_ms_q:.2f} ms/q -> PLAID speedup {v_ms_q / plaid_ms_q:.1f}x, "
        f"top-1 agreement {agree:.0%}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
