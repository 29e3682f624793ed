"""Serving driver: build a retrieval index over a synthetic corpus and serve
batched requests through the ``repro_torch.retrieval`` facade (the
counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --docs 20000 --queries 256 --k 10
[--backend plaid|plaid-cuda|vanilla|live|live-cuda|...] [--pallas]
[--compare-vanilla] [--sweep-t-cs] [--device cpu]`` prints latency
percentiles, (optionally) the speedup and success@1 of the vanilla
ColBERTv2 baseline (the paper's Table 3 protocol at laptop scale), and
(optionally) a sweep of the pruning threshold ``t_cs``, a per-call
parameter.  ``--pallas`` is the reference's shorthand for its kernels'
backend; here it selects ``plaid-cuda`` (the Hopper kernels).  Runs on
the card unless ``--device cpu``; each timed batch ends with the device
synchronised.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, retrieval
from repro_torch.core import index as index_mod
from repro_torch.data import synthetic as syn

T_CS_SWEEP = (0.3, 0.4, 0.5, 0.6)


def percentile_ms(times, p):
    return float(np.percentile(np.asarray(times) * 1e3, p))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_sweep(searcher, qs, batch, dev):
    """Per-query seconds of each batch (the device synchronised inside the
    timed window) and every query's pids."""
    times, all_pids = [], []
    for i in range(0, qs.shape[0], batch):
        chunk = qs[i : i + batch]
        t0 = time.perf_counter()
        res = searcher.search_batch(chunk)
        _sync(dev)
        times.append((time.perf_counter() - t0) / len(chunk))
        all_pids.append(res.pids.cpu().numpy())
    return times, np.concatenate(all_pids)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nbits", type=int, default=2)
    ap.add_argument("--backend", default="plaid", choices=retrieval.list_backends())
    ap.add_argument("--pallas", action="store_true", help="shorthand for --backend plaid-cuda")
    ap.add_argument("--compare-vanilla", action="store_true")
    ap.add_argument("--sweep-t-cs", action="store_true",
                    help="sweep the pruning threshold, a per-call parameter")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, log=print) -> dict:
    """The serving run for parsed ``args``; prints its lines through
    ``log`` and returns the numbers behind them, the index and every
    query's pids."""
    backend = "plaid-cuda" if args.pallas else args.backend
    dev = resolve_device(args.device)

    log(f"building corpus: {args.docs} docs ...")
    docs, _ = syn.embedding_corpus(args.docs, dim=args.dim)
    t0 = time.perf_counter()
    index = index_mod.build_index(docs, nbits=args.nbits, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    log(f"index: {index.num_passages} docs / {index.num_tokens} tokens / "
        f"{index.num_centroids} centroids ({build_s:.1f}s)")

    qs, gold = syn.queries_from_docs(docs, args.queries)
    qs = torch.as_tensor(np.asarray(qs, np.float32), device=dev)
    searcher = retrieval.from_index(index, backend=backend, params=retrieval.params_for_k(args.k))

    searcher.search_batch(qs[: args.batch])  # warm-up
    _sync(dev)
    times, pids = _timed_sweep(searcher, qs, args.batch, dev)
    hits = int((pids[:, 0] == gold).sum())
    out = dict(backend=backend, k=args.k, device=str(dev), index=index, build_s=build_s,
               num_passages=index.num_passages, num_tokens=index.num_tokens,
               num_centroids=index.num_centroids, times_s=times,
               mean_ms=float(np.mean(times)) * 1e3, p50_ms=percentile_ms(times, 50),
               p99_ms=percentile_ms(times, 99), success_at_1=hits / args.queries,
               pids=pids, gold=np.asarray(gold))
    log(f"{backend}  k={args.k}: mean {out['mean_ms']:.2f} ms/q  "
        f"p50 {out['p50_ms']:.2f}  p99 {out['p99_ms']:.2f}  "
        f"success@1 {out['success_at_1']:.3f}")

    if args.sweep_t_cs:
        info = searcher.describe()
        if "t_cs" not in info["dynamic_fields"]:
            log(f"  ({backend} has no dynamic t_cs; skipping sweep)")
        else:
            traces0 = info["compile"]["trace_count"]
            out["sweep"] = []
            for t_cs in T_CS_SWEEP:
                res = searcher.search_batch(qs[: args.batch], t_cs=t_cs)
                s1 = float((res.pids[:, 0].cpu().numpy() == gold[: args.batch]).mean())
                ms_q = res.latency_ms / args.batch
                out["sweep"].append(dict(t_cs=t_cs, success_at_1=s1, ms_per_query=ms_q))
                log(f"  t_cs={t_cs:.2f}: success@1 {s1:.3f}  {ms_q:.2f} ms/q")
            out["sweep_trace_count"] = searcher.describe()["compile"]["trace_count"] - traces0
            # the reference counts jit retraces here; the port runs eagerly
            # and traces nothing, so the count is 0 by construction
            log(f"  sweep recompiles: {out['sweep_trace_count']} (describe()'s trace_count; "
                "eager PyTorch traces nothing, so this checks no recompilation)")

    if args.compare_vanilla:
        vs = retrieval.from_index(
            index, backend="vanilla",
            params=retrieval.SearchParams(k=args.k, nprobe=4, candidate_cap=2**13, ndocs=4096),
        )
        vs.search_batch(qs[: args.batch])  # warm-up
        _sync(dev)
        vt, v_pids = _timed_sweep(vs, qs, args.batch, dev)
        vhits = int((v_pids[:, 0] == gold).sum())
        out["vanilla"] = dict(mean_ms=float(np.mean(vt)) * 1e3, times_s=vt,
                              success_at_1=vhits / args.queries, pids=v_pids,
                              speedup=float(np.mean(vt) / np.mean(times)))
        log(f"vanilla k={args.k}: mean {out['vanilla']['mean_ms']:.2f} ms/q  "
            f"success@1 {out['vanilla']['success_at_1']:.3f}  "
            f"-> {backend} speedup {out['vanilla']['speedup']:.1f}x")
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
