"""Alternating A/B of the search kernels (K1, K2, K3, K5, K6) and the
``plaid-cuda`` search between two checkouts.

    python3 src/repro_torch/launch/maxsim_ab.py --parent DIR [--change DIR]
        [--rounds 2] [--batches 8] [--passages 2000000] [--seed 0]

Each round runs one worker process per checkout in the order parent,
change, change, parent, so a drift of the card or the host over the call
falls on both sides alike.  A worker imports ``repro_torch`` from its
checkout's ``src`` (building that checkout's kernels there) and draws the
synthetic index and query batches of ``chip_smoke.py`` (taken from the
change's checkout) from ``--seed``.  On them it

* runs K1 at stage 2's and stage 3's shapes (B=32, nd 8192 with keep and
  4096 without), K5 at lane 0's stage-2 block, and K2, K3 and K6 at the
  k=1000 shapes of ``chip_smoke.py``'s ``kernels`` phase, checks each bit
  for bit against its plain version, and times it between CUDA events
  (``ms``), behind a ~1 ms device sleep (``device_ms``) and on the host
  (``host_us``), 25 launches each;
* searches ``--batches`` B=32 batches with ``plaid-cuda`` for k in {10,
  100, 1000} x fused off/on after one warm-up batch (p50 of the batch
  latency, and a digest of the pids, which must agree between sides);
* profiles one warm k=1000 batch, fused off and on (device ms by kernel,
  busy share; ``chip_smoke.py``'s ``profile_batch``).

Prints one JSON line per worker, then a summary line: each side's median
over its runs of every number, and the change over the parent.  Needs one
card; ``--change`` defaults to the checkout that holds this file.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

KS = (10, 100, 1000)


def worker(src: str, root: str, passages: int, batches: int, seed: int) -> dict:
    """Time K1/K2/K3/K5/K6 and the search with ``src``'s ``repro_torch``;
    the index, queries and timers come from ``root``'s ``chip_smoke.py``."""
    sys.path.insert(0, src)
    import torch

    import repro_torch  # this checkout's package, before chip_smoke adds its own src
    from repro_torch import retrieval
    from repro_torch.core import pipeline, plaid, scoring
    from repro_torch.kernels import ops, ref

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(root) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert Path(repro_torch.__file__).resolve().is_relative_to(Path(src).resolve())

    index = cs.synth_index(passages=passages, seed=seed)
    qs, _ = cs.synth_queries(index, cs.BATCH * (batches + 1), seed)
    qm = torch.ones(cs.BATCH, cs.NQ, device=qs.device)
    qb = qs[: cs.BATCH].contiguous()
    p1000 = plaid.clamp_params(plaid.params_for_k(1000), index.num_passages)
    s_cq = pipeline.stage1_scores_batched(index, qb)
    cands = pipeline.candidate_generation_batched(index, s_cq, p1000.nprobe, p1000.candidate_cap)
    keep = scoring.prune_mask(s_cq, p1000.t_cs)
    codes2, _ = pipeline.gather_candidate_tokens_shared(index, cands)
    codes3 = codes2[:, : p1000.ndocs].contiguous()
    k5_args = (s_cq[0], codes2[0], qm[0], keep[0])
    final_pids, codes4, valid4, _ = pipeline.select_finalists_impl(
        index, qb, qm, p1000.t_cs, params=p1000
    )
    res4, _ = scoring.gather_doc_tokens(
        index.residuals, index.doc_offsets, index.doc_lens, final_pids.reshape(-1),
        index.doc_maxlen, fill=0,
    )
    res4 = res4.reshape(*codes4.shape, -1)
    cw = (index.centroids, index.weights)
    k3_args = (qb, qm, final_pids, index.codes, index.residuals, index.doc_offsets,
               index.doc_lens, *cw)
    k6_args = (qb[0], qm[0], codes4[0], res4[0], valid4[0], *cw)
    cases = {
        "centroid_interaction_batched": (
            lambda: ops.centroid_interaction_batched(s_cq, codes2, qm, keep),
            lambda: ref.centroid_interaction_batched_ref(s_cq, codes2, keep, qm)),
        "centroid_interaction_batched_stage3": (
            lambda: ops.centroid_interaction_batched(s_cq, codes3, qm, None),
            lambda: ref.centroid_interaction_batched_ref(s_cq, codes3, None, qm)),
        "centroid_interaction": (
            lambda: ops.centroid_interaction(*k5_args),
            lambda: ref.centroid_interaction_ref(s_cq[0], codes2[0], keep[0], qm[0])),
        "decompress_and_score_batched": (
            lambda: ops.decompress_and_score_batched(qb, qm, codes4, res4, valid4, *cw,
                                                     nbits=index.nbits),
            lambda: ref.decompress_and_score_batched_ref(qb, qm, codes4, res4, valid4, *cw,
                                                         nbits=index.nbits)),
        "gather_decompress_maxsim": (
            lambda: ops.gather_decompress_maxsim(*k3_args, nbits=index.nbits,
                                                 doc_maxlen=index.doc_maxlen),
            lambda: ref.gather_decompress_maxsim_ref(*k3_args, nbits=index.nbits,
                                                     doc_maxlen=index.doc_maxlen)),
        "decompress_and_score": (
            lambda: ops.decompress_and_score(*k6_args, nbits=index.nbits),
            lambda: ref.decompress_and_score_ref(*k6_args, nbits=index.nbits)),
    }
    kernels = {}
    for name, (kern, plain) in cases.items():
        got = kern()
        kernels[name] = dict(
            equal=bool(torch.equal(got, plain())), sum=float(got.double().sum()),
            ms=cs.time_ms(kern, reps=25), device_ms=cs.device_time_ms(kern, reps=25),
            host_us=cs.host_us(kern, reps=25),
        )
    kernels["valid_tokens"] = int(valid4.sum())

    search = {}
    for k in KS:
        for fused in (False, True):
            r = retrieval.from_index(index, backend="plaid-cuda",
                                     params=retrieval.params_for_k(k).replace(fused=fused))
            lat, digest = [], hashlib.sha256()
            for i in range(batches + 1):
                res = r.search_batch(qs[i * cs.BATCH : (i + 1) * cs.BATCH])
                digest.update(res.pids.cpu().numpy().tobytes())
                if i:
                    lat.append(res.latency_ms)
            search[f"k{k}_{'fused' if fused else 'unfused'}"] = dict(
                p50_ms=statistics.median(lat), pids=digest.hexdigest()[:16])
    profile = {}
    for fused in (False, True):
        r = retrieval.from_index(index, backend="plaid-cuda",
                                 params=retrieval.params_for_k(1000).replace(fused=fused))
        prof = cs.profile_batch(r, qs[cs.BATCH : 2 * cs.BATCH])
        profile["fused" if fused else "unfused"] = {
            key: prof[key] for key in ("wall_ms", "device_ms", "busy_share", "launches", "top",
                                       "port")}
    return dict(src=src, kernels=kernels, search=search, profile=profile)


def _numbers(res: dict) -> dict:
    """The worker's timings, flat: name -> ms."""
    out = {}
    for name, kv in res["kernels"].items():
        if isinstance(kv, dict):
            out[f"{name}.ms"] = kv["ms"]
            out[f"{name}.device_ms"] = kv["device_ms"]
            out[f"{name}.host_us"] = kv["host_us"]
    for name, kv in res["search"].items():
        out[f"search.{name}.p50_ms"] = kv["p50_ms"]
    for name, kv in res["profile"].items():
        out[f"profile.{name}.device_ms"] = kv["device_ms"]
        out[f"profile.{name}.wall_ms"] = kv["wall_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--passages", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = worker(args.worker, args.change, args.passages, args.batches, args.seed)
        print(json.dumps(res), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("maxsim_ab: torch.cuda.is_available() is False; needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = {side: str(Path(d).resolve() / "src")
           for side, d in (("parent", args.parent), ("change", args.change))}
    runs = {"parent": [], "change": []}
    for r in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            cmd = [sys.executable, __file__, "--worker", src[side], "--change", args.change,
                   "--passages", str(args.passages), "--batches", str(args.batches),
                   "--seed", str(args.seed)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode:
                raise SystemExit(f"maxsim_ab: {side} worker failed:\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(json.dumps(dict(round=r, side=side, **res)), flush=True)
    for side, rs in runs.items():
        for res in rs:
            assert all(kv["equal"] for kv in res["kernels"].values() if isinstance(kv, dict)), side
    # both sides rank the same passages
    digests = {json.dumps({k: v["pids"] for k, v in res["search"].items()}, sort_keys=True)
               for rs in runs.values() for res in rs}
    summary = {side: {key: statistics.median(_numbers(res)[key] for res in rs)
                      for key in _numbers(rs[0])}
               for side, rs in runs.items()}
    summary["change_over_parent"] = {key: summary["change"][key] / summary["parent"][key]
                                     for key in summary["change"]}
    summary["pids_identical_across_sides"] = len(digests) == 1
    print(json.dumps({"maxsim_ab": summary, "smi": smi}), flush=True)
    assert len(digests) == 1, "the two sides rank different passages"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
