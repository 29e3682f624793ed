"""Alternating A/B of the full-width query encode between two checkouts.

    python3 src/repro_torch/launch/encode_ab.py --parent DIR [--change DIR]
        [--rounds 3] [--batches 200] [--seed 0]

Each round runs one worker process per checkout in the order parent,
change, change, parent, so a drift of the card or the host over the call
falls on both sides alike.  A worker imports ``repro_torch`` from its
checkout's ``src`` (building that checkout's kernels there), draws
ColBERTv2 at full width with ``attn_impl="flash"`` from ``--seed``, and
times ``--batches`` B=32 x 32-token query encodes after a warm-up, each on
the host clock up to a synchronize, as ``chip_smoke.py``'s encode phase
does.  It also times K7 alone at the encoder's two shapes three ways:
between CUDA events (``ms``), between CUDA events behind a ~1 ms device
sleep (``device_ms``: device work without the host's submission), and on
the host from entry to return on an idle card (``host_us``).

Then one more worker, in one process with the change's package, switches
K7's library batch by batch between the change's build and the parent's
(the same C interface) in blocks of change, parent, parent, change, as
many batches a side as the process runs gave each, so a difference
between processes cannot hide a difference between kernels.

Prints one JSON line per process run, then a summary line: for each side
the p50 of every run and the p50 / p90 over all its batches pooled, the
change's pooled p50 over the parent's, and for the interleaved run each
side's p50 / p90 and the change-minus-parent difference of the blocks
(median, mean and its standard error, the share of blocks where the
change was slower), with K7's timings by library.  Needs one card;
``--change`` defaults to the checkout that holds this file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

QUERY_BATCH, QUERY_LEN, WARMUP = 32, 32, 10
#: (name, B, S, H, Hkv, dh): the encoder's query and passage shapes
K7_SHAPES = (("queries", 32, 32, 48, 12, 64), ("passages", 64, 180, 48, 12, 64))
SLEEP_CYCLES = 2_000_000


def _quantile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def worker(src: str, batches: int, seed: int, other: str | None = None) -> dict:
    """Time query encodes and K7 with ``src``'s ``repro_torch``.  With
    ``other`` (another checkout's ``src``), K7's library alternates batch by
    batch between this checkout's build and ``other``'s (same C interface),
    in the order this, other, other, this; all else is this checkout's."""
    sys.path.insert(0, src)
    import ctypes
    import dataclasses

    import torch

    from repro_torch.configs import colbertv2 as colbert_cfg
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import colbert

    def events_ms(fn, reps: int, sleep: bool) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def host_us(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    libs = {"this": _build.load("flash_attention")}
    if other:  # other's own build code builds and names its library
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from repro_torch.kernels import _build; "
                "print(_build.build_all()['flash_attention'])")
        out = subprocess.run([sys.executable, "-c", code, other], capture_output=True,
                             text=True, check=True).stdout
        libs["other"] = ctypes.CDLL(out.strip().splitlines()[-1])
    order = ("this", "other", "other", "this") if other else ("this",)

    def use(side: str) -> None:
        _build._LIBS["flash_attention"] = libs[side]

    cfg = colbert_cfg.full_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_impl="flash"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = colbert.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.backbone.vocab, (WARMUP + batches, QUERY_BATCH, QUERY_LEN),
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    encode_ms = {side: [] for side in libs}
    for i in range(WARMUP + batches):
        side = order[i % len(order)]
        use(side)
        t0 = time.perf_counter()
        out = colbert.encode(model, toks[i])
        torch.cuda.synchronize()
        if i >= WARMUP:
            encode_ms[side].append((time.perf_counter() - t0) * 1e3)
        assert out.shape == (QUERY_BATCH, QUERY_LEN, cfg.out_dim)
        assert bool(torch.isfinite(out).all())

    k7 = {side: {} for side in libs}
    for name, B, S, H, Hkv, dh in K7_SHAPES:
        q = torch.randn(B, S, H, dh, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, S, Hkv, dh, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, S, Hkv, dh, generator=gen, device="cuda").bfloat16()

        def call():
            return fa.flash_attention(q, k, v)

        for side in libs:
            use(side)
            k7[side][name] = dict(ms=events_ms(call, 25, sleep=False),
                                  device_ms=events_ms(call, 25, sleep=True),
                                  host_us=host_us(call, 25))
    use("this")
    return dict(src=src, encode_ms=encode_ms, k7=k7)


def _side_summary(runs: list) -> dict:
    pooled = [x for ms in runs for x in ms]
    return dict(run_p50_ms=[statistics.median(ms) for ms in runs],
                pooled_p50_ms=statistics.median(pooled), pooled_p90_ms=_quantile(pooled, 0.9),
                batches=len(pooled))


def _k7_median(k7s: list) -> dict:
    return {name: {key: statistics.median(k7[name][key] for k7 in k7s)
                   for key in ("ms", "device_ms", "host_us")}
            for name, *_ in K7_SHAPES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the parent commit")
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--other", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.batches, args.seed, args.other)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("encode_ab: torch.cuda.is_available() is False; needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = {side: str(Path(d).resolve() / "src")
           for side, d in (("parent", args.parent), ("change", args.change))}

    def run_worker(batches: int, *extra: str) -> dict:
        cmd = [sys.executable, __file__, "--batches", str(batches),
               "--seed", str(args.seed), *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise SystemExit(f"encode_ab: worker {extra} failed:\n{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    runs = {"parent": [], "change": []}
    for r in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            res = run_worker(args.batches, "--worker", src[side])
            runs[side].append(res)
            print(json.dumps(dict(round=r, side=side,
                                  encode_p50_ms=statistics.median(res["encode_ms"]["this"]),
                                  k7=res["k7"]["this"])), flush=True)
    summary = {side: dict(**_side_summary([res["encode_ms"]["this"] for res in rs]),
                          k7=_k7_median([res["k7"]["this"] for res in rs]))
               for side, rs in runs.items()}
    summary["change_over_parent_p50"] = (summary["change"]["pooled_p50_ms"]
                                         / summary["parent"]["pooled_p50_ms"])

    # one process, the change's package, K7's library switched batch by
    # batch; as many batches a side as the process runs gave each side
    res = run_worker(4 * args.rounds * args.batches, "--worker", src["change"],
                     "--other", src["parent"])
    this, other = res["encode_ms"]["this"], res["encode_ms"]["other"]
    n = min(len(this), len(other)) // 2
    # blocks of four batches (this, other, other, this): change minus parent
    diffs = [(this[2 * j] + this[2 * j + 1] - other[2 * j] - other[2 * j + 1]) / 2
             for j in range(n)]
    summary["interleaved"] = dict(
        change=_side_summary([this]), parent=_side_summary([other]), blocks=n,
        block_diff_p50_ms=statistics.median(diffs),
        block_diff_mean_ms=statistics.fmean(diffs),
        block_diff_stderr_ms=statistics.stdev(diffs) / n ** 0.5,
        change_slower_share=sum(d > 0 for d in diffs) / n,
        k7=dict(change=res["k7"]["this"], parent=res["k7"]["other"]),
    )
    print(json.dumps({"encode_ab": summary, "smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
