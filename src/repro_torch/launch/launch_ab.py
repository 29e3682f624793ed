"""Kernel launches a B=32 search batch, counted in two checkouts.

    python3 src/repro_torch/launch/launch_ab.py --parent DIR [--change DIR]
        [--sessions 3] [--passages 2000000] [--seed 0]

One worker process per checkout, parent then change.  A worker imports
``repro_torch`` from its checkout's ``src`` (building that checkout's
kernels there), draws its checkout's ``chip_smoke.py`` synthetic index and
one query batch from ``--seed``, and counts the
CUDA kernels of one ``search_batch`` of ``plaid-cuda`` at k = 10 and
1000, and of ``live-cuda`` over the bare index where the checkout has
``repro_torch.live``, by ``torch.profiler`` two ways, ``--sessions``
times each:

* ``plain``: one session around three batches;
* ``warm``: a session whose warm-up step (``torch.profiler.schedule``)
  traces one batch and discards it before its three, as ``chip_smoke.py``'s
  ``traced_kernels`` traces (which also traces again when a count is not
  whole).

Each count is the session's kernels over three, with ``whole`` true when
every kernel's count is a multiple of three (no launch lost).  Prints one
JSON line per worker.  Needs one card; ``--change`` defaults to the
checkout that holds this file.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPS = 3


def worker(src: str, passages: int, sessions: int, seed: int) -> dict:
    sys.path.insert(0, src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    import repro_torch  # this checkout's package, before chip_smoke adds its own src
    from repro_torch import retrieval
    from repro_torch.kernels import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(src).parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert Path(repro_torch.__file__).resolve().is_relative_to(Path(src).resolve())

    _build.build_all()
    index = cs.synth_index(passages=passages, seed=seed)
    qb = cs.synth_queries(index, 2 * cs.BATCH, seed)[0][cs.BATCH:]

    def count(prof):
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]
        return sum(e.count for e in kern) / REPS, all(e.count % REPS == 0 for e in kern)

    def plain(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return count(prof)

    def warm(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            prof.step()
        return count(prof)

    targets = [("plaid-cuda", index)]
    try:
        from repro_torch.live import LiveIndex
        targets.append(("live-cuda", LiveIndex(index)))
    except ImportError:  # a checkout before the live index
        pass
    out = dict(src=src)
    for k in (10, 1000):
        for backend, idx in targets:
            r = retrieval.from_index(idx, backend=backend, params=retrieval.params_for_k(k))
            for name, method in (("plain", plain), ("warm", warm)):
                rows = []
                for _ in range(sessions):
                    launches, whole = method(lambda: r.search_batch(qb))
                    rows.append(dict(launches=launches, whole=whole))
                out[f"{backend} k={k} {name}"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--passages", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    change = str(Path(args.change).resolve())
    if args.worker:
        res = worker(args.worker, args.passages, args.sessions, args.seed)
        print(json.dumps(res), flush=True)
        return 0
    for side, root in (("parent", args.parent), ("change", change)):
        cmd = [sys.executable, __file__, "--parent", args.parent, "--change", change,
               "--sessions", str(args.sessions), "--passages", str(args.passages),
               "--seed", str(args.seed), "--worker", str(Path(root).resolve() / "src")]
        line = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
        print(json.dumps(dict(side=side, **json.loads(line.strip().splitlines()[-1]))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
