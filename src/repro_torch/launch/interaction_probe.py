"""K1's device time at the main path's shapes, split by ablation.

    python3 src/repro_torch/launch/interaction_probe.py [--passages 2000000]
        [--seed 0] [--per-warp 1 2 4 8]

Builds ``csrc/maxsim.cu`` as it stands and a copy whose keep test never
passes while every code is still read (``stream``: the codes stream, one
vote a window and the empty-score store a candidate; no keep lookup, no
row), with ``nvcc`` into the git-ignored ``build/repro_torch/
interaction_probe``.  Draws ``chip_smoke.py``'s synthetic index and the
k=1000 blocks of its ``kernels`` phase, and times between CUDA events
behind a ~1 ms device sleep (``device_ms``, 25 launches) for each
candidates-a-warp value of ``--per-warp``:

* stage 2 (B=32, nd=8192, keep of t_cs): ``full``; ``no_rows`` (keep all
  false: every lookup, no row, every candidate empty); ``stream``;
* stage 3 (nd=4096, null keep): ``full``; ``stream``;
* K5 (lane 0's stage-2 block): ``full``.

Each ``full`` and ``no_rows`` run is checked bit for bit against the plain
version.  Prints the ``nvidia-smi`` line, the blocks' token counts, then one
JSON line a case.  Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
#: the keep test of csrc/maxsim.cu, and one that never passes but still
#: reads every code (no code equals 10^6 + i at the shapes probed)
KEEP_TEST = "live[i] = c[i] >= 0 && keep(c[i]);"
NO_KEEP_TEST = "live[i] = c[i] == 1000000 + i;"


def build(out: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "maxsim.cu").read_text()
    assert src.count(KEEP_TEST) == 1
    sources = {"full": src, "stream": src.replace(KEEP_TEST, NO_KEEP_TEST)}
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).plaid_centroid_interaction_batched
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passages", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-warp", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("interaction_probe: torch.cuda.is_available() is False; needs a GPU")
    from repro_torch.core import pipeline, plaid, scoring
    from repro_torch.kernels import _build, ref

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(_build.BUILD_ROOT / "interaction_probe")

    index = cs.synth_index(passages=args.passages, seed=args.seed)
    qs, _ = cs.synth_queries(index, cs.BATCH, args.seed)
    qm = torch.ones(cs.BATCH, cs.NQ, device="cuda")
    p = plaid.clamp_params(plaid.params_for_k(1000), index.num_passages)
    s_cq = pipeline.stage1_scores_batched(index, qs.contiguous())
    cands = pipeline.candidate_generation_batched(index, s_cq, p.nprobe, p.candidate_cap)
    keep = scoring.prune_mask(s_cq, p.t_cs)
    codes2, _ = pipeline.gather_candidate_tokens_shared(index, cands)
    codes3 = codes2[:, : p.ndocs].contiguous()
    lane = torch.arange(cs.BATCH, device="cuda")[:, None, None]
    valid = codes2 >= 0
    kept = valid & keep[lane, torch.where(valid, codes2, 0).long()]
    print(json.dumps({"blocks": dict(
        slots=codes2.numel(), valid=int(valid.sum()), kept=int(kept.sum()),
        kept_centroids_per_lane=float(keep.sum(1).float().mean()),
        valid_stage3=int((codes3 >= 0).sum()))}), flush=True)

    none = torch.zeros_like(keep)
    cases = [  # shape, case, library, (s_cq, codes, keep), checked
        ("stage2", "full", "full", (s_cq, codes2, keep), True),
        ("stage2", "no_rows", "full", (s_cq, codes2, none), True),
        ("stage2", "stream", "stream", (s_cq, codes2, keep), False),
        ("stage3", "full", "full", (s_cq, codes3, None), True),
        ("stage3", "stream", "stream", (s_cq, codes3, None), False),
        ("k5", "full", "full", (s_cq[:1], codes2[:1], keep[:1]), True),
    ]
    stream = torch.cuda.current_stream().cuda_stream
    for shape, case, lib, (s, c, k), checked in cases:
        B, K, nq = s.shape
        nd, L = c.shape[1:]
        m = qm[:B]
        out = torch.empty(B, nd, device="cuda")
        want = ref.centroid_interaction_batched_ref(s, c, k, m) if checked else None
        for pw in args.per_warp:
            def run(fn=libs[lib], pw=pw):
                err = fn(s.data_ptr(), c.data_ptr(), None if k is None else k.data_ptr(),
                         m.data_ptr(), out.data_ptr(), B, K, nq, nd, L, pw, stream)
                assert err == 0, err

            run()
            torch.cuda.synchronize()
            row = dict(shape=shape, case=case, per_warp=pw, B=B, nd=nd,
                       device_ms=cs.device_time_ms(run, reps=25))
            if checked:
                row["equal"] = bool(torch.equal(out, want))
            print(json.dumps(row), flush=True)
            assert row.get("equal", True), row
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
