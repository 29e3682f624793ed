#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PLAID (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--passages N] [--seed S]

Phases, one JSON line each, any failure ends the run with a non-zero exit:

1. env         torch / CUDA versions and the card (nvidia-smi line printed
               as it is);
2. build       nvcc builds every kernel of ``src/repro_torch/csrc``;
3. index       a synthetic index built on the card at ColBERTv2's widths
               (d=128, nbits=2, nq=32, K=2^18, 2M passages of 8..180
               tokens) plus a >=1M-token compress/decompress round trip;
4. reference   a small index searched under lossless caps against a brute-
               force exact MaxSim written here, independent of the engine;
5. kernels     K1/K2/K3 held against their plain PyTorch versions at the
               main path's shapes and at nbits 1/4, ragged nd, nq 20/40;
               median times of CUDA-event-timed launches;
6. search      the ``plaid-cuda`` backend for k in {10, 100, 1000} x fused
               on/off over a warm-up and 4 timed B=32 batches, ranked pids
               identical to the ``plaid`` backend (plain PyTorch, same
               card), launch counts;
7. persist     the main index saved and loaded through the facade: every
               array identical, the same batch gives identical pids;
8. profile     device time of one plaid-cuda batch by kernel (torch.profiler)
               and the device's busy share of the batch's wall time.

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# Copied out of the repository, the script stops here (no package).
from repro_torch import retrieval  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import pipeline, plaid, scoring  # noqa: E402
from repro_torch.core import residual_codec as rc  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

NBITS, DIM, NQ, BATCH = 2, 128, 32, 32
TIMED_BATCHES = 4  # per (k, fused), after one warm-up batch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line when the block ends cleanly."""

    def __init__(self, name: str):
        self.name, self.info = name, {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0, **self.info})
        return False


def num_centroids_for(n_tokens: int, cap: int = 2**18) -> int:
    """ColBERTv2's rule as the repository applies it (repro/core/kmeans.py:18-21):
    next power of two >= 16 sqrt(n), capped."""
    k = 2 ** int(math.ceil(math.log2(max(16.0 * math.sqrt(max(n_tokens, 1)), 2.0))))
    return int(min(k, cap, max(2, n_tokens)))


# --------------------------------------------------------------------------
# synthetic corpus
# --------------------------------------------------------------------------
def synth_index(*, passages, seed, n_centroids=None, maxlen=180):
    """Topic-structured corpus on the card: each passage draws its codes
    from its topic's pool of centroids; residual bytes are uniform (valid
    at any nbits); the codec tables are normal quantiles at
    sigma = 0.35 / sqrt(d).  K follows ColBERTv2's rule unless
    ``n_centroids`` is given.  No k-means (that is the build slice's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    lens = torch.normal(70.0, 40.0, (passages,), generator=g, device=dev)
    lens = lens.round().clamp(8, maxlen).to(torch.int32)
    lens[0] = maxlen
    nt = int(lens.long().sum())
    K = n_centroids or num_centroids_for(nt)
    cents = torch.randn(K, DIM, generator=g, device=dev)
    cents = cents / cents.norm(dim=1, keepdim=True)
    n_topics, pool = max(K // 32, 4), 64
    pools = torch.randint(0, K, (n_topics, pool), generator=g, device=dev)
    doc_topic = torch.randint(0, n_topics, (passages,), generator=g, device=dev)
    tok_topic = torch.repeat_interleave(doc_topic, lens.long())
    pick = torch.randint(0, pool, (nt,), generator=g, device=dev)
    codes = pools[tok_topic, pick].to(torch.int32)
    del tok_topic, pick
    residuals = torch.randint(
        0, 256, (nt, DIM * NBITS // 8), generator=g, device=dev, dtype=torch.uint8
    )
    nb = 2**NBITS
    sigma = 0.35 / math.sqrt(DIM)
    cut_q = torch.arange(1, nb, device=dev, dtype=torch.float64) / nb
    w_q = (torch.arange(nb, device=dev, dtype=torch.float64) + 0.5) / nb
    index = index_mod.assemble_index(
        cents, codes, residuals, lens,
        cutoffs=(sigma * torch.special.ndtri(cut_q)).float(),
        weights=(sigma * torch.special.ndtri(w_q)).float(),
        nbits=NBITS, device=dev,
    )
    return index


def synth_queries(index, n, seed):
    """Noisy, renormalized reconstructions of NQ tokens of a chosen passage
    each; returns (queries (n, NQ, d), source pids (n,))."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    src = torch.randint(0, index.num_passages, (n,), generator=g, device="cuda")
    lens = index.doc_lens[src].long()
    pos = (torch.rand(n, NQ, generator=g, device="cuda") * lens[:, None]).long()
    tok = index.doc_offsets[src].long()[:, None] + pos
    q = index.reconstruct_tokens(tok)
    q = q + 0.1 / math.sqrt(DIM) * torch.randn(q.shape, generator=g, device="cuda")
    return q / q.norm(dim=-1, keepdim=True), src.to(torch.int32)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------
def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_unique(x) -> int:
    return int(torch.unique(x).numel())


def k1_bound(s_cq, codes, keep):
    B, K, nq = s_cq.shape
    nd, L = codes.shape[1:]
    valid = codes >= 0
    lane = torch.arange(B, device=codes.device)[:, None, None]
    safe = torch.where(valid, codes, 0).long()
    kept = valid & keep[lane, safe]
    rows = n_unique((lane * K + safe)[kept])  # distinct score rows read
    seen = n_unique((lane * K + safe)[valid])  # distinct keep flags read
    nbytes = codes.numel() * 4 + rows * nq * 4 + seen + B * nq * 4 + B * nd * 4
    flops = int(kept.sum()) * nq + B * nd * nq * 3
    return bound(nbytes, flops)


def stage4_bound(n_tokens, codes_valid, nq, d, pd, B, n_out, extra_bytes):
    """K2/K3: the valid tokens' codes and payload bytes, each distinct
    centroid row once, the queries and the output; 2*nq*d flops per token."""
    rows = n_unique(codes_valid)
    nbytes = n_tokens * (4 + pd) + rows * d * 4 + B * nq * (d + 1) * 4 + n_out * 4
    return bound(nbytes + extra_bytes, 2.0 * n_tokens * nq * d + n_tokens * nq)


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passages", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")

    torch.manual_seed(args.seed)
    dev = torch.device("cuda", 0)

    # ---- 1. environment ---------------------------------------------------
    with Phase("env") as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(
            python=sys.version.split()[0], torch=torch.__version__,
            cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
            device_count=torch.cuda.device_count(), nvidia_smi=smi,
            allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        )
    assert not torch.backends.cuda.matmul.allow_tf32

    # ---- 2. build ---------------------------------------------------------
    with Phase("build") as info:
        libs = _build.build_all()
        info["libraries"] = {k: str(v.relative_to(SRC.parent)) for k, v in libs.items()}
        info["ptxas"] = {
            k: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for k, log in _build.BUILD_LOGS.items()
        }

    # ---- 3. index ---------------------------------------------------------
    with Phase("index") as info:
        index = synth_index(passages=args.passages, seed=args.seed)
        torch.cuda.synchronize()
        info.update(
            passages=index.num_passages, tokens=index.num_tokens,
            centroids=index.num_centroids, dim=index.dim, nbits=index.nbits,
            doc_maxlen=index.doc_maxlen, ivf_list_cap=index.ivf_list_cap,
            mean_doc_len=index.num_tokens / index.num_passages,
            bytes=index.nbytes(), total_bytes=sum(index.nbytes().values()),
        )
    with Phase("codec_roundtrip") as info:
        n = min(1 << 20, index.num_tokens)
        codec = index.codec
        x = rc.decompress(codec, index.codes[:n], index.residuals[:n], index.centroids)
        codes2, packed2 = [], []
        for c0 in range(0, n, 2048):
            c, p = rc.compress(codec, x[c0 : c0 + 2048], index.centroids)
            codes2.append(c)
            packed2.append(p)
        codes2, packed2 = torch.cat(codes2), torch.cat(packed2)
        same = codes2 == index.codes[:n]
        exact = (packed2 == index.residuals[:n]).all(dim=1) & same
        info.update(tokens=n, codes_match=float(same.float().mean()),
                    payload_match=float(exact.float().mean()))
        assert info["codes_match"] >= 0.99 and info["payload_match"] >= 0.99, info
        del x, codes2, packed2

    qs_all, src_all = synth_queries(index, BATCH * (TIMED_BATCHES + 1), args.seed)
    batches = [
        (qs_all[i * BATCH : (i + 1) * BATCH], src_all[i * BATCH : (i + 1) * BATCH])
        for i in range(TIMED_BATCHES + 1)
    ]
    qm = torch.ones(BATCH, NQ, device=dev)

    # ---- 4. independent reference on a small index ------------------------
    with Phase("reference") as info:
        small = synth_index(passages=3000, n_centroids=1024, seed=args.seed + 7)
        sq, _ = synth_queries(small, 8, args.seed + 7)
        lossless = retrieval.SearchParams(
            k=10, nprobe=small.num_centroids, ndocs=small.num_passages,
            candidate_cap=small.num_passages, t_cs=-1e9,
        )
        got = retrieval.from_index(small, backend="plaid-cuda", params=lossless).search_batch(sq)
        # brute force: every passage decompressed, exact MaxSim, plain einsum
        L = small.doc_maxlen
        allp = torch.arange(small.num_passages, device=dev, dtype=torch.int32)
        cb, valid = scoring.gather_doc_tokens(small.codes, small.doc_offsets, small.doc_lens, allp, L, -1)
        rb, _ = scoring.gather_doc_tokens(small.residuals, small.doc_offsets, small.doc_lens, allp, L, 0)
        emb = rc.decompress(small.codec, cb.clamp(min=0), rb, small.centroids)
        exact = torch.stack([scoring.maxsim(q, emb, d_mask=valid) for q in sq])
        want_s, want_p = torch.topk(exact, 10, dim=1)
        recall = float((got.pids[:, :, None] == want_p[:, None, :]).any(-1).float().mean())
        info.update(recall_at_10=recall,
                    max_abs_score_err=float((got.scores - want_s).abs().max()))
        assert recall >= 0.99 and info["max_abs_score_err"] < 1e-3, info

    # ---- 5. kernels against their plain versions --------------------------
    kernels = {}
    p1000 = plaid.clamp_params(plaid.params_for_k(1000), index.num_passages)
    with Phase("kernels") as info:
        qb = batches[0][0].contiguous()
        s_cq = pipeline.stage1_scores_batched(index, qb)
        cands = pipeline.candidate_generation_batched(index, s_cq, p1000.nprobe, p1000.candidate_cap)
        keep = scoring.prune_mask(s_cq, p1000.t_cs)
        codes_blk, _ = pipeline.gather_candidate_tokens_shared(index, cands)
        final_pids, codes4, valid4, _ = pipeline.select_finalists_impl(
            index, qb, qm, p1000.t_cs, params=p1000
        )
        res4, _ = scoring.gather_doc_tokens(
            index.residuals, index.doc_offsets, index.doc_lens,
            final_pids.reshape(-1), index.doc_maxlen, fill=0,
        )
        res4 = res4.reshape(*codes4.shape, -1)
        shape = dict(B=BATCH, nq=NQ, d=DIM, pd=res4.shape[-1])
        cases = {
            "centroid_interaction_batched": (
                lambda: ops.centroid_interaction_batched(s_cq, codes_blk, qm, keep),
                lambda: ref.centroid_interaction_batched_ref(s_cq, codes_blk, keep, qm),
                k1_bound(s_cq, codes_blk, keep),
                dict(shape, nd=codes_blk.shape[1], L=codes_blk.shape[2], K=s_cq.shape[1]),
            ),
            "decompress_and_score_batched": (
                lambda: ops.decompress_and_score_batched(
                    qb, qm, codes4, res4, valid4, index.centroids, index.weights, nbits=NBITS),
                lambda: ref.decompress_and_score_batched_ref(
                    qb, qm, codes4, res4, valid4, index.centroids, index.weights, nbits=NBITS),
                stage4_bound(int(valid4.sum()), codes4[valid4], NQ, DIM,
                             res4.shape[-1], BATCH, final_pids.numel(), valid4.numel()),
                dict(shape, nd=codes4.shape[1], L=codes4.shape[2]),
            ),
        }
        codes3f, valid3f = scoring.gather_doc_tokens(
            index.codes, index.doc_offsets, index.doc_lens, final_pids.reshape(-1),
            index.doc_maxlen, fill=-1,
        )
        cases["gather_decompress_maxsim"] = (
            lambda: ops.gather_decompress_maxsim(
                qb, qm, final_pids, index.codes, index.residuals, index.doc_offsets,
                index.doc_lens, index.centroids, index.weights, nbits=NBITS,
                doc_maxlen=index.doc_maxlen),
            lambda: ref.gather_decompress_maxsim_ref(
                qb, qm, final_pids, index.codes, index.residuals, index.doc_offsets,
                index.doc_lens, index.centroids, index.weights, nbits=NBITS,
                doc_maxlen=index.doc_maxlen),
            stage4_bound(int(valid3f.sum()), codes3f[valid3f], NQ, DIM,
                         index.residuals.shape[1], BATCH, final_pids.numel(),
                         final_pids.numel() * 12),
            dict(shape, n3=final_pids.shape[1]),
        )
        for name, (kern, plain, (bound_ms, bound_by), shp) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = err / want.abs().clamp(min=1e-30)
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            kernels[name] = dict(
                max_abs_err=float(err.max()), max_rel_err=float(rel.max()),
                ms=time_ms(kern, reps=25), plain_ms=time_ms(plain, reps=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, shape=shp,
            )
            emit({"kernel_check": name, "ok": ok, **kernels[name]})
            assert ok, name
        # stage-3 shape of K1 (keep all true), then small ragged cases
        codes3 = codes_blk[:, : p1000.ndocs]
        a = ops.centroid_interaction_batched(s_cq, codes3, qm, None)
        b = ref.centroid_interaction_batched_ref(s_cq, codes3, None, qm)
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), "K1 stage-3 shape"
        info["extra_cases"] = extra_kernel_cases(dev)
        del s_cq, cands, codes_blk, codes3, res4

    # ---- 6. the main path: plaid-cuda vs plaid ----------------------------
    ops.reset_launch_counts()
    with Phase("search") as info:
        runs = []
        for k in (10, 100, 1000):
            for fused in (False, True):
                p = retrieval.params_for_k(k).replace(fused=fused)
                cuda_r = retrieval.from_index(index, backend="plaid-cuda", params=p)
                plain_r = retrieval.from_index(index, backend="plaid", params=p)
                lat = {"plaid-cuda": [], "plaid": []}
                hits = 0
                for i, (qb, src) in enumerate(batches):
                    rc_ = cuda_r.search_batch(qb)
                    rp_ = plain_r.search_batch(qb)
                    assert rc_.pids.shape == (BATCH, k) and torch.isfinite(rc_.scores).all()
                    assert bool((rc_.pids >= 0).all()), "fewer than k results"
                    assert bool((rc_.scores[:, :-1] >= rc_.scores[:, 1:]).all())
                    assert torch.equal(rc_.pids, rp_.pids), f"pids differ k={k} fused={fused}"
                    assert torch.allclose(rc_.scores, rp_.scores, rtol=1e-5, atol=1e-5)
                    hits += int((rc_.pids == src[:, None]).any(1).sum())
                    if i:  # batch 0 warms up
                        lat["plaid-cuda"].append(rc_.latency_ms)
                        lat["plaid"].append(rp_.latency_ms)
                row = dict(k=k, fused=fused, batch=BATCH, batches=len(batches) - 1,
                           success_at_k=hits / (BATCH * len(batches)))
                for name, xs in lat.items():
                    p50 = statistics.median(xs)
                    row[name] = dict(p50_ms=p50, qps=BATCH / p50 * 1e3)
                emit({"search": row})
                runs.append(row)
        counts = ops.launch_counts()
        info.update(configs=len(runs), launches=counts)
        assert all(v > 0 for v in counts.values()), counts

    # ---- 7. persistence of the main index ---------------------------------
    with Phase("persist") as info:
        r = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(10))
        qb = batches[1][0]
        before = r.search_batch(qb)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            r.save(tmp)
            t1 = time.perf_counter()
            r2 = retrieval.load(tmp, device="cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            disk_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        loaded = r2.index
        same = {f: torch.equal(getattr(index, f), getattr(loaded, f))
                for f in index_mod.ARRAY_FIELDS}
        after = r2.search_batch(qb)
        info.update(backend=r2.backend_name, passages=loaded.num_passages,
                    tokens=loaded.num_tokens, disk_bytes=disk_bytes,
                    save_s=t1 - t0, load_s=t2 - t1, arrays_identical=same)
        assert r2.backend_name == "plaid-cuda"
        assert all(same.values()), same
        assert torch.equal(before.pids, after.pids)
        assert torch.equal(before.scores, after.scores)
        del r, r2, loaded

    # ---- 8. where a plaid-cuda batch spends its device time ---------------
    with Phase("profile") as info:
        info["configs"] = [
            dict(k=k, fused=False, **profile_batch(
                retrieval.from_index(index, backend="plaid-cuda",
                                            params=retrieval.params_for_k(k)),
                batches[1][0]))
            for k in (10, 1000)
        ]

    replaces = {
        "centroid_interaction_batched": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:110"),
        "decompress_and_score_batched": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:205"),
        "gather_decompress_maxsim": ("src/repro_torch/csrc/fused_score.cu", "src/repro/kernels/fused_score.py:79"),
    }
    emit({"kernels": [
        dict(
            name=name, route="cuda", source=replaces[name][0], replaces=replaces[name][1],
            launches=counts[name], max_abs_err=kv["max_abs_err"], ms=kv["ms"],
            plain_ms=kv["plain_ms"], bound_ms=kv["bound_ms"], bound_by=kv["bound_by"],
            library_ms=None,
        )
        for name, kv in kernels.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_batch(retriever, qb, reps: int = 3) -> dict:
    """Device time of one ``search_batch`` by kernel, from ``torch.profiler``
    (CUPTI), over ``reps`` warm batches: the top kernels, their total, the
    profiled wall time and the device's busy share of it (one stream, so
    kernel times do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retriever.search_batch(qb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            retriever.search_batch(qb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        busy_share=device_ms / wall_ms if device_ms else None,
        launches=sum(e.count for e in kern) // reps,
        top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                  calls=e.count // reps) for e in kern[:10]],
    )


def extra_kernel_cases(dev) -> list:
    """Small random cases off the main path's shapes: nbits 1/2/4, ragged
    nd, nq not a multiple of 32 (20) and above it (40), scattered -1 pads,
    pruned centroids, scattered invalid tokens and pid == -1 lanes."""
    g = torch.Generator(device="cuda").manual_seed(123)
    out = []
    for nbits, nq, d in ((1, 20, 128), (2, 40, 64), (4, 32, 128)):
        B, nd, L, K, nt_docs = 3, 37, 45, 512, 300
        pd = d * nbits // 8
        s_cq = torch.randn(B, K, nq, generator=g, device=dev)
        codes = torch.randint(-1, K, (B, nd, L), generator=g, device=dev, dtype=torch.int32)
        keep = torch.rand(B, K, generator=g, device=dev) > 0.3
        qm = (torch.rand(B, nq, generator=g, device=dev) > 0.1).float()
        q = torch.randn(B, nq, d, generator=g, device=dev)
        packed = torch.randint(0, 256, (B, nd, L, pd), generator=g, device=dev, dtype=torch.uint8)
        valid = torch.rand(B, nd, L, generator=g, device=dev) > 0.4
        cents = torch.randn(K, d, generator=g, device=dev)
        w = torch.sort(torch.randn(2**nbits, generator=g, device=dev)).values
        lens = torch.randint(1, L + 1, (nt_docs,), generator=g, device=dev, dtype=torch.int32)
        offs = torch.zeros(nt_docs + 1, dtype=torch.int32, device=dev)
        offs[1:] = torch.cumsum(lens, 0)
        nt = int(offs[-1])
        codes_tok = torch.randint(0, K, (nt,), generator=g, device=dev, dtype=torch.int32)
        res_tok = torch.randint(0, 256, (nt, pd), generator=g, device=dev, dtype=torch.uint8)
        pids = torch.randint(-1, nt_docs, (B, nd), generator=g, device=dev, dtype=torch.int32)
        pairs = [
            (ops.centroid_interaction_batched(s_cq, codes, qm, keep),
             ref.centroid_interaction_batched_ref(s_cq, codes, keep, qm)),
            (ops.decompress_and_score_batched(q, qm, codes, packed, valid, cents, w, nbits=nbits),
             ref.decompress_and_score_batched_ref(q, qm, codes, packed, valid, cents, w, nbits=nbits)),
            (ops.gather_decompress_maxsim(q, qm, pids, codes_tok, res_tok, offs, lens, cents, w,
                                          nbits=nbits, doc_maxlen=L),
             ref.gather_decompress_maxsim_ref(q, qm, pids, codes_tok, res_tok, offs, lens, cents, w,
                                              nbits=nbits, doc_maxlen=L)),
        ]
        errs = [float((a - b).abs().max()) for a, b in pairs]
        out.append(dict(nbits=nbits, nq=nq, d=d, nd=nd, max_abs_err=errs))
        for (a, b), name in zip(pairs, ("K1", "K2", "K3")):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), (name, nbits, nq)
    return out


if __name__ == "__main__":
    sys.exit(main())
