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
6. flash       K7 (attention) against its plain version at the encoder's
               two bf16 shapes (B=32 queries of 32 tokens, B=64 passages of
               180; 48 heads over 12 KV heads, dh 64) and the reference's
               f32 test shapes (causal, MQA); times beside SDPA's;
7. search      the ``plaid-cuda`` backend for k in {10, 100, 1000} x fused
               on/off over a warm-up and 4 timed B=32 batches, ranked pids
               identical to the ``plaid`` backend (plain PyTorch, same
               card), launch counts;
8. encode      ColBERTv2 at full width (``attn_impl="flash"``, seeded
               weights) encodes a corpus of 8..180-token passages,
               ``build_index`` indexes it on the card (k-means at
               ColBERTv2's centroid count), encoded B=32 query batches are
               searched with ``plaid-cuda`` and ``plaid`` (identical pids)
               and in the main index: encode and tokens -> pids latencies,
               K7 launch counts, one encode held against the CPU;
9. persist     the main index saved and loaded through the facade: every
               array identical, the same batch gives identical pids;
10. profile    device time of one plaid-cuda batch and of one B=32 query
               encode by kernel (torch.profiler) and the device's busy
               share of each.

Then the ``{"kernels": [...]}`` line, the card's nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of ``jax`` or ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# Copied out of the repository, the script stops here (no package).
from repro_torch import retrieval  # noqa: E402
from repro_torch.configs import colbertv2 as colbert_cfg  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import kmeans, pipeline, plaid, scoring  # noqa: E402
from repro_torch.core import residual_codec as rc  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import colbert  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

NBITS, DIM, NQ, BATCH = 2, 128, 32, 32
TIMED_BATCHES = 4  # per (k, fused), after one warm-up batch
SEARCH_KERNELS = ("centroid_interaction_batched", "decompress_and_score_batched",
                  "gather_decompress_maxsim")
ENCODE_PASSAGES, DOC_MAXLEN, ENCODE_BATCH = 8192, 180, 64
#: K7 vs plain: f32 sums in another order (64-key tiles vs one tile); bf16
#: outputs one bf16 ulp apart (both round an f32 result once)
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2.0**-7, atol=1e-6)}
#: the reference's flash test shapes (tests/test_flash_attention.py:10-18):
#: B, S, H, Hkv, dh, causal
JAX_FLASH_SHAPES = [(2, 64, 4, 2, 16, True), (1, 128, 8, 1, 32, True),
                    (2, 64, 4, 4, 16, False), (1, 96, 6, 2, 8, True)]


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
    K = n_centroids or kmeans.num_centroids_for(nt)
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


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
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

    # ---- 6. K7 against its plain version ----------------------------------
    with Phase("flash") as info:
        info["cases"] = flash_cases(dev)
        kernels["flash_attention"] = next(c for c in info["cases"] if c["case"] == "passages")

    # ---- 7. the search path: plaid-cuda vs plaid --------------------------
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
        assert all(counts[name] > 0 for name in SEARCH_KERNELS), counts

    # ---- 8. the encoder path: tokens -> vectors -> index -> pids ----------
    with Phase("encode") as info:
        model, encode_counts, q_toks = encode_phase(index, args.seed, dev, info)

    # ---- 9. persistence of the main index ---------------------------------
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

    # ---- 10. where a plaid-cuda batch and a query encode spend device time -
    with Phase("profile") as info:
        info["configs"] = [
            dict(k=k, fused=False, **profile_batch(
                retrieval.from_index(index, backend="plaid-cuda",
                                            params=retrieval.params_for_k(k)),
                batches[1][0]))
            for k in (10, 1000)
        ]
        info["encode"] = dict(batch=BATCH, seq=NQ, **profile_encode(model, q_toks[:BATCH]))

    replaces = {
        "centroid_interaction_batched": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:110"),
        "decompress_and_score_batched": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:205"),
        "gather_decompress_maxsim": ("src/repro_torch/csrc/fused_score.cu", "src/repro/kernels/fused_score.py:79"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:86"),
    }
    # launches: the search kernels' from the search phase, K7's from the
    # encode phase (each path's counts were zeroed just before it ran)
    launches = dict(counts, flash_attention=encode_counts["flash_attention"])
    emit({"kernels": [
        dict(
            name=name, route="cuda", source=replaces[name][0], replaces=replaces[name][1],
            launches=launches[name], max_abs_err=kv["max_abs_err"], ms=kv["ms"],
            plain_ms=kv["plain_ms"], bound_ms=kv["bound_ms"], bound_by=kv["bound_by"],
            library_ms=kv.get("library_ms"),
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


def flash_check(name, B, S, H, Hkv, dh, causal, dtype, g, timed: bool) -> dict:
    """K7 against its plain version on one seeded case; at the encoder's
    shapes also its time, the plain version's, SDPA's and the bound."""
    dev = "cuda"
    q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dh, generator=g, device=dev).to(dtype)

    def kern():
        return fa.flash_attention(q, k, v, causal=causal)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    row = dict(case=name, shape=dict(B=B, S=S, H=H, Hkv=Hkv, dh=dh), dtype=str(dtype),
               causal=causal, tol=tol, max_abs_err=float((got.float() - want.float()).abs().max()),
               ok=torch.allclose(got.float(), want.float(), **tol))
    if timed:
        def sdpa():  # the yardstick; the port never calls it
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        lib = sdpa().transpose(1, 2)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, o, k, v
        flops = 4.0 * B * H * S * S * dh * (0.5 if causal else 1.0)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = bound(nbytes, flops, peak)
        row.update(
            ms=time_ms(kern, reps=25), plain_ms=time_ms(plain, reps=5, warmup=1),
            library_ms=time_ms(sdpa, reps=25),
            library_max_abs_err=float((lib.float() - want.float()).abs().max()),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
    emit({"kernel_check": "flash_attention", **row})
    assert row["ok"], row
    return row


def flash_cases(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(321)
    enc = [("queries", BATCH, NQ, 48, 12, 64, False, torch.bfloat16),
           ("passages", ENCODE_BATCH, DOC_MAXLEN, 48, 12, 64, False, torch.bfloat16)]
    jax_shapes = [(f"reference_test_{i}", *shape, torch.float32)
                  for i, shape in enumerate(JAX_FLASH_SHAPES)]
    return ([flash_check(*c, g, timed=True) for c in enc]
            + [flash_check(*c, g, timed=False) for c in jax_shapes])


def check_result(res, k) -> None:
    """(BATCH, k) pids, -1 only in trailing slots, real scores finite and
    in descending order."""
    real = res.pids >= 0
    assert res.pids.shape == (BATCH, k) and bool((res.pids >= -1).all())
    assert bool((real[:, :-1] | ~real[:, 1:]).all()), "a -1 slot before a real pid"
    assert bool(torch.isfinite(res.scores[real]).all())
    s = torch.where(real, res.scores, -torch.inf)
    assert bool((s[:, :-1] >= s[:, 1:]).all())


def encode_phase(index, seed, dev, info: dict):
    """ColBERTv2 at full width on the card: corpus -> build_index -> B=32
    query batches searched with plaid-cuda and plaid (identical pids) and in
    the main index.  Returns the model, the phase's launch counts and the
    query tokens."""
    cfg = colbert_cfg.full_config()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_impl="flash"))
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    model = colbert.init_params(cfg, gen, device=dev)
    vocab, n = cfg.backbone.vocab, ENCODE_PASSAGES
    lens = torch.randint(8, DOC_MAXLEN + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    lens[0] = DOC_MAXLEN
    toks = torch.randint(0, vocab, (n, DOC_MAXLEN), generator=gen, device=dev)
    mask = torch.arange(DOC_MAXLEN, device=dev)[None, :] < lens[:, None]
    n_batches = TIMED_BATCHES + 1
    src = torch.randint(0, n, (BATCH * n_batches,), generator=gen, device=dev)
    q_toks = toks[src, :NQ]  # a query is the head of a passage
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    calls = 0
    t0 = time.perf_counter()
    chunks = []
    for i in range(0, n, ENCODE_BATCH):
        e = colbert.encode(model, toks[i : i + ENCODE_BATCH], mask[i : i + ENCODE_BATCH])
        chunks.append(e[mask[i : i + ENCODE_BATCH]])
        calls += 1
    doc_embs = torch.cat(chunks)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    norms = doc_embs.norm(dim=-1)
    assert torch.isfinite(doc_embs).all() and bool(((norms - 1).abs() < 1e-3).all())

    t0 = time.perf_counter()
    enc_index = index_mod.build_index(doc_embs, lens, seed=seed, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert enc_index.num_centroids == kmeans.num_centroids_for(doc_embs.shape[0])
    t0 = time.perf_counter()  # the k-means step of that build, timed alone
    kmeans.train_centroids(doc_embs, enc_index.num_centroids, seed=seed)
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0

    q_batches, encode_ms = [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        qe = colbert.encode(model, q_toks[b * BATCH : (b + 1) * BATCH])
        torch.cuda.synchronize()
        calls += 1
        assert qe.shape == (BATCH, NQ, DIM) and torch.isfinite(qe).all()
        if b:
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        q_batches.append(qe)

    searches = []
    for k in (10, 100):
        p = retrieval.params_for_k(k)
        cuda_r = retrieval.from_index(enc_index, backend="plaid-cuda", params=p)
        plain_r = retrieval.from_index(enc_index, backend="plaid", params=p)
        hits, filled, lat = 0, 0, []
        for b, qe in enumerate(q_batches):
            got, want = cuda_r.search_batch(qe), plain_r.search_batch(qe)
            check_result(got, k)
            assert torch.equal(got.pids, want.pids), f"encoded index: pids differ at k={k}"
            assert torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
            hits += int((got.pids == src[b * BATCH : (b + 1) * BATCH, None]).any(1).sum())
            filled += int((got.pids >= 0).sum())
            if b:
                lat.append(got.latency_ms)
        # with random weights a passage's tokens sit close together, so the
        # probed centroids' lists can hold fewer than k passages (-1 slots)
        searches.append(dict(k=k, plaid_cuda_p50_ms=statistics.median(lat),
                             success_at_k=hits / (BATCH * n_batches),
                             filled_share=filled / (BATCH * n_batches * k)))

    big = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(10))
    e2e_ms = []
    for b in range(n_batches):
        t0 = time.perf_counter()
        res = big.search_batch(colbert.encode(model, q_toks[b * BATCH : (b + 1) * BATCH]))
        calls += 1
        check_result(res, 10)
        if b:
            e2e_ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    layers = cfg.backbone.n_layers
    assert counts["flash_attention"] == layers * calls > 0, (counts, calls)

    # one query batch on the card against the same weights on the CPU (K7's
    # plain version there); bf16 rounds at other places on the two devices,
    # in each of 12 layers, so the bound is looser than one layer's (0.999)
    cpu_model = colbert.params_from_numpy(model.numpy_params(), cfg, device="cpu")
    a = colbert.encode(model, q_toks[:2]).cpu()
    b = colbert.encode(cpu_model, q_toks[:2].cpu())
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    info.update(
        config=dict(n_layers=layers, d_model=cfg.backbone.d_model, heads=cfg.backbone.n_heads,
                    padded_heads=cfg.backbone.padded_heads, d_ff=cfg.backbone.d_ff,
                    vocab=cfg.backbone.vocab, dtype=str(cfg.backbone.dtype),
                    attn_impl=cfg.backbone.attn_impl, out_dim=cfg.out_dim),
        passages=n, tokens=int(doc_embs.shape[0]), corpus_encode_s=corpus_s,
        corpus_tokens_per_s=doc_embs.shape[0] / corpus_s,
        build_s=build_s, kmeans_s=kmeans_s, centroids=enc_index.num_centroids,
        query_batch=BATCH, query_len=NQ, timed_batches=TIMED_BATCHES,
        encode_p50_ms=statistics.median(encode_ms), encoded_index_search=searches,
        main_index_passages=index.num_passages,
        tokens_to_pids_p50_ms=statistics.median(e2e_ms),
        encode_calls=calls, launches=counts, k7_launches_per_encode=layers,
        cpu_check=dict(min_cosine=float(cos.min()), max_abs_err=float((a - b).abs().max())),
    )
    assert info["cpu_check"]["min_cosine"] >= 0.99 and info["cpu_check"]["max_abs_err"] <= 0.1
    del cpu_model, enc_index, doc_embs, chunks
    return model, counts, q_toks


def profile_encode(model, toks, reps: int = 3) -> dict:
    """Device time of one warm query encode, grouped: cuBLAS GEMMs, K7 and
    everything else (elementwise ops, norms, reductions, copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    colbert.encode(model, toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            colbert.encode(model, toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    groups = {"gemm": 0.0, "flash_attention": 0.0, "other": 0.0}
    for e in kern:
        name = e.key.lower()
        grp = ("flash_attention" if "flash_attention_kernel" in name
               else "gemm" if any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass"))
               else "other")
        groups[grp] += e.self_device_time_total / 1e3 / reps
    device_ms = sum(groups.values())
    return dict(
        wall_ms=wall_ms, device_ms=device_ms, device_ms_by_group=groups,
        busy_share=device_ms / wall_ms if device_ms else None,
        launches=sum(e.count for e in kern) // reps,
        top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                  calls=e.count // reps) for e in kern[:12]],
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
