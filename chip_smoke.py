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
               main path's shapes (K1 at stage 2's and at stage 3's, with
               no keep) and at nbits 1/4, ragged nd, nq 20/40, all bit for
               bit; K4 at vanilla's stage-3 block (4096 passages x 180
               rows) and at nbits 1/4, K5/K6 at ``_search``'s k=1000 shapes;
               K2/K3's blocks an SM (the occupancy API);
               median times of launches between CUDA events (``ms``), of
               the same behind a device sleep (``device_ms``: device work
               alone, without the host's submission) and the host's time
               per call (``host_us``);
6. flash       K7 (attention) against its plain version at the encoder's
               two bf16 shapes (B=32 queries of 32 tokens, B=64 passages of
               180; 48 heads over 12 KV heads, dh 64), the reference's f32
               test shapes (causal, MQA) and bf16 views at an odd offset
               and transposed; ``ms``, ``device_ms`` and the host's time
               per call (``host_us``) beside SDPA's;
7. search      the ``plaid-cuda`` backend for k in {10, 100, 1000} x fused
               on/off over a warm-up and 4 timed B=32 batches, ranked pids
               identical to the ``plaid`` backend (plain PyTorch, same
               card), launch counts; then, per k, one unfused batch with
               ``with_funnel=True`` through both backends (pids identical
               to each other and to the batch without the funnel, every
               ``FunnelStats`` field identical), each field's mean over the
               batch, and funnel off against on interleaved (p50 of 4
               pairs);
8. vanilla     the ``vanilla`` backend (ColBERTv2's baseline, K4) at the
               reference's ``vanilla_p4_c8192`` settings for k in {10,
               1000} over a warm-up and 2 timed B=32 batches: pids
               identical to ``VanillaEngine(impl="ref")``, p50 per batch
               beside ``plaid-cuda``'s on the same batches, and
               ``plaid-cuda``'s recall@10 against vanilla's top 10 (the
               paper's Table 3 protocol, as smoke numbers);
9. oracle      8 queries through the single-query ``plaid._search`` with
               ``impl="cuda"`` (K5, K6) for k in {10, 100, 1000}: pids
               identical to the same lanes of ``plaid-cuda``'s batch and to
               ``_search(impl="ref")``;
10. quality    the quality harness (``repro_torch.eval``): (i) an index
               of 2^16 passages of 8..180 tokens from
               ``data.synthetic.embedding_corpus`` (d=128, nbits 2, K by
               ColBERTv2's rule) built on the card and 64 seeded queries of
               32 tokens; ``sweep_quality`` over ``default_grid`` (48
               points) and 8 points whose ndocs caps cut real candidates,
               with ``impl="cuda"`` and with ``impl="ref"``: pids, funnel,
               work and metrics identical at every point; records, the
               frontier, ``n_programs``, per-point latency, the points
               where each cap's mask bound; (ii)
               ``certify_backends`` at lossless caps on 4,096 passages and
               32 queries: every variant (``plaid-cuda``, ``vanilla``,
               fused, bf16 and int8 stage 1) within 1e-6 of the exact f32
               ``plaid`` baseline's recall@10, the PLAID variants' pids
               identical to the baseline's and ``vanilla``'s to
               ``VanillaEngine(impl="ref")``'s, scores within 1e-5, with
               the IVF walk's and the candidate blocks' bytes;
11. encode     ColBERTv2 at full width (``attn_impl="flash"``, seeded
               weights) encodes a corpus of 8..180-token passages,
               ``build_index`` indexes it on the card (k-means at
               ColBERTv2's centroid count), encoded B=32 query batches are
               searched with ``plaid-cuda`` and ``plaid`` (identical pids)
               and in the main index: encode and tokens -> pids latencies,
               K7 launch counts, one encode held against the CPU;
12. stream_build  the streaming build (``repro_torch.build``): (i) a
               trained build at ColBERTv2's widths (d=128, nbits=2, K=2^17,
               a 2^18 sample, 8 Lloyd iterations) of 250,000 passages of
               8..180 tokens (~23.5M tokens) made chunk by chunk on the
               card: pass 1/pass 2/k-means seconds, tokens/s, peak device
               memory beside the corpus's f32 size, BuildStats, pass 2's
               device time by kernel, and a B=32 batch with identical pids
               through plaid-cuda and plaid; (ii) frozen-table streaming
               builds of the encode phase's corpus at two chunk sizes,
               pruned (0.25) and not, array-identical to ``build_index``;
               (iii) two trained builds of ~1M tokens at chunk_docs 256 and
               4,096, bit-identical; (iv) ``indexer.build_from_encoder``
               over 2,048 passages through the encoder (K7) identical to
               ``build_index`` over the same output, and ``retrieval.build``
               identical to ``build_index_streaming``;
13. persist    the main index saved and loaded through the facade: every
               array identical, the same batch gives identical pids;
14. profile    device time of one plaid-cuda batch, one vanilla batch and
               one B=32 query encode by kernel (torch.profiler) and the
               device's busy share of each.

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

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# Copied out of the repository, the script stops here (no package).
from repro_torch import build, retrieval  # noqa: E402
from repro_torch.configs import colbertv2 as colbert_cfg  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import indexer  # noqa: E402
from repro_torch.core import kmeans, pipeline, plaid, scoring, vanilla  # noqa: E402
from repro_torch.core import residual_codec as rc  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.eval import qrels as eval_qrels, sweep as eval_sweep  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import colbert  # noqa: E402
from repro_torch.obs.funnel import FunnelStats  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

NBITS, DIM, NQ, BATCH = 2, 128, 32, 32
TIMED_BATCHES = 4  # per (k, fused), after one warm-up batch
SEARCH_KERNELS = ("centroid_interaction_batched", "decompress_and_score_batched",
                  "gather_decompress_maxsim")
VANILLA_BATCHES = 3  # one warm-up, two timed
ORACLE_QUERIES = 8
#: the reference's vanilla_p4_c8192 (benchmarks/table3_endtoend.py:25-31)
VANILLA_SETTINGS = dict(nprobe=4, candidate_cap=2**13, ndocs=4096)
#: kernels held bit for bit against their plain versions
BIT_EXACT = ("centroid_interaction_batched", "decompress_residuals",
             "decompress_and_score_batched", "gather_decompress_maxsim",
             "centroid_interaction", "decompress_and_score")
#: kernel -> (its CUDA source, the TPU kernel it replaces)
REPLACES = {
    "centroid_interaction_batched": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:110"),
    "decompress_and_score_batched": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:205"),
    "gather_decompress_maxsim": ("src/repro_torch/csrc/fused_score.cu", "src/repro/kernels/fused_score.py:79"),
    "decompress_residuals": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:54"),
    "centroid_interaction": ("src/repro_torch/csrc/maxsim.cu", "src/repro/kernels/maxsim.py:48"),
    "decompress_and_score": ("src/repro_torch/csrc/decompress.cu", "src/repro/kernels/decompress.py:119"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:86"),
}
#: substrings of the port's kernel names in a profile (profile_batch's "port")
PORT_KERNEL_KEYS = ("interaction", "score_kernel", "decompress_residuals", "flash_attention")
ENCODE_PASSAGES, DOC_MAXLEN, ENCODE_BATCH = 8192, 180, 64
#: the streaming build: one LoTTE topic's corpus (250k passages, ~23.5M
#: tokens) in chunks of 16,384 passages; ~1M tokens for the determinism
#: check; 2,048 encoded passages for build_from_encoder
STREAM_PASSAGES, STREAM_CHUNK_DOCS = 250_000, 16_384
DETERMINISM_PASSAGES, ENCODER_BUILD_PASSAGES = 10_640, 2048
#: phase quality: the sweep's corpus and queries (embedding_corpus, 8..180
#: tokens), the certification's.  16 passages a topic (the reference's
#: 96-passage harness has 12): at the default 32 topics a query would judge
#: 2,048 passages relevant and recall@10 could not pass ~0.005
QUALITY_PASSAGES, QUALITY_QUERIES = 1 << 16, 64
CERT_PASSAGES, CERT_QUERIES = 4096, 32
PASSAGES_PER_TOPIC = 16
#: phase quality: sweep points past ``default_grid`` whose ndocs sit below
#: the stage-1 candidates a query of that corpus gathers (~640 at nprobe 3,
#: ~1,850 at 8) and below their pow2 bucket, so that the ndocs_t / n3_t
#: masks cut real candidates; default_grid's ndocs (n/8 and up) exceed them
CAP_GRID_NPROBES, CAP_GRID_NDOCS = (3, 8), (12, 40, 100, 300)
#: phase quality: certification scores, a variant against the baseline and
#: vanilla against its plain version
CERT_SCORE_ATOL = 1e-5
FUNNEL_PAIRS = 4  # funnel off/on timing pairs per k, interleaved
SLEEP_CYCLES = 2_000_000  # queued before each call device_time_ms times
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
    """Median over ``reps`` calls, each between two CUDA events: the call's
    device time plus whatever part of its host work the device waits for."""
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


def device_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """As ``time_ms``, with a device sleep of ~1 ms (``SLEEP_CYCLES``)
    queued before the start event: the device is still asleep while the
    host submits the call, so the events time the call's device work
    alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps: int, warmup: int = 2) -> float:
    """Median host time of one call on an idle device, from entry to return
    (argument checks, launch set-up and submission; no synchronize)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_unique(x) -> int:
    return int(torch.unique(x).numel())


def k1_bound(s_cq, codes, keep):
    """K1/K5: every code slot (pads too), each distinct kept score row and
    each distinct keep flag (none for a null keep) once, q_mask and the
    output; one max per (kept token, query) and the query sum."""
    B, K, nq = s_cq.shape
    nd, L = codes.shape[1:]
    valid = codes >= 0
    lane = torch.arange(B, device=codes.device)[:, None, None]
    safe = torch.where(valid, codes, 0).long()
    kept = valid if keep is None else valid & keep[lane, safe]
    rows = n_unique((lane * K + safe)[kept])  # distinct score rows read
    seen = 0 if keep is None else n_unique((lane * K + safe)[valid])  # keep flags read
    nbytes = codes.numel() * 4 + rows * nq * 4 + seen + B * nq * 4 + B * nd * 4
    flops = int(kept.sum()) * nq + B * nd * nq * 3
    return bound(nbytes, flops)


def k1_stage3_check(s_cq, codes3, qm) -> dict:
    """K1 at stage 3's shape (the ndocs survivors, keep null), bit for bit
    against its plain version, timed as the kernels phase times.  Its rows
    are gathered for every valid token, so beside the bound (distinct bytes
    at the memory rate) it reports the bytes of those gathers, which the
    SMs take in from L1/L2."""
    def kern():
        return ops.centroid_interaction_batched(s_cq, codes3, qm, None)

    def plain():
        return ref.centroid_interaction_batched_ref(s_cq, codes3, None, qm)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    valid = int((codes3 >= 0).sum())
    bound_ms, bound_by = k1_bound(s_cq, codes3, None)
    row = dict(equal=torch.equal(got, want), max_abs_err=float((got - want).abs().max()),
               ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
               host_us=host_us(kern, reps=25), plain_ms=time_ms(plain, reps=3),
               bound_ms=bound_ms, bound_by=bound_by, valid_tokens=valid, gathered_row_bytes=valid * NQ * 4,
               shape=dict(B=codes3.shape[0], nd=codes3.shape[1], L=codes3.shape[2],
                          K=s_cq.shape[1], nq=NQ))
    emit({"kernel_check": "centroid_interaction_batched", "case": "stage3", **row})
    assert row["equal"], "K1 stage-3 shape"
    return row


def k4_bound(n_bytes, nbits):
    """K4: each packed byte read once, its 8/nbits f32 fields written once;
    no arithmetic (a lookup)."""
    return bound(n_bytes * (1 + (8 // nbits) * 4) + 4 * 2**nbits, 0.0)


def stage4_bound(n_tokens, codes_valid, nq, d, pd, B, n_out, extra_bytes):
    """K2/K3: the valid tokens' codes and payload bytes, each distinct
    centroid row once, the queries and the output; 2*nq*d flops per token."""
    rows = n_unique(codes_valid)
    nbytes = n_tokens * (4 + pd) + rows * d * 4 + B * nq * (d + 1) * 4 + n_out * 4
    return bound(nbytes + extra_bytes, 2.0 * n_tokens * nq * d + n_tokens * nq)


def contract_bound_ms(n_tokens, nq, d) -> float:
    """K2/K3/K6 under the shared-order contract: no FMA, so each of the
    nq*d terms of a token is a rounded multiply and a rounded add, two
    instructions on the FP32 pipes, each at half the 67 TFLOP/s (which
    counts an FMA as two operations): twice the operations bound."""
    return 2.0 * n_tokens * nq * d / (F32_FLOPS / 2) * 1e3


def score_occupancy(nq, d, L) -> dict:
    """Blocks of K2's and K3's nbits-2 body an SM holds at the G the main
    path picks (the occupancy API, through the kernels' libraries)."""
    from repro_torch.kernels import decompress as dec

    g2, g3 = dec.passages_per_block(BATCH, 1024, L), dec.passages_per_block(BATCH, 1024)
    return dict(
        G_k2=g2, k2=_build.load("decompress").plaid_decompress_score_blocks_per_sm(nq, d, g2, L),
        G_k3=g3, k3=_build.load("fused_score").plaid_gather_maxsim_blocks_per_sm(nq, d, g3, 0))


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
            k: [ln.strip() for ln in log.splitlines()
                if any(t in ln for t in ("entry function", "registers", "spill"))]
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
        # K4 at vanilla's stage-3 block: 4096 passages' padded rows
        res_v, _ = scoring.gather_doc_tokens(
            index.residuals, index.doc_offsets, index.doc_lens, cands[0, :4096],
            index.doc_maxlen, fill=0,
        )
        cases["decompress_residuals"] = (
            lambda: ops.decompress_residuals(res_v, index.weights, nbits=NBITS),
            lambda: ref.decompress_residuals_ref(res_v, index.weights, nbits=NBITS),
            k4_bound(res_v.numel(), NBITS),
            dict(n=res_v.shape[0] * res_v.shape[1], pd=res_v.shape[2], nbits=NBITS,
                 passages=res_v.shape[0], L=res_v.shape[1]),
        )
        # K5 / K6 at _search's k=1000 shapes: lane 0's stage-2 block over
        # all K centroids, and its stage-4 finalists
        s1, c1, k1, m1 = s_cq[0], codes_blk[0], keep[0], qm[0]
        cases["centroid_interaction"] = (
            lambda: ops.centroid_interaction(s1, c1, m1, k1),
            lambda: ref.centroid_interaction_ref(s1, c1, k1, m1),
            k1_bound(s_cq[:1], codes_blk[:1], keep[:1]),
            dict(nd=c1.shape[0], L=c1.shape[1], K=s1.shape[0], nq=NQ),
        )
        q6, c6, r6, v6 = qb[0], codes4[0], res4[0], valid4[0]
        cases["decompress_and_score"] = (
            lambda: ops.decompress_and_score(q6, m1, c6, r6, v6, index.centroids,
                                             index.weights, nbits=NBITS),
            lambda: ref.decompress_and_score_ref(q6, m1, c6, r6, v6, index.centroids,
                                                 index.weights, nbits=NBITS),
            stage4_bound(int(v6.sum()), c6[v6], NQ, DIM, r6.shape[-1], 1, c6.shape[0],
                         v6.numel()),
            dict(nd=c6.shape[0], L=c6.shape[1], pd=r6.shape[-1], nq=NQ, d=DIM),
        )
        contract = {  # K2/K3/K6: valid tokens under the no-FMA contract
            "decompress_and_score_batched": contract_bound_ms(int(valid4.sum()), NQ, DIM),
            "gather_decompress_maxsim": contract_bound_ms(int(valid3f.sum()), NQ, DIM),
            "decompress_and_score": contract_bound_ms(int(v6.sum()), NQ, DIM),
        }
        for name, (kern, plain, (bound_ms, bound_by), shp) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = err / want.abs().clamp(min=1e-30)
            # K4 does no arithmetic, K1/K5 take an exact max, and all keep
            # their plain versions' f32 order (the shared-order contract):
            # bit for bit
            ok = (torch.equal(got, want) if name in BIT_EXACT
                  else torch.allclose(got, want, rtol=1e-5, atol=1e-5))
            kernels[name] = dict(
                max_abs_err=float(err.max()), max_rel_err=float(rel.max()),
                ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
                host_us=host_us(kern, reps=25), plain_ms=time_ms(plain, reps=5, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, shape=shp,
            )
            if name in contract:
                kernels[name]["contract_bound_ms"] = contract[name]
            emit({"kernel_check": name, "ok": ok, **kernels[name]})
            assert ok, name
        # K1 at stage 3's shape (no keep: a null pointer), then small
        # ragged cases
        info["k1_stage3"] = k1_stage3_check(s_cq, codes_blk[:, : p1000.ndocs].contiguous(), qm)
        info["extra_cases"] = extra_kernel_cases(dev)
        info["score_blocks_per_sm"] = score_occupancy(NQ, DIM, index.doc_maxlen)
        assert min(info["score_blocks_per_sm"]["k2"], info["score_blocks_per_sm"]["k3"]) >= 1
        info["k4_nbits_cases"] = k4_nbits_cases(dev, res_v.shape[0] * res_v.shape[1])
        del s_cq, cands, codes_blk, res4, res_v

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
        info["funnel"] = funnel_rows(index, batches)
        search_counts = ops.launch_counts()
        info.update(configs=len(runs), launches=search_counts)
        assert all(search_counts[name] > 0 for name in SEARCH_KERNELS), search_counts

    # ---- 8. the vanilla ColBERTv2 baseline (K4) ---------------------------
    ops.reset_launch_counts()
    with Phase("vanilla") as info:
        info["configs"] = vanilla_phase(index, batches[:VANILLA_BATCHES])
        vanilla_counts = ops.launch_counts()
        info["launches"] = vanilla_counts
        assert vanilla_counts["decompress_residuals"] > 0, vanilla_counts

    # ---- 9. the single-query _search oracle (K5, K6) ----------------------
    ops.reset_launch_counts()
    with Phase("oracle") as info:
        info["configs"] = oracle_phase(index, batches[1][0])
        oracle_counts = ops.launch_counts()
        info["launches"] = oracle_counts
        assert oracle_counts["centroid_interaction"] > 0, oracle_counts
        assert oracle_counts["decompress_and_score"] > 0, oracle_counts

    # ---- 10. the quality harness: sweep and certification -----------------
    ops.reset_launch_counts()
    with Phase("quality") as info:
        quality_phase(args.seed, dev, info)
        info["launches"] = ops.launch_counts()

    # ---- 11. the encoder path: tokens -> vectors -> index -> pids ---------
    with Phase("encode") as info:
        model, encode_counts, q_toks, enc_corpus = encode_phase(index, args.seed, dev, info)

    # ---- 12. the streaming build --------------------------------------------
    ops.reset_launch_counts()
    with Phase("stream_build") as info:
        stream_build_phase(model, enc_corpus, args.seed, dev, info)
        stream_counts = ops.launch_counts()
        info["launches"] = stream_counts
        assert stream_counts["flash_attention"] > 0, stream_counts
    del enc_corpus

    # ---- 13. persistence of the main index --------------------------------
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

    # ---- 14. where a plaid-cuda batch and a query encode spend device time -
    with Phase("profile") as info:
        info["configs"] = [
            dict(k=k, fused=False, **profile_batch(
                retrieval.from_index(index, backend="plaid-cuda",
                                            params=retrieval.params_for_k(k)),
                batches[1][0]))
            for k in (10, 1000)
        ]
        info["vanilla"] = dict(k=10, **profile_batch(
            retrieval.from_index(index, backend="vanilla",
                                 params=retrieval.SearchParams(k=10, **VANILLA_SETTINGS)),
            batches[1][0]))
        info["encode"] = dict(batch=BATCH, seq=NQ, **profile_encode(model, q_toks[:BATCH]))

    # launches: each kernel's from the path that runs it, its counts zeroed
    # just before that path: K1-K3 in search, K4 in vanilla, K5/K6 in
    # oracle, K7 in encode and stream_build
    launches = {name: search_counts[name] for name in SEARCH_KERNELS}
    launches["decompress_residuals"] = vanilla_counts["decompress_residuals"]
    for name in ("centroid_interaction", "decompress_and_score"):
        launches[name] = oracle_counts[name]
    launches["flash_attention"] = (encode_counts["flash_attention"]
                                   + stream_counts["flash_attention"])
    rows = [
        dict(
            name=name, route="cuda", source=REPLACES[name][0], replaces=REPLACES[name][1],
            launches=launches[name], max_abs_err=kv["max_abs_err"], ms=kv["ms"],
            device_ms=kv["device_ms"], host_us=kv.get("host_us"), plain_ms=kv["plain_ms"],
            bound_ms=kv["bound_ms"], bound_by=kv["bound_by"],
            library_ms=kv.get("library_ms"), contract_bound_ms=kv.get("contract_bound_ms"),
        )
        for name, kv in kernels.items()
    ]
    assert sorted(r["name"] for r in rows) == sorted(REPLACES), [r["name"] for r in rows]
    assert all(r["launches"] > 0 for r in rows), launches
    emit({"kernels": rows})
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

    def row(e):
        return dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                    calls=e.count // reps)

    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        busy_share=device_ms / wall_ms if device_ms else None,
        launches=sum(e.count for e in kern) // reps,
        top=[row(e) for e in kern[:10]],
        # the port's own kernels (K1: "interaction", K2/K3: "score_kernel",
        # K4, K7), wherever they rank
        port=[row(e) for e in kern if any(t in e.key for t in PORT_KERNEL_KEYS)],
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
            ms=time_ms(kern, reps=25), device_ms=device_time_ms(kern, reps=25),
            host_us=host_us(kern, reps=25), plain_ms=time_ms(plain, reps=5, warmup=1),
            library_ms=time_ms(sdpa, reps=25), library_device_ms=device_time_ms(sdpa, reps=25),
            library_host_us=host_us(sdpa, reps=25),
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
            + [flash_check(*c, g, timed=False) for c in jax_shapes]
            + flash_view_cases(dev, g))


def flash_view_cases(dev, g) -> list:
    """K7 on views it cannot read as they stand, at the query shape: bf16 q
    at an odd element offset (TMA needs 16-byte alignment) and transposed
    (not contiguous); the wrapper copies them, and the result is held
    against the plain version within one bf16 ulp and equals K7 on the
    contiguous original."""
    q, k, v = (torch.randn(BATCH, NQ, h, 64, generator=g, device=dev).bfloat16()
               for h in (48, 12, 12))
    flat = torch.empty(q.numel() + 1, device=dev, dtype=torch.bfloat16)
    views = {"offset": flat[1:].view(q.shape).copy_(q),
             "transposed": q.transpose(1, 2).contiguous().transpose(1, 2)}
    base = fa.flash_attention(q, k, v, causal=False)
    rows = []
    for name, view in views.items():
        got = fa.flash_attention(view, k, v, causal=False)
        want = ref.flash_attention_ref(view, k, v, causal=False)
        torch.cuda.synchronize()
        tol = FLASH_TOL[torch.bfloat16]
        row = dict(case=f"view_{name}", aligned=view.data_ptr() % 16 == 0,
                   contiguous=view.is_contiguous(), tol=tol,
                   max_abs_err=float((got.float() - want.float()).abs().max()),
                   ok=torch.allclose(got.float(), want.float(), **tol) and torch.equal(got, base))
        emit({"kernel_check": "flash_attention", **row})
        assert row["ok"], row
        rows.append(row)
    return rows


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
    del cpu_model, chunks
    corpus = dict(toks=toks, lens=lens, doc_embs=doc_embs, index=enc_index)
    return model, counts, q_toks, corpus


def stream_corpus(passages, seed, chunk_docs):
    """A chunk factory for a topic-structured corpus made on the card from
    the seed, chunk by chunk (never one array): passages of 8..180 tokens,
    each token a term of its passage's topic plus noise, unit norm.
    Returns ``(factory, n_tokens)``."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    n_terms, n_topics, pool = 1 << 16, 1 << 12, 32
    terms = F.normalize(torch.randn(n_terms, DIM, generator=g, device=dev), dim=1)
    pools = torch.randint(0, n_terms, (n_topics, pool), generator=g, device=dev)
    lens = torch.randint(8, DOC_MAXLEN + 1, (passages,), generator=g, device=dev,
                         dtype=torch.int32).cpu().numpy()

    def chunk(i):
        gc = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)
        cl = lens[i * chunk_docs : (i + 1) * chunk_docs]
        nt = int(cl.sum())
        topic = torch.randint(0, n_topics, (len(cl),), generator=gc, device=dev)
        tok_topic = torch.repeat_interleave(topic, torch.from_numpy(cl).to(dev).long())
        pick = torch.randint(0, pool, (nt,), generator=gc, device=dev)
        x = terms[pools[tok_topic, pick]]
        x += (0.3 / math.sqrt(DIM)) * torch.randn(nt, DIM, generator=gc, device=dev)
        return F.normalize(x, dim=1), cl

    def factory():
        for i in range(-(-passages // chunk_docs)):
            yield chunk(i)

    return factory, int(lens.sum())


def profile_quantize(index, factory) -> dict:
    """Device time of pass 2's per-chunk work (``quantize_rows``: assign,
    residual, compress) over four 16,384-row windows of the first chunk
    against the built tables, by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.build.streaming import quantize_rows

    x = next(factory())[0][: 4 * 16384]
    quantize_rows(x, index.centroids, index.codec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        quantize_rows(x, index.centroids, index.codec)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    flops = 2.0 * x.shape[0] * index.num_centroids * DIM
    return dict(rows=x.shape[0], wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if device_ms else None,
                gemm_bound_ms=flops / F32_FLOPS * 1e3,
                distance_bytes_bound_ms=2 * 4 * x.shape[0] * index.num_centroids
                / HBM_BYTES_PER_S * 1e3,
                top=[dict(kernel=e.key[:90], ms=e.self_device_time_total / 1e3, calls=e.count)
                     for e in kern[:8]])


def same_index(a, b) -> dict:
    """Every array field and static field of two indexes, compared bit for
    bit; returns the fields that differ."""
    diff = [f for f in index_mod.ARRAY_FIELDS
            if getattr(a, f).dtype != getattr(b, f).dtype
            or not torch.equal(getattr(a, f), getattr(b, f))]
    diff += [f for f in index_mod.STATIC_FIELDS if getattr(a, f) != getattr(b, f)]
    return diff


def stream_build_phase(model, enc, seed, dev, info: dict):
    """The streaming build on the card: (i) a trained build at ColBERTv2's
    widths from a corpus made chunk by chunk, searched with plaid-cuda and
    plaid (identical pids); (ii) frozen-table builds of the encode phase's
    corpus at two chunk sizes, pruned and not, array-identical to
    ``build_index``; (iii) two trained builds of a ~1M-token corpus at two
    chunk sizes, bit-identical; (iv) ``build_from_encoder`` through the
    encoder (K7) against ``build_index`` over the same encoder output, and
    ``retrieval.build`` against ``build_index_streaming``."""
    # (i) trained, at scale
    factory, nt = stream_corpus(STREAM_PASSAGES, seed, STREAM_CHUNK_DOCS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big, st = build.build_index_streaming(
        build.iterator_stream(factory), seed=seed, return_stats=True, device=dev
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    assert big.num_tokens == nt == st.n_tokens and big.num_passages == STREAM_PASSAGES
    assert big.num_centroids == kmeans.num_centroids_for(nt) and st.trained
    assert torch.isfinite(big.centroids).all()
    info["trained"] = dict(
        passages=STREAM_PASSAGES, tokens=nt, chunk_docs=STREAM_CHUNK_DOCS, dim=DIM,
        nbits=big.nbits, centroids=big.num_centroids, sample=build.DEFAULT_SAMPLE_SIZE,
        kmeans_iters=8, build_s=build_s, pass1_s=st.pass1_s, pass2_s=st.pass2_s,
        kmeans_s=st.kmeans_s, tokens_per_s=nt / build_s, pass2_tokens_per_s=nt / st.pass2_s,
        peak_device_bytes=peak, monolithic_corpus_bytes=nt * DIM * 4,
        index_bytes=sum(big.nbytes().values()), stats=dataclasses.asdict(st),
    )
    emit({"stream_build": info["trained"]})
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    emb0, lens0 = next(factory())
    offs0 = torch.from_numpy(lens0).to(dev).long().cumsum(0) - torch.from_numpy(lens0).to(dev).long()
    src = torch.randint(0, len(lens0), (BATCH,), generator=g, device=dev)
    pos = (torch.rand(BATCH, NQ, generator=g, device=dev)
           * torch.from_numpy(lens0).to(dev)[src, None]).long()
    qb = emb0[offs0[src, None] + pos]
    qb = F.normalize(qb + 0.02 * torch.randn(qb.shape, generator=g, device=dev), dim=-1)
    del emb0
    p = retrieval.params_for_k(10)
    got = retrieval.from_index(big, backend="plaid-cuda", params=p).search_batch(qb)
    want = retrieval.from_index(big, backend="plaid", params=p).search_batch(qb)
    check_result(got, 10)
    assert torch.equal(got.pids, want.pids), "streamed index: plaid-cuda pids differ from plaid"
    assert torch.allclose(got.scores, want.scores, rtol=1e-5, atol=1e-5)
    info["trained"]["search"] = dict(
        k=10, batch=BATCH, pids_identical=True,
        success_at_10=float((got.pids == src[:, None]).any(1).float().mean()))
    info["trained"]["pass2_profile"] = profile_quantize(big, factory)
    del big, got, want

    # (ii) frozen tables: streaming == monolithic, pruned and not
    emb, lens, tables = enc["doc_embs"], enc["lens"], enc["index"]
    frozen = dict(centroids=tables.centroids, codec=tables.codec)
    rows = []
    for frac in (0.0, 0.25):
        mono = index_mod.build_index(emb, lens, prune_fraction=frac, device=dev, **frozen)
        for cd in (256, 4096):
            t0 = time.perf_counter()
            streamed = build.build_index_streaming(emb, lens, chunk_docs=cd, prune_fraction=frac,
                                                   device=dev, **frozen)
            torch.cuda.synchronize()
            diff = same_index(streamed, mono)
            rows.append(dict(prune_fraction=frac, chunk_docs=cd, tokens=streamed.num_tokens,
                             seconds=time.perf_counter() - t0, differing_fields=diff))
            assert not diff, rows[-1]
    info["frozen_identity"] = rows

    # (iii) trained builds at two chunkings: bit for bit
    f3, nt3 = stream_corpus(DETERMINISM_PASSAGES, seed + 1, 4096)
    parts = list(f3())
    packed = torch.cat([e for e, _ in parts])
    lens3 = np.concatenate([cl for _, cl in parts])
    del parts
    a = build.build_index_streaming(packed, lens3, chunk_docs=256, seed=seed, device=dev)
    b = build.build_index_streaming(packed, lens3, chunk_docs=4096, seed=seed, device=dev)
    diff = same_index(a, b)
    info["determinism"] = dict(tokens=nt3, passages=DETERMINISM_PASSAGES, chunk_docs=[256, 4096],
                               centroids=a.num_centroids, differing_fields=diff)
    assert not diff, info["determinism"]
    del packed, a, b

    # (iv) the encoder path (K7) under frozen tables, then retrieval.build
    toks = enc["toks"][:ENCODER_BUILD_PASSAGES]
    n, L = toks.shape
    t0 = time.perf_counter()
    streamed, st4 = indexer.build_from_encoder(
        lambda t: colbert.encode(model, t), toks, chunk=ENCODE_BATCH, return_stats=True,
        device=dev, **frozen)
    torch.cuda.synchronize()
    enc_build_s = time.perf_counter() - t0
    out = torch.cat([colbert.encode(model, toks[i : i + ENCODE_BATCH]).reshape(-1, DIM)
                     for i in range(0, n, ENCODE_BATCH)])
    full_lens = torch.full((n,), L, dtype=torch.int32)
    mono = index_mod.build_index(out, full_lens, device=dev, **frozen)
    diff = same_index(streamed, mono)
    assert st4.peak_host_f32_bytes == 0 and not st4.trained, st4
    cfg_index = dict(num_centroids=4096, kmeans_iters=4, chunk_docs=512, seed=seed)
    r = retrieval.build(out, doc_lens=full_lens, backend="plaid-cuda", index=cfg_index,
                        device=dev)
    direct = build.build_index_streaming(out, full_lens, device=dev, **cfg_index)
    diff_facade = same_index(r.index, direct)
    check_result(r.search_batch(out.reshape(n, L, DIM)[:BATCH, :NQ]), 10)
    info["encoder"] = dict(
        passages=n, rows_per_passage=L, tokens=streamed.num_tokens, chunk=ENCODE_BATCH,
        build_s=enc_build_s, tokens_per_s=streamed.num_tokens / enc_build_s,
        stats=dataclasses.asdict(st4), differing_fields=diff,
        facade=dict(backend=r.backend_name, index=cfg_index, differing_fields=diff_facade))
    assert not diff, info["encoder"]
    assert not diff_facade, info["encoder"]


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


def k4_nbits_cases(dev, n) -> list:
    """K4 at nbits 1 and 4 on random bytes, as many rows as the stage-3
    block: bit for bit against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(77)
    out = []
    for nbits in (1, 4):
        packed = torch.randint(0, 256, (n, DIM * nbits // 8), generator=g, device=dev,
                               dtype=torch.uint8)
        w = torch.sort(torch.randn(2**nbits, generator=g, device=dev)).values
        got = ops.decompress_residuals(packed, w, nbits=nbits)
        want = ref.decompress_residuals_ref(packed, w, nbits=nbits)
        torch.cuda.synchronize()
        row = dict(nbits=nbits, n=n, pd=packed.shape[1], equal=torch.equal(got, want),
                   max_abs_err=float((got - want).abs().max()),
                   ms=time_ms(lambda: ops.decompress_residuals(packed, w, nbits=nbits), reps=10),
                   bound_ms=k4_bound(packed.numel(), nbits)[0])
        out.append(row)
        assert row["equal"], row
        del packed, got, want
    return out


def vanilla_phase(index, batches) -> list:
    """The ``vanilla`` backend at the reference's vanilla_p4_c8192 settings
    against ``VanillaEngine(impl="ref")`` on the same card (identical pids,
    scores within 1e-5), and against ``plaid-cuda`` at paper Table 2
    settings on the same batches: p50 per batch of each and the ratio, and
    ``plaid-cuda``'s recall@10 against vanilla's top 10 (batch 0 warms up);
    success@k is the share of queries whose source passage each returns."""
    rows = []
    for k in (10, 1000):
        van = retrieval.from_index(index, backend="vanilla",
                                   params=retrieval.SearchParams(k=k, **VANILLA_SETTINGS))
        plain = vanilla.VanillaEngine(index, vanilla.VanillaParams(
            k=k, nprobe=VANILLA_SETTINGS["nprobe"], ncandidates=VANILLA_SETTINGS["candidate_cap"],
            ndocs_cap=VANILLA_SETTINGS["ndocs"], impl="ref"))
        pc = retrieval.from_index(index, backend="plaid-cuda", params=retrieval.params_for_k(k))
        lat = {"vanilla": [], "plaid-cuda": []}
        hits, found = 0, {"vanilla": 0, "plaid-cuda": 0}
        for i, (qb, src) in enumerate(batches):
            got = van.search_batch(qb)
            want_s, want_p = plain.search_batch(qb)
            check_result(got, k)
            assert torch.equal(got.pids, want_p), f"vanilla pids differ from impl='ref' at k={k}"
            assert torch.allclose(got.scores, want_s, rtol=1e-5, atol=1e-5)
            res = pc.search_batch(qb)
            top_v, top_p = got.pids[:, :10], res.pids[:, :10]
            hits += int(((top_p[:, :, None] == top_v[:, None, :]) & (top_v[:, None, :] >= 0))
                        .any(-1).sum())
            for name, r in (("vanilla", got), ("plaid-cuda", res)):
                found[name] += int((r.pids == src[:, None]).any(1).sum())
            if i:
                lat["vanilla"].append(got.latency_ms)
                lat["plaid-cuda"].append(res.latency_ms)
        p50 = {name: statistics.median(xs) for name, xs in lat.items()}
        row = dict(k=k, batch=BATCH, batches=len(batches) - 1, settings=VANILLA_SETTINGS,
                   vanilla_p50_ms=p50["vanilla"], plaid_cuda_p50_ms=p50["plaid-cuda"],
                   vanilla_over_plaid_cuda=p50["vanilla"] / p50["plaid-cuda"],
                   plaid_cuda_recall_at_10_vs_vanilla=hits / (BATCH * len(batches) * 10),
                   success_at_k={name: n / (BATCH * len(batches)) for name, n in found.items()})
        emit({"vanilla": row})
        rows.append(row)
    return rows


def oracle_phase(index, qb) -> list:
    """``plaid._search`` one query at a time, ``impl="cuda"`` (K5, K6) and
    ``"ref"``, against the lanes of one ``plaid-cuda`` batch, for k in
    {10, 100, 1000} at paper Table 2 settings."""
    rows = []
    qm = torch.ones(NQ, device=qb.device)
    s1_all = pipeline.stage1_scores_batched(index, qb)  # the batch's C.Q^T
    for k in (10, 100, 1000):
        eng = plaid.PlaidEngine(index, plaid.params_for_k(k, impl="cuda"))
        kw, t_cs = eng._kwargs(), eng.params.t_cs
        batch = retrieval.from_index(index, backend="plaid-cuda",
                                     params=retrieval.params_for_k(k)).search_batch(qb)
        batch_s, batch_p = batch.scores, batch.pids
        same_s1, ms = 0, []
        for i in range(ORACLE_QUERIES):
            same_s1 += int(torch.equal(scoring.centroid_scores(qb[i], index.centroids), s1_all[i]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_c, p_c = plaid._search(index, qb[i], qm, t_cs=t_cs, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            s_r, p_r = plaid._search(index, qb[i], qm, t_cs=t_cs, **dict(kw, impl="ref"))
            msg = f"k={k} query {i}: stage-1 identical to the batch's for {same_s1} of {i + 1}"
            assert torch.equal(p_c, batch_p[i]), "oracle vs plaid-cuda batch: " + msg
            assert torch.equal(p_c, p_r), "oracle cuda vs ref: " + msg
            assert torch.allclose(s_c, batch_s[i], rtol=1e-5, atol=1e-5), msg
            assert torch.equal(s_c, s_r), msg
        row = dict(k=k, queries=ORACLE_QUERIES, pids_identical=True,
                   stage1_identical_to_batch=same_s1, search_ms_p50=statistics.median(ms))
        emit({"oracle": row})
        rows.append(row)
    del s1_all
    return rows


def funnel_rows(index, batches) -> list:
    """Funnel telemetry on the main index, for k in {10, 100, 1000}: one
    unfused batch with ``with_funnel=True`` through ``plaid-cuda`` and
    ``plaid``, pids identical to each other and to the batch without the
    funnel, every ``FunnelStats`` field identical; each field's mean over
    the batch; then ``plaid-cuda`` funnel off against on, interleaved in one
    process (p50 of FUNNEL_PAIRS pairs of the call's wall time, which
    includes the funnel's copy to the host)."""
    rows = []
    qb = batches[1][0]
    for k in (10, 100, 1000):
        p = retrieval.params_for_k(k)
        cuda_r = retrieval.from_index(index, backend="plaid-cuda", params=p)
        plain_r = retrieval.from_index(index, backend="plaid", params=p)
        on = cuda_r.search_batch(qb, with_funnel=True)
        on_plain = plain_r.search_batch(qb, with_funnel=True)
        off = cuda_r.search_batch(qb)
        check_result(on, k)
        assert off.funnel is None and list(on.funnel) == list(FunnelStats._fields)
        assert torch.equal(on.pids, on_plain.pids), f"funnel: plaid-cuda vs plaid pids, k={k}"
        assert torch.equal(on.pids, off.pids), f"funnel on vs off pids, k={k}"
        assert torch.equal(on.scores, off.scores), f"funnel on vs off scores, k={k}"
        fn = on.funnel
        for f, v in fn.items():
            assert v.shape == (BATCH,) and np.array_equal(v, on_plain.funnel[f]), (k, f)
        assert (fn["stage2_survivors"] <= fn["stage1_candidates"]).all()
        assert (fn["stage3_survivors"] <= fn["stage2_survivors"]).all()
        assert (fn["alive_dropped"] == 0).all() and (fn["gathered_tokens"] > 0).all()
        times = {"off": [], "on": []}
        for i in range(FUNNEL_PAIRS):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cuda_r.search_batch(qb, with_funnel=mode == "on")
                times[mode].append((time.perf_counter() - t0) * 1e3)
        p50 = {mode: statistics.median(xs) for mode, xs in times.items()}
        row = dict(k=k, batch=BATCH, funnel_mean={f: float(v.mean()) for f, v in fn.items()},
                   identical_to_plaid=True, pairs=FUNNEL_PAIRS, off_p50_ms=p50["off"],
                   on_p50_ms=p50["on"], on_minus_off_ms=p50["on"] - p50["off"],
                   off_ms=times["off"], on_ms=times["on"])
        emit({"funnel": row})
        rows.append(row)
    return rows


def quality_phase(seed, dev, info: dict) -> None:
    """The quality harness (``repro_torch.eval``) on the card.

    (i) An index of QUALITY_PASSAGES passages of 8..180 tokens from
    ``data.synthetic.embedding_corpus`` (d=128, nbits 2, K by ColBERTv2's
    rule) built on the card, QUALITY_QUERIES seeded queries of NQ tokens:
    ``sweep_quality`` over ``default_grid`` (48 points) and the
    CAP_GRID points with ``impl="cuda"``, then with ``impl="ref"`` on the
    same card; every point's pids, funnel, work and metrics identical, and
    the ndocs mask cuts real candidates at every CAP_GRID point.  (ii)
    ``certify_backends`` at lossless caps on a CERT_PASSAGES-passage index
    of the same widths, CERT_QUERIES queries: every variant's recall@10
    within 1e-6 of the exact f32 ``plaid`` baseline; the PLAID variants'
    pids identical to the baseline's and ``vanilla``'s to its plain
    version's on the same batches, scores within CERT_SCORE_ATOL.  At nprobe = K the IVF
    walk holds B x nq x K x ivf_list_cap pids, so certification searches
    a few queries at a time (``eval.sweep.lossless_query_batch``)."""
    # ---- (i) the sweep
    t0 = time.perf_counter()
    docs, topics = synthetic.embedding_corpus(
        QUALITY_PASSAGES, dim=DIM, min_len=8, max_len=DOC_MAXLEN, seed=seed,
        n_topics=QUALITY_PASSAGES // PASSAGES_PER_TOPIC, n_concepts=QUALITY_PASSAGES)
    qset = eval_qrels.synthetic_query_set(docs, topics, QUALITY_QUERIES, q_len=NQ,
                                          seed=seed + 1)
    corpus_s = time.perf_counter() - t0
    n_tok = sum(len(d) for d in docs)
    t0 = time.perf_counter()
    index = build.build_index_streaming(
        docs, num_centroids=kmeans.num_centroids_for(n_tok), nbits=NBITS, seed=seed,
        chunk_docs=STREAM_CHUNK_DOCS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del docs
    grid = eval_sweep.default_grid(index)
    assert len(grid) == 48
    grid += [eval_sweep.GridPoint(eval_sweep.T_CS_OFF, p, d)
             for p in CAP_GRID_NPROBES for d in CAP_GRID_NDOCS]
    t0 = time.perf_counter()
    rec_c, eng = eval_sweep.sweep_quality(index, qset, grid=grid, impl="cuda")
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec_r, _ = eval_sweep.sweep_quality(index, qset, grid=grid, impl="ref",
                                        measure_latency=False)
    ref_s = time.perf_counter() - t0
    assert len(rec_c) == len(rec_r) == len(grid)
    for c, r in zip(rec_c, rec_r):
        assert np.array_equal(c.pids, r.pids), f"sweep pids, cuda vs ref, at {c.case}"
        for f, v in r.funnel.items():
            assert np.array_equal(c.funnel[f], v), f"sweep funnel {f}, cuda vs ref, at {c.case}"
        assert c.work == r.work and c.metrics == r.metrics, c.case
        assert math.isfinite(c.work) and 0.0 <= c.metrics["recall@10"] <= 1.0, c.case
    # a cap's mask binds where it sits below its bucket and cut a real
    # candidate (ndocs_t at stage 2, n3_t at stage 3) in some query
    def cut(r, kept, had):
        return bool((r.funnel[kept] < r.funnel[had]).any())

    ndocs_binds = [r.case for r in rec_c if r.ndocs < r.bucket_ndocs
                   and cut(r, "stage2_survivors", "stage1_candidates")]
    n3_binds = [r.case for r in rec_c if r.ndocs < r.bucket_ndocs
                and cut(r, "stage3_survivors", "stage2_survivors")]
    nprobe_masked = [r.case for r in rec_c if r.nprobe < r.bucket_nprobe]
    cap_cases = {r.case for r in rec_c[48:]}
    assert cap_cases <= set(ndocs_binds), f"ndocs mask cut nothing at {cap_cases - set(ndocs_binds)}"
    frontier = eval_sweep.pareto_frontier(rec_c)
    emit({"sweep": [
        dict(case=r.case, bucket=[r.bucket_nprobe, r.bucket_ndocs], work=r.work,
             recall_at_10=r.metrics["recall@10"], mrr_at_10=r.metrics["mrr@10"],
             latency_ms_per_query=r.latency_ms, on_frontier=r.on_frontier,
             stage1_candidates_mean=float(r.funnel["stage1_candidates"].mean()),
             stage2_survivors_mean=float(r.funnel["stage2_survivors"].mean()),
             stage3_survivors_mean=float(r.funnel["stage3_survivors"].mean()))
        for r in rec_c]})
    recalls = [r.metrics["recall@10"] for r in rec_c]
    info["sweep"] = dict(
        passages=index.num_passages, tokens=index.num_tokens, centroids=index.num_centroids,
        ivf_list_cap=index.ivf_list_cap, queries=QUALITY_QUERIES, points=len(rec_c),
        default_grid_points=48, cap_grid_points=len(rec_c) - 48,
        identical_cuda_vs_ref=True, ndocs_mask_binds=len(ndocs_binds),
        n3_mask_binds=len(n3_binds), nprobe_mask_points=len(nprobe_masked),
        ndocs_mask_binds_in_default_grid=len(set(ndocs_binds) - cap_cases),
        frontier=len(frontier),
        frontier_cases=[r.case for r in frontier], n_programs=eng.n_programs,
        recall_at_10_min=min(recalls), recall_at_10_max=max(recalls),
        latency_ms_per_query_p50=statistics.median(r.latency_ms for r in rec_c),
        corpus_s=corpus_s, build_s=build_s, cuda_sweep_s=cuda_s, ref_sweep_s=ref_s)
    del index, rec_c, rec_r

    # ---- (ii) lossless-caps certification
    t0 = time.perf_counter()
    docs_c, topics_c = synthetic.embedding_corpus(
        CERT_PASSAGES, dim=DIM, min_len=8, max_len=DOC_MAXLEN, seed=seed + 2,
        n_topics=CERT_PASSAGES // PASSAGES_PER_TOPIC, n_concepts=CERT_PASSAGES)
    qset_c = eval_qrels.synthetic_query_set(docs_c, topics_c, CERT_QUERIES, q_len=NQ,
                                            seed=seed + 3)
    idx_c = build.build_index_streaming(docs_c, nbits=NBITS, seed=seed, device=dev)
    del docs_c
    n, K, L = idx_c.num_passages, idx_c.num_centroids, idx_c.doc_maxlen
    walk_slots = NQ * K * idx_c.ivf_list_cap  # one query's IVF walk at nprobe = K
    qbatch = eval_sweep.lossless_query_batch(idx_c, NQ, CERT_QUERIES)
    n3 = max(n // 4, 10)
    sizes = dict(
        passages=n, tokens=idx_c.num_tokens, centroids=K, ivf_list_cap=idx_c.ivf_list_cap,
        queries=CERT_QUERIES, query_batch=qbatch,
        walk_pids_bytes_all_queries=CERT_QUERIES * walk_slots * 4,
        walk_pids_bytes_a_batch=qbatch * walk_slots * 4,
        stage2_blocks_bytes_a_batch=qbatch * n * L * 5,  # codes i32 + valid
        stage4_blocks_bytes_a_batch=qbatch * n3 * L * (idx_c.residuals.shape[1] + 5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    records, failures = eval_sweep.certify_backends(idx_c, qset_c)
    torch.cuda.synchronize()
    sizes["peak_device_bytes_above_resident"] = torch.cuda.max_memory_allocated() - base
    emit({"certify": [dict(variant=r["variant"], backend=r["backend"],
                           recall_at_10=r["metrics"]["recall@10"], delta=r["delta"],
                           passed=r["passed"]) for r in records]})
    assert not failures, failures
    variants = {r["variant"] for r in records}
    want = {"baseline-exact-f32", "plaid-cuda", "vanilla", "plaid-fused",
            "plaid-stage1-bf16", "plaid-stage1-int8"}
    assert want <= variants, variants
    assert all(abs(r["delta"]) <= eval_sweep.CERT_TOLERANCE for r in records), records
    # recall@10 alone would pass a kernel that reorders the top 10 or gets a
    # score wrong: at lossless caps every PLAID variant ranks as the exact
    # baseline does, and vanilla as its plain version on the same batches
    by = {r["variant"]: r for r in records}
    base, score_err = by["baseline-exact-f32"], {}
    for v in ("plaid-cuda", "plaid-fused", "plaid-stage1-bf16", "plaid-stage1-int8"):
        assert np.array_equal(by[v]["pids"], base["pids"]), f"certify: {v} pids differ from the baseline's"
        score_err[v] = float(np.abs(by[v]["scores"] - base["scores"]).max())
    lossless = eval_sweep.lossless_params(idx_c)
    plain = vanilla.VanillaEngine(idx_c, vanilla.VanillaParams(
        k=lossless.k, nprobe=lossless.nprobe, ncandidates=idx_c.num_tokens,
        ndocs_cap=lossless.ndocs, impl="ref"))
    qs_c = np.asarray(qset_c.queries, np.float32)
    want = [plain.search_batch(qs_c[i:i + qbatch]) for i in range(0, CERT_QUERIES, qbatch)]
    want_p = np.concatenate([p.cpu().numpy() for _, p in want])
    want_s = np.concatenate([s.cpu().numpy() for s, _ in want])
    assert np.array_equal(by["vanilla"]["pids"], want_p), "certify: vanilla pids differ from impl='ref'"
    score_err["vanilla_vs_ref"] = float(np.abs(by["vanilla"]["scores"] - want_s).max())
    assert all(e <= CERT_SCORE_ATOL for e in score_err.values()), score_err
    info["certify"] = dict(sizes, variants=len(records), passed=True,
                           pids_identical=True, max_abs_score_err=score_err,
                           seconds=time.perf_counter() - t0)


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
        for (a, b), name in zip(pairs, ("K1", "K2", "K3")):  # the shared-order contract
            assert torch.equal(a, b), (name, nbits, nq)
    return out


if __name__ == "__main__":
    sys.exit(main())
