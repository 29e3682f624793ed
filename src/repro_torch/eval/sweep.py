"""Latency/quality Pareto sweeps + lossless-caps backend certification (the
counterpart of ``repro.eval.sweep``).

Reproduces the PLAID reproducibility study's analysis (MacAvaney &
Tonellotto 2024): the t_cs × nprobe × ndocs surface forms a Pareto
frontier, and naive settings fall off it.  The sweep runs the whole grid
through :class:`repro_torch.exec.bucketed.BucketedCapEngine`, so the
nprobe/ndocs points run at one launch shape per pow2 cap bucket.

Each grid point yields a :class:`SweepRecord` with the full metric dict
(``repro_torch.eval.metrics``), measured wall-clock latency, and a
DETERMINISTIC ``work`` score computed from the funnel counts
(:class:`repro_torch.obs.funnel.FunnelStats`): a pure function of (corpus,
queries, grid point), equal to the reference's for the same index and
queries, while latency is informational.  The port's records also keep
each point's ranked pids and funnel counts as host arrays, so two sweeps
(``impl="cuda"`` against ``impl="ref"``) can be held against each other.

:func:`certify_backends` is the second half: at LOSSLESS caps (nprobe =
num_centroids, t_cs = -inf, ndocs/candidate_cap >= corpus) every shipped
approximation must reproduce the exact float32 ``plaid`` baseline's
metrics to within 1e-6.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.eval.metrics import DEFAULT_KS, compute_metrics
from repro_torch.eval.qrels import QuerySet

#: "minus infinity" pruning threshold (keeps every centroid; matches the
#: lossless-caps convention the rank-identity tests use)
T_CS_OFF = -1e9

#: recall@k tolerance for the certification gate
CERT_TOLERANCE = 1e-6

#: (query, token, probe, list slot) entries of one certification batch's
#: IVF walk: at nprobe = K a query's walk holds nq x K x ivf_list_cap pids
#: (and over ten times as many bytes in transient indices and sort keys),
#: so a large index is certified a few queries at a time
LOSSLESS_WALK_SLOTS = 1 << 28

#: the backend the param-level variants (fused tail, bf16 / int8 stage 1)
#: run through.  The reference uses its plain ``plaid``; the port uses
#: ``plaid-cuda``, so that on the card each variant runs the kernels it
#: exists for (the fused variant is K3's path); on CPU tensors
#: ``plaid-cuda`` runs the plain versions and ranks as ``plaid`` does.
VARIANT_BACKEND = "plaid-cuda"


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One sweep setting: ``t_cs`` per call; the caps are bucket-mapped."""

    t_cs: float
    nprobe: int
    ndocs: int

    @property
    def case(self) -> str:
        t = "off" if self.t_cs <= T_CS_OFF else f"{self.t_cs:g}"
        return f"t{t}_p{self.nprobe}_d{self.ndocs}"


@dataclasses.dataclass
class SweepRecord:
    """Per-point sweep output: setting, cost axes, quality metrics."""

    t_cs: float
    nprobe: int
    ndocs: int
    bucket_nprobe: int
    bucket_ndocs: int
    work: float  # deterministic analytic funnel work (the gated axis)
    latency_ms: float  # measured wall-clock (informational only)
    metrics: dict  # {"recall@10": ..., "mrr@10": ..., ...}
    on_frontier: bool = False
    pids: np.ndarray | None = dataclasses.field(default=None, repr=False)
    funnel: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def case(self) -> str:
        return GridPoint(self.t_cs, self.nprobe, self.ndocs).case

    def as_dict(self) -> dict:
        d = dict(
            t_cs=self.t_cs,
            nprobe=self.nprobe,
            ndocs=self.ndocs,
            bucket_nprobe=self.bucket_nprobe,
            bucket_ndocs=self.bucket_ndocs,
            work=self.work,
            latency_ms=self.latency_ms,
            on_frontier=self.on_frontier,
        )
        d.update({k.replace("@", "_at_"): v for k, v in self.metrics.items()})
        return d


def work_score(funnel_stats, index, nq: int) -> float:
    """Deterministic per-query work: analytic funnel arithmetic.

    ``stage-1`` one C·Qᵀ product (K·d·nq MACs) + ``stage 2-3`` score-matrix
    lookups over every gathered candidate token (2 interaction passes ×
    gathered_tokens × nq) + ``stage 4`` exact rescore of the survivors'
    padded token blocks (survivors × doc_maxlen × d × nq MACs).
    """
    gathered = float(np.mean(np.asarray(funnel_stats.gathered_tokens.cpu())))
    survivors = float(np.mean(np.asarray(funnel_stats.stage3_survivors.cpu())))
    stage1 = index.num_centroids * index.dim * nq
    stage23 = 2.0 * gathered * nq
    stage4 = survivors * index.doc_maxlen * index.dim * nq
    return float(stage1 + stage23 + stage4)


def default_grid(index, k: int = 10) -> list[GridPoint]:
    """A small t_cs × nprobe × ndocs grid scaled to the index.

    Includes non-pow2 cap values so the bucket masking is exercised, and a
    lossless corner (t_cs off, max caps) that anchors the frontier's
    quality ceiling.
    """
    K = index.num_centroids
    n = index.num_passages
    nprobes = sorted({1, min(2, K), min(3, K), min(8, K)})
    ndocs = sorted(
        {
            max(k, n // 8),
            max(k, (3 * n) // 8),  # non-pow2 on purpose
            min(n, max(4 * k, n // 2)),
            n,
        }
    )
    t_css = (T_CS_OFF, 0.25, 0.45)
    return [
        GridPoint(t, p, d) for t in t_css for p in nprobes for d in ndocs
    ]


def _on(index, device):
    """``index`` on ``device`` (``None``: where it already is)."""
    return index if device is None else index.to(resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep_quality(
    index,
    query_set: QuerySet,
    *,
    k: int = 10,
    grid: list[GridPoint] | None = None,
    ks=DEFAULT_KS,
    impl: str = "ref",
    measure_latency: bool = True,
    device=None,
) -> tuple[list[SweepRecord], "BucketedCapEngine"]:
    """Run the grid through the bucketed engine -> per-point records.

    Runs on ``device`` (the index is moved there), or where the index lies
    when ``device`` is ``None``.  ``impl="cuda"`` runs the Hopper kernels
    (their plain versions for a CPU index).  Returns ``(records, engine)``;
    ``engine.n_programs`` counts the distinct launch shapes of the grid.
    """
    from repro_torch.core import plaid
    from repro_torch.exec.bucketed import BucketedCapEngine
    from repro_torch.obs import funnel as funnel_mod

    index = _on(index, device)
    if grid is None:
        grid = default_grid(index, k)
    params = plaid.SearchParams(
        k=k,
        candidate_cap=index.num_passages,
        impl=impl,
        score_dtype="float32",
    )
    engine = BucketedCapEngine(index, params)
    qs = np.asarray(query_set.queries, np.float32)
    nq = qs.shape[1]
    records = []
    for point in grid:
        _, pids, fstats = engine.search_batch(
            qs, None, point.t_cs, nprobe=point.nprobe, ndocs=point.ndocs,
            funnel=True,
        )
        pids = pids.cpu().numpy()
        metrics = compute_metrics(pids, query_set.qrels, ks)
        latency_ms = float("nan")
        if measure_latency:
            _sync(index.device)
            t0 = time.perf_counter()
            out2 = engine.search_batch(
                qs, None, point.t_cs, nprobe=point.nprobe,
                ndocs=point.ndocs, funnel=True,
            )
            _sync(out2[1].device)
            latency_ms = (time.perf_counter() - t0) * 1e3 / qs.shape[0]
        np_b, nd_b = engine.bucket(point.nprobe, point.ndocs)
        records.append(
            SweepRecord(
                t_cs=point.t_cs,
                nprobe=point.nprobe,
                ndocs=point.ndocs,
                bucket_nprobe=np_b,
                bucket_ndocs=nd_b,
                work=work_score(fstats, index, nq),
                latency_ms=latency_ms,
                metrics=metrics,
                pids=pids,
                funnel=funnel_mod.to_host(fstats),
            )
        )
    engine.assert_zero_retrace_within_bucket()
    return records, engine


def pareto_frontier(
    records: list[SweepRecord],
    *,
    metric: str = "recall@10",
) -> list[SweepRecord]:
    """Mark + return the (work, metric) Pareto frontier of a sweep.

    A record is on the frontier iff no other record has <= its work AND
    > its quality (less work at strictly better quality dominates; equal
    work keeps only the best quality).  Returned sorted by work
    ascending; every record's ``on_frontier`` flag is set in place.
    """
    for r in records:
        r.on_frontier = False
    by_work = sorted(records, key=lambda r: (r.work, -r.metrics[metric]))
    frontier: list[SweepRecord] = []
    best = -np.inf
    for r in by_work:
        q = r.metrics[metric]
        if q > best:
            r.on_frontier = True
            frontier.append(r)
            best = q
    return frontier


# --------------------------------------------------------------------------
# lossless-caps certification of every shipped approximation
# --------------------------------------------------------------------------
def lossless_params(index, k: int = 10, **overrides):
    """Facade SearchParams at lossless caps for ``index``: every candidate
    survives every stage, so stage-4's exact MaxSim fully determines the
    ranking and any two correct engines must agree."""
    from repro_torch import retrieval

    n = index.num_passages
    return retrieval.SearchParams(
        k=k,
        nprobe=index.num_centroids,
        t_cs=T_CS_OFF,
        ndocs=n,
        candidate_cap=n,
        **overrides,
    )


def lossless_query_batch(index, nq: int, n_queries: int) -> int:
    """Queries a certification batch holds: as many as keep its lossless IVF
    walk within :data:`LOSSLESS_WALK_SLOTS` (at least one)."""
    walk = nq * index.num_centroids * index.ivf_list_cap
    return max(1, min(n_queries, LOSSLESS_WALK_SLOTS // walk))


def _ranked(retriever, qs, step: int) -> tuple[np.ndarray, np.ndarray]:
    """(pids, scores) of every query as host arrays, ``step`` at a time."""
    outs = [retriever.search_batch(qs[i : i + step]) for i in range(0, qs.shape[0], step)]
    return (
        np.concatenate([o.pids.cpu().numpy() for o in outs]),
        np.concatenate([o.scores.float().cpu().numpy() for o in outs]),
    )


def certify_backends(
    index,
    query_set: QuerySet,
    *,
    docs=None,
    k: int = 10,
    ks=DEFAULT_KS,
    threshold: float = CERT_TOLERANCE,
    backends: list[str] | None = None,
    device=None,
) -> tuple[list[dict], list[str]]:
    """Certify every registered backend + approximation variant at lossless
    caps against the exact float32 ``plaid`` baseline.

    Variants: every registered backend name (``vanilla`` at a stage-1 cap
    of ``num_tokens``, its candidate unit being embeddings), plus the
    param-level approximations through :data:`VARIANT_BACKEND`
    (``fused``, ``stage1_dtype`` in bf16/int8).  Runs on ``device`` (the
    index is moved there), or where the index lies when ``device`` is
    ``None``.  Queries are searched :func:`lossless_query_batch` at a time.

    ``docs`` asks for the reference's ``live-delta`` variant (a
    frozen-centroid base plus an ingested delta segment), which needs the
    live index (``repro_torch.live``); it is not ported, so ``docs`` is
    refused.

    Returns ``(records, failures)``: one record per variant with its full
    metric dict and recall@k delta vs the baseline, and (port only) its
    ranked ``pids`` and ``scores`` as host arrays, so that a caller can hold
    a variant's ranking, not only its recall, against another; ``failures`` lists
    human-readable messages for any variant whose recall@k fell more than
    ``threshold`` below the baseline.
    """
    from repro_torch import retrieval

    if docs is not None:
        raise NotImplementedError(
            "certify_backends(docs=...): the live-delta variant needs the live "
            "index (repro_torch.live), which is not ported"
        )
    index = _on(index, device)
    qs = np.asarray(query_set.queries, np.float32)
    qrels = query_set.qrels
    base_params = lossless_params(index, k)
    key = f"recall@{k}"
    step = lossless_query_batch(index, qs.shape[1], qs.shape[0])

    baseline = retrieval.from_index(index, backend="plaid", params=base_params)
    base_pids, base_scores = _ranked(baseline, qs, step)
    base_metrics = compute_metrics(base_pids, qrels, ks)
    records = [
        dict(
            variant="baseline-exact-f32",
            backend="plaid",
            metrics=base_metrics,
            delta=0.0,
            passed=True,
            pids=base_pids,
            scores=base_scores,
        )
    ]
    failures: list[str] = []

    def check(variant: str, backend: str, retriever) -> None:
        pids, scores = _ranked(retriever, qs, step)
        metrics = compute_metrics(pids, qrels, ks)
        delta = metrics[key] - base_metrics[key]
        passed = delta >= -threshold
        records.append(
            dict(
                variant=variant, backend=backend, metrics=metrics,
                delta=float(delta), passed=bool(passed), pids=pids, scores=scores,
            )
        )
        if not passed:
            failures.append(
                f"{variant}: {key} {metrics[key]:.6f} is "
                f"{-delta:.2e} below the exact baseline "
                f"{base_metrics[key]:.6f} at lossless caps "
                f"(tolerance {threshold:g})"
            )

    names = backends if backends is not None else retrieval.list_backends()
    for name in names:
        if name == "plaid":
            continue  # the baseline itself
        params = base_params
        if name == "vanilla":
            # vanilla's candidate unit is EMBEDDINGS, not passages: its
            # lossless stage-1 bound is the token count
            params = dataclasses.replace(params, candidate_cap=index.num_tokens)
        check(name, name, retrieval.from_index(index, backend=name, params=params))

    # param-level approximations
    for variant, overrides in (
        ("plaid-fused", dict(fused=True)),
        ("plaid-stage1-bf16", dict(stage1_dtype="bfloat16")),
        ("plaid-stage1-int8", dict(stage1_dtype="int8")),
    ):
        check(variant, VARIANT_BACKEND, retrieval.from_index(
            index, backend=VARIANT_BACKEND,
            params=lossless_params(index, k, **overrides),
        ))

    return records, failures
