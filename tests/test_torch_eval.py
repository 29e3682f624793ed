"""Port vs reference: the retrieval-quality harness (``repro_torch.eval``
and ``repro_torch.exec.bucketed`` against ``repro.eval`` and
``repro.exec.bucketed``): metric pins, qrels sources, the bucketed-cap
engine's identity, the sweep's records and the lossless-caps
certification of every port backend.

The metrics must give the reference's float64 results exactly on the same
ranklists, including the over-count on a ranklist that repeats a
relevant pid, which both packages share.  Both engines search one index:
the reference's ``build_index`` output, carried across with
``index_from_numpy``.  The ``gpu`` case holds a sweep with
``impl="cuda"`` against ``impl="ref"`` on the card.
"""
import dataclasses
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    from repro.core import index as ri
    from repro.core import pipeline as rp
    from repro.core import plaid as rplaid
    from repro.data import synthetic as rsyn
    from repro.eval import metrics as RM
    from repro.eval import qrels as rqrels
    from repro.eval import sweep as rsweep
    from repro.exec.bucketed import BucketedCapEngine as RefEngine
except ImportError:
    ri = None

from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.eval import metrics as M  # noqa: E402
from repro_torch.eval.qrels import QuerySet, load_trec_qrels, synthetic_query_set  # noqa: E402
from repro_torch.eval.sweep import (  # noqa: E402
    T_CS_OFF,
    GridPoint,
    certify_backends,
    default_grid,
    pareto_frontier,
    sweep_quality,
)
from repro_torch.exec.bucketed import BucketedCapEngine  # noqa: E402
from repro_torch.exec.segments import pow2_bucket  # noqa: E402

# hand-checkable two-query fixture: q0 judges pids {3, 2} relevant (ranked
# hits at ranks 0 and 2, one pad slot), q1 judges only pid 9 (never
# retrieved)
RANKED = np.array([[3, 1, 2, -1], [5, 6, 7, 8]])
QRELS = [{3: 1.0, 2: 1.0}, {9: 2.0}]
METRIC_FNS = ("recall_at_k", "success_at_k", "mrr_at_k", "ndcg_at_k")


@pytest.fixture
def reference():
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")


def _same_as_reference(ranked, qrels, ks) -> dict:
    """The port's compute_metrics, asserted equal to the reference's (exact
    float64, NaN where the reference gives NaN)."""
    got = M.compute_metrics(ranked, qrels, ks)
    if ri is not None:
        want = RM.compute_metrics(np.asarray(ranked), qrels, ks)
        assert list(got) == list(want)
        for key, w in want.items():
            assert (math.isnan(w) and math.isnan(got[key])) or got[key] == w, key
    return got


# --------------------------------------------------------------------------
# metric pins (hand-computed), each equal to the reference's
# --------------------------------------------------------------------------
def test_recall_pins():
    assert M.recall_at_k(RANKED, QRELS, 1) == pytest.approx(0.25)
    assert M.recall_at_k(RANKED, QRELS, 4) == pytest.approx(0.5)
    _same_as_reference(RANKED, QRELS, (1, 4))


def test_mrr_success_pins():
    assert M.mrr_at_k(RANKED, QRELS, 4) == pytest.approx(0.5)
    assert M.success_at_k(RANKED, QRELS, 2) == pytest.approx(0.5)
    _same_as_reference(RANKED, QRELS, (2, 4))


def test_ndcg_pin():
    # q0: DCG = 1/log2(2) + 1/log2(4) = 1.5; ideal = 1 + 1/log2(3); q1: 0
    expect = 0.5 * 1.5 / (1.0 + 1.0 / math.log2(3.0))
    assert M.ndcg_at_k(RANKED, QRELS, 4) == pytest.approx(expect, abs=1e-9)
    _same_as_reference(RANKED, QRELS, (4,))


def test_perfect_ranking_scores_one():
    ranked = np.array([[7, 4, -1]])
    qrels = [{7: 3.0, 4: 1.0}]
    for name in METRIC_FNS:
        assert getattr(M, name)(ranked, qrels, 3) == pytest.approx(1.0)
    _same_as_reference(ranked, qrels, (3,))


def test_unjudged_queries_excluded_from_mean():
    # q1 carries no judged-relevant pid: it must not deflate the mean
    assert M.recall_at_k(np.array([[3, -1], [5, 6]]), [{3: 1.0}, {}], 2) == pytest.approx(1.0)
    assert math.isnan(M.recall_at_k(np.array([[5, 6]]), [{}], 2))
    _same_as_reference(np.array([[5, 6]]), [{}], (2,))


def test_pad_pid_never_matches():
    # -1 pads must not match a (bogus) -1 judgment
    assert M.recall_at_k(np.array([[-1, -1]]), [{-1: 1.0, 3: 1.0}], 2) == 0.0


def test_repeated_relevant_pid_over_counts_as_the_reference_does():
    """A shared fault, pinned: a ranklist that repeats a relevant pid counts
    it at every rank, so recall exceeds 1.  The port keeps the reference's
    answer (the engines never emit a repeated pid)."""
    ranked = np.array([[0] * 7] * 3)
    qrels = [{}, {}, {0: 1.0}]
    assert M.recall_at_k(ranked, qrels, k=2) == 2.0
    got = _same_as_reference(ranked, qrels, (1, 2, 7))
    assert got["recall@7"] == 7.0


def test_compute_metrics_keys_and_shallow_saturation():
    out = _same_as_reference(RANKED, QRELS, (1, 100))
    assert set(out) == {
        f"{m}@{k}" for m in ("recall", "success", "mrr", "ndcg") for k in (1, 100)
    }
    # cutoff deeper than the list saturates at list depth (trec_eval)
    assert out["recall@100"] == pytest.approx(M.recall_at_k(RANKED, QRELS, 4))


def test_metrics_take_tensors():
    got = M.compute_metrics(torch.from_numpy(RANKED), QRELS, (1, 4))
    assert got == M.compute_metrics(RANKED, QRELS, (1, 4))


def test_relevance_gains_validates_shapes():
    with pytest.raises(ValueError, match="Q, depth"):
        M.relevance_gains(np.array([1, 2, 3]), [{}])
    with pytest.raises(ValueError, match="qrels entries"):
        M.relevance_gains(RANKED, [{}])


@st.composite
def _ranked_and_qrels(draw):
    nq = draw(st.integers(1, 4))
    depth = draw(st.integers(1, 8))
    ranked = draw(
        st.lists(
            st.lists(st.integers(-1, 15), min_size=depth, max_size=depth),
            min_size=nq, max_size=nq,
        )
    )
    qrels = [
        draw(st.dictionaries(st.integers(0, 15), st.floats(0.5, 3.0), max_size=6))
        for _ in range(nq)
    ]
    return np.asarray(ranked), qrels


@given(_ranked_and_qrels(), st.integers(1, 8))
@settings(max_examples=60, deadline=None, database=None)
def test_metrics_equal_reference_and_truncation_monotone(rq, k):
    """On every drawn input the port gives the reference's answer (NaN
    where it gives NaN, and the same over-count on repeated pids).  Where
    the ranklist repeats no pid, deeper cutoffs never lose recall/success
    and every metric stays inside [0, 1]."""
    ranked, qrels = rq
    _same_as_reference(ranked, qrels, (k, k + 1))
    if not any(any(g > 0 for g in r.values()) for r in qrels):
        return  # all-unjudged: metrics are NaN by convention
    if any(len(set(row[row >= 0])) < (row >= 0).sum() for row in ranked):
        return  # repeated pids over-count (the shared fault pinned above)
    for name in METRIC_FNS:
        fn = getattr(M, name)
        a, b = fn(ranked, qrels, k), fn(ranked, qrels, k + 1)
        assert 0.0 <= a <= 1.0 + 1e-12 and 0.0 <= b <= 1.0 + 1e-12
        if name in ("recall_at_k", "success_at_k"):
            assert b >= a - 1e-12


# --------------------------------------------------------------------------
# qrels sources
# --------------------------------------------------------------------------
def test_synthetic_corpus_and_query_set_equal_the_reference(reference):
    """One seed gives the reference's arrays and judgments."""
    docs, topics = tsyn.embedding_corpus(40, dim=16, seed=0, n_topics=4)
    rdocs, rtopics = rsyn.embedding_corpus(40, dim=16, seed=0, n_topics=4)
    assert len(docs) == len(rdocs)
    for a, b in zip(docs, rdocs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(topics, rtopics)
    a = synthetic_query_set(docs, topics, 6, seed=1)
    b = synthetic_query_set(docs, topics, 6, seed=1)
    want = rqrels.synthetic_query_set(rdocs, rtopics, 6, seed=1)
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(a.queries, want.queries)
    assert a.queries.dtype == want.queries.dtype == np.float32
    assert a.qrels == b.qrels == want.qrels
    for rel in a.qrels:
        gains = set(rel.values())
        assert 2.0 in gains  # the gold source doc
        assert gains <= {1.0, 2.0}
    q, gold = tsyn.queries_from_docs(docs, 5, q_len=3, seed=4)
    rq, rgold = rsyn.queries_from_docs(rdocs, 5, q_len=3, seed=4)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(gold, rgold)


def test_query_set_alignment_validated():
    with pytest.raises(ValueError, match="qrels"):
        QuerySet(np.zeros((3, 2, 4), np.float32), [{}, {}])


TREC_TEXT = (
    "# comment line\n"
    "q1 0 17 2\n"          # 4-col TREC
    "q1 23 1\n"            # 3-col
    "q2 5\n"               # 2-col MS MARCO (implicit rel 1)
    "q2 0 9 0\n"           # explicit non-relevance: dropped
    "q3 0 4 -1  # trailing comment\n"
    "\n"
)


def test_trec_loader_layouts(tmp_path):
    p = tmp_path / "qrels.txt"
    p.write_text(TREC_TEXT)
    out = load_trec_qrels(str(p))
    assert out == {"q1": {17: 2.0, 23: 1.0}, "q2": {5: 1.0}}
    if ri is not None:
        assert out == rqrels.load_trec_qrels(str(p))
    from repro_torch.eval.qrels import trec_query_set

    qs = trec_query_set(np.zeros((3, 2, 4)), ["q2", "q9", "q1"], out)
    assert qs.qrels == [{5: 1.0}, {}, {17: 2.0, 23: 1.0}] and qs.queries.dtype == np.float32
    with pytest.raises(ValueError, match="qids"):
        trec_query_set(np.zeros((3, 2, 4)), ["q1"], out)


def test_trec_loader_rejects_garbage(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("q1 0 17 2 extra-column\n")
    with pytest.raises(ValueError, match="bad.txt:1"):
        load_trec_qrels(str(p))


# --------------------------------------------------------------------------
# bucketed-cap engine and the sweep, against the reference's
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def harness():
    """The reference's harness: 96 docs at dim 32, 8 topics, 8 queries; the
    reference index and the port's copy of it on the CPU."""
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, topics = tsyn.embedding_corpus(96, dim=32, seed=0, n_topics=8)
    ref = ri.build_index(docs, nbits=2, kmeans_iters=3, seed=0)
    arrays = {f: np.asarray(getattr(ref, f)) for f in ti.ARRAY_FIELDS}
    static = {f: getattr(ref, f) for f in ti.STATIC_FIELDS}
    port = ti.index_from_numpy(arrays, static, "cpu")
    qset = synthetic_query_set(docs, topics, 8, seed=1)
    return docs, topics, ref, port, qset


@pytest.fixture(scope="module")
def ref_sweep(harness):
    """The reference's sweep over its default grid (records, engine)."""
    _, _, ref, _, qset = harness
    return rsweep.sweep_quality(ref, qset, measure_latency=False)


def test_bucketed_matches_static_program_at_requested_caps(harness):
    """The masked bucket's rank prefix equals a static program at the
    requested (non-pow2) caps, and the reference engine's pids."""
    _, _, ref, idx, qset = harness
    n = idx.num_passages
    params = tplaid.SearchParams(k=10, candidate_cap=n, score_dtype="float32")
    engine = BucketedCapEngine(idx, params)
    ref_engine = RefEngine(ref, rplaid.SearchParams(k=10, candidate_cap=n))
    qs = np.asarray(qset.queries, np.float32)
    masks = torch.ones(qs.shape[:2])
    for nprobe, ndocs in [(3, 3 * n // 8), (1, 10), (idx.num_centroids, n)]:
        _, pids_b = engine.search_batch(qs, None, 0.3, nprobe=nprobe, ndocs=ndocs)
        np_eff, nd_eff = engine.effective_caps(nprobe, ndocs)
        assert (np_eff, nd_eff) == ref_engine.effective_caps(nprobe, ndocs)
        assert engine.bucket(nprobe, ndocs) == ref_engine.bucket(nprobe, ndocs)
        static = dataclasses.replace(engine.base_params, nprobe=np_eff, ndocs=nd_eff)
        _, pids_s = tp.run_pipeline(idx, torch.from_numpy(qs), masks, 0.3, static)
        k_live = min(10, nd_eff)
        assert torch.equal(pids_b[:, :k_live], pids_s[:, :k_live])
        _, want = ref_engine.search_batch(qs, None, 0.3, nprobe=nprobe, ndocs=ndocs)
        np.testing.assert_array_equal(pids_b.numpy(), np.asarray(want))
        # and against the reference's static program at the requested caps
        rstatic = dataclasses.replace(ref_engine.base_params, nprobe=np_eff, ndocs=nd_eff)
        _, rpids = rp.run_pipeline(ref, qs, np.ones(qs.shape[:2], np.float32), 0.3, rstatic)
        np.testing.assert_array_equal(pids_s[:, :k_live].numpy(), np.asarray(rpids)[:, :k_live])
    assert engine.retraces_within_bucket == 0 and tp.trace_count() == 0


def test_pow2_bucket_rule():
    assert [pow2_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [1, 1, 2, 4, 8, 8, 16]
    assert pow2_bucket(3, lo=8) == 8
    assert pow2_bucket(100, hi=96) == 96  # a non-pow2 ceiling is a bucket


def test_default_grid_equals_the_reference(harness):
    _, _, ref, idx, _ = harness
    assert default_grid(idx) == [
        GridPoint(p.t_cs, p.nprobe, p.ndocs) for p in rsweep.default_grid(ref)
    ]
    assert len(default_grid(idx)) == 48


def test_sweep_records_equal_the_reference(harness, ref_sweep):
    """The same buckets, the same deterministic work, recall within 1e-12
    (every metric in fact equal), and the launch-shape bound."""
    _, _, _, idx, qset = harness
    records, engine = sweep_quality(idx, qset, measure_latency=False, device="cpu")
    want, ref_engine = ref_sweep
    assert engine.retraces_within_bucket == 0
    assert len(records) == len(want) == 48
    for r, w in zip(records, want):
        assert r.case == w.case
        assert (r.bucket_nprobe, r.bucket_ndocs) == (w.bucket_nprobe, w.bucket_ndocs)
        assert r.work == w.work, r.case
        assert abs(r.metrics["recall@10"] - w.metrics["recall@10"]) <= 1e-12, r.case
        assert r.metrics == w.metrics, r.case
        assert r.pids.shape[0] == qset.n_queries and r.funnel["gathered_tokens"].shape == (8,)
        assert set(r.as_dict()) == set(w.as_dict())
    buckets = {engine.bucket(r.nprobe, r.ndocs) for r in records}
    assert engine.n_programs == ref_engine.n_programs <= len(buckets) + 1
    assert len(records) > len(buckets)  # the grid genuinely shares programs
    for r in records:
        assert r.work > 0
        assert 0.0 <= r.metrics["recall@10"] <= 1.0


def test_pareto_frontier_properties(harness, ref_sweep):
    _, _, _, idx, qset = harness
    records, _ = sweep_quality(idx, qset, measure_latency=False)
    frontier = pareto_frontier(records, metric="recall@10")
    assert frontier  # non-empty
    # sorted by work, strictly improving quality along the frontier
    works = [r.work for r in frontier]
    quals = [r.metrics["recall@10"] for r in frontier]
    assert works == sorted(works)
    assert all(b > a for a, b in zip(quals, quals[1:]))
    # no record dominates a frontier point
    for f in frontier:
        assert not any(
            r.work <= f.work and r.metrics["recall@10"] > quals[-1] for r in records
        )
    assert all(r.on_frontier == (r in frontier) for r in records)
    want = rsweep.pareto_frontier(ref_sweep[0], metric="recall@10")
    assert [r.case for r in frontier] == [w.case for w in want]


def test_grid_point_case_names():
    assert GridPoint(T_CS_OFF, 2, 48).case == "toff_p2_d48"
    assert GridPoint(0.45, 8, 96).case == "t0.45_p8_d96"


# --------------------------------------------------------------------------
# lossless-caps certification: every port backend and variant identical to
# the exact f32 baseline, and to the reference's records
# --------------------------------------------------------------------------
@pytest.mark.slow
def test_all_backends_certify_at_lossless_caps(harness):
    docs, _, ref, idx, qset = harness
    records, failures = certify_backends(idx, qset, device="cpu")
    assert failures == []
    from repro_torch import retrieval

    variants = {r["variant"] for r in records}
    assert set(retrieval.list_backends()) - {"plaid"} <= variants
    assert {"baseline-exact-f32", "plaid-cuda", "vanilla", "plaid-fused",
            "plaid-stage1-bf16", "plaid-stage1-int8"} <= variants
    for r in records:
        assert r["passed"], r
        assert abs(r["delta"]) <= 1e-6, r
    _assert_rankings_certified(idx, qset, records)
    want, want_failures = rsweep.certify_backends(ref, qset, backends=["vanilla"])
    assert want_failures == []
    got = {r["variant"]: r for r in records}
    for w in want:
        assert got[w["variant"]]["metrics"] == w["metrics"], w["variant"]
    # a walk budget of three queries a batch gives the same records
    from repro_torch.eval import sweep as tsweep

    nq = qset.queries.shape[1]
    walk = nq * idx.num_centroids * idx.ivf_list_cap
    assert tsweep.lossless_query_batch(idx, nq, 8) == 8
    budget = tsweep.LOSSLESS_WALK_SLOTS
    tsweep.LOSSLESS_WALK_SLOTS = 3 * walk
    try:
        assert tsweep.lossless_query_batch(idx, nq, 8) == 3
        batched, _ = certify_backends(idx, qset)
    finally:
        tsweep.LOSSLESS_WALK_SLOTS = budget
    assert [r["metrics"] for r in batched] == [r["metrics"] for r in records]
    for b, r in zip(batched, records):
        np.testing.assert_array_equal(b["pids"], r["pids"], err_msg=r["variant"])
        np.testing.assert_array_equal(b["scores"], r["scores"], err_msg=r["variant"])


def _assert_rankings_certified(idx, qset, records, atol=1e-5):
    """At lossless caps every PLAID variant ranks as the exact baseline does
    (recall alone would pass a reordered or misscored top k), and
    ``vanilla`` as its plain version."""
    from repro_torch.core import vanilla
    from repro_torch.eval import sweep as tsweep

    by = {r["variant"]: r for r in records}
    base = by["baseline-exact-f32"]
    for v in ("plaid-cuda", "plaid-fused", "plaid-stage1-bf16", "plaid-stage1-int8"):
        np.testing.assert_array_equal(by[v]["pids"], base["pids"], err_msg=v)
        np.testing.assert_allclose(by[v]["scores"], base["scores"], rtol=0, atol=atol, err_msg=v)
    p = tsweep.lossless_params(idx)
    plain = vanilla.VanillaEngine(idx, vanilla.VanillaParams(
        k=p.k, nprobe=p.nprobe, ncandidates=idx.num_tokens, ndocs_cap=p.ndocs, impl="ref"))
    want_s, want_p = plain.search_batch(np.asarray(qset.queries, np.float32))
    np.testing.assert_array_equal(by["vanilla"]["pids"], want_p.cpu().numpy())
    np.testing.assert_allclose(by["vanilla"]["scores"], want_s.cpu().numpy(), rtol=0, atol=atol)


def test_certify_refuses_the_live_delta_variant(harness):
    docs, _, _, idx, qset = harness
    with pytest.raises(NotImplementedError, match="repro_torch.live"):
        certify_backends(idx, qset, docs=docs)


@pytest.mark.gpu
def test_sweep_cuda_equals_ref_on_card():
    """On the card, a sweep through K1-K3 at every bucket shape gives the
    plain versions' pids and funnel counts at every point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core.index import build_index

    docs, topics = tsyn.embedding_corpus(300, dim=64, min_len=6, max_len=40, seed=1)
    idx = build_index(docs, nbits=2, kmeans_iters=3, device="cuda")
    qset = synthetic_query_set(docs, topics, 12, q_len=16, seed=2)
    got, eng = sweep_quality(idx, qset, impl="cuda", measure_latency=False)
    want, _ = sweep_quality(idx, qset, impl="ref", measure_latency=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pids, w.pids, err_msg=g.case)
        for field, v in w.funnel.items():
            np.testing.assert_array_equal(g.funnel[field], v, err_msg=f"{g.case}/{field}")
        assert g.work == w.work and g.metrics == w.metrics
    records, failures = certify_backends(idx, qset)
    assert failures == [], failures
    _assert_rankings_certified(idx, qset, records)
