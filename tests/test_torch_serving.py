"""Port vs reference: the serving tier (``repro_torch.serving`` against
``repro.serving``).

Every test of ``tests/test_serving_tier.py`` has a case here under the
same name.  Where the reference drives its server through the gated
``StubRetriever``, the port's server is driven through the same stub
(admission, shedding, deadlines, shutdown, failure propagation, the
latency window, the future contract).  Where the reference serves its
``live_setup`` fixture, both packages' ``live`` backends are built here
from the SAME frozen tables — the centroids and codec of the reference's
``build_index`` passed in ``index=`` (the reference's trained
``retrieval.build`` raises ``ShardingTypeError`` under jax 0.9, which is
why its own fixture fails) — and the port's server must serve the
reference server's pids for the same requests, bucket by bucket, with
mixed ``t_cs`` and ``k``, from the cache and after mutations.  Scores are
held to relative 1e-5: the packages sum f32 products on different
backends (XLA on the CPU, PyTorch on the CPU).

Also mirrored: ``tests/test_live.py::test_server_concurrent_ingest_while_querying``
and ``::test_server_rejects_mutation_on_static_backend``,
``tests/test_serving_and_persistence.py::test_batching_server_returns_correct_results``
(the raw engine behind the server) and
``tests/test_tiered.py::test_server_surfaces_transfer_stats``.

``test_zero_retrace_*`` checks only the eager convention: the port traces
nothing, ``core.pipeline.trace_count()`` stays 0 and the server's
``retraces`` counter with it, so it shows that bucket reuse and knob
variation keep that convention and serve the right lanes, not a compile
discipline.

The ``gpu`` case (skipped without a card) serves ``plaid-cuda`` and holds
every bucket's lanes to a direct ``search_batch`` of the padded bucket,
with K1 launched twice and K2 once for every dispatch.
"""
import dataclasses
import queue as queue_mod
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference
    import jax.numpy as jnp

    from repro import retrieval as rret
    from repro.core import index as ri
    from repro.core import plaid as rplaid
    from repro.serving import ReplicaPool as RReplicaPool
    from repro.serving import buckets as rbuckets
    from repro.serving import server as rserver
    from repro.serving.cache import query_key as r_query_key
except ImportError:
    ri = None

from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.core import residual_codec as trc  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.live.backend import LiveRetriever  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.retrieval import SearchParams, SearchRequest  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionQueue,
    BatchingServer,
    DeadlineExceeded,
    LatencyWindow,
    QueueFull,
    ReplicaPool,
    ResultCache,
    ServerClosed,
    bucket_batch_size,
    bucket_ladder,
)
from repro_torch.serving import server as tserver  # noqa: E402
from repro_torch.serving.buckets import pad_batch  # noqa: E402
from repro_torch.serving.cache import query_key  # noqa: E402
from repro_torch.serving.server import ResultFuture, _Pending  # noqa: E402

DIM = 32
TOL = dict(rtol=1e-5, atol=1e-6)
LIVE_PARAMS = dict(k=5, nprobe=4, t_cs=0.4)
#: the schema dashboards scrape (tests/test_serving_tier.py:659-669)
STATS_KEYS = {
    "n", "window", "mean_ms", "p50_ms", "p99_ms",
    "submitted", "completed", "cache_hits", "expired", "errors",
    "dispatches", "retraces",
    "shed", "rejected", "pending", "buckets",
    "queue_depth", "outstanding", "cache",
}


# ---------------------------------------------------------------------------
# stubs: deterministic control over dispatch timing and failures
# ---------------------------------------------------------------------------
class StubRetriever:
    """A retriever whose dispatch the test can gate, fail, and observe (the
    reference's stub, with the port's ``SearchParams``)."""

    backend_name = "stub"

    def __init__(self, k=4, gated=False):
        self.params = SearchParams(k=k)
        self.fail_with = None
        self.calls = []  # (batch_size, t_cs vector copy, first-lane marker)
        self.entered = threading.Event()  # set when a dispatch starts
        self.gate = threading.Event()  # dispatch blocks until set
        if not gated:
            self.gate.set()

    def search_batch(self, qs, t_cs=None):
        self.entered.set()
        self.gate.wait(timeout=30)
        if self.fail_with is not None:
            raise self.fail_with
        qs = np.asarray(qs)
        B, k = qs.shape[0], self.params.k
        ts = None if t_cs is None else np.asarray(t_cs).copy()
        self.calls.append((B, ts, float(qs[0, 0, 0])))
        scores = np.tile(np.arange(k, 0, -1, np.float32), (B, 1))
        # pids encode the query so result->request routing is checkable
        pids = (qs[:, :1, :1].reshape(B, 1) + np.arange(k)).astype(np.int32)
        return scores, pids


def _stub_query(marker: float) -> np.ndarray:
    q = np.zeros((4, DIM), np.float32)
    q[:, 0] = marker
    return q


def _wait(predicate, timeout=10.0, msg="condition"):
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# fixtures: one corpus, both packages' live backends over the same tables
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus():
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, _ = syn.embedding_corpus(150, dim=DIM, seed=0)
    qs, _ = syn.queries_from_docs(docs, 8)
    mono = ri.build_index(docs, num_centroids=32, kmeans_iters=3)
    return docs, np.asarray(qs, np.float32), mono


def _live_pair(corpus, **params):
    """(port ``live`` retriever, reference ``live`` retriever), each from its
    own package's ``retrieval.build`` over the reference's frozen tables."""
    docs, _, mono = corpus
    p = dict(LIVE_PARAMS, **params)
    codec = trc.ResidualCodec(torch.tensor(np.asarray(mono.cutoffs)),
                              torch.tensor(np.asarray(mono.weights)), mono.nbits)
    t = tret.build(docs, backend="live", params=SearchParams(**p), device="cpu",
                   index=dict(centroids=np.array(mono.centroids), codec=codec))
    r = rret.build(docs, backend="live", params=rret.SearchParams(**p),
                   index=dict(centroids=mono.centroids, codec=mono.codec))
    return t, r


@pytest.fixture(scope="module")
def live_setup(corpus):
    """Read-only pair; tests that mutate build their own."""
    t, r = _live_pair(corpus)
    return t, r, corpus[1]


def _same(got, want):
    """A port result against a reference result (served or direct)."""
    np.testing.assert_array_equal(np.asarray(got.pids), np.asarray(want.pids))
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), **TOL)


def _pending(mod, q, t_cs, k):
    return mod._Pending(
        q=q, t_cs=t_cs, k=k, t0=time.perf_counter(), deadline=None,
        future=mod.ResultFuture(), cache_key=None,
    )


def _dispatch_both(tsrv, rsrv, qs, knobs):
    """One coalesced batch (request i: ``qs[i]`` at ``knobs[i] = (t_cs, k)``)
    through each server's ``_dispatch``; returns both result lists."""
    out = []
    for mod, srv in ((tserver, tsrv), (rserver, rsrv)):
        batch = [_pending(mod, qs[i], t, k) for i, (t, k) in enumerate(knobs)]
        srv._dispatch(batch)
        out.append([p.future.get(timeout=60) for p in batch])
    return out


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------
def test_bucket_batch_size_pow2_rounding():
    assert [bucket_batch_size(n, 16) for n in (1, 2, 3, 4, 5, 9, 16)] == [
        1, 2, 4, 4, 8, 16, 16,
    ]
    # max_batch_size is a terminal bucket even when not a power of two
    assert bucket_batch_size(11, 12) == 12
    with pytest.raises(ValueError):
        bucket_batch_size(0, 16)
    with pytest.raises(ValueError):
        bucket_batch_size(17, 16)
    if ri is not None:
        for cap in (1, 7, 12, 16, 32):
            for n in range(1, cap + 1):
                assert bucket_batch_size(n, cap) == rbuckets.bucket_batch_size(n, cap)


def test_bucket_ladder():
    assert bucket_ladder(16) == (1, 2, 4, 8, 16)
    assert bucket_ladder(12) == (1, 2, 4, 8, 12)
    assert bucket_ladder(1) == (1,)
    if ri is not None:
        for cap in range(1, 40):
            assert bucket_ladder(cap) == rbuckets.bucket_ladder(cap)


def test_pad_batch_replicates_last_lane():
    qs = [np.full((2, 3), i, np.float32) for i in range(3)]
    stacked, ts = pad_batch(qs, [0.1, 0.2, 0.3], 4)
    assert stacked.shape == (4, 2, 3) and ts.shape == (4,)
    assert ts.dtype == np.float32
    np.testing.assert_array_equal(stacked[3], stacked[2])
    assert ts[3] == np.float32(0.3)
    if ri is not None:
        want_q, want_t = rbuckets.pad_batch(qs, [0.1, 0.2, 0.3], 4)
        np.testing.assert_array_equal(stacked, want_q)
        np.testing.assert_array_equal(ts, want_t)


# ---------------------------------------------------------------------------
# bucketed dispatch (the port's live backend against the reference's)
# ---------------------------------------------------------------------------
def test_bucketed_dispatch_results_match_direct_search(live_setup):
    t, r, qs = live_setup
    tsrv = BatchingServer(t, batch_size=8, max_wait_ms=2.0, cache_size=None)
    rsrv = rserver.BatchingServer(r, batch_size=8, max_wait_ms=2.0, cache_size=None)
    try:
        # exact bucket control: hand _dispatch coalesced batches directly
        for n in (1, 3, 5):
            got, want = _dispatch_both(tsrv, rsrv, qs, [(0.4, 5)] * n)
            for i in range(n):
                _same(got[i], want[i])
                direct = t.search(qs[i], t_cs=0.4)
                np.testing.assert_array_equal(got[i].pids, direct.pids.numpy())
                _same(got[i], r.search(jnp.asarray(qs[i]), t_cs=0.4))
        st = tsrv.stats()
        assert st["buckets"] == {1: 1, 4: 1, 8: 1} == rsrv.stats()["buckets"]
        # a burst submitted through the public queue coalesces too
        futs = [tsrv.submit(qs[i]) for i in range(6)]
        for i, f in enumerate(futs):
            res = f.get(timeout=30)
            assert res.pids.shape == (5,)
            _same(res, r.search(jnp.asarray(qs[i])))
        assert sum(tsrv.stats()["buckets"].values()) > 3
    finally:
        tsrv.shutdown()
        rsrv.shutdown()


def test_zero_retrace_across_bucket_reuse_and_knob_variation(live_setup):
    """The eager convention (module docstring): warm buckets reused across
    a grid of per-request ``t_cs`` and ``k`` leave ``trace_count()`` and
    ``retraces`` at 0 — and every lane is the reference server's lane."""
    t, r, qs = live_setup
    tsrv = BatchingServer(t, batch_size=8, max_wait_ms=2.0, cache_size=None)
    rsrv = rserver.BatchingServer(r, batch_size=8, max_wait_ms=2.0, cache_size=None)
    try:
        for n in (1, 2, 4):
            tsrv._dispatch([_pending(tserver, qs[i], 0.4, 5) for i in range(n)])
        warm_traces = pipeline.trace_count()
        for n in (1, 2, 4):
            for t0 in (0.2, 0.45, 0.7):
                for k in (1, 3, 5):
                    knobs = [(t0 + 0.01 * i, k) for i in range(n)]
                    got, want = _dispatch_both(tsrv, rsrv, qs, knobs)
                    for g, w in zip(got, want):
                        assert g.pids.shape == (k,)
                        _same(g, w)
        assert pipeline.trace_count() == warm_traces == 0
        assert tsrv.stats()["retraces"] == 0
        tsrv.assert_zero_retrace()
    finally:
        tsrv.shutdown()
        rsrv.shutdown()


def test_per_request_t_cs_matches_per_request_direct_search(live_setup):
    t, r, qs = live_setup
    tsrv = BatchingServer(t, batch_size=8, max_wait_ms=2.0, cache_size=None)
    rsrv = rserver.BatchingServer(r, batch_size=8, max_wait_ms=2.0, cache_size=None)
    try:
        # one coalesced batch, three different thresholds
        knobs = [(0.2, 5), (0.5, 3), (0.8, 1)]
        got, want = _dispatch_both(tsrv, rsrv, qs, knobs)
        for i, (tc, k) in enumerate(knobs):
            res = got[i]
            direct = t.search(qs[i], t_cs=tc)
            assert res.k == k and res.t_cs == tc
            np.testing.assert_array_equal(res.pids, direct.pids.numpy()[:k])
            np.testing.assert_allclose(res.scores, direct.scores.numpy()[:k])
            _same(res, want[i])
    finally:
        tsrv.shutdown()
        rsrv.shutdown()


def test_per_request_k_validation():
    srv = BatchingServer(StubRetriever(k=4), batch_size=2, max_wait_ms=0.5)
    try:
        with pytest.raises(ValueError, match="exceeds the serving"):
            srv.submit(_stub_query(1.0), k=5)
        with pytest.raises(ValueError, match="k must be >= 1"):
            srv.submit(_stub_query(1.0), k=0)
        assert srv.search(_stub_query(1.0), k=2).pids.shape == (2,)
    finally:
        srv.shutdown()


def test_search_request_carries_serving_knobs():
    stub = StubRetriever(k=4)
    srv = BatchingServer(stub, batch_size=2, max_wait_ms=0.5, cache_size=None)
    try:
        req = SearchRequest(q=_stub_query(7.0), t_cs=0.9, k=2)
        res = srv.submit(req).get(timeout=10)
        assert res.t_cs == 0.9 and res.k == 2
        assert res.pids.shape == (2,)
        _, ts, marker = stub.calls[-1]
        assert marker == 7.0 and np.float32(0.9) in ts
    finally:
        srv.shutdown()


def test_search_request_fields_match_reference():
    """The port's ``SearchRequest`` has the reference's fields, defaults and
    ``batched`` property; direct searches ignore the serving-only ones."""
    if ri is None:
        pytest.skip("needs the repro package (the reference)")
    from repro.retrieval import SearchRequest as RSearchRequest

    got = {f.name: f.default for f in dataclasses.fields(SearchRequest)}
    want = {f.name: f.default for f in dataclasses.fields(RSearchRequest)}
    assert got == want
    assert SearchRequest(q=np.zeros((2, 4, DIM))).batched
    assert not SearchRequest(q=np.zeros((4, DIM))).batched
    assert not SearchRequest(q=[[0.0]]).batched


def test_direct_search_ignores_serving_fields(live_setup):
    t, _, qs = live_setup
    plain = t.search(SearchRequest(q=qs[0], t_cs=0.4))
    served_fields = t.search(SearchRequest(q=qs[0], t_cs=0.4, k=1, priority="batch",
                                           deadline_ms=0.0))
    assert served_fields.pids.shape == (5,)
    assert torch.equal(plain.pids, served_fields.pids)
    assert torch.equal(plain.scores, served_fields.scores)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_admission_queue_priority_order_and_drain():
    q = AdmissionQueue(max_pending=8)
    a, b, c = (_pending(tserver, _stub_query(i), 0.0, 1) for i in (1, 2, 3))
    q.put(a, "batch")
    q.put(b, "interactive")
    q.put(c, "batch")
    assert q.get(timeout=0) is b  # interactive pops first
    assert q.get(timeout=0) is a
    q.put(b, "interactive")
    assert [len(q)] == [2]
    assert q.drain() == [b, c]  # dispatch order: interactive first
    assert len(q) == 0
    with pytest.raises(ValueError, match="priority"):
        q.put(a, "bulk")
    with pytest.raises(ValueError):
        AdmissionQueue(max_pending=0)
    q.close()
    with pytest.raises(ServerClosed):
        q.put(a)


def test_queue_full_sheds_typed():
    stub = StubRetriever(gated=True)
    srv = BatchingServer(
        stub, batch_size=1, max_wait_ms=0.0, max_pending=2, cache_size=None
    )
    try:
        f0 = srv.submit(_stub_query(0.0))  # enters dispatch, blocks on gate
        _wait(stub.entered.is_set, msg="dispatcher pickup")
        srv.submit(_stub_query(1.0), priority="batch")
        f2 = srv.submit(_stub_query(2.0), priority="batch")  # queue now full
        # batch arrival beyond the bound is rejected outright
        with pytest.raises(QueueFull):
            srv.submit(_stub_query(3.0), priority="batch")
        # interactive arrival sheds the YOUNGEST queued batch request
        f4 = srv.submit(_stub_query(4.0))
        with pytest.raises(QueueFull):
            f2.get(timeout=10)
        # interactive arrival with no batch victim is rejected itself
        f5 = srv.submit(_stub_query(5.0))  # sheds f1
        with pytest.raises(QueueFull):
            srv.submit(_stub_query(6.0))
        assert srv._q.shed == 2 and srv._q.rejected == 2
        stub.gate.set()
        # survivors complete, routed to the right requests
        for f, marker in ((f0, 0.0), (f4, 4.0), (f5, 5.0)):
            assert f.get(timeout=10).pids[0] == int(marker)
        st = srv.stats()
        assert st["shed"] == 2 and st["rejected"] == 2
    finally:
        srv.shutdown()


def test_interactive_dispatches_ahead_of_batch():
    stub = StubRetriever(gated=True)
    srv = BatchingServer(stub, batch_size=1, max_wait_ms=0.0, cache_size=None)
    try:
        srv.submit(_stub_query(0.0))
        _wait(stub.entered.is_set, msg="dispatcher pickup")
        srv.submit(_stub_query(1.0), priority="batch")
        srv.submit(_stub_query(2.0), priority="interactive")
        stub.gate.set()
        _wait(lambda: len(stub.calls) == 3, msg="all dispatches")
        assert [c[2] for c in stub.calls] == [0.0, 2.0, 1.0]
    finally:
        srv.shutdown()


def test_expired_requests_skip_dispatch():
    stub = StubRetriever(gated=True)
    srv = BatchingServer(stub, batch_size=1, max_wait_ms=0.0, cache_size=None)
    try:
        srv.submit(_stub_query(0.0))
        _wait(stub.entered.is_set, msg="dispatcher pickup")
        f = srv.submit(_stub_query(1.0), timeout_ms=10.0)
        g = srv.submit(SearchRequest(q=_stub_query(2.0), deadline_ms=10.0))
        time.sleep(0.05)  # let the deadlines lapse while queued
        stub.gate.set()
        for fut in (f, g):
            with pytest.raises(DeadlineExceeded):
                fut.get(timeout=10)
        _wait(lambda: srv.stats().get("expired") == 2, msg="expired counter")
        # the expired requests never reached the retriever
        assert [c[2] for c in stub.calls] == [0.0]
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# dispatcher failures propagate, dispatcher survives
# ---------------------------------------------------------------------------
def test_dispatch_exception_propagates_and_dispatcher_survives():
    stub = StubRetriever()
    srv = BatchingServer(stub, batch_size=4, max_wait_ms=0.5, cache_size=None)
    try:
        stub.fail_with = RuntimeError("CUDA error: out of memory")
        with pytest.raises(RuntimeError, match="out of memory"):
            srv.submit(_stub_query(1.0)).get(timeout=10)
        # the dispatcher must still be alive and serving
        stub.fail_with = None
        res = srv.search(_stub_query(2.0), timeout=10)
        assert res.pids[0] == 2
        st = srv.stats()
        assert st["errors"] == 1 and st["completed"] == 1
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# bounded latency window
# ---------------------------------------------------------------------------
def test_latency_window_bounded_and_exact():
    w = LatencyWindow(capacity=4)
    assert w.summary() == {}
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):  # first two rotate out
        w.add(v)
    s = w.summary()
    assert s["n"] == 6 and s["window"] == 4
    assert s["p50_ms"] == pytest.approx(4.5e3)  # exact over [3,4,5,6]
    assert s["mean_ms"] == pytest.approx(3.5e3)  # all-time mean
    with pytest.raises(ValueError):
        LatencyWindow(capacity=0)


def test_server_latency_window_is_bounded():
    srv = BatchingServer(
        StubRetriever(), batch_size=1, max_wait_ms=0.0,
        cache_size=None, latency_window=8,
    )
    try:
        for i in range(20):
            srv.search(_stub_query(float(i)), timeout=10)
        st = srv.stats()
        assert st["n"] == 20 and st["window"] == 8
        assert srv._latencies._buf.shape == (8,)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# graceful shutdown
# ---------------------------------------------------------------------------
def test_shutdown_drain_completes_queued_requests():
    stub = StubRetriever(gated=True)
    srv = BatchingServer(stub, batch_size=2, max_wait_ms=0.0, cache_size=None)
    futs = [srv.submit(_stub_query(float(i))) for i in range(5)]
    _wait(stub.entered.is_set, msg="dispatcher pickup")

    def release():
        time.sleep(0.05)
        stub.gate.set()

    t = threading.Thread(target=release)
    t.start()
    srv.shutdown(drain=True)
    t.join(timeout=10)
    assert not t.is_alive()
    assert not srv._thread.is_alive()
    for i, f in enumerate(futs):
        assert f.get(timeout=1).pids[0] == i  # all served before exit
    with pytest.raises(ServerClosed):
        srv.submit(_stub_query(9.0))


def test_shutdown_without_drain_fails_queued_waiters_typed():
    stub = StubRetriever(gated=True)
    srv = BatchingServer(stub, batch_size=1, max_wait_ms=0.0, cache_size=None)
    f0 = srv.submit(_stub_query(0.0))
    _wait(stub.entered.is_set, msg="dispatcher pickup")
    queued = [srv.submit(_stub_query(float(i))) for i in (1, 2, 3)]
    stub.gate.set()
    srv.shutdown(drain=False)
    assert f0.get(timeout=1).pids[0] == 0  # in-flight request still lands
    outcomes = []
    for f in queued:
        try:
            f.get(timeout=1)
            outcomes.append("served")
        except ServerClosed:
            outcomes.append("closed")
    assert "closed" in outcomes  # nobody hangs, queued work fails typed
    with pytest.raises(ServerClosed):
        srv.submit(_stub_query(9.0))


def test_submit_after_shutdown_raises_even_on_cache_hit():
    stub = StubRetriever()
    srv = BatchingServer(stub, batch_size=1, max_wait_ms=0.0, cache_size=32)
    q = _stub_query(1.0)
    srv.search(q, timeout=10)  # warm the cache
    assert srv.search(q, timeout=10).cached
    srv.shutdown()
    with pytest.raises(ServerClosed):  # the cache must not serve a
        srv.submit(q)  # closed server


# ---------------------------------------------------------------------------
# generation-aware result cache
# ---------------------------------------------------------------------------
def test_result_cache_generation_invalidation_unit():
    c = ResultCache(capacity=2)
    key = (b"q", (1,), "float32", 0.5)
    c.put(key, 3, np.arange(4.0), np.arange(4))
    hit = c.get(key, 3)
    assert hit is not None and c.hits == 1
    assert c.get(key, 4) is None  # newer generation: stale, dropped
    assert c.invalidations == 1 and len(c) == 0
    # LRU eviction at capacity
    for i in range(3):
        c.put((b"k", (1,), "f", float(i)), 0, np.zeros(1), np.zeros(1))
    assert len(c) == 2 and c.evictions == 1
    assert set(c.stats()) == {"size", "capacity", "hits", "misses", "invalidations",
                              "insertions", "evictions"}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("t_cs", [0.4, np.float32(0.45), 1])
def test_query_key_equal_across_packages(dtype, t_cs):
    if ri is None:
        pytest.skip("needs the repro package (the reference)")
    q = np.random.default_rng(3).standard_normal((6, DIM)).astype(dtype)
    for arr in (q, np.asfortranarray(q), q[::-1]):
        assert query_key(arr, t_cs) == r_query_key(arr, t_cs)
    assert query_key(q, t_cs) != query_key(q, 0.9)
    assert query_key(torch.from_numpy(q).numpy(), t_cs) == r_query_key(q, t_cs)


def test_cache_hit_is_array_identical_and_invalidated_by_mutation(corpus):
    t, r = _live_pair(corpus)
    qs = corpus[1]
    tsrv = BatchingServer(t, batch_size=4, max_wait_ms=1.0, cache_size=64)
    rsrv = rserver.BatchingServer(r, batch_size=4, max_wait_ms=1.0, cache_size=64)
    try:
        q = np.asarray(qs[0])
        cold = tsrv.search(q, timeout=60)
        assert not cold.cached
        _same(cold, rsrv.search(q, timeout=60))
        hit = tsrv.search(q, timeout=60)
        assert hit.cached
        np.testing.assert_array_equal(hit.pids, cold.pids)
        np.testing.assert_array_equal(hit.scores, cold.scores)
        _same(hit, rsrv.search(q, timeout=60))
        # a smaller per-request k is served from the same full-k entry
        small = tsrv.search(q, k=2, timeout=60)
        assert small.cached
        np.testing.assert_array_equal(small.pids, cold.pids[:2])
        _same(small, rsrv.search(q, k=2, timeout=60))

        gen_before = t.generation
        new_docs, _ = syn.embedding_corpus(5, dim=DIM, seed=99)
        np.testing.assert_array_equal(tsrv.add_passages(new_docs), rsrv.add_passages(new_docs))
        assert t.generation > gen_before and t.generation == r.generation
        fresh = tsrv.search(q, timeout=60)
        assert not fresh.cached  # generation bump made the entry stale
        _same(fresh, rsrv.search(q, timeout=60))
        cs = tsrv.stats()["cache"]
        assert cs["invalidations"] >= 1 and cs["hits"] >= 2
        # and the refreshed entry caches at the new generation
        again = tsrv.search(q, timeout=60)
        assert again.cached and rsrv.search(q, timeout=60).cached
        np.testing.assert_array_equal(again.pids, fresh.pids)
        np.testing.assert_array_equal(again.scores, fresh.scores)
        # the same requests leave both caches in the same state
        got, want = tsrv.stats()["cache"], rsrv.stats()["cache"]
        assert got == want
    finally:
        tsrv.shutdown()
        rsrv.shutdown()


def test_cache_skips_insert_when_mutation_races_dispatch():
    class MutatingStub(StubRetriever):
        generation = 0

        def search_batch(self, qs, t_cs=None):
            out = super().search_batch(qs, t_cs=t_cs)
            self.generation += 1  # a mutation lands mid-dispatch
            return out

    srv = BatchingServer(
        MutatingStub(), batch_size=1, max_wait_ms=0.0, cache_size=32
    )
    try:
        q = _stub_query(1.0)
        srv.search(q, timeout=10)
        assert not srv.search(q, timeout=10).cached  # never inserted
        assert srv.cache.stats()["insertions"] == 0
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------
def test_replica_pool_routes_to_least_outstanding():
    stubs = [StubRetriever(gated=True), StubRetriever(gated=True)]
    pool = ReplicaPool(
        stubs, batch_size=1, max_wait_ms=0.0, cache_size=None
    )
    try:
        f0 = pool.submit(_stub_query(0.0))
        _wait(
            lambda: any(r.entered.is_set() for r in stubs),
            msg="first dispatch",
        )
        # the replica whose dispatch holds request 0 (in flight: outstanding 1)
        busy = [s for s in pool.servers if s.retriever.entered.is_set()][0]
        assert busy.outstanding == 1
        f = pool.submit(_stub_query(1.0))  # must land on the idle replica
        idle = [s for s in pool.servers if s is not busy][0]
        _wait(lambda: idle.retriever.entered.is_set(), msg="second dispatch")
        for s in stubs:
            s.gate.set()
        assert f.get(timeout=10).pids[0] == 1
        # stats() of a replica is {} until its first completion: wait for
        # the first request too before reading the aggregate
        assert f0.get(timeout=10).pids[0] == 0
        st = pool.stats()
        assert st["n_replicas"] == 2 and st["submitted"] == 2
        assert [p["completed"] for p in st["replicas"]] == [1, 1]
        pool.assert_zero_retrace()
    finally:
        pool.shutdown()


def test_replica_pool_mutates_shared_index_once(corpus):
    from repro.live.backend import LiveRetriever as RLiveRetriever

    t, r = _live_pair(corpus)
    qs = corpus[1]
    # two replicas over ONE LiveIndex: the shared-index deployment
    pool = ReplicaPool([LiveRetriever(t.index, t.params), LiveRetriever(t.index, t.params)],
                       batch_size=4, max_wait_ms=1.0)
    rpool = RReplicaPool([RLiveRetriever(r.index, r.params), RLiveRetriever(r.index, r.params)],
                         batch_size=4, max_wait_ms=1.0)
    try:
        assert len(pool._unique_servers()) == 1
        gen0 = t.index.generation
        new_docs, _ = syn.embedding_corpus(4, dim=DIM, seed=7)
        pids = pool.add_passages(new_docs)
        np.testing.assert_array_equal(pids, rpool.add_passages(new_docs))
        assert t.index.generation == gen0 + 1  # exactly one mutation
        assert pool.delete_passages(pids[:2]) == 2 == rpool.delete_passages(pids[:2])
        assert t.index.generation == gen0 + 2 == r.index.generation
        # both replicas serve the mutated corpus, as the reference's do
        want = rpool.servers[0].search(np.asarray(qs[0]), timeout=60)
        for s in pool.servers:
            res = s.search(np.asarray(qs[0]), timeout=60)
            assert res.pids.shape == (t.params.k,)
            assert not set(res.pids.tolist()) & set(pids[:2].tolist())
            _same(res, want)
        pid_map = pool.compact()
        np.testing.assert_array_equal(pid_map, np.asarray(rpool.compact()))
        assert t.index.generation == r.index.generation
    finally:
        pool.shutdown()
        rpool.shutdown()


# ---------------------------------------------------------------------------
# concurrent serving + mutation stress
# ---------------------------------------------------------------------------
def test_serving_stress_with_concurrent_mutations(corpus):
    """4 client threads and a mutator (add / delete / compact) against one
    port server.  The mutator logs its operations; once quiet, they are
    replayed on the reference's live index in the same order, and every
    (query, t_cs) the port serves must equal the reference's direct
    search as well as the port's own."""
    t, r = _live_pair(corpus)
    qs = corpus[1]
    srv = BatchingServer(t, batch_size=8, max_wait_ms=1.0, cache_size=256)
    n_threads, n_iters = 4, 12
    pool = [np.asarray(q) for q in qs[:4]]
    t_grid = (0.3, 0.4, 0.5)
    failures: list = []
    log: list = []  # the mutator's operations, in order
    stop = threading.Event()

    def client(tid):
        rng = np.random.default_rng(tid)
        for _ in range(n_iters):
            q = pool[rng.integers(len(pool))]
            tc = t_grid[rng.integers(len(t_grid))]
            try:
                res = srv.search(q, t_cs=tc, timeout=120)
                if res.pids.shape != (t.params.k,):
                    failures.append(("shape", res.pids.shape))
            except (QueueFull, DeadlineExceeded):
                pass  # typed shedding is an acceptable outcome
            except Exception as exc:  # hangs/untyped errors are not
                failures.append(("client", repr(exc)))

    def mutator():
        rng = np.random.default_rng(1234)
        added: list = []
        while not stop.is_set():
            op = rng.integers(3)
            try:
                if op == 0:
                    seed = int(rng.integers(1 << 30))
                    docs, _ = syn.embedding_corpus(3, dim=DIM, seed=seed)
                    new = srv.add_passages(docs)
                    log.append(("add", seed, new))
                    added.extend(new.tolist())
                elif op == 1 and added:
                    pid = added.pop()
                    log.append(("delete", pid, srv.delete_passages([pid])))
                else:
                    pid_map = srv.compact()  # remaps the whole pid space
                    log.append(("compact", None, pid_map))
                    added = [int(pid_map[p]) for p in added if pid_map[p] >= 0]
            except Exception as exc:
                failures.append(("mutator", repr(exc)))
            time.sleep(0.05)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
    mt = threading.Thread(target=mutator)
    mt.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive(), "client thread hung"
    stop.set()
    mt.join(timeout=60)
    assert not mt.is_alive(), "mutator thread hung"
    assert failures == []
    assert log, "the mutator ran no operation"
    # replay the log on the reference's index: same pids, same counts
    for op, arg, out in log:
        if op == "add":
            docs, _ = syn.embedding_corpus(3, dim=DIM, seed=arg)
            np.testing.assert_array_equal(r.add_passages(docs), out)
        elif op == "delete":
            assert r.delete_passages([arg]) == out
        else:
            np.testing.assert_array_equal(np.asarray(r.compact()), out)
    assert r.generation == t.generation
    # quiescent now: every served result matches a direct search at the
    # final generation, in both packages
    for q in pool:
        for tc in t_grid:
            served = srv.search(q, t_cs=tc, timeout=120)
            direct = t.search(q, t_cs=tc)
            np.testing.assert_array_equal(served.pids, direct.pids.numpy())
            np.testing.assert_allclose(served.scores, direct.scores.numpy(), rtol=1e-5)
            _same(served, r.search(jnp.asarray(q), t_cs=tc))
    st = srv.stats()
    assert st["completed"] >= n_threads * n_iters
    # deterministic epilogue: a quiescent entry goes stale across one more
    # mutation and is invalidated (not served) on the next touch
    assert srv.search(pool[0], t_cs=t_grid[0], timeout=120).cached
    inval0 = srv.cache.stats()["invalidations"]
    docs, _ = syn.embedding_corpus(2, dim=DIM, seed=4242)
    srv.add_passages(docs)
    assert not srv.search(pool[0], t_cs=t_grid[0], timeout=120).cached
    assert srv.cache.stats()["invalidations"] == inval0 + 1
    srv.shutdown()
    with pytest.raises(ServerClosed):
        srv.submit(pool[0])


# ---------------------------------------------------------------------------
# future contract
# ---------------------------------------------------------------------------
def test_result_future_timeout_raises_queue_empty():
    f = ResultFuture()
    with pytest.raises(queue_mod.Empty):
        f.get(timeout=0.01)
    f.set("done")
    assert f.done() and f.get(timeout=0.01) == "done"
    g = ResultFuture()
    g.set_exception(QueueFull("shed"))
    with pytest.raises(QueueFull):
        g.get(timeout=0.01)
    if ri is not None:
        assert _Pending.__dataclass_fields__.keys() == rserver._Pending.__dataclass_fields__.keys()


# ---------------------------------------------------------------------------
# observability: stats schema, gauges, spans
# ---------------------------------------------------------------------------
def test_stats_snapshot_schema_and_gauges(live_setup):
    """The stats() contract the dashboards scrape: the reference's keys,
    the queue-depth/outstanding gauges, the cache hit rate and the spans."""
    from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
    from repro.obs.trace import Tracer as RTracer

    t, r, qs = live_setup
    tracer, registry = Tracer(), MetricsRegistry()
    srv = BatchingServer(t, batch_size=4, max_wait_ms=1.0, tracer=tracer, registry=registry)
    rsrv = rserver.BatchingServer(r, batch_size=4, max_wait_ms=1.0, tracer=RTracer(),
                                  registry=RMetricsRegistry())
    try:
        assert srv.stats() == {}  # legacy contract: empty until completion
        for s in (srv, rsrv):
            s.search(qs[0], timeout=60)
            s.search(qs[0], timeout=60)  # cache hit
        st = srv.stats()
        assert STATS_KEYS <= set(st), STATS_KEYS - set(st)
        assert set(st) == set(rsrv.stats())
        # a result future resolves inside _dispatch, a beat before the
        # dispatcher loop clears _inflight — poll the tiny race out
        deadline = time.perf_counter() + 5.0
        while srv.outstanding and time.perf_counter() < deadline:
            time.sleep(0.01)
        st = srv.stats()
        assert st["queue_depth"] == 0 and st["outstanding"] == 0
        cache = st["cache"]
        assert {"hits", "misses", "hit_rate", "size", "capacity"} <= set(cache)
        assert set(cache) == set(rsrv.stats()["cache"])
        assert cache["hits"] == 1
        assert cache["hit_rate"] == pytest.approx(1 / 2)
        # the injected registry carries the same numbers as gauges
        snap = registry.snapshot()
        assert snap["serving_queue_depth"]["value"] == 0.0
        assert snap["serving_outstanding"]["value"] == 0.0
        # every dispatch-path span fired at least once
        names = {s.name for s in tracer.spans()}
        assert {
            "serve.queue_wait", "serve.pad", "serve.dispatch",
            "serve.truncate", "serve.cache_lookup",
        } <= names, names
        # queue_wait is recorded retroactively from submit time: its start
        # precedes the dispatch span's
        qw = tracer.spans("serve.queue_wait")[0]
        disp = tracer.spans("serve.dispatch")[0]
        assert qw.ts <= disp.ts
        assert disp.attrs == dict(bucket=1, n=1, generation=t.generation)
    finally:
        srv.shutdown()
        rsrv.shutdown()


def test_replica_pool_stats_aggregates_observability(live_setup):
    t, r, qs = live_setup
    pool = ReplicaPool([t], batch_size=4, max_wait_ms=1.0)
    rpool = RReplicaPool([r], batch_size=4, max_wait_ms=1.0)
    try:
        for p in (pool, rpool):
            p.search(qs[0], timeout=60)
            p.search(qs[0], timeout=60)
        st = pool.stats()
        for key in ("cache_hits", "cache_hit_rate", "queue_depth",
                    "expired", "shed"):
            assert key in st, key
        assert set(st) == set(rpool.stats())
        assert st["cache_hits"] == 1
        assert 0.0 < st["cache_hit_rate"] <= 1.0
    finally:
        pool.shutdown()
        rpool.shutdown()


# ---------------------------------------------------------------------------
# the other servers the reference's tests drive
# ---------------------------------------------------------------------------
def test_server_concurrent_ingest_while_querying():
    """tests/test_live.py's case, on its corpus: ingest and deletes from a
    second thread while 24 queries are in flight; the ingest lands under
    its global pids and the deletes are gone.  Frozen tables from the
    reference's ``build_index`` over the first 100 docs; the same
    mutations applied to the reference's ``live`` backend give the same
    pids and the same final ranking."""
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, _ = syn.embedding_corpus(140, dim=32, min_len=6, max_len=18, seed=0)
    qs, _ = syn.queries_from_docs(docs, 10, q_len=6)
    mono = ri.build_index(docs[:100], num_centroids=64, kmeans_iters=3)
    codec = trc.ResidualCodec(torch.tensor(np.asarray(mono.cutoffs)),
                              torch.tensor(np.asarray(mono.weights)), mono.nbits)
    p = dict(k=5, nprobe=4, t_cs=0.3, ndocs=256, candidate_cap=256)
    r = tret.build(docs[:100], backend="live", device="cpu", params=SearchParams(**p),
                   index=dict(centroids=np.array(mono.centroids), codec=codec))
    ref = rret.build(docs[:100], backend="live", params=rret.SearchParams(**p),
                     index=dict(centroids=mono.centroids, codec=mono.codec))
    srv = BatchingServer(r, batch_size=4, max_wait_ms=2.0)
    errors: list = []

    def mutate():
        try:
            for i in range(4):
                lo = 100 + 10 * i
                pids = srv.add_passages([np.asarray(d) for d in docs[lo:lo + 10]])
                srv.delete_passages(pids[:2])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    try:
        th = threading.Thread(target=mutate)
        th.start()
        futs = [srv.submit(np.asarray(qs[i % qs.shape[0]])) for i in range(24)]
        got = [f.get(timeout=180) for f in futs]
        th.join(timeout=180)
        assert not th.is_alive()
    finally:
        srv.shutdown()
    assert not errors
    for res in got:
        assert res.pids.shape == (5,) and res.latency_ms > 0
    # an exact-token query for an added (non-deleted) passage finds it at
    # rank 1, under its global pid; the per-batch deletes are gone
    res = r.search(docs[105][:6])
    assert int(res.pids[0]) == 105
    for i in range(4):
        assert 100 + 10 * i not in res.pids.tolist()
    assert r.describe()["index"]["num_deleted"] == 8
    for i in range(4):
        lo = 100 + 10 * i
        ref.delete_passages(ref.add_passages([np.asarray(d) for d in docs[lo:lo + 10]])[:2])
    _same(res, ref.search(jnp.asarray(docs[105][:6])))
    _same(r.search_batch(qs), ref.search_batch(jnp.asarray(qs)))


def test_server_rejects_mutation_on_static_backend(corpus):
    docs, _, _ = corpus
    r = tret.build(docs[:60], backend="plaid", params=SearchParams(k=5), device="cpu",
                   index=dict(num_centroids=32, kmeans_iters=2))
    assert not isinstance(r, tret.MutableRetriever)
    srv = BatchingServer(r, batch_size=2, max_wait_ms=1.0)
    try:
        for op, arg in (("add_passages", [np.asarray(docs[60])]), ("delete_passages", [0])):
            with pytest.raises(TypeError, match="live"):
                getattr(srv, op)(arg)
        with pytest.raises(TypeError, match="live"):
            srv.compact()
    finally:
        srv.shutdown()


def test_batching_server_returns_correct_results(corpus):
    """tests/test_serving_and_persistence.py's case: the raw ``PlaidEngine``
    (plain ``(scores, pids)`` tensors, no facade) behind the server answers
    as a direct ``search_batch`` does, and as the reference's engine."""
    docs, qs, mono = corpus
    idx = ti.index_from_numpy(
        {f: np.asarray(getattr(mono, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(mono, f) for f in ti.STATIC_FIELDS}, "cpu",
    )
    searcher = tplaid.PlaidEngine(idx, tplaid.params_for_k(5))
    _, want = searcher.search_batch(qs)
    _, ref_want = rplaid.PlaidEngine(mono, rplaid.params_for_k(5)).search_batch(jnp.asarray(qs))
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref_want))
    srv = BatchingServer(searcher, batch_size=4, max_wait_ms=5.0)
    try:
        futs = [srv.submit(np.asarray(qs[i])) for i in range(qs.shape[0])]
        got = [f.get(timeout=60) for f in futs]
        # a query tensor is taken as its host array
        by_tensor = srv.search(torch.from_numpy(qs[0]), timeout=60)
    finally:
        srv.shutdown()
    for i, res in enumerate(got):
        np.testing.assert_array_equal(res.pids, want[i].numpy())
        assert isinstance(res.pids, np.ndarray) and res.latency_ms > 0
    np.testing.assert_array_equal(by_tensor.pids, want[0].numpy())
    st = srv.stats()
    assert st["n"] == qs.shape[0] + 1 and st["p99_ms"] >= st["p50_ms"]


def test_server_serves_vanilla_and_refuses_t_cs_without_it(corpus):
    """``vanilla`` behind the facade serves what its direct search gives;
    the raw ``VanillaEngine`` takes no ``t_cs``, so a per-request ``t_cs``
    is refused (the reference sniffs the same signature)."""
    docs, qs, _ = corpus
    r = tret.build(docs, backend="vanilla", device="cpu",
                   params=SearchParams(k=5, nprobe=4, candidate_cap=512, ndocs=64),
                   index=dict(num_centroids=32, kmeans_iters=2))
    srv = BatchingServer(r, batch_size=4, max_wait_ms=2.0, cache_size=None)
    raw = BatchingServer(r._engine, batch_size=4, max_wait_ms=2.0, cache_size=None)
    try:
        want = r.search_batch(qs[:3])
        for i, f in enumerate([srv.submit(qs[i]) for i in range(3)]):
            res = f.get(timeout=60)
            np.testing.assert_array_equal(res.pids, want.pids[i].numpy())
            np.testing.assert_array_equal(res.scores, want.scores[i].numpy())
        res = raw.search(qs[0], timeout=60)
        np.testing.assert_array_equal(res.pids, want.pids[0].numpy())
        with pytest.raises(ValueError, match="t_cs"):
            raw.submit(qs[0], t_cs=0.5)
    finally:
        srv.shutdown()
        raw.shutdown()


def test_server_surfaces_transfer_stats(corpus):
    """tests/test_tiered.py's case, exact: ``stats()["transfer"]`` is the
    tiered backend's ``transfer_totals`` after the served requests."""
    docs, qs, mono = corpus
    idx = ti.index_from_numpy(
        {f: np.asarray(getattr(mono, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(mono, f) for f in ti.STATIC_FIELDS}, "cpu",
    )
    r = tret.from_index(idx, backend="plaid", params=SearchParams(
        k=5, nprobe=4, t_cs=0.3, ndocs=64, candidate_cap=64, tiered=True))
    assert r.backend_name == "plaid-tiered"
    srv = BatchingServer(r, batch_size=4, max_wait_ms=1.0)
    try:
        first = srv.submit(np.asarray(qs[0])).get(timeout=30)
        for f in [srv.submit(np.asarray(qs[i])) for i in range(1, 4)]:
            f.get(timeout=30)
        stats = srv.stats()
    finally:
        srv.shutdown()
    assert stats["transfer"]["batches"] >= 2
    assert stats["transfer"]["slice_bytes"] > 0
    assert stats["transfer"] == r.transfer_totals
    np.testing.assert_array_equal(first.pids, r.search(qs[0]).pids.numpy())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_plaid_cuda_server_buckets_equal_direct_search_batch_on_card():
    """``plaid-cuda`` served at every bucket: each lane equals the same lane
    of a direct ``search_batch`` of the padded bucket (scores and pids,
    exactly), and every dispatch launched K1 twice and K2 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops

    docs, _ = syn.embedding_corpus(600, dim=64, seed=5)
    qs, _ = syn.queries_from_docs(docs, 32, q_len=16, seed=6)
    qs = np.asarray(qs, np.float32)
    r = tret.build(docs, backend="plaid-cuda", device="cuda",
                   params=SearchParams(k=10, nprobe=2, t_cs=0.45, ndocs=64),
                   index=dict(num_centroids=64, kmeans_iters=4))
    srv = BatchingServer(r, batch_size=32, max_wait_ms=2.0, cache_size=None)
    t_grid, k_grid = (0.4, 0.5, 0.6), (1, 5, 10)
    try:
        ops.reset_launch_counts()
        for n in (1, 3, 5, 17, 32):
            knobs = [(t_grid[i % 3], k_grid[i % 3]) for i in range(n)]
            batch = [_pending(tserver, qs[i], tc, k) for i, (tc, k) in enumerate(knobs)]
            srv._dispatch(batch)
            bucket = bucket_batch_size(n, 32)
            pq, pt = pad_batch([qs[i] for i in range(n)], [tc for tc, _ in knobs], bucket)
            direct = r.search_batch(pq, t_cs=pt)
            for i, p in enumerate(batch):
                res, k = p.future.get(timeout=60), knobs[i][1]
                np.testing.assert_array_equal(res.pids, direct.pids[i, :k].cpu().numpy())
                np.testing.assert_array_equal(res.scores, direct.scores[i, :k].cpu().numpy())
        counts = ops.launch_counts()
        dispatches = srv.stats()["dispatches"]
        assert dispatches == 5
        assert counts["centroid_interaction_batched"] == 2 * (dispatches + 5)
        assert counts["decompress_and_score_batched"] == dispatches + 5
    finally:
        srv.shutdown()
