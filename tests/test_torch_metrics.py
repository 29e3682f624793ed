"""Port vs reference: the metrics substrate (``repro_torch.obs.metrics``
against ``repro.obs.metrics``) and the gold-pid IR metrics
(``repro_torch.core.metrics`` against ``repro.core.metrics``).

Each case mirrors one of ``tests/test_obs.py``'s metrics tests (lines
38-134) or ``tests/test_serving_and_persistence.py::test_metrics`` and adds
the reference as the oracle: one sequence of operations applied to an
instrument of each package must give equal ``summary()`` / ``snapshot()``
values and equal ``to_prometheus()`` text.  Everything here is host
Python and numpy, so the comparisons are exact.
"""
import json
import threading

import numpy as np
import pytest

pytest.importorskip("torch")
try:  # the reference
    from repro.core import metrics as rcm
    from repro.obs import metrics as rm
except ImportError:
    rm = rcm = None

from repro_torch.core import metrics as tcm  # noqa: E402
from repro_torch.obs import metrics as tm  # noqa: E402


@pytest.fixture
def reference():
    if rm is None:
        pytest.skip("needs the repro package (the reference)")
    return rm


# --------------------------------------------------------------------------
# counters (test_obs.py::test_counters_*)
# --------------------------------------------------------------------------
def test_counters_strict_by_default(reference):
    for mod in (tm, reference):
        c = mod.Counters("a", "b")
        c.inc("a")
        c.inc("b", 3)
        assert c["a"] == 1 and c["b"] == 3
        with pytest.raises(KeyError):
            c.inc("typo")
        with pytest.raises(KeyError):
            c["typo"]
        assert "typo" not in c.snapshot()
    assert tm.Counters("a", "b").snapshot() == reference.Counters("a", "b").snapshot()


def test_counters_non_strict_keeps_legacy_behaviour(reference):
    got, want = tm.Counters(strict=False), reference.Counters(strict=False)
    for c in (got, want):
        c.inc("adhoc")
        assert c["adhoc"] == 1 and c["never_incremented"] == 0
    assert got.snapshot() == want.snapshot()


# --------------------------------------------------------------------------
# latency window (test_obs.py::test_latency_window_*)
# --------------------------------------------------------------------------
def test_latency_window_extend_matches_add_loop(reference):
    """extend() is add() in a loop: same ring, same totals, and the same
    summary as the reference's window fed the same values."""
    vals = [0.001 * i for i in range(20)]  # wraps the capacity-8 ring
    a, b, want = tm.LatencyWindow(8), tm.LatencyWindow(8), reference.LatencyWindow(8)
    for v in vals:
        a.add(v)
        want.add(v)
    b.extend(vals)
    assert a.summary() == b.summary() == want.summary()
    assert a.count == b.count == want.count == 20
    np.testing.assert_array_equal(a._buf, want._buf)


def test_latency_window_extend_single_lock_acquisition():
    """A batch replay takes the lock once, not per element (counted on a
    proxy lock)."""

    class CountingLock:
        def __init__(self):
            self.acquisitions = 0
            self._l = threading.Lock()

        def __enter__(self):
            self.acquisitions += 1
            return self._l.__enter__()

        def __exit__(self, *exc):
            return self._l.__exit__(*exc)

    w = tm.LatencyWindow(16)
    lock = CountingLock()
    w._lock = lock
    w.extend([0.001] * 100)
    assert lock.acquisitions == 1
    w.extend([])  # empty batch: no lock traffic at all
    assert lock.acquisitions == 1


# --------------------------------------------------------------------------
# histogram (test_obs.py::test_histogram_log_buckets_and_overflow)
# --------------------------------------------------------------------------
def test_histogram_log_buckets_and_overflow(reference):
    got = tm.Histogram("lat", start=1e-3, factor=2.0, n_buckets=4)
    want = reference.Histogram("lat", start=1e-3, factor=2.0, n_buckets=4)
    # bounds: 1ms, 2ms, 4ms, 8ms (+Inf overflow); 2ms sits on a bound
    for v in (0.0005, 0.002, 0.003, 0.1):
        got.observe(v)
        want.observe(v)
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert snap["count"] == 4
    assert snap["buckets"][0] == 1  # 0.5ms <= 1ms
    assert snap["buckets"][1] == 1  # 2ms <= 2ms (bisect_left: bounds inclusive)
    assert snap["buckets"][2] == 1  # 3ms <= 4ms
    assert snap["buckets"][-1] == 1  # 100ms -> overflow
    with pytest.raises(ValueError):
        tm.Histogram("bad", factor=1.0)


# --------------------------------------------------------------------------
# registry (test_obs.py::test_registry_*)
# --------------------------------------------------------------------------
def test_registry_get_or_create_and_kind_mismatch():
    r = tm.MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    assert r.window("w") is r.window("w")
    with pytest.raises(TypeError):
        r.gauge("x")
    with pytest.raises(TypeError):
        r.window("x")


def _drive(mod):
    """One sequence of registry operations, applied to ``mod``'s registry."""
    r = mod.MetricsRegistry(namespace="repro")
    r.counter("reqs").inc(5)
    r.gauge("depth").set(3)
    r.gauge("depth").inc(0.5)
    h = r.histogram("lat", start=1e-3, factor=2.0, n_buckets=3)
    for v in (0.002, 0.0007, 9.0):
        h.observe(v)
    r.window("w").extend([0.01, 0.03, 0.02])
    r.window("empty")
    r.counter("serve.dispatch-ms").inc()  # a name the exporter must sanitize
    return r


def test_registry_snapshot_and_prometheus_export(reference):
    got, want = _drive(tm), _drive(reference)
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert snap["reqs"] == dict(type="counter", value=5)
    assert snap["depth"]["value"] == 3.5
    assert snap["lat"]["count"] == 3
    assert snap["w"]["n"] == 3
    json.dumps(snap)  # JSON-safe end to end
    text = got.to_prometheus()
    assert text == want.to_prometheus()
    assert "# TYPE repro_reqs counter" in text
    assert "repro_reqs 5" in text
    assert 'repro_lat_bucket{le="+Inf"} 3' in text
    assert "repro_lat_count 3" in text
    assert "repro_serve_dispatch_ms 1" in text
    assert "repro_empty_count 0" in text


def test_default_registry_is_one_per_process():
    assert tm.get_registry() is tm.get_registry()
    assert tm.get_registry().namespace == "repro"


def test_serving_stats_shim_reexports():
    """serving.stats keeps the reference's names over obs.metrics."""
    from repro_torch import obs
    from repro_torch.serving import stats as shim

    assert shim.Counters is tm.Counters is obs.Counters
    assert shim.LatencyWindow is tm.LatencyWindow is obs.LatencyWindow


# --------------------------------------------------------------------------
# gold-pid IR metrics (test_serving_and_persistence.py::test_metrics)
# --------------------------------------------------------------------------
def test_metrics():
    if rcm is None:
        pytest.skip("needs the repro package (the reference)")
    pids = np.asarray([[3, 1, 2], [9, 8, 7], [5, 4, 0]])
    gold = np.asarray([1, 0, 5])
    assert tcm.success_at_k(pids, gold, 2) == pytest.approx(2 / 3)
    assert tcm.mrr_at_k(pids, gold, 3) == pytest.approx((0.5 + 0 + 1.0) / 3)
    rel = [{3, 1}, {9}, {0, 7}]
    assert tcm.recall_at_k(pids, rel, 2) == pytest.approx((1.0 + 1.0 + 0.0) / 3)
    assert tcm.recall_at_k(pids, [set(), set(), set()], 2) == 0.0
    assert tcm.agreement_at_k(pids, pids, 3) == 1.0
    assert tcm.agreement_at_k(pids, pids[::-1], 3) == pytest.approx(1 / 3)
    for k in (1, 2, 3):
        assert tcm.success_at_k(pids, gold, k) == rcm.success_at_k(pids, gold, k)
        assert tcm.mrr_at_k(pids, gold, k) == rcm.mrr_at_k(pids, gold, k)
        assert tcm.recall_at_k(pids, rel, k) == rcm.recall_at_k(pids, rel, k)
        assert tcm.agreement_at_k(pids, pids[::-1], k) == rcm.agreement_at_k(pids, pids[::-1], k)
