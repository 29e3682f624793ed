"""Port vs reference: span tracing (``repro_torch.obs.trace`` against
``repro.obs.trace``) and the spans the port's live index, compactor and
streaming build record.

A ``Tracer`` driven by the same fake clock exports the same Chrome trace
JSON in both packages; the ring, exception and thread-safety cases are the
reference's (``tests/test_obs.py``).  The same mutations and builds, run
through both packages, record the same span names and attributes on each
package's process-wide tracer.  ``device_trace`` writes a
``torch.profiler`` Chrome trace (the host only on ``device="cpu"``) and,
unlike the reference's, raises instead of recording nothing: without a
card, ``device="cuda"`` raises.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    from repro import live as rlive
    from repro.build import build_index_streaming as rbuild
    from repro.core import index as ri
    from repro.obs import trace as rtrace
except ImportError:
    rtrace = None

from repro_torch import live as tlive  # noqa: E402
from repro_torch.build import build_index_streaming as tbuild  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    if rtrace is None:
        pytest.skip("needs jax and the repro package (the reference)")
    return rtrace


def _fake_clock(step):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


def _drive(tracer):
    with tracer.span("dispatch", bucket=4, pad=np.int64(3)):
        pass
    tracer.instant("generation_bump", generation=3)
    tracer.record("queue_wait", 0.125, 0.5, depth=2)
    with pytest.raises(RuntimeError):
        with tracer.span("boom"):
            raise RuntimeError("x")


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------
def test_chrome_trace_equals_reference(ref, tmp_path):
    got_tr = ttrace.Tracer(clock=_fake_clock(0.25))
    want_tr = ref.Tracer(clock=_fake_clock(0.25))
    _drive(got_tr)
    _drive(want_tr)
    assert got_tr.to_chrome_trace() == want_tr.to_chrome_trace()
    assert got_tr.summary() == want_tr.summary()
    assert got_tr.durations_ms("dispatch") == want_tr.durations_ms("dispatch") == [250.0]
    n = got_tr.export(str(tmp_path / "got.json"))
    assert n == want_tr.export(str(tmp_path / "want.json")) == 4
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == json.loads((tmp_path / "want.json").read_text())
    full, instant = got["traceEvents"][:2]
    assert full["ph"] == "X" and full["args"] == {"bucket": 4, "pad": 3}
    assert instant["ph"] == "i" and instant["s"] == "t" and instant["dur"] == 0.0


def test_tracer_deterministic_with_fake_clock():
    tr = ttrace.Tracer(clock=_fake_clock(0.5))
    with tr.span("a", foo=1):
        pass
    (s,) = tr.spans("a")
    assert s.ts == 0.5 and s.dur == 0.5 and s.attrs == {"foo": 1}
    assert tr.durations_ms("a") == [500.0]
    assert len(tr) == 1
    tr.clear()
    assert len(tr) == 0


def test_tracer_records_span_on_exception():
    tr = ttrace.Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert len(tr.spans("boom")) == 1


def test_tracer_ring_bounds_memory():
    tr = ttrace.Tracer(capacity=16)
    for i in range(100):
        tr.instant("tick", i=i)
    spans = tr.spans()
    assert len(spans) == 16
    assert spans[-1].attrs == {"i": 99}  # newest kept, oldest dropped
    with pytest.raises(ValueError, match="capacity"):
        ttrace.Tracer(capacity=0)


def test_tracer_concurrent_writers_race_free():
    """Threads hammer one tracer; every record lands, nothing raises, and
    each thread's spans stay in order."""
    tr = ttrace.Tracer(capacity=100_000)
    n_threads, per = 8, 500
    errors = []

    def work(tid):
        try:
            for i in range(per):
                with tr.span("w", tid=tid, i=i):
                    pass
        except Exception as e:  # pragma: no cover - the failure mode
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors
    assert len(tr.spans("w")) == n_threads * per
    by_tid = {}
    for s in tr.spans("w"):
        by_tid.setdefault(s.attrs["tid"], []).append(s.ts)
    for ts in by_tid.values():
        assert ts == sorted(ts)


def test_device_trace_writes_a_profile_and_never_degrades(tmp_path):
    tr = ttrace.Tracer()
    with tr.device_trace(str(tmp_path), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (s,) = tr.spans("device_trace")
    assert s.attrs == {"logdir": str(tmp_path)}
    events = json.loads((tmp_path / "device_trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            with tr.device_trace(str(tmp_path)):
                pass


# --------------------------------------------------------------------------
# the spans of the live index, the compactor and the streaming build
# --------------------------------------------------------------------------
def _spans(tracer):
    return [(s.name, s.attrs) for s in tracer.spans()]


@pytest.fixture(scope="module")
def corpus(ref):
    docs, _ = syn.embedding_corpus(60, dim=16, max_len=12, seed=0)
    base = ri.build_index(docs[:40], num_centroids=8, nbits=2, kmeans_iters=3, seed=0)
    port = ti.index_from_numpy(
        {f: np.asarray(getattr(base, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(base, f) for f in ti.STATIC_FIELDS}, "cpu",
    )
    return docs, base, port


def test_live_index_and_compactor_spans_equal_reference(ref, corpus, tmp_path):
    docs, base, port = corpus
    want_tr, got_tr = ref.get_tracer(), ttrace.get_tracer()
    want_tr.clear()
    got_tr.clear()
    for lv, pkg, sub in ((rlive.LiveIndex(base), rlive, "ref"),
                         (tlive.LiveIndex(port), tlive, "port")):
        lv.add_passages(docs[40:50])
        lv.add_passages(docs[50:60])
        lv.delete([3, 41, 41, 55])
        pkg.Compactor(lv, min_deltas=2, spill_path=str(tmp_path / sub)).maybe_compact()
    got, want = _spans(got_tr), _spans(want_tr)
    spill = {"path": str(tmp_path / "port")}
    assert got == [(n, spill if n == "live.compact.spill" else a) for n, a in want]
    # a span records when it ends: each delta's build inside its ingest
    assert [n for n, _ in got] == [
        "build.quantize_chunk", "live.add_passages",
        "build.quantize_chunk", "live.add_passages", "live.delete",
        "live.compact.merge", "live.compact.swap", "live.compact.spill",
    ]
    assert dict(got)["live.delete"] == {"n_pids": 3}


def test_streaming_build_spans_equal_reference(ref, corpus):
    docs, base, _ = corpus
    want_tr, got_tr = ref.get_tracer(), ttrace.get_tracer()
    # frozen centroids, codec fitted: pass 1 samples, pass 2 quantizes
    want_tr.clear()
    got_tr.clear()
    rbuild(docs, centroids=base.centroids, chunk_docs=16)
    tbuild(docs, centroids=np.asarray(base.centroids), chunk_docs=16, device="cpu")
    assert _spans(got_tr) == _spans(want_tr)
    assert [n for n, _ in _spans(got_tr)] == ["build.sample_chunk"] * 4 + ["build.quantize_chunk"] * 4
    # trained: the k-means span after pass 1's chunks
    want_tr.clear()
    got_tr.clear()
    try:
        rbuild(docs, num_centroids=8, chunk_docs=16, kmeans_iters=2)
    except Exception as e:  # the reference's trained build under jax 0.9
        assert type(e).__name__ == "ShardingTypeError", e
    tbuild(docs, num_centroids=8, chunk_docs=16, kmeans_iters=2, device="cpu")
    want = _spans(want_tr)
    assert want[-1] == ("build.kmeans", {"k": 8, "sample_tokens": 595})
    assert _spans(got_tr)[: len(want)] == want
    assert [n for n, _ in _spans(got_tr)[len(want):]] in ([], ["build.quantize_chunk"] * 4)
