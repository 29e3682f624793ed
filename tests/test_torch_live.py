"""Port vs reference: the live index (``repro_torch.live`` and the ``live`` /
``live-cuda`` backends against ``repro.live``).

Both packages start from one reference base (``build_index``, carried
across with ``index_from_numpy``) and ingest the same passages as delta
segments through their own streaming builders against its frozen tables.
Delta arrays, compacted bases and pid maps must be array-identical; with
deltas and tombstones, before and after ``compact()``, under lossless and
truncating caps, ``live`` and ``live-cuda`` (the kernels' plain versions
on the CPU) must give the reference ``live`` backend's ranked pids, its
scores within relative 1e-5 and every ``FunnelStats`` field.  Directories
cross-load both ways.  The ``gpu`` case holds ``live-cuda`` (K1-K3 on every
segment) against ``live`` on the card.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax.numpy as jnp

    from repro import live as rlive
    from repro import retrieval as rret
    from repro.core import index as ri
    from repro.core import indexer as rindexer
    from repro.eval import sweep as rsweep
except ImportError:
    ri = None

from repro_torch import live as tlive  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.core import indexer as tindexer  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed.topk import merge_topk  # noqa: E402
from repro_torch.eval import sweep as tsweep  # noqa: E402
from repro_torch.eval.qrels import synthetic_query_set  # noqa: E402
from repro_torch.live import manifest as tman  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CAPS = {
    "lossless": dict(k=8, nprobe=8, t_cs=0.3, ndocs=256, candidate_cap=256),
    "truncating": dict(k=4, nprobe=2, t_cs=0.45, ndocs=24, candidate_cap=40),
}
N_BASE, DELTAS = 70, ((70, 95), (95, 104), (104, 120))
DEAD = [3, 41, 72, 99, 110]


@pytest.fixture(scope="module")
def corpus():
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, topics = syn.embedding_corpus(120, dim=32, min_len=5, max_len=16, seed=7)
    qs, _ = syn.queries_from_docs(docs, 6, q_len=6)
    base = ri.build_index(docs[:N_BASE], num_centroids=48, nbits=2, kmeans_iters=3)
    return docs, topics, np.asarray(qs, np.float32), base


def _port(ref_index):
    return ti.index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS},
        "cpu",
    )


def _pair(corpus, deltas=DELTAS, dead=DEAD):
    """(reference LiveIndex, port LiveIndex) with the same deltas and
    tombstones."""
    docs, _, _, base = corpus
    r, t = rlive.LiveIndex(base), tlive.LiveIndex(_port(base))
    for a, b in deltas:
        np.testing.assert_array_equal(r.add_passages(docs[a:b]), t.add_passages(docs[a:b]))
    assert r.delete(dead) == t.delete(dead) == len(dead)
    return r, t


def _same_arrays(port_index, ref_index):
    for f in ti.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(port_index, f).numpy(),
                                      np.asarray(getattr(ref_index, f)), err_msg=f)
    assert port_index.static_dict() == {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS}


def _same_results(got, want):
    np.testing.assert_array_equal(got.pids.numpy(), np.asarray(want.pids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    if want.funnel is not None:
        assert set(got.funnel) == set(want.funnel)
        for f, v in want.funnel.items():
            np.testing.assert_array_equal(got.funnel[f], np.asarray(v), err_msg=f)


# --------------------------------------------------------------------------
# segments and search
# --------------------------------------------------------------------------
def test_delta_segments_equal_reference(corpus):
    r, t = _pair(corpus)
    assert t.num_segments == r.num_segments == 4 and t.generation == r.generation
    for a, b in zip(t.snapshot().segments[1:], r.snapshot().segments[1:]):
        _same_arrays(a, b)
    np.testing.assert_array_equal(t.tombstones(), r.tombstones())
    snap = t.snapshot()
    assert snap.offsets == tuple(r.snapshot().offsets) and snap is t.snapshot()
    for a, w in zip(snap.alive, r.snapshot().alive):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("backend", ["live", "live-cuda"])
def test_search_equals_reference_before_and_after_compaction(corpus, backend, caps):
    docs, _, qs, _ = corpus
    r, t = _pair(corpus)
    rr = rret.from_index(r, backend="live", params=rret.SearchParams(**CAPS[caps]))
    tr = tret.from_index(t, backend=backend, params=tret.SearchParams(**CAPS[caps]))
    for funnel in (False, True):
        _same_results(tr.search_batch(qs, with_funnel=funnel),
                      rr.search_batch(jnp.asarray(qs), with_funnel=funnel))
    _same_results(tr.search_batch(qs, t_cs=0.6), rr.search_batch(jnp.asarray(qs), t_cs=0.6))
    one, want = tr.search(qs[2], with_funnel=True), rr.search(jnp.asarray(qs[2]), with_funnel=True)
    _same_results(one, want)
    assert all(isinstance(v, int) for v in one.funnel.values())
    got = tr.search_batch(qs, with_funnel=True)
    assert not set(got.pids.flatten().tolist()) & set(DEAD)
    assert got.funnel["alive_dropped"].sum() > 0 or caps == "truncating"
    # compaction: the same pid map and base, the same rankings after it
    np.testing.assert_array_equal(tr.compact(), rr.compact())
    _same_arrays(t.base, r.base)
    assert t.num_segments == 1 and t.num_deleted == 0 and t.generation == r.generation
    _same_results(tr.search_batch(qs, with_funnel=True),
                  rr.search_batch(jnp.asarray(qs), with_funnel=True))


def test_compaction_equals_a_rebuild_of_the_survivors(corpus):
    """The compacted base is array-identical to ``build_index`` over the
    surviving passages against the frozen tables (the reference's
    contract), and ``compact_segments`` returns the reference's pid map."""
    docs, _, _, base = corpus
    r, t = _pair(corpus)
    snap = t.snapshot()
    new_base, pid_map = tlive.compact_segments(list(snap.segments), t.tombstones())
    want_base, want_map = rlive.compact_segments(list(r.snapshot().segments), r.tombstones())
    np.testing.assert_array_equal(pid_map, want_map)
    _same_arrays(new_base, want_base)
    alive = ~t.tombstones()
    rebuilt = ri.build_index([d for d, a in zip(docs, alive) if a],
                             centroids=base.centroids, codec=base.codec)
    for f in ("codes", "residuals", "doc_offsets", "ivf_pids", "ivf_offsets", "eivf_eids"):
        np.testing.assert_array_equal(getattr(new_base, f).numpy(),
                                      np.asarray(getattr(rebuilt, f)), err_msg=f)
    with pytest.raises(ValueError, match="every passage"):
        tlive.compact_segments(list(snap.segments), np.ones(t.num_passages, bool))


def test_compact_reconciles_racing_mutations(corpus, monkeypatch):
    """The merge runs outside the index lock; a delete and an append that
    land mid-merge survive the swap (the delete re-applied to the new base,
    the racing segment kept as a delta, the pid map covering the tail)."""
    import repro_torch.live.index as live_index_mod

    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base))
    lv.add_passages(docs[70:90])

    merged, release = threading.Event(), threading.Event()
    real_compact = live_index_mod.compact_segments

    def stalled_compact(segments, tombstones):
        out = real_compact(segments, tombstones)
        merged.set()  # merge done, swap not yet taken
        assert release.wait(timeout=60)
        return out

    monkeypatch.setattr(live_index_mod, "compact_segments", stalled_compact)
    result: dict = {}
    th = threading.Thread(target=lambda: result.update(m=lv.compact()))
    th.start()
    assert merged.wait(timeout=60)
    assert lv.delete([5]) == 1
    new_pids = lv.add_passages(docs[90:100])
    release.set()
    th.join(timeout=60)
    full_map = result["m"]

    assert lv.num_deltas == 1, "the racing segment must survive the swap"
    assert full_map.shape[0] == 100
    assert lv.tombstones()[full_map[5]] and lv.num_deleted == 1
    np.testing.assert_array_equal(full_map[new_pids], lv.base.num_passages + np.arange(10))
    eng = tlive.LiveEngine(lv, tret.backends.to_engine_params(tret.SearchParams(**CAPS["lossless"])))
    _, pids = eng.search(docs[95][:6])
    assert int(pids[0]) == int(full_map[new_pids[5]])
    _, pids5 = eng.search(docs[5][:6])
    assert int(full_map[5]) not in pids5.tolist()


# --------------------------------------------------------------------------
# writer and compactor
# --------------------------------------------------------------------------
def test_index_writer_buffers_and_flushes(corpus):
    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base))
    w = tlive.IndexWriter(lv)
    w.add(docs[70])
    w.add(docs[71:80])
    assert w.pending == 10 and lv.num_deltas == 0  # buffered, not visible
    np.testing.assert_array_equal(w.flush(), np.arange(70, 80))
    assert lv.num_deltas == 1 and w.pending == 0 and w.flush().size == 0
    assert w.delete([70, 71]) == 2
    w2 = tlive.IndexWriter(lv, flush_every=5)
    for d in docs[80:85]:
        w2.add(torch.from_numpy(np.asarray(d)))  # tensors buffer as arrays do
    assert w2.pending == 0 and lv.num_deltas == 2
    with tlive.IndexWriter(lv) as w3:
        w3.add(docs[85:88])
    assert lv.num_passages == 88 and lv.num_deltas == 3


def test_compactor_thread_and_final_flush(corpus, tmp_path):
    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base))
    with tlive.Compactor(lv, min_deltas=2, interval_s=0.01):
        lv.add_passages(docs[70:80])
        lv.add_passages(docs[80:90])
        deadline = time.time() + 30
        while lv.num_deltas >= 2 and time.time() < deadline:
            time.sleep(0.02)
    assert lv.num_deltas < 2, "the background compactor never ran"
    assert lv.num_passages == 90
    # stop(final_compact=True) compacts and spills below min_deltas
    lv.add_passages(docs[90:100])
    lv.delete([3])
    c = tlive.Compactor(lv, min_deltas=4, spill_path=str(tmp_path)).start()
    assert c.maybe_compact() is None
    c.stop(final_compact=True)
    assert lv.num_deltas == 0 and lv.num_deleted == 0 and c.compactions == 1
    assert c.last_error is None
    back = rlive.LiveIndex.load(str(tmp_path))  # the reference reads the spill
    assert back.num_passages == 99 and back.num_deltas == 0
    _same_arrays(lv.base, back.base)


def test_compactor_errors_are_kept_and_retried(corpus):
    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base), tombstones=np.ones(N_BASE, bool))
    lv.add_passages(docs[70:72])
    lv.delete([70, 71])
    c = tlive.Compactor(lv, min_deltas=1, interval_s=0.01).start()
    deadline = time.time() + 30
    while c.last_error is None and time.time() < deadline:
        time.sleep(0.02)
    c.stop()
    assert isinstance(c.last_error, ValueError) and lv.num_deltas == 1


# --------------------------------------------------------------------------
# manifests, both directions
# --------------------------------------------------------------------------
def test_port_directory_loads_in_reference_and_back(corpus, tmp_path):
    _, _, qs, _ = corpus
    r, t = _pair(corpus)
    path = str(tmp_path / "port")
    t.save(path)
    m = json.load(open(os.path.join(path, "manifest.json")))
    assert m["format_version"] == 2 and len(m["segments"]) == 4
    assert m["generation"] == t.generation and m["tombstones"]
    back = rlive.LiveIndex.load(path)
    assert back.generation == t.generation and back.num_deltas == 3
    np.testing.assert_array_equal(back.tombstones(), t.tombstones())
    for a, b in zip(t.snapshot().segments, back.snapshot().segments):
        _same_arrays(a, b)
    again = tlive.LiveIndex.load(path, device="cpu")
    assert again.num_deltas == 3 and again._uuid == t._uuid
    p = rret.SearchParams(**CAPS["truncating"])
    _same_results(tret.from_index(again, backend="live", params=tret.SearchParams(**CAPS["truncating"])).search_batch(qs),
                  rret.from_index(back, backend="live", params=p).search_batch(jnp.asarray(qs)))


def test_reference_directory_loads_in_port(corpus, tmp_path):
    _, _, qs, _ = corpus
    r, _ = _pair(corpus)
    path = str(tmp_path / "ref")
    rr = rret.from_index(r, backend="live", params=rret.SearchParams(**CAPS["lossless"]))
    rr.save(path)
    tr = tret.load(path, device="cpu")  # backend and params from retriever.json
    assert tr.backend_name == "live" and tr.params == tret.SearchParams(**CAPS["lossless"])
    assert tr.index.generation == r.generation and tr.index._uuid == r._uuid
    for a, b in zip(tr.index.snapshot().segments, r.snapshot().segments):
        _same_arrays(a, b)
    _same_results(tr.search_batch(qs, with_funnel=True),
                  rr.search_batch(jnp.asarray(qs), with_funnel=True))
    cuda = tret.load(path, backend="live-cuda", device="cpu")
    _same_results(cuda.search_batch(qs), rr.search_batch(jnp.asarray(qs)))


def test_v1_directory_loads_as_one_base_segment(corpus, tmp_path):
    _, _, qs, base = corpus
    rindexer.save_index_v1(str(tmp_path), base)
    lv = tlive.LiveIndex.load(str(tmp_path), device="cpu")
    assert lv.num_segments == 1 and lv.num_deleted == 0 and lv.generation == 0
    _same_arrays(lv.base, base)
    assert tret.load(str(tmp_path), device="cpu").backend_name == "plaid"


def test_unknown_version_and_stale_generation_fail(corpus, tmp_path):
    _, t = _pair(corpus)
    path = str(tmp_path)
    t.save(path)
    with pytest.raises(tman.StaleGenerationError):
        tman.load_segmented(path, min_generation=t.generation + 1, device="cpu")
    assert tman.load_segmented(path, min_generation=t.generation, device="cpu")[3] == t.generation
    mpath = os.path.join(path, "manifest.json")
    m = json.load(open(mpath))
    m["format_version"] = 99
    json.dump(m, open(mpath, "w"))
    with pytest.raises(ValueError, match="format_version"):
        tlive.LiveIndex.load(path, device="cpu")
    with pytest.raises(ValueError, match="format_version"):
        tret.load(path, device="cpu")


def test_stale_generation_files_are_collected(corpus, tmp_path):
    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base))
    lv.add_passages(docs[70:90])
    lv.delete([3])
    path = str(tmp_path)
    lv.save(path)
    gen0 = lv.generation
    assert f"tombstones_{gen0:06d}.npy" in os.listdir(path)
    lv.compact()
    lv.save(path)
    after = set(os.listdir(path))
    assert f"tombstones_{gen0:06d}.npy" not in after
    assert len([e for e in after if e.startswith("seg_")]) == 1
    back = rlive.LiveIndex.load(path)
    assert back.generation == lv.generation and back.num_passages == lv.num_passages


def test_save_within_a_lineage_skips_segments_on_disk(corpus, tmp_path, monkeypatch):
    docs, _, _, base = corpus
    lv = tlive.LiveIndex(_port(base))
    lv.add_passages(docs[70:80])
    path = str(tmp_path)
    lv.save(path)
    written = []
    real = tman.write_segment
    monkeypatch.setattr(tman, "write_segment",
                        lambda d, seg, **kw: written.append(os.path.basename(d))
                        or real(d, seg, **kw))
    lv.add_passages(docs[80:90])
    lv.save(path)
    assert written == ["seg_000002"]  # the base and the first delta stay
    other = tlive.LiveIndex(lv.base, lv.snapshot().segments[1:], seg_ids=[0, 1, 2])
    other.save(path)  # another lineage rewrites every segment
    assert written == ["seg_000002", "seg_000000", "seg_000001", "seg_000002"]
    assert rlive.LiveIndex.load(path).num_deltas == 2


def test_single_segment_loader_still_refuses_live_directories(corpus, tmp_path):
    _, t = _pair(corpus)
    t.save(str(tmp_path))
    with pytest.raises(ValueError, match="live index"):
        tindexer.load_index(str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------
def test_facade_build_from_index_describe_and_sniffing(corpus, tmp_path):
    docs, _, qs, base = corpus
    params = CAPS["truncating"]
    frozen = dict(centroids=np.asarray(base.centroids), codec=base.codec)
    want = rret.build(docs[:N_BASE], backend="live", params=rret.SearchParams(**params),
                      index=frozen)
    got = tret.build(docs[:N_BASE], backend="live-cuda", device="cpu",
                     params=tret.SearchParams(**params), index=frozen)
    assert isinstance(got, tret.MutableRetriever)
    _same_arrays(got.index.base, want.index.base)
    np.testing.assert_array_equal(got.add_passages(docs[70:90]), want.add_passages(docs[70:90]))
    assert got.delete_passages([1, 75]) == want.delete_passages([1, 75]) == 2
    assert got.generation == want.generation == 2
    _same_results(got.search_batch(qs, with_funnel=True),
                  want.search_batch(jnp.asarray(qs), with_funnel=True))
    d, w = got.describe(), want.describe()
    assert set(w) <= set(d) and d["impl"] == "cuda" and d["device"] == "cpu"
    for key in ("static", "dynamic", "index"):
        assert d[key] == w[key], key
    assert d["compile"] == dict(trace_count=0)  # eager: nothing is traced
    assert tuple(d["static_fields"]) == tuple(w["static_fields"])
    with pytest.raises(ValueError, match="with_diagnostics"):
        got.search_batch(qs, with_diagnostics=True)
    # a bare live directory (no retriever.json) sniffs as "live", before
    # and after a compaction leaves one clean segment
    bare = str(tmp_path / "bare")
    got.index.save(bare)
    assert tret.load(bare, device="cpu").backend_name == "live"
    got.compact()
    got.index.save(bare)
    assert tret.load(bare, device="cpu").backend_name == "live"
    writer = got.writer(flush_every=2)
    writer.add(docs[90:92])
    assert got.index.num_deltas == 1
    assert isinstance(got.compactor(min_deltas=3), tlive.Compactor)


def test_sharded_live_directory_is_refused(corpus, tmp_path):
    """A directory stamped ``"sharding"`` is no longer refused: it sniffs
    as ``live-sharded`` at the stamped shard count, and ``backend="live"``
    reads the same segments unsharded, with the same ranking.  Only a
    manifest that is both a shard layout and a segment manifest is."""
    _, t = _pair(corpus)
    path = str(tmp_path)
    t.save(path)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps(dict(manifest, sharding=dict(n_shards=2))))
    sharded = tret.load(path, device="cpu")
    assert sharded.backend_name == "live-sharded" and sharded.n_shards == 2
    plain = tret.load(path, backend="live", device="cpu")
    assert plain.backend_name == "live"
    assert {"live-sharded", "live-sharded-cuda"} <= set(tret.list_backends())
    (tmp_path / "manifest.json").write_text(json.dumps(dict(manifest, n_shards=2)))
    with pytest.raises(ValueError, match="mixed manifest"):
        tret.load(path, device="cpu")


# --------------------------------------------------------------------------
# live-sharded: the base sharded over a mesh of the host, deltas replicated
# --------------------------------------------------------------------------
SHARD_CAPS = dict(nprobe=4, t_cs=0.3, ndocs=256, candidate_cap=256)


@pytest.mark.parametrize("n_deltas", [0, 1, 3])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_live_sharded_rank_identity_vs_rebuild(corpus, n_shards, n_deltas):
    """A sharded base with stacked deltas ranks, under non-truncating caps,
    as a one-shard rebuild of the surviving corpus against the frozen
    tables (the reference's grid, ``tests/test_exec.py``)."""
    docs, _, qs, base = corpus
    t_base = _port(base)
    lv = tlive.LiveIndex(t_base)
    if n_deltas:
        for chunk in np.array_split(np.arange(N_BASE, len(docs)), n_deltas):
            lv.add_passages([docs[i] for i in chunk])
        lv.delete([7, 40, 75, 110])
    else:
        lv.delete([7, 40])
    used = docs[: lv.num_passages]
    k = lv.num_alive  # the full ranking: the strictest comparison
    params = tplaid.SearchParams(k=k, **SHARD_CAPS)
    eng = tlive.LiveEngine(lv, params, n_shards=n_shards)
    assert eng.n_shards == n_shards
    got_s, got_p = eng.search_batch(qs)
    alive = ~lv.tombstones()
    rebuilt = ti.build_index([d for d, a in zip(used, alive) if a], centroids=t_base.centroids,
                             codec=t_base.codec, device="cpu")
    want_s, want_p = tplaid.PlaidEngine(rebuilt, params).search_batch(qs)
    to_global = np.flatnonzero(alive)
    want_p = want_p.numpy()
    np.testing.assert_array_equal(got_p.numpy(), np.where(want_p >= 0, to_global[want_p], -1))
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def ref_live_sharded(corpus):
    """The reference's one-shard ``live-sharded`` results, searched once per
    caps (each search compiles a program of its own)."""
    _, _, qs, _ = corpus
    done = {}

    def get(caps):
        if caps not in done:
            r, _ = _pair(corpus)
            want = rret.from_index(r, backend="live-sharded", n_shards=1,
                                   params=rret.SearchParams(**CAPS[caps]))
            done[caps] = want.search_batch(jnp.asarray(qs), with_funnel=True)
        return done[caps]

    return get


@pytest.mark.parametrize("backend", ["live-sharded", "live-sharded-cuda"])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_live_sharded_one_shard_equals_reference(corpus, ref_live_sharded, caps, backend):
    """At one shard the port's live-sharded backends give the reference's
    ``live-sharded`` ranking over the same frozen-table base, deltas and
    tombstones, and every funnel field."""
    _, _, qs, _ = corpus
    _, t = _pair(corpus)
    got = tret.from_index(t, backend=backend, n_shards=1, params=tret.SearchParams(**CAPS[caps]))
    assert got.n_shards == 1 and got.describe()["sharding"]["mesh"] is None
    _same_results(got.search_batch(qs, with_funnel=True), ref_live_sharded(caps))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_live_sharded_backend_roundtrip(corpus, tmp_path, n_shards):
    docs, _, qs, _ = corpus
    params = tret.SearchParams(k=5, **SHARD_CAPS)
    r = tret.build(docs[:100], backend="live-sharded", n_shards=n_shards, device="cpu",
                   params=params, index=dict(num_centroids=32, kmeans_iters=3))
    assert isinstance(r, tret.MutableRetriever)
    pids = r.add_passages(docs[100:120])
    np.testing.assert_array_equal(pids, np.arange(100, 120))
    assert r.delete_passages(pids[:2]) == 2
    res = r.search_batch(qs)
    assert res.backend == "live-sharded" and res.pids.shape == (qs.shape[0], 5)
    d = r.describe()
    assert d["sharding"]["n_shards"] == n_shards and d["index"]["num_deltas"] == 1
    path = str(tmp_path)
    r.save(path)
    assert json.loads((tmp_path / "manifest.json").read_text())["sharding"] == {"n_shards": n_shards}
    r2 = tret.load(path, device="cpu")  # with retriever.json
    assert r2.backend_name == "live-sharded" and r2.n_shards == n_shards
    os.unlink(os.path.join(path, "retriever.json"))
    r3 = tret.load(path, params=r.params, device="cpu")  # sniffed from the stamp
    assert r3.backend_name == "live-sharded" and r3.n_shards == n_shards
    for again in (r2, r3):
        got = again.search_batch(qs)
        assert torch.equal(got.pids, res.pids) and torch.equal(got.scores, res.scores)
    back = rlive.LiveIndex.load(path)  # the reference reads the same segments
    assert back.num_passages == 120 and back.num_deleted == 2


def test_live_sharded_through_batching_server(corpus):
    from repro_torch.serving.server import BatchingServer

    docs, _, qs, _ = corpus
    r = tret.build(docs[:100], backend="live-sharded", n_shards=2, device="cpu",
                   params=tret.SearchParams(k=5, **SHARD_CAPS),
                   index=dict(num_centroids=32, kmeans_iters=3))
    srv = BatchingServer(r, batch_size=4, max_wait_ms=1.0)
    try:
        pids = srv.add_passages(docs[100:110])
        assert srv.delete_passages(pids[:2]) == 2
        res = srv.search(qs[0])
        assert res.pids.shape == (5,)
        direct = r.search_batch(qs[:1])
        np.testing.assert_array_equal(np.asarray(res.pids), direct.pids[0].numpy())
    finally:
        srv.shutdown()
    assert r.describe()["index"]["num_deleted"] == 2


def test_live_sharded_compaction_reshards(corpus):
    """After ``compact()`` the executor re-shards the new base (a new
    segment id) and the ranking is the old one through the pid map."""
    docs, _, qs, base = corpus
    lv = tlive.LiveIndex(_port(base))
    lv.add_passages(docs[N_BASE:100])
    lv.delete([3, 80])
    eng = tlive.LiveEngine(lv, tplaid.SearchParams(k=10, **SHARD_CAPS), n_shards=2)
    s0, p0 = eng.search_batch(qs)
    sid0 = eng._base_shards["sid"]
    pid_map = lv.compact()
    s1, p1 = eng.search_batch(qs)  # a re-sharded base, no deltas
    assert eng._base_shards["sid"] != sid0
    assert eng._base_shards["per"] == -(-lv.base.num_passages // 2)
    np.testing.assert_array_equal(np.where(p0.numpy() >= 0, pid_map[p0.numpy()], -1), p1.numpy())
    np.testing.assert_allclose(s0.numpy(), s1.numpy(), atol=1e-5)


def test_certify_live_delta_record_equals_reference(corpus):
    docs, topics, _, _ = corpus
    idx_r = ri.build_index(docs, num_centroids=48, nbits=2, kmeans_iters=3, seed=1)
    qset = synthetic_query_set(docs, topics, 6, seed=2)
    records, failures = tsweep.certify_backends(_port(idx_r), qset, docs=docs,
                                                backends=["live"], device="cpu")
    want, want_failures = rsweep.certify_backends(idx_r, qset, docs=docs, backends=["live"])
    assert failures == want_failures == []
    got = {r["variant"]: r for r in records}
    for w in want:
        g = got[w["variant"]]
        assert g["metrics"] == w["metrics"] and g["delta"] == w["delta"], w["variant"]
        assert g["passed"] == w["passed"]
    # the record's ranking is the reference's live-delta ranking: its base
    # over the first half against the frozen tables, the rest as a delta
    live_delta = got["live-delta"]
    assert live_delta["backend"] == tsweep.LIVE_VARIANT_BACKEND
    half = len(docs) // 2
    ref_live = rret.from_index(
        ri.build_index(docs[:half], centroids=idx_r.centroids, codec=idx_r.codec),
        backend="live", params=rsweep.lossless_params(idx_r))
    ref_live.add_passages(docs[half:])
    want_res = ref_live.search_batch(jnp.asarray(qset.queries, jnp.float32))
    np.testing.assert_array_equal(live_delta["pids"], np.asarray(want_res.pids))
    np.testing.assert_allclose(live_delta["scores"], np.asarray(want_res.scores), **TOL)


@pytest.mark.gpu
def test_live_cuda_equals_live_on_card():
    """On the card: ``live-cuda`` (K1-K3 on every segment) and ``live``
    give identical pids, scores and funnels with deltas and tombstones,
    fused or not, and ``live-cuda`` over a bare base equals ``plaid-cuda``
    (its pids put in the merge's order: equal scores by pid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    docs, _ = syn.embedding_corpus(600, dim=64, min_len=6, max_len=40, seed=2)
    qs, _ = syn.queries_from_docs(docs, 12, q_len=16)
    base = ti.build_index(docs[:400], num_centroids=256, nbits=2, kmeans_iters=3, device="cuda")

    def same_as_plaid_cuda(index, k):
        p = tret.params_for_k(k, candidate_cap=512)
        want = tret.from_index(index.base, backend="plaid-cuda", params=p).search_batch(qs)
        got = tret.from_index(index, backend="live-cuda", params=p).search_batch(qs)
        assert torch.equal(got.scores, want.scores)
        assert torch.equal(got.pids, merge_topk(want.scores, want.pids, k)[1])

    for k in (10, 100):
        same_as_plaid_cuda(tlive.LiveIndex(base), k)
    lv = tlive.LiveIndex(base)
    for a, b in ((400, 500), (500, 560), (560, 600)):
        lv.add_passages(docs[a:b])
    lv.delete(np.arange(0, 600, 9))
    for k, fused in ((10, False), (100, False), (100, True)):
        p = tret.params_for_k(k, candidate_cap=512).replace(fused=fused)
        c = tret.from_index(lv, backend="live-cuda", params=p).search_batch(qs, with_funnel=True)
        r = tret.from_index(lv, backend="live", params=p).search_batch(qs, with_funnel=True)
        assert torch.equal(c.pids, r.pids) and torch.equal(c.scores, r.scores), (k, fused)
        for f, v in r.funnel.items():
            np.testing.assert_array_equal(c.funnel[f], v, err_msg=f)
        assert (c.funnel["alive_dropped"] > 0).any()
        assert not (c.pids.cpu().numpy() % 9 == 0).any()
    # a compaction on a stream of its own: synchronized before the swap, so
    # a search on the default stream right after reads a finished base
    comp = tlive.Compactor(lv, min_deltas=1, stream=torch.cuda.Stream())
    assert comp.maybe_compact() is not None and lv.num_segments == 1
    same_as_plaid_cuda(lv, 10)


@pytest.mark.gpu
def test_stream_compaction_waits_for_work_queued_on_the_readers_stream():
    """A compaction on a stream of its own, queued while the readers'
    stream still has the work that writes its segments queued (no host
    sync in between), merges the finished segments.  The readers run on
    the default stream, then on a stream of their own: the merge begins
    with a copy from pageable host memory, which waits for the default
    stream's queued work anyway (a copy without ``wait_stream`` passes
    the first case on an H100), but not for another stream's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    docs, _ = syn.embedding_corpus(300, dim=64, min_len=6, max_len=40, seed=4)
    base = ti.build_index(docs[:200], num_centroids=128, nbits=2, kmeans_iters=3, device="cuda")
    lv = tlive.LiveIndex(base)
    lv.add_passages(docs[200:])
    lv.delete(np.arange(0, 300, 7))
    segs = lv.snapshot().segments
    want, want_map = tlive.compact_segments(segs, lv.tombstones())
    for readers in (torch.cuda.current_stream(), torch.cuda.Stream()):
        # zeroed copies, written on the readers' stream behind a long
        # sleep: a merge that does not wait for that stream reads the zeros
        copies = [{f: torch.zeros_like(getattr(s, f)) for f in ti.ARRAY_FIELDS} for s in segs]
        torch.cuda.synchronize()
        with torch.cuda.stream(readers):
            torch.cuda._sleep(200_000_000)
            for s, c in zip(segs, copies):
                for f, t in c.items():
                    t.copy_(getattr(s, f))
            racing = tlive.LiveIndex(
                *(dataclasses.replace(s, **c) for s, c in zip(segs[:1], copies[:1])),
                [dataclasses.replace(s, **c) for s, c in zip(segs[1:], copies[1:])],
                tombstones=lv.tombstones())
            pid_map = racing.compact(stream=torch.cuda.Stream())
        torch.cuda.synchronize()
        np.testing.assert_array_equal(pid_map, want_map)
        for f in ti.ARRAY_FIELDS:
            assert torch.equal(getattr(racing.base, f), getattr(want, f)), f
