"""Port vs reference: the partition layer (``repro_torch.distributed.topk``,
``repro_torch.exec.{plan,segments,live}`` against ``repro.distributed.topk``
and ``repro.exec``).

``merge_topk`` must rank as the reference's ``jax.lax.sort`` does, signed
zeros and pads included; the port's stacked group (a loop over the real
segments) must give the reference's padded, stacked, vmapped program's
pids, scores (relative 1e-5) and every funnel field, with 1, 2 and 3
deltas (3 pads a filler segment there), under lossless caps and under
truncating caps where the group's clamp basis binds.  Segments are built
with the reference's ``build_index`` against frozen tables and carried
across with ``index_from_numpy``.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import index as ri  # noqa: E402
from repro.core import plaid as rplaid  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro.distributed import topk as rtopk  # noqa: E402
from repro.exec import segments as rseg  # noqa: E402
from repro_torch import live as tlive  # noqa: E402
from repro_torch.constants import NEG  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.distributed import topk as ttopk  # noqa: E402
from repro_torch.exec import ExecutionPlan, LiveExecutor  # noqa: E402
from repro_torch.exec import segments as tseg  # noqa: E402
from repro_torch.obs.funnel import FunnelStats  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
#: every candidate survives every stage at these caps (the corpus is small)
LOSSLESS = dict(k=6, nprobe=4, t_cs=0.3, ndocs=256, candidate_cap=256)
#: truncating caps: clamped to a group's largest delta (20 passages) the
#: stage-3 keep is max(20 // 4, 3) = 5, to a 7-passage delta's own count 3
TRUNCATING = dict(k=3, nprobe=2, t_cs=0.45, ndocs=48, candidate_cap=64)
DELTA_SIZES = (20, 12, 7)


def _port(ref_index):
    return ti.index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS},
        "cpu",
    )


# --------------------------------------------------------------------------
# merge_topk
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_merge_topk_equals_reference_on_ties_signed_zeros_and_pads(seed):
    rng = np.random.default_rng(seed)
    values = np.array([-0.0, 0.0, 1.5, -1.5, 2.0, NEG], np.float32)
    for _ in range(40):
        B, m = 3, int(rng.integers(1, 30))
        s = rng.choice(values, size=(B, m))
        p = rng.integers(-1, 25, size=(B, m)).astype(np.int32)
        p[s == NEG] = -1
        k = int(rng.integers(1, m + 3))
        ws, wp = rtopk.merge_topk(jnp.asarray(s), jnp.asarray(p), k)
        gs, gp = ttopk.merge_topk(torch.from_numpy(s), torch.from_numpy(p), k)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(np.signbit(gs.numpy()), np.signbit(np.asarray(ws)))


def test_merge_topk_treats_signed_zeros_as_equal():
    """Unlike ``stable_topk`` (+0.0 above -0.0), the merge lets the pid
    decide between them, as ``jax.lax.sort`` does."""
    pids = torch.tensor([[5, 1]], dtype=torch.int32)
    for row, signs in (([-0.0, 0.0], [False, True]), ([0.0, -0.0], [True, False])):
        s, p = ttopk.merge_topk(torch.tensor([row]), pids, 2)
        assert p.tolist() == [[1, 5]]
        assert np.signbit(s.numpy()[0]).tolist() == signs  # each score kept as given


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 6])
def test_merge_topk_invariant_under_partitioning_and_grouping(n_parts):
    """Per-partition top-k lists merged flat, or in groups and then across
    the groups, rank as one merge of everything: ties by ascending pid."""
    rng = np.random.default_rng(n_parts)
    scores = np.repeat(np.asarray([5.0, 4.0, 0.0, -0.0, 3.0], np.float32), 12)
    pids = rng.permutation(60).astype(np.int32)
    k = 9
    flat = ttopk.merge_topk(torch.from_numpy(scores), torch.from_numpy(pids), k)
    parts = [
        ttopk.merge_topk(torch.from_numpy(s), torch.from_numpy(p), k)
        for s, p in zip(np.array_split(scores, n_parts), np.array_split(pids, n_parts))
    ]
    one = ttopk.merge_topk(torch.cat([s for s, _ in parts]), torch.cat([p for _, p in parts]), k)
    groups = [parts[: n_parts // 2 + 1], parts[n_parts // 2 + 1:]]
    merged = [ttopk.merge_topk(torch.cat([s for s, _ in g]), torch.cat([p for _, p in g]), k)
              for g in groups if g]
    two = ttopk.merge_topk(torch.cat([s for s, _ in merged]), torch.cat([p for _, p in merged]), k)
    for got in (one, two):
        assert torch.equal(got[1], flat[1]) and torch.equal(got[0], flat[0])
    want = rtopk.merge_topk(jnp.asarray(scores), jnp.asarray(pids), k)
    np.testing.assert_array_equal(flat[1].numpy(), np.asarray(want[1]))


def test_merge_topk_collective_case_is_left_to_the_multi_gpu_slice():
    """The collective case (``mesh=``) is ported: the per-shard tuples,
    gathered in shard order, merge as their concatenation does, and
    ``local_to_global_pids`` offsets shard-local ids, pads kept."""
    from repro_torch.launch.mesh import Mesh

    rng = np.random.default_rng(3)
    scores = [torch.from_numpy(rng.choice([0.5, 1.0, -0.0, 0.0], (2, 4)).astype(np.float32))
              for _ in range(3)]
    local = [torch.from_numpy(rng.integers(-1, 4, (2, 4)).astype(np.int32)) for _ in range(3)]
    pids = [ttopk.local_to_global_pids(p, s, 4) for s, p in enumerate(local)]
    for s, (lp, gp) in enumerate(zip(local, pids)):
        assert torch.equal(gp, torch.where(lp >= 0, lp + 4 * s, -1))
    got = ttopk.merge_topk(scores, pids, 5, mesh=Mesh(("cpu",) * 3))
    want = ttopk.merge_topk(torch.cat(scores, 1), torch.cat(pids, 1), 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref = rtopk.merge_topk(jnp.asarray(torch.cat(scores, 1).numpy()),
                           jnp.asarray(torch.cat(pids, 1).numpy()), 5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# --------------------------------------------------------------------------
# buckets, offsets, alive masks
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def segments():
    """A reference base of 60 passages (dim 32, K=64) and three deltas of
    DELTA_SIZES passages against its frozen tables; queries; the port's
    copies on the CPU."""
    docs, _ = syn.embedding_corpus(60 + sum(DELTA_SIZES), dim=32, min_len=6, max_len=18, seed=3)
    qs, _ = syn.queries_from_docs(docs, 5, q_len=6)
    base = ri.build_index(docs[:60], num_centroids=64, nbits=2, kmeans_iters=3)
    ref_segs, start = [base], 60
    for n in DELTA_SIZES:
        ref_segs.append(ri.build_index(docs[start:start + n], centroids=base.centroids,
                                       codec=base.codec))
        start += n
    return ref_segs, [_port(s) for s in ref_segs], np.asarray(qs, np.float32)


def test_bucket_offsets_and_alive_equal_reference(segments):
    """The port's bucket keeps the reference's stacked axis size and clamp
    basis; its offsets are the reference's; each segment's own alive mask
    is the reference's packed row with the padding cut off."""
    ref_segs, port_segs, _ = segments
    rng = np.random.default_rng(0)
    for sl in (slice(0, 1), slice(1, 3), slice(1, 4)):
        rb, tb = rseg.bucket_for(ref_segs[sl]), tseg.bucket_for(port_segs[sl])
        assert (tb.n_segments, tb.nd_clamp) == (rb.n_segments, rb.nd_clamp)
        offsets = [int(o) for o in rng.integers(0, 500, len(port_segs[sl]))]
        np.testing.assert_array_equal(tseg.pack_offsets(offsets, tb).numpy(),
                                      np.asarray(rseg.pack_offsets(offsets, rb)))
        alive = [rng.random(s.num_passages) > 0.3 for s in port_segs[sl]]
        rows = np.asarray(rseg.pack_alive(alive, rb))
        for i, a in enumerate(alive):
            np.testing.assert_array_equal(rows[i, : a.shape[0]], a)
            assert not rows[i, a.shape[0]:].any()
        assert not rows[len(alive):].any()  # filler rows are dead
    assert tseg.bucket_for(port_segs[1:]).n_segments == 4  # 3 deltas: one filler


# --------------------------------------------------------------------------
# the stacked group against the reference's stacked program
# --------------------------------------------------------------------------
def _stacked_both(segments, n_deltas, caps, funnel, t_cs):
    ref_segs, port_segs, qs = segments
    rs, ts = ref_segs[1:1 + n_deltas], port_segs[1:1 + n_deltas]
    offsets = list(60 + np.cumsum((0,) + DELTA_SIZES[: n_deltas - 1]))
    rng = np.random.default_rng(n_deltas)
    alive = [rng.random(s.num_passages) > 0.2 for s in ts]
    rb, tb = rseg.bucket_for(rs), tseg.bucket_for(ts)
    stacked, shared = rseg.pack_segments(rs, rb)
    rfn = rseg.make_stacked_search(rplaid.SearchParams(**caps), rb, funnel=funnel)
    qm = np.ones(qs.shape[:2], np.float32)
    want = rfn(stacked, shared, jnp.asarray(qs), jnp.asarray(qm), jnp.float32(t_cs),
               rseg.pack_offsets(offsets, rb), rseg.pack_alive(alive, rb))
    tfn = tseg.make_stacked_search(tplaid.SearchParams(**caps), tb, funnel=funnel)
    got = tfn(ts, torch.from_numpy(qs), torch.from_numpy(qm), t_cs,
              tseg.pack_offsets(offsets, tb), [torch.from_numpy(a) for a in alive])
    return got, want


def _assert_same(got, want, funnel):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    if funnel:
        assert isinstance(got[2], FunnelStats)
        for f in FunnelStats._fields:
            np.testing.assert_array_equal(getattr(got[2], f).numpy(),
                                          np.asarray(getattr(want[2], f)), err_msg=f)


@pytest.mark.parametrize("caps", ["lossless", "truncating"])
@pytest.mark.parametrize("n_deltas", [1, 2, 3])
def test_stacked_group_equals_reference_stacked_program(segments, n_deltas, caps):
    params = LOSSLESS if caps == "lossless" else TRUNCATING
    got, want = _stacked_both(segments, n_deltas, params, funnel=True, t_cs=params["t_cs"])
    _assert_same(got, want, funnel=True)
    assert ((got[1] >= 60) | (got[1] == -1)).all()  # global (offset) pids


def test_stacked_group_without_funnel_and_per_lane_t_cs(segments):
    t = np.asarray([0.2, 0.5, 0.35, 0.6, 0.45], np.float32)
    ref_segs, port_segs, qs = segments
    got, want = _stacked_both(segments, 3, TRUNCATING, funnel=False, t_cs=0.45)
    assert len(got) == 2
    _assert_same(got, want, funnel=False)
    # a per-lane (B,) t_cs through the same group
    rs, ts = ref_segs[1:], port_segs[1:]
    rb, tb = rseg.bucket_for(rs), tseg.bucket_for(ts)
    stacked, shared = rseg.pack_segments(rs, rb)
    offs, alive = [60, 80, 92], [np.ones(s.num_passages, bool) for s in ts]
    qm = np.ones(qs.shape[:2], np.float32)
    want = rseg.make_stacked_search(rplaid.SearchParams(**TRUNCATING), rb)(
        stacked, shared, jnp.asarray(qs), jnp.asarray(qm), jnp.asarray(t),
        rseg.pack_offsets(offs, rb), rseg.pack_alive(alive, rb))
    got = tseg.make_stacked_search(tplaid.SearchParams(**TRUNCATING), tb)(
        ts, torch.from_numpy(qs), torch.from_numpy(qm), torch.from_numpy(t),
        tseg.pack_offsets(offs, tb), [torch.from_numpy(a) for a in alive])
    _assert_same(got, want, funnel=False)


def test_group_clamp_basis_is_the_largest_delta(segments):
    """Under the truncating caps, probing every centroid, the 7-passage
    delta keeps 5 finalists (the group's clamp), not the 3 its own count
    gives."""
    _, port_segs, qs = segments
    tb = tseg.bucket_for(port_segs[1:])
    assert tb.nd_clamp == max(DELTA_SIZES)
    caps = dict(TRUNCATING, nprobe=64)
    got = tseg.make_stacked_search(tplaid.SearchParams(**caps), tb, funnel=True)(
        port_segs[3:], torch.from_numpy(qs), torch.ones(qs.shape[:2]), 0.45,
        tseg.pack_offsets([0], tb), [torch.ones(7, dtype=torch.bool)])
    assert (got[2].stage3_survivors == 5).all()
    own = tplaid.clamp_params(tplaid.SearchParams(**caps), 7)
    *_, fs = tp.run_pipeline(port_segs[3], torch.from_numpy(qs), torch.ones(qs.shape[:2]),
                             0.45, own, funnel=True)
    assert (fs.stage3_survivors == 3).all()


# --------------------------------------------------------------------------
# stage 1 runs once a batch
# --------------------------------------------------------------------------
def _live(port_segs, deltas=3):
    lv = tlive.LiveIndex(port_segs[0], port_segs[1:1 + deltas])
    lv.delete([4, 61, 85])
    return lv


def test_stage1_runs_once_a_batch_and_equals_per_segment_stage1(segments, monkeypatch):
    _, port_segs, qs = segments
    lv = _live(port_segs)
    params = tplaid.SearchParams(**TRUNCATING)
    ex = LiveExecutor(lv, params)
    calls = []
    real = tp.stage1_scores_batched
    monkeypatch.setattr(tp, "stage1_scores_batched",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    shared_out = ex.search_batch(qs, funnel=True)
    assert len(calls) == 1, "one C·Qᵀ for the base and every delta"
    ex.search_batch(qs, t_cs=0.3)
    assert len(calls) == 2
    # each segment's pipeline with the shared stage 1 equals it with its own
    qt, qm = torch.from_numpy(qs), torch.ones(qs.shape[:2])
    shared = tp.shared_stage1(port_segs[0], qt, 0.45, params)
    snap = lv.snapshot()
    for seg, alive in zip(snap.segments, snap.alive):
        p = tplaid.clamp_params(params, max(DELTA_SIZES))
        a = tp.run_pipeline(seg, qt, qm, 0.45, p, alive=alive, funnel=True, stage1=shared)
        b = tp.run_pipeline(seg, qt, qm, 0.45, p, alive=alive, funnel=True)
        for x, y in zip(a[:2], b[:2]):
            assert torch.equal(x, y)
        for x, y in zip(a[2], b[2]):
            assert torch.equal(x, y)
    assert len(calls) == 2 + 1 + len(snap.segments)
    assert shared_out[1].shape == (qs.shape[0], TRUNCATING["k"])


# --------------------------------------------------------------------------
# the plan and the executor
# --------------------------------------------------------------------------
def test_plan_with_one_group_returns_it_and_merges_several():
    s = torch.tensor([[3.0, 1.0], [2.0, NEG]])
    p = torch.tensor([[7, 2], [4, -1]], dtype=torch.int32)

    def group(out):
        return lambda qs, qm, t, stage1: out

    one = ExecutionPlan((group((s, p)),), k=2).search_batch(None, None, 0.5)
    assert one[0] is s and one[1] is p
    s2 = torch.tensor([[3.0, 0.5], [2.5, 2.0]])
    p2 = torch.tensor([[1, 9], [8, 3]], dtype=torch.int32)
    got = ExecutionPlan((group((s, p)), group((s2, p2))), k=3).search_batch(None, None, 0.5)
    want = ttopk.merge_topk(torch.cat([s, s2], 1), torch.cat([p, p2], 1), 3)
    assert torch.equal(got[1], want[1]) and got[1].tolist() == [[1, 7, 2], [8, 3, 4]]  # ties by pid


def test_executor_refuses_a_sharded_base(segments):
    """A sharded base is taken (``n_shards > 1`` builds a mesh of the
    index's device, ``mesh=`` is used as given); the executor refuses only
    an ``n_shards`` the mesh does not have."""
    from repro_torch.launch.mesh import Mesh

    _, port_segs, _ = segments
    lv = tlive.LiveIndex(port_segs[0])
    ex = LiveExecutor(lv, n_shards=2)
    assert ex.n_shards == 2 and ex.mesh.devices == (torch.device("cpu"),) * 2
    assert LiveExecutor(lv, mesh=Mesh(("cpu",) * 3)).n_shards == 3
    with pytest.raises(ValueError, match="must equal the mesh"):
        LiveExecutor(lv, n_shards=2, mesh=Mesh(("cpu",) * 3))
    one = LiveExecutor(lv, n_shards=1)
    assert one.n_shards == 1 and one.mesh is None


def test_deletes_and_t_cs_reuse_cached_per_segment_data(segments):
    _, port_segs, qs = segments
    lv = tlive.LiveIndex(port_segs[0], port_segs[1:3])
    ex = LiveExecutor(lv, tplaid.SearchParams(**LOSSLESS))
    s0, p0 = ex.search_batch(qs)
    buckets = dict(ex._buckets)
    fns = dict(ex._stacked_fns)
    assert len(buckets) == 2 and len(fns) == 2  # the base group and the deltas
    lv.delete([int(p0[0, 0])])
    s1, p1 = ex.search_batch(qs)
    ex.search_batch(qs, t_cs=0.6)
    assert ex._buckets.keys() == buckets.keys()
    assert all(ex._buckets[k] is v for k, v in buckets.items())
    assert ex._stacked_fns == fns
    assert int(p0[0, 0]) not in p1[0].tolist()
    # a plan is cached per generation; a compaction drops the old lists
    plan = ex.plan_for(lv.snapshot())
    assert ex.plan_for(lv.snapshot()) is plan
    lv.compact()
    ex.search_batch(qs)
    assert len(ex._buckets) == 1 and not set(ex._buckets) & set(buckets)


def test_a_cached_plan_does_not_pin_compacted_segments(segments):
    """After ``compact()`` the superseded segments are freed at once, not
    at the next search: the cached plan holds them weakly."""
    _, port_segs, qs = segments
    lv = tlive.LiveIndex(*(dataclasses.replace(s) for s in port_segs[:1]),
                         [dataclasses.replace(s) for s in port_segs[1:3]])
    ex = LiveExecutor(lv, tplaid.SearchParams(**LOSSLESS))
    before = ex.search_batch(qs)
    plan = ex.plan_for(lv.snapshot())
    old = [weakref.ref(s) for s in lv.snapshot().segments]
    lv.compact()
    gc.collect()
    assert all(r() is None for r in old)
    assert plan is ex._plan  # not rebuilt yet
    after = ex.search_batch(qs)
    assert torch.equal(after[1], before[1])
