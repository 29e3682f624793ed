"""Port vs reference: funnel telemetry (``repro_torch.obs.funnel`` and
``run_pipeline(funnel=True)`` against ``repro.obs.funnel`` and
``repro.core.pipeline``), with and without tombstones and the traced
``nprobe_t`` / ``ndocs_t`` caps.

Both sides get one index: the reference's ``build_index`` output, carried
across with ``index_from_numpy``.  Every ``FunnelStats`` field must equal
the reference's exactly (int equality), and the ranked pids too.  The
``gpu`` case holds ``plaid-cuda`` against ``plaid`` on the card.

Left out of ``tests/test_obs.py``'s funnel tests: the zero-retrace and
single-stage-1-dot checks, which read XLA's jit cache and HLO and have no
meaning for eager PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax.numpy as jnp
    from repro import retrieval as rret
    from repro.core import index as ri
    from repro.core import pipeline as rp
    from repro.core import plaid as rplaid
    from repro.obs import funnel as rfunnel
    from repro.retrieval import backends as rback
except ImportError:
    jnp = None

from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.obs import funnel as tfunnel  # noqa: E402
from repro_torch.obs.funnel import FunnelStats  # noqa: E402
from repro_torch.retrieval import backends as tback  # noqa: E402

PARAMS = dict(k=5, nprobe=2, ndocs=32, candidate_cap=64)
#: a bucket program (nprobe 4, ndocs 64) masked down to (3, 24)
BUCKET = dict(k=5, nprobe=4, ndocs=64, candidate_cap=64)


@pytest.fixture(scope="module")
def funnel_index():
    """(docs, reference index, the port's copy on the CPU, queries) — the
    reference's ``funnel_index`` fixture."""
    if jnp is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, _ = tsyn.embedding_corpus(120, dim=16, min_len=6, max_len=12, seed=3)
    ref = ri.build_index(docs, num_centroids=16, nbits=2, kmeans_iters=3)
    arrays = {f: np.asarray(getattr(ref, f)) for f in ti.ARRAY_FIELDS}
    static = {f: getattr(ref, f) for f in ti.STATIC_FIELDS}
    port = ti.index_from_numpy(arrays, static, "cpu")
    qs, _ = tsyn.queries_from_docs(docs, 6, q_len=4)
    return docs, ref, port, np.asarray(qs, np.float32)


def _run_both(funnel_index, caps, *, t_cs=0.4, alive=None, impl="ref", fused=False,
              nprobe_t=None, ndocs_t=None, diag=False):
    _, ref_idx, port_idx, qs = funnel_index
    qm = np.ones(qs.shape[:2], np.float32)
    rparams = rplaid.SearchParams(**caps, fused=fused)
    tparams = tplaid.SearchParams(**caps, fused=fused, impl=impl)
    want = rp.run_pipeline(
        ref_idx, jnp.asarray(qs), jnp.asarray(qm), jnp.asarray(t_cs), rparams,
        diag=diag, funnel=True, alive=None if alive is None else jnp.asarray(alive),
        nprobe_t=nprobe_t, ndocs_t=ndocs_t,
    )
    got = tp.run_pipeline(
        port_idx, torch.from_numpy(qs), torch.from_numpy(qm), torch.as_tensor(t_cs),
        tparams, diag=diag, funnel=True,
        alive=None if alive is None else torch.from_numpy(alive),
        nprobe_t=nprobe_t, ndocs_t=ndocs_t,
    )
    return want, got


def _assert_funnel_equal(got: FunnelStats, want) -> None:
    assert isinstance(got, FunnelStats)
    assert got._fields == type(want)._fields
    for field in FunnelStats._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.int32, field
        np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


def test_funnel_values_consistent_with_diag(funnel_index):
    """The funnel's shared fields agree exactly with the diag counters,
    every count respects the funnel's monotone narrowing, and every field
    equals the reference's."""
    _, ref_idx, idx, _ = funnel_index
    want, (scores, pids, diag, fs) = _run_both(funnel_index, PARAMS, diag=True)
    for name in ("stage1_candidates", "stage2_kept_centroids", "stage3_survivors"):
        np.testing.assert_array_equal(getattr(fs, name).numpy(), diag[name].numpy())
    s1, s2, s3 = (getattr(fs, f).numpy() for f in
                  ("stage1_candidates", "stage2_survivors", "stage3_survivors"))
    assert (s2 <= s1).all() and (s3 <= s2).all()  # the funnel narrows
    assert (fs.probed_centroids.numpy() <= idx.num_centroids).all()
    assert (fs.alive_dropped.numpy() == 0).all()  # no tombstones here
    assert (fs.gathered_tokens.numpy() > 0).all()
    np.testing.assert_array_equal(pids.numpy(), np.asarray(want[1]))
    _assert_funnel_equal(fs, want[3])


#: (caps, nprobe_t, ndocs_t, tombstones, per-lane t_cs)
CASES = {
    "static": (PARAMS, None, None, False, False),
    "masked": (BUCKET, 3, 24, False, False),
    "masked_ndocs_only": (BUCKET, None, 9, False, False),
    "tombstoned": (PARAMS, None, None, True, False),
    "tombstoned_masked_per_lane_t": (BUCKET, 3, 24, True, True),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_funnel_matches_reference(funnel_index, case, impl, fused):
    """Every FunnelStats field equals the reference's run_pipeline(funnel=True)
    exactly, with and without tombstones and the traced caps (``impl="cuda"``
    runs the kernels' plain versions on CPU tensors)."""
    caps, nprobe_t, ndocs_t, tomb, per_lane = CASES[case]
    n = funnel_index[2].num_passages
    alive = None
    if tomb:
        alive = np.ones(n, bool)
        alive[np.random.default_rng(5).choice(n, n // 3, replace=False)] = False
    t = np.linspace(0.3, 0.6, 6).astype(np.float32) if per_lane else 0.4
    want, got = _run_both(funnel_index, caps, t_cs=t, alive=alive, impl=impl, fused=fused,
                          nprobe_t=nprobe_t, ndocs_t=ndocs_t)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    _assert_funnel_equal(got[2], want[2])
    if tomb:
        assert (got[2].alive_dropped.numpy() > 0).any()


def test_masked_caps_equal_a_static_program(funnel_index):
    """(4, 64) masked down to (3, 24) ranks and counts as a static (3, 24)
    program, except ``probed_centroids``' collapse of the masked probes,
    which also matches."""
    _, _, idx, qs = funnel_index
    qm = torch.ones(qs.shape[:2])
    q = torch.from_numpy(qs)
    masked = tp.run_pipeline(idx, q, qm, 0.4, tplaid.SearchParams(**BUCKET), funnel=True,
                             nprobe_t=3, ndocs_t=24)
    static = tp.run_pipeline(idx, q, qm, 0.4,
                             tplaid.SearchParams(**dict(BUCKET, nprobe=3, ndocs=24)),
                             funnel=True)
    assert torch.equal(masked[1][:, :5], static[1])
    for field in FunnelStats._fields:
        assert torch.equal(getattr(masked[2], field), getattr(static[2], field)), field


def _fs(make, probed, s1):
    return FunnelStats(
        probed_centroids=make([probed]),
        stage1_candidates=make([s1]),
        alive_dropped=make([1]),
        stage2_kept_centroids=make([7]),
        stage2_survivors=make([s1 // 2]),
        stage3_survivors=make([s1 // 4]),
        gathered_tokens=make([s1 * 3]),
    )


def test_funnel_merge_semantics():
    """Doc-partitioned counts ADD, centroid-replicated counts MAX; the
    stacked reduction equals the list merge; both equal the reference's."""

    def make(v):
        return torch.tensor(v, dtype=torch.int32)

    m = tfunnel.merge([_fs(make, 5, 20), _fs(make, 5, 12)])
    assert int(m.stage1_candidates[0]) == 32  # additive: partitioned docs
    assert int(m.gathered_tokens[0]) == 96
    assert int(m.alive_dropped[0]) == 2
    assert int(m.probed_centroids[0]) == 5  # replicated: max, not sum
    assert int(m.stage2_kept_centroids[0]) == 7
    stacked = FunnelStats(*(torch.stack([a, b]) for a, b in
                            zip(_fs(make, 5, 20), _fs(make, 5, 12))))
    r = tfunnel.reduce_stacked(stacked)
    for field in FunnelStats._fields:
        assert getattr(r, field).dtype == torch.int32, field
        assert torch.equal(getattr(r, field), getattr(m, field)), field
    host = tfunnel.to_host(m)
    assert set(host) == set(FunnelStats._fields)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.int32 for v in host.values())
    if jnp is not None:
        def jmake(v):
            return jnp.asarray(v, jnp.int32)

        want = rfunnel.merge([_fs(jmake, 5, 20), _fs(jmake, 5, 12)])
        assert tfunnel.ADDITIVE_FIELDS == rfunnel.ADDITIVE_FIELDS
        assert tfunnel.REPLICATED_FIELDS == rfunnel.REPLICATED_FIELDS
        for field, v in rfunnel.to_host(want).items():
            np.testing.assert_array_equal(host[field], v, err_msg=field)


def test_funnel_alive_dropped_counts_tombstoned_candidates(funnel_index):
    """Tombstoning docs surfaces in alive_dropped and shrinks the funnel,
    with the reference's counts."""
    _, _, idx, _ = funnel_index
    alive = np.ones(idx.num_passages, bool)
    alive[::3] = False  # kill a third of the corpus
    want_dead, (_, pids_dead, fs_dead) = _run_both(funnel_index, PARAMS, alive=alive)
    _, (_, _, fs_all) = _run_both(funnel_index, PARAMS)
    assert (fs_dead.alive_dropped.numpy() > 0).any()
    assert (fs_dead.stage1_candidates <= fs_all.stage1_candidates).all()
    real = pids_dead.numpy()[pids_dead.numpy() >= 0]
    assert alive[real].all()
    _assert_funnel_equal(fs_dead, want_dead[2])


def test_funnel_rejected_on_vanilla(funnel_index):
    docs = funnel_index[0]
    qs = funnel_index[3]
    cfg = tret.RetrieverConfig(
        backend="vanilla",
        params=tret.SearchParams(**PARAMS),
        index=dict(num_centroids=16, nbits=2, kmeans_iters=3, seed=0),
    )
    r = tret.build(docs, cfg, device="cpu")
    with pytest.raises(ValueError, match="with_funnel") as got:
        r.search_batch(qs, with_funnel=True)
    with pytest.raises(ValueError, match="with_funnel"):
        r.search(qs[0], with_funnel=True)
    # the reference's message, word for word
    with pytest.raises(ValueError) as want:
        rback._reject_funnel(rret.SearchRequest(q=qs, with_funnel=True), "vanilla")
    assert str(got.value) == str(want.value)
    assert tback._reject_funnel(tret.SearchRequest(q=qs), "vanilla") is None


def test_funnel_single_query_squeeze(funnel_index):
    docs, _, _, qs = funnel_index
    cfg = tret.RetrieverConfig(
        params=tret.SearchParams(**PARAMS),
        index=dict(num_centroids=16, nbits=2, kmeans_iters=3, seed=0),
    )
    r = tret.build(docs, cfg, device="cpu")
    batched = r.search_batch(qs, with_funnel=True).funnel
    single = r.search(qs[0], with_funnel=True).funnel
    assert set(single) == set(FunnelStats._fields)
    for field, v in single.items():
        assert np.ndim(v) == 0 and isinstance(v, int)
        assert v == int(np.asarray(batched[field])[0])


@pytest.mark.parametrize("backend", ["plaid", "plaid-cuda"])
def test_facade_funnel_matches_reference(funnel_index, backend):
    """``SearchResult.funnel``: host int32 arrays with the reference's keys
    and values, opt-in only, next to unchanged pids and diagnostics."""
    _, ref_idx, idx, qs = funnel_index
    want = rret.from_index(ref_idx, backend="plaid", params=rret.SearchParams(**PARAMS))
    r = tret.from_index(idx, backend=backend, params=tret.SearchParams(**PARAMS))
    w = want.search_batch(jnp.asarray(qs), with_funnel=True, with_diagnostics=True)
    g = r.search_batch(qs, with_funnel=True, with_diagnostics=True)
    assert r.search_batch(qs).funnel is None  # opt-in only
    assert list(g.funnel) == list(w.funnel)
    for field, v in w.funnel.items():
        assert g.funnel[field].dtype == np.int32, field
        np.testing.assert_array_equal(g.funnel[field], v, err_msg=field)
    for name, v in w.diagnostics.items():
        np.testing.assert_array_equal(g.diagnostics[name], v, err_msg=name)
    np.testing.assert_array_equal(g.pids.numpy(), np.asarray(w.pids))
    assert torch.equal(g.pids, r.search_batch(qs).pids)


@pytest.mark.gpu
def test_funnel_plaid_cuda_equals_plaid_on_card():
    """On the card, K1-K3 under the funnel and the caps: plaid-cuda's
    pids and every FunnelStats field equal plaid's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core.index import build_index

    docs, _ = tsyn.embedding_corpus(400, dim=64, min_len=6, max_len=40, seed=2)
    idx = build_index(docs, num_centroids=64, nbits=2, kmeans_iters=3, device="cuda")
    qs, _ = tsyn.queries_from_docs(docs, 8, q_len=12)
    qs, qm = torch.from_numpy(qs).cuda(), torch.ones(8, 12, device="cuda")
    alive = torch.ones(idx.num_passages, dtype=torch.bool, device="cuda")
    alive[::5] = False
    for fused in (False, True):
        for caps, np_t, nd_t in ((PARAMS, None, None), (BUCKET, 3, 24)):
            out = {}
            for impl in ("ref", "cuda"):
                p = tplaid.SearchParams(**caps, fused=fused, impl=impl)
                out[impl] = tp.run_pipeline(idx, qs, qm, 0.4, p, funnel=True, alive=alive,
                                            nprobe_t=np_t, ndocs_t=nd_t)
            assert torch.equal(out["ref"][1], out["cuda"][1])
            for field in FunnelStats._fields:
                assert torch.equal(getattr(out["ref"][2], field),
                                   getattr(out["cuda"][2], field)), field
