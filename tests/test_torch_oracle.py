"""Port vs reference: the single-query ``_search`` oracle
(``repro_torch.core.plaid._search`` against ``repro.core.plaid._search``),
and the oracle against the port's own batched ``run_pipeline``.

Both packages search the reference's ``build_index`` output, carried across
with ``index_from_numpy``.  ``impl="cuda"`` on CPU tensors runs K5 and K6's
plain versions, which are K1 and K2's at B=1, so it equals ``impl="ref"``
bit for bit.  Against the reference: ranked pids identical, scores within
rtol = atol = 1e-5 (the port sums in the CUDA kernels' order, not XLA's).
Against ``run_pipeline``: the reference's ``tests/test_pipeline.py`` oracle
(a vmap of ``_search``), written as a loop over the lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import index as ri  # noqa: E402
from repro.core import plaid as rplaid  # noqa: E402
from repro.core import scoring as rscoring  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)
N_DOCS = 140

#: paper Table 2 (k = 10, 100), and tight caps that cut at every stage
CAPS = {
    "paper10": dict(k=10, nprobe=1, t_cs=0.5, ndocs=256, candidate_cap=8192),
    "paper100": dict(k=100, nprobe=2, t_cs=0.45, ndocs=1024, candidate_cap=8192),
    "tight": dict(k=5, nprobe=2, t_cs=0.4, ndocs=40, candidate_cap=64),
}


@pytest.fixture(scope="module")
def corpus():
    docs, _ = syn.embedding_corpus(N_DOCS, dim=32, min_len=6, max_len=18, seed=5)
    qs, _ = syn.queries_from_docs(docs, 4, q_len=6, seed=6)
    return docs, np.asarray(qs, np.float32)


_INDEXES: dict = {}


def _indexes(docs, nbits):
    """(reference index, the port's copy of it on the CPU), one per nbits."""
    if nbits not in _INDEXES:
        ref = ri.build_index(docs, num_centroids=64, nbits=nbits, kmeans_iters=3)
        arrays = {f: np.asarray(getattr(ref, f)) for f in ti.ARRAY_FIELDS}
        static = {f: getattr(ref, f) for f in ti.STATIC_FIELDS}
        _INDEXES[nbits] = (ref, ti.index_from_numpy(arrays, static, "cpu"))
    return _INDEXES[nbits]


def _kwargs(caps, impl):
    """The engine's corpus-clamped keyword caps, for either package."""
    p = tplaid.clamp_params(tplaid.SearchParams(**caps, impl=impl), N_DOCS)
    return dict(k=p.k, nprobe=p.nprobe, ndocs=p.ndocs, candidate_cap=p.candidate_cap,
                impl=impl, score_dtype=p.score_dtype)


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("nbits", [2, 4])
def test_search_matches_reference(corpus, nbits, caps):
    docs, qs = corpus
    ref_idx, port_idx = _indexes(docs, nbits)
    t_cs = CAPS[caps]["t_cs"]
    qm = np.ones(qs.shape[1], np.float32)
    qm[-1] = 0.0  # one masked query token
    tops.reset_launch_counts()
    for q in qs:
        want_s, want_p, want_d = rplaid._search(
            ref_idx, jnp.asarray(q), jnp.asarray(qm), t_cs=t_cs, diag=True,
            **_kwargs(CAPS[caps], "ref"),
        )
        got = {
            impl: tplaid._search(port_idx, torch.from_numpy(q), torch.from_numpy(qm),
                                 t_cs=t_cs, diag=True, **_kwargs(CAPS[caps], impl))
            for impl in ("ref", "cuda")
        }
        scores, pids, diag = got["ref"]
        assert pids.shape == np.asarray(want_p).shape
        np.testing.assert_array_equal(pids.numpy(), np.asarray(want_p))
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), **TOL)
        assert {k: int(v) for k, v in diag.items()} == {k: int(v) for k, v in want_d.items()}
        assert torch.equal(got["cuda"][1], pids) and torch.equal(got["cuda"][0], scores)
    # on CPU tensors the K5 / K6 wrappers ran their plain versions
    assert set(tops.launch_counts().values()) == {0}


def test_search_takes_precomputed_stage1_scores(corpus):
    """``s_cq=`` (a batched engine's one C.Q^T product, one lane of it)
    gives what the oracle computes itself."""
    docs, qs = corpus
    _, port_idx = _indexes(docs, 2)
    kw = _kwargs(CAPS["tight"], "cuda")
    s_all = tp.stage1_scores_batched(port_idx, torch.from_numpy(qs))
    for b, q in enumerate(qs):
        q = torch.from_numpy(q)
        own = tplaid._search(port_idx, q, None, t_cs=0.4, **kw)
        given = tplaid._search(port_idx, q, None, s_all[b], t_cs=0.4, **kw)
        assert torch.equal(own[1], given[1]) and torch.equal(own[0], given[0])


def test_candidate_generation_matches_reference_at_a_full_cap(corpus):
    """candidate_cap = num_passages: the pads sort past every real pid, so
    no real candidate is evicted, as in the reference."""
    docs, qs = corpus
    ref_idx, port_idx = _indexes(docs, 2)
    for q, nprobe in zip(qs, (1, 8, 64, 64)):
        s_ref = rscoring.centroid_scores(jnp.asarray(q), ref_idx.centroids)
        want = rplaid.candidate_generation(ref_idx, s_ref, nprobe, N_DOCS)
        got = tplaid.candidate_generation(port_idx, torch.from_numpy(np.array(s_ref)), nprobe, N_DOCS)
        assert got.shape == (N_DOCS,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).all()  # nprobe = K lists every passage


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("caps,score_dtype", [
    ("paper10", "float32"), ("tight", "float32"), ("tight", "bfloat16"),
])
def test_search_matches_run_pipeline_lane_by_lane(corpus, impl, caps, score_dtype):
    docs, qs = corpus
    _, port_idx = _indexes(docs, 2)
    params = tplaid.SearchParams(**CAPS[caps], impl=impl, score_dtype=score_dtype)
    eng = tplaid.PlaidEngine(port_idx, params)
    new_s, new_p = eng.search_batch(qs)
    for b, q in enumerate(qs):
        old_s, old_p = tplaid._search(
            port_idx, torch.from_numpy(q), None, t_cs=eng.params.t_cs, **eng._kwargs()
        )
        np.testing.assert_array_equal(new_p[b].numpy(), old_p.numpy())
        np.testing.assert_allclose(new_s[b].numpy(), old_s.numpy(), atol=1e-5)


def test_search_refuses_an_unknown_impl(corpus):
    docs, qs = corpus
    _, port_idx = _indexes(docs, 2)
    with pytest.raises(ValueError, match="impl"):
        tplaid._search(port_idx, torch.from_numpy(qs[0]), **dict(_kwargs(CAPS["tight"], "ref"), impl="pallas"))
