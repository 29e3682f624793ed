"""Port vs reference: the batched PLAID pipeline (``repro_torch.core.pipeline``
against ``repro.core.pipeline``, impl ``ref``) on the same index and queries.

Both sides get one index: the reference's ``build_index`` output, carried
across with ``index_from_numpy``.  Ranked pids must be identical and scores
within rtol = atol = 1e-5 (the port sums in the CUDA kernels' order, not
XLA's, which moves the last bits of a float32 sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import index as ri  # noqa: E402
from repro.core import pipeline as rp  # noqa: E402
from repro.core import plaid as rplaid  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.core import scoring  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N_DOCS = 140


@pytest.fixture(scope="module")
def corpus():
    docs, _ = syn.embedding_corpus(N_DOCS, dim=32, min_len=6, max_len=18, seed=0)
    qs, _ = syn.queries_from_docs(docs, 4, q_len=6)
    return docs, np.asarray(qs, np.float32)


# one reference index per nbits, built lazily and shared across the grid
_INDEXES: dict = {}


def _indexes(docs, nbits):
    """(reference index, the port's copy of it on the CPU)."""
    if nbits not in _INDEXES:
        ref = ri.build_index(docs, num_centroids=64, nbits=nbits, kmeans_iters=3)
        arrays = {f: np.asarray(getattr(ref, f)) for f in ti.ARRAY_FIELDS}
        static = {f: getattr(ref, f) for f in ti.STATIC_FIELDS}
        _INDEXES[nbits] = (ref, ti.index_from_numpy(arrays, static, "cpu"))
    return _INDEXES[nbits]


#: paper Table 2 (k=10), and tight caps that truncate at every stage
#: (candidate_cap < corpus, ndocs < cap, stage 3 keeps ndocs // 4)
CAPS = {
    "paper": dict(k=10, nprobe=1, t_cs=0.5, ndocs=256, candidate_cap=8192),
    "tight": dict(k=5, nprobe=2, t_cs=0.4, ndocs=40, candidate_cap=64),
}
LOSSLESS = dict(k=10, nprobe=64, t_cs=-1e9, ndocs=256, candidate_cap=256)


def _both(caps, **kw):
    """The same search params for the two packages (corpus-clamped)."""
    ref = rplaid.clamp_params(rplaid.SearchParams(**caps, **kw), N_DOCS)
    port = tplaid.clamp_params(tplaid.SearchParams(**caps, **kw), N_DOCS)
    return ref, port


def _run_both(docs, qs, nbits, caps, *, t_cs=None, alive=None, diag=False, **kw):
    ref_idx, port_idx = _indexes(docs, nbits)
    rparams, tparams = _both(caps, **kw)
    t = caps["t_cs"] if t_cs is None else t_cs
    B = qs.shape[0]
    qm = np.ones(qs.shape[:2], np.float32)
    want = rp.run_pipeline(
        ref_idx, jnp.asarray(qs), jnp.asarray(qm), jnp.asarray(t), rparams,
        diag=diag, alive=None if alive is None else jnp.asarray(alive),
    )
    got = tp.run_pipeline(
        port_idx, torch.from_numpy(qs), torch.from_numpy(qm), torch.as_tensor(t),
        tparams, diag=diag, alive=None if alive is None else torch.from_numpy(alive),
    )
    assert got[1].dtype == torch.int32 and got[1].shape == (B, rparams.k)
    return want, got


def _assert_same(want, got):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("nbits", [2, 4])
@pytest.mark.parametrize("B", [1, 4])
def test_run_pipeline_matches_reference(corpus, B, nbits, fused, caps):
    docs, qs = corpus
    want, got = _run_both(docs, qs[:B], nbits, CAPS[caps], fused=fused)
    _assert_same(want, got)


@pytest.mark.parametrize(
    "stage1_dtype,caps",
    [("float32", CAPS["paper"]), ("int8", CAPS["paper"]), ("bfloat16", LOSSLESS)],
)
def test_stage1_dtypes_match_reference(corpus, stage1_dtype, caps):
    """bf16 operands are summed in another order than XLA's bf16 dot, which
    can flip a probe at a near tie, so bf16 is held under lossless caps."""
    docs, qs = corpus
    want, got = _run_both(docs, qs, 2, caps, stage1_dtype=stage1_dtype)
    _assert_same(want, got)


def test_per_lane_t_cs_alive_mask_and_diag_match_reference(corpus):
    docs, qs = corpus
    t = np.asarray([0.3, 0.5, 0.45, 0.6], np.float32)
    alive = np.ones(N_DOCS, bool)
    alive[np.random.default_rng(1).choice(N_DOCS, 30, replace=False)] = False
    want, got = _run_both(docs, qs, 2, CAPS["tight"], t_cs=t, alive=alive, diag=True)
    _assert_same(want, got)
    assert alive[got[1].numpy()[got[1].numpy() >= 0]].all()
    assert set(got[2]) == set(want[2])
    for name, v in want[2].items():
        np.testing.assert_array_equal(got[2][name].numpy(), np.asarray(v), err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_cuda_impl_on_cpu_tensors_equals_ref_impl(corpus, fused):
    """On CPU tensors the kernel wrappers run their plain versions, so the
    ``cuda`` and ``ref`` impls give the same bits."""
    docs, qs = corpus
    _, idx = _indexes(docs, 2)
    out = {}
    for impl in ("ref", "cuda"):
        p = tplaid.SearchParams(**CAPS["tight"], impl=impl, fused=fused)
        out[impl] = tplaid.PlaidEngine(idx, p).search_batch(qs)
    assert torch.equal(out["ref"][0], out["cuda"][0])
    assert torch.equal(out["ref"][1], out["cuda"][1])


def test_stage_functions_match_reference(corpus):
    docs, qs = corpus
    ref_idx, idx = _indexes(docs, 2)
    s_want = rp.stage1_scores_batched(ref_idx, jnp.asarray(qs))
    s_got = tp.stage1_scores_batched(idx, torch.from_numpy(qs))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), **TOL)
    # from here on both sides get the same scores
    s = np.asarray(s_want)
    c_want = rp.candidate_generation_batched(ref_idx, jnp.asarray(s), 2, 64)
    c_got = tp.candidate_generation_batched(idx, torch.tensor(s), 2, 64)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))
    g_want = rp.gather_candidate_tokens_shared(ref_idx, c_want)
    g_got = tp.gather_candidate_tokens_shared(idx, c_got)
    for a, b in zip(g_got, g_want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unknown_impl_and_stage1_dtype_are_refused(corpus):
    docs, qs = corpus
    _, idx = _indexes(docs, 2)
    with pytest.raises(ValueError, match="impl"):
        tplaid.SearchParams(impl="pallas")
    with pytest.raises(ValueError, match="stage1_dtype"):
        tp.stage1_scores_batched(idx, torch.from_numpy(qs), stage1_dtype="fp8")


@pytest.mark.parametrize("operand_dtype", ["float32", "bfloat16", "int8"])
def test_single_query_scoring_ops_match_reference(operand_dtype):
    from repro.core import scoring as rs

    rng = np.random.default_rng(3)
    K, nq, d, nd, L = 24, 5, 16, 9, 7
    q = rng.standard_normal((nq, d)).astype(np.float32)
    cents = rng.standard_normal((K, d)).astype(np.float32)
    cq, cs = ri.quantize_centroids(jnp.asarray(cents))
    want_s = rs.centroid_scores(jnp.asarray(q), jnp.asarray(cents), operand_dtype=operand_dtype,
                                centroids_q=cq, centroids_scale=cs)
    got_s = scoring.centroid_scores(torch.from_numpy(q), torch.from_numpy(cents),
                                    operand_dtype=operand_dtype,
                                    centroids_q=torch.tensor(np.asarray(cq)),
                                    centroids_scale=torch.tensor(np.asarray(cs)))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    s = np.asarray(want_s)
    codes = rng.integers(-1, K, (nd, L)).astype(np.int32)
    keep = np.asarray(rs.prune_mask(want_s, 0.3))
    np.testing.assert_array_equal(scoring.prune_mask(torch.from_numpy(s), 0.3).numpy(), keep)
    qm = (rng.random(nq) > 0.3).astype(np.float32)
    for kc in (None, keep):
        want = rs.centroid_interaction(jnp.asarray(s), jnp.asarray(codes), jnp.asarray(qm),
                                       None if kc is None else jnp.asarray(kc))
        got = scoring.centroid_interaction(torch.from_numpy(s), torch.from_numpy(codes),
                                           torch.from_numpy(qm),
                                           None if kc is None else torch.from_numpy(kc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    docs = rng.standard_normal((nd, L, d)).astype(np.float32)
    dmask = rng.random((nd, L)) > 0.3
    np.testing.assert_allclose(
        scoring.maxsim(torch.from_numpy(q), torch.from_numpy(docs), torch.from_numpy(qm),
                       torch.from_numpy(dmask)).numpy(),
        np.asarray(rs.maxsim(jnp.asarray(q), jnp.asarray(docs), jnp.asarray(qm), jnp.asarray(dmask))),
        **TOL,
    )


def test_gather_doc_tokens_matches_reference(corpus):
    from repro.core import scoring as rs

    docs, _ = corpus
    ref_idx, idx = _indexes(docs, 2)
    pids = np.asarray([3, -1, N_DOCS - 1, 0, -1], np.int32)
    for name, fill in (("codes", -1), ("residuals", 0)):
        want = rs.gather_doc_tokens(getattr(ref_idx, name), ref_idx.doc_offsets, ref_idx.doc_lens,
                                    jnp.asarray(pids), ref_idx.doc_maxlen, fill)
        got = scoring.gather_doc_tokens(getattr(idx, name), idx.doc_offsets, idx.doc_lens,
                                        torch.from_numpy(pids), idx.doc_maxlen, fill)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# --------------------------------------------------------------------------
# the two helpers jax.numpy gives for free
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 9])
def test_stable_topk_breaks_ties_like_lax_top_k(k):
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 3, (5, 9)).astype(np.float32)  # many exact ties
    x[0] = 0.0
    x[1, :4] = [-0.0, 0.0, -0.0, 1.0]  # top_k ranks +0.0 above -0.0
    x[2, 3] = -1e4
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = scoring.stable_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # bf16 scores rank by value with the same tie rule
    got_bf = scoring.stable_topk(torch.from_numpy(x).bfloat16(), k)[1]
    np.testing.assert_array_equal(got_bf.numpy(), np.asarray(want_i))


def test_unique_sized_matches_jnp_unique_at_a_full_cap():
    """A full cap with pads = num_passages: the pads sort past every real
    pid, so the highest real pid survives the truncation (a -1 pad would
    sort first and evict it)."""
    n = 50
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, (3, 40)).astype(np.int32)
    rows[:, ::3] = n  # padded IVF slots
    rows[0, 5] = n - 1
    size = int(max(len(np.unique(r[r < n])) for r in rows))  # exactly full
    for r, got in zip(rows, scoring.unique_sized(torch.from_numpy(rows), size, n)):
        want = np.asarray(jnp.unique(jnp.asarray(r), size=size, fill_value=n))
        np.testing.assert_array_equal(got.numpy(), want)
    got0 = scoring.unique_sized(torch.from_numpy(rows[:1]), size, n)[0]
    assert n - 1 in got0.tolist()
    # a cap below the distinct count keeps the smallest values
    small = scoring.unique_sized(torch.from_numpy(rows), 4, n)
    for r, got in zip(rows, small):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.unique(jnp.asarray(r), size=4, fill_value=n))
        )
    # a 1-d input, wider than its distinct count
    flat = torch.tensor([3, 1, 3, 2], dtype=torch.int32)
    assert scoring.unique_sized(flat, 6, -7).tolist() == [1, 2, 3, -7, -7, -7]


def test_engine_search_is_the_b1_squeeze_of_search_batch(corpus):
    docs, qs = corpus
    _, idx = _indexes(docs, 2)
    eng = tplaid.PlaidEngine(idx, tplaid.SearchParams(**CAPS["tight"]))
    s1, p1, d1 = eng.search(qs[2], diag=True)
    sb, pb = eng.search_batch(qs[2:3])
    assert torch.equal(p1, pb[0]) and torch.equal(s1, sb[0])
    assert set(d1) == {"stage1_candidates", "stage2_kept_centroids", "stage3_survivors"}
    assert eng._kwargs()["candidate_cap"] == 64
    # numpy queries and a float t_cs override are accepted
    s2, p2 = eng.search_batch(qs, t_cs=0.45)
    assert p2.shape == (4, 5) and s2.dtype == torch.float32


@pytest.mark.parametrize("stage1_dtype", ["float32", "bfloat16", "int8"])
def test_stage1_turns_tf32_off_only_around_its_product(corpus, monkeypatch, stage1_dtype):
    """The stage-1 product runs without TF32, and the caller's setting is
    back once it returns, whatever that setting was."""
    docs, qs = corpus
    _, port_idx = _indexes(docs, 2)
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tp.stage1_scores_batched(port_idx, torch.from_numpy(qs), stage1_dtype=stage1_dtype)
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True
