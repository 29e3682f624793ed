"""The port's index build against the reference (``repro_torch.core.kmeans``
/ ``index.build_index`` against ``repro.core.kmeans`` / ``index``), and the
whole encoder slice end to end: tokens -> ``colbert.encode`` ->
``build_index`` under frozen tables -> the ``plaid`` backend, against the
JAX chain on the same weights and tables.

Tolerances, with their reasons:

* assignment: codes identical except on rows whose best two distances lie
  within 1e-5 (XLA and PyTorch sum the x.c products in another order);
* one Lloyd step: atol 1e-5 on the centroids (cluster sums of f32 rows in
  another order);
* frozen-table builds: every array identical (assignment, residuals and
  compression are per token, and the seeded data has no near ties);
* trained builds: recall@10 against brute-force MaxSim, not bits, because
  ``torch.Generator`` and ``jax.random`` draw different samples;
* end to end: pids identical where the reference's scores are more than
  1e-5 apart; within a group of scores that close the order may differ.
  Scores agree to 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import retrieval as rret  # noqa: E402
from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.core import index as ri  # noqa: E402
from repro.core import kmeans as rk  # noqa: E402
from repro.core import residual_codec as rrc  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import kmeans as tk  # noqa: E402
from repro_torch.core import residual_codec as trc  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402


def _clustered(seed, n=3000, d=32, k=40):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def test_num_centroids_for_matches_reference():
    for n in (0, 1, 3, 100, 4097, 10**6, 10**9):
        assert tk.num_centroids_for(n) == rk.num_centroids_for(n), n


def test_assign_chunked_matches_reference():
    x = _clustered(0)
    c = x[np.random.default_rng(1).choice(len(x), 64, replace=False)] + 0.01
    want_codes, want_d = rk._assign_chunked(jnp.asarray(x), jnp.asarray(c), chunk=1000)
    got_codes, got_d = tk._assign_chunked(torch.from_numpy(x), torch.from_numpy(c), chunk=700)
    assert got_codes.dtype == torch.int32
    d2 = (c * c).sum(-1)[None, :] - 2.0 * x.astype(np.float64) @ c.T.astype(np.float64)
    two = np.sort(d2, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got_codes.numpy()[clear], np.asarray(want_codes)[clear])
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


def test_one_lloyd_step_matches_reference():
    """The step of ``repro.core.kmeans.kmeans_fit`` (assign, segment sums,
    means, empty clusters re-seeded) from the same centroids and re-seed
    rows; one initial centroid is far from every row, so its cluster is
    empty and takes its re-seed row."""
    x = _clustered(2)
    rng = np.random.default_rng(3)
    k = 48
    init = x[rng.choice(len(x), k, replace=False)].copy()
    init[5] = 100.0
    reseed = x[rng.integers(0, len(x), k)]
    xj, cj = jnp.asarray(x), jnp.asarray(init)
    codes, _ = rk._assign_chunked(xj, cj, chunk=1024)
    sums = jax.ops.segment_sum(xj, codes, num_segments=k)
    counts = jax.ops.segment_sum(jnp.ones((len(x),), jnp.float32), codes, k)
    assert float(counts[5]) == 0
    want = jnp.where((counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], jnp.asarray(reseed))
    got = tk.lloyd_step(torch.from_numpy(x), torch.from_numpy(init), torch.from_numpy(reseed), chunk=1024)
    np.testing.assert_array_equal(got[5].numpy(), reseed[5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_kmeans_fit_is_seeded_and_finds_the_clusters():
    x = torch.from_numpy(_clustered(4, k=16))
    fit = [tk.train_centroids(x, 16, seed=s, sample=2000, iters=8) for s in (0, 0, 1)]
    assert torch.equal(fit[0], fit[1]) and not torch.equal(fit[0], fit[2])
    _, d_fit = tk._assign_chunked(x, fit[0])
    _, d_init = tk._assign_chunked(x, x[:16])
    x_sq = (x * x).sum(-1)
    assert float((x_sq + d_fit).mean()) < 0.8 * float((x_sq + d_init).mean())


@pytest.fixture(scope="module")
def corpus():
    docs, _ = syn.embedding_corpus(150, dim=32, seed=3)
    return [np.asarray(d, np.float32) for d in docs]


@pytest.fixture(scope="module")
def ref_trained(corpus):
    return ri.build_index(corpus, num_centroids=32, nbits=2, kmeans_iters=3)


def _port_codec(ref_index):
    return trc.ResidualCodec(torch.tensor(np.asarray(ref_index.cutoffs)),
                             torch.tensor(np.asarray(ref_index.weights)), ref_index.nbits)


def test_frozen_table_build_is_array_identical_to_reference(corpus, ref_trained):
    cents = np.asarray(ref_trained.centroids)
    want = ri.build_index(
        corpus, centroids=cents,
        codec=rrc.ResidualCodec(ref_trained.cutoffs, ref_trained.weights, 2),
    )
    lens = np.array([len(d) for d in corpus], np.int32)
    for docs, doc_lens in ((corpus, None), (np.concatenate(corpus), lens)):
        got = ti.build_index(docs, doc_lens, centroids=cents, codec=_port_codec(ref_trained),
                             device="cpu")
        for f in ti.ARRAY_FIELDS:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.static_dict() == {f: getattr(want, f) for f in ti.STATIC_FIELDS}


def test_build_refuses_pruning_and_unbalanced_lengths(corpus):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ti.build_index(corpus, prune_fraction=0.25, device="cpu")
    with pytest.raises(ValueError, match="doc_lens"):
        ti.build_index(np.concatenate(corpus), np.array([1, 2], np.int32), device="cpu")


def _recall_at_10(pids, docs, qs):
    """Share of each query's brute-force exact-MaxSim top 10 (over the
    uncompressed embeddings) that ``pids`` finds."""
    hits = []
    for qi, q in enumerate(qs):
        exact = np.array([(q @ d.T).max(axis=1).sum() for d in docs])
        top = set(np.argsort(-exact, kind="stable")[:10].tolist())
        hits.append(len(top & set(pids[qi].tolist())) / 10)
    return float(np.mean(hits))


def test_trained_build_recall_matches_reference(corpus, ref_trained):
    qs, _ = syn.queries_from_docs(corpus, 16, q_len=8, seed=5)
    qs = np.asarray(qs, np.float32)
    # lossless caps: recall is set by the trained centroids and codec alone
    params = dict(k=10, nprobe=32, t_cs=-1e9, ndocs=150, candidate_cap=150)
    port = ti.build_index(corpus, num_centroids=32, nbits=2, kmeans_iters=3, device="cpu")
    assert port.num_centroids == 32 and port.num_tokens == sum(len(d) for d in corpus)
    got = tret.from_index(port, backend="plaid", params=tret.SearchParams(**params)).search_batch(qs)
    want = rret.from_index(ref_trained, backend="plaid", params=rret.SearchParams(**params))
    want = want.search_batch(jnp.asarray(qs))
    r_port = _recall_at_10(got.pids.numpy(), corpus, qs)
    r_ref = _recall_at_10(np.asarray(want.pids), corpus, qs)
    # the 2-bit codec caps both near 0.8 on this corpus (10/150 by chance)
    assert r_port >= 0.6 and r_port >= r_ref - 0.05, (r_port, r_ref)


# --------------------------------------------------------------------------
# end to end: tokens -> encode -> frozen-table build -> plaid
# --------------------------------------------------------------------------
def assert_same_ranking(got_pids, got_scores, want_pids, want_scores, tie=1e-5):
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=tie)
    for q in range(want_pids.shape[0]):
        for j in np.nonzero(got_pids[q] != want_pids[q])[0]:
            near = np.abs(want_scores[q] - want_scores[q, j]) <= tie
            at_edge = abs(want_scores[q, j] - want_scores[q, -1]) <= tie
            assert got_pids[q, j] in set(want_pids[q][near]) or at_edge, (q, j)


def test_encoder_slice_end_to_end_matches_reference():
    rcfg, tcfg = rcfgs.reduced_config(), tcfgs.reduced_config()
    params = jax.jit(rcol.init_params, static_argnums=1)(jax.random.PRNGKey(9), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tcol.params_from_numpy(tree, tcfg, device="cpu")
    encode_ref = jax.jit(rcol.encode, static_argnums=1)

    rng = np.random.default_rng(10)
    n_docs, d_len, vocab = 200, 12, rcfg.backbone.vocab
    toks = rng.integers(0, vocab, (n_docs, d_len)).astype(np.int32)
    lens = rng.integers(4, d_len + 1, n_docs).astype(np.int32)
    mask = (np.arange(d_len)[None, :] < lens[:, None]).astype(np.float32)
    ref_emb = np.asarray(encode_ref(params, rcfg, jnp.asarray(toks), jnp.asarray(mask)))
    port_emb = tcol.encode(model, toks, mask).numpy()
    ref_docs = [ref_emb[i, : lens[i]] for i in range(n_docs)]
    port_docs = [port_emb[i, : lens[i]] for i in range(n_docs)]

    # frozen tables: the reference's trained centroids and codec
    tables = ri.build_index(ref_docs, num_centroids=64, nbits=2, kmeans_iters=3)
    cents = np.asarray(tables.centroids)
    want_idx = ri.build_index(
        ref_docs, centroids=cents,
        codec=rrc.ResidualCodec(tables.cutoffs, tables.weights, 2),
    )
    got_idx = ti.build_index(port_docs, centroids=cents, codec=_port_codec(tables), device="cpu")
    np.testing.assert_array_equal(got_idx.codes.numpy(), np.asarray(want_idx.codes))

    q_toks = toks[rng.integers(0, n_docs, 8), :8]
    q_ref = encode_ref(params, rcfg, jnp.asarray(q_toks))
    q_port = tcol.encode(model, q_toks)
    params_s = dict(k=10, nprobe=4, t_cs=0.3, ndocs=64, candidate_cap=128)
    want = rret.from_index(want_idx, backend="plaid", params=rret.SearchParams(**params_s))
    want = want.search_batch(q_ref)
    got = tret.from_index(got_idx, backend="plaid", params=tret.SearchParams(**params_s))
    got = got.search_batch(q_port)
    assert_same_ranking(got.pids.numpy(), got.scores.numpy(),
                        np.asarray(want.pids), np.asarray(want.scores))
