"""PLAID as an item index (``repro_torch.core.item_retrieval``) against the
reference (``repro.core.item_retrieval``) on the reference test's two
catalogs (``tests/test_item_retrieval.py``).

The two packages' k-means draw different samples, so the identity checks
search the reference's own index carried across as numpy
(``index_from_numpy``): the same ranked pids, the scores within rtol 1e-5
(the users' norms are sums in another order).  The port's own build is
held to the reference test's recall and score bars.  On the card,
``impl="cuda"`` (K1 for stages 2/3, K2 for stage 4, at nq = 1 and one
token a document) equals ``impl="ref"`` bit for bit; that case imports no
JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax.numpy as jnp

    from repro.core import item_retrieval as rir
    from repro.core import plaid as rplaid
except ImportError:
    jnp = rir = rplaid = None

from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import item_retrieval as tir  # noqa: E402

needs_ref = pytest.mark.skipif(rir is None, reason="needs the JAX reference")


def clustered_catalog():
    """The reference test's clustered catalog (5,000 items of 32 dims around
    32 centers) and 8 users."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((32, 32)).astype(np.float32)
    items = (centers[rng.integers(0, 32, 5000)]
             + 0.15 * rng.standard_normal((5000, 32)).astype(np.float32))
    users = rng.standard_normal((8, 32)).astype(np.float32)
    return items, users


def small_catalog():
    """The reference test's 500 isotropic items of 16 dims and one user."""
    rng = np.random.default_rng(1)
    items = rng.standard_normal((500, 16)).astype(np.float32)
    return items, rng.standard_normal(16).astype(np.float32)


def carried(rindex, device="cpu"):
    return ti.index_from_numpy({f: np.asarray(getattr(rindex, f)) for f in ti.ARRAY_FIELDS},
                               {f: getattr(rindex, f) for f in ti.STATIC_FIELDS}, device)


@needs_ref
def test_search_settings_are_the_reference_ones():
    p = tir.item_search_params(k=7, nprobe=3, candidate_cap=100, impl="ref")
    for f in ("k", "nprobe", "t_cs", "ndocs", "candidate_cap", "fused"):
        want = {"k": 7, "nprobe": 3, "t_cs": -1e9, "ndocs": 400, "candidate_cap": 100,
                "fused": rplaid.SearchParams().fused}[f]
        assert getattr(p, f) == want, f


@needs_ref
@pytest.mark.parametrize("catalog", ["clustered", "small"])
def test_ranked_items_equal_the_reference_on_its_index(catalog):
    if catalog == "clustered":
        items, users = clustered_catalog()
        build, search = dict(num_centroids=128), dict(k=10, nprobe=16)
    else:
        items, users = small_catalog()
        build, search = dict(num_centroids=32), dict(k=5, nprobe=32, candidate_cap=500)
    rindex = rir.build_item_index(items, **build)
    want_s, want_p = rir.retrieve_items(rindex, jnp.asarray(users), **search)
    got_s, got_p = tir.retrieve_items(carried(rindex), users, impl="ref", **search)
    assert got_p.shape == tuple(want_p.shape) == (users.reshape(-1, users.shape[-1]).shape[0],
                                                  search["k"])
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)


def test_the_ports_own_index_recovers_brute_force_top_k():
    """The reference test's bars on the port's own build: recall@10 >= 0.95
    against brute force over the reconstructed embeddings (IVF probing and
    an exact re-rank) and >= 0.4 over the exact ones (2-bit codec loss)."""
    items, users = clustered_catalog()
    index = tir.build_item_index(items, num_centroids=128, device="cpu")
    assert index.num_passages == index.num_tokens == 5000 and index.doc_maxlen == 1
    _, pids = tir.retrieve_items(index, users, k=10, nprobe=16, impl="ref")
    users_n = users / np.linalg.norm(users, axis=-1, keepdims=True)
    recon = index.reconstruct_tokens(torch.arange(index.num_tokens)).numpy()
    brute_c = users_n @ recon.T
    items_n = items / np.linalg.norm(items, axis=-1, keepdims=True)
    brute_x = users_n @ items_n.T
    rec_engine, rec_exact = [], []
    for i in range(len(users)):
        got = set(pids[i].tolist())
        rec_engine.append(len(got & set(np.argsort(-brute_c[i])[:10].tolist())) / 10)
        rec_exact.append(len(got & set(np.argsort(-brute_x[i])[:10].tolist())) / 10)
    assert np.mean(rec_engine) >= 0.95, rec_engine
    assert np.mean(rec_exact) >= 0.4, rec_exact


def test_the_ports_scores_are_the_users_dot_products():
    items, user = small_catalog()
    index = tir.build_item_index(torch.from_numpy(items), num_centroids=32, device="cpu")
    scores, pids = tir.retrieve_items(index, torch.from_numpy(user), k=5, nprobe=32,
                                      candidate_cap=500, impl="ref")
    assert scores.shape == pids.shape == (1, 5)
    items_n = items / np.linalg.norm(items, axis=-1, keepdims=True)
    want = user @ items_n[pids[0].numpy()].T
    # 2-bit residual reconstruction error bounds the score gap
    np.testing.assert_allclose(scores[0].numpy(), want, atol=0.35, rtol=0.2)


@pytest.mark.gpu
def test_kernels_equal_the_plain_path_on_the_card():
    """``impl="cuda"`` against ``impl="ref"`` on one index on the card: the
    same pids and the same scores bit for bit (K1 and K2 keep their plain
    versions' f32 order), at nq = 1 and one token a document."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs K1 and K2")
    from repro_torch.kernels import ops

    items, users = clustered_catalog()
    index = tir.build_item_index(items, num_centroids=128, device="cuda")
    ops.reset_launch_counts()
    got_s, got_p = tir.retrieve_items(index, users, k=10, nprobe=16, impl="cuda")
    counts = ops.launch_counts()
    want_s, want_p = tir.retrieve_items(index, users, k=10, nprobe=16, impl="ref")
    assert counts["centroid_interaction_batched"] > 0 and counts["decompress_and_score_batched"] > 0
    assert torch.equal(got_p, want_p) and torch.equal(got_s, want_s)
