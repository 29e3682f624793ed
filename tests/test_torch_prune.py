"""Build-time token pruning: the port's ``repro_torch.build.prune`` against
the reference's ``repro.build.prune`` on the same numpy inputs.

Tolerance 0 throughout: importance scores are float64 and computed by the
reference's own numpy expressions on the host, and the keep mask, the kept
rows and the kept lengths are held identical (``np.array_equal``).  The
corpora hold exact duplicate tokens (ties broken by position), one-token
and two-token documents, and, for the streaming build, chunks cut inside
runs of equal-length documents.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.build import prune as rp  # noqa: E402
from repro.core import index as ri  # noqa: E402

from repro_torch import build as tb  # noqa: E402
from repro_torch.build import prune as tp  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402

FRACTIONS = [0.1, 0.25, 0.5, 0.9]


def _packed(seed, n_docs=120, dim=24):
    """A packed corpus with duplicate tokens inside documents and 1- and
    2-token documents; rows are not normalized (norms matter to "norm")."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 30, n_docs).astype(np.int32)
    lens[:4] = [1, 2, 1, 2]
    emb = rng.standard_normal((int(lens.sum()), dim)).astype(np.float32)
    emb *= rng.uniform(0.2, 2.0, (len(emb), 1)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for s, n in zip(starts, lens):
        if n >= 6:  # an exact duplicate pair and a scaled copy in each longer doc
            emb[s + 1] = emb[s]
            emb[s + 3] = 0.5 * emb[s + 2]
    return emb, lens


@pytest.mark.parametrize("method", tp.METHODS)
@pytest.mark.parametrize("seed", [0, 1])
def test_token_importance_matches_reference(method, seed):
    emb, lens = _packed(seed)
    want = rp.token_importance(emb, lens, method=method)
    got = tp.token_importance(emb, lens, method=method)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # a tensor on any device scores the same
    np.testing.assert_array_equal(tp.token_importance(torch.from_numpy(emb), lens, method=method), want)


@pytest.mark.parametrize("method", tp.METHODS)
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_prune_mask_matches_reference(method, fraction):
    """The vectorized stable ranking gives the reference's per-document
    loop's mask, ties (duplicate tokens) included."""
    for seed in (0, 1, 2):
        emb, lens = _packed(seed)
        want = rp.prune_mask(emb, lens, fraction=fraction, method=method)
        got = tp.prune_mask(emb, lens, fraction=fraction, method=method)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", tp.METHODS)
def test_prune_chunk_matches_reference(method):
    emb, lens = _packed(3)
    want_e, want_l = rp.prune_chunk(emb, lens, fraction=0.25, method=method)
    got_e, got_l = tp.prune_chunk(emb, lens, fraction=0.25, method=method)
    assert got_l.dtype == np.int32 and isinstance(got_e, np.ndarray)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_l, want_l)
    t_e, t_l = tp.prune_chunk(torch.from_numpy(emb), lens, fraction=0.25, method=method)
    assert isinstance(t_e, torch.Tensor)  # kept rows stay on their device
    np.testing.assert_array_equal(t_e.numpy(), want_e)
    np.testing.assert_array_equal(t_l, want_l)


def test_keep_floor_and_drop_count():
    """Every document keeps at least one token; a document of n tokens
    drops min(floor(fraction * n), n - 1), and survivors keep their order."""
    emb, lens = _packed(4)
    for fraction in (0.5, 0.99):
        keep = tp.prune_mask(emb, lens, fraction=fraction)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        for s, n in zip(starts, lens):
            kept = int(keep[s : s + n].sum())
            assert kept >= 1 and n - kept == min(int(fraction * n), n - 1)
    e, l_kept = tp.prune_chunk(emb, lens, fraction=0.5)
    np.testing.assert_array_equal(e, emb[tp.prune_mask(emb, lens, fraction=0.5)])
    assert int(l_kept.sum()) == len(e)


def test_fraction_zero_is_identity():
    emb, lens = _packed(5)
    t = torch.from_numpy(emb)
    for x in (emb, t):
        out, out_lens = tp.prune_chunk(x, lens, fraction=0.0)
        assert out is x and out_lens is lens
    assert tp.prune_mask(emb, lens, fraction=0.0).all()


def test_prune_is_chunk_invariant():
    """Doc-local scoring: pruning chunk by chunk (cut on document
    boundaries) equals pruning the whole corpus at once."""
    emb, lens = _packed(6)
    whole_e, whole_l = tp.prune_chunk(emb, lens, fraction=0.25)
    offs = np.concatenate([[0], np.cumsum(lens)])
    parts = [tp.prune_chunk(emb[offs[lo] : offs[min(lo + 17, len(lens))]], lens[lo : lo + 17],
                            fraction=0.25) for lo in range(0, len(lens), 17)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), whole_e)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), whole_l)


def test_bad_arguments_raise():
    emb, lens = _packed(7)
    for bad in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError, match="prune fraction"):
            tp.prune_mask(emb, lens, fraction=bad)
    with pytest.raises(ValueError, match="unknown importance method"):
        tp.token_importance(emb, lens, method="random")
    with pytest.raises(ValueError, match="doc_lens sum"):
        tp.token_importance(emb, lens[:-1])
    with pytest.raises(ValueError, match="prune_fraction"):
        tb.StreamingIndexBuilder(prune_fraction=1.0, device="cpu")
    with pytest.raises(ValueError, match="unknown prune method"):
        tb.StreamingIndexBuilder(prune_fraction=0.25, prune_method="random", device="cpu")


def test_pruned_builds_match_reference_and_each_other():
    """A pruned monolithic build (the port's and the reference's) and the
    port's pruned streaming build at two chunkings, under frozen tables:
    one index, ``prune_fraction`` recorded, the payload shrunk."""
    emb, lens = _packed(8, dim=32)
    tables = ri.build_index(emb, lens, num_centroids=32, kmeans_iters=3)
    cents = np.array(tables.centroids)
    codec = ti.build_index(emb, lens, centroids=cents, device="cpu").codec
    want = ri.build_index(emb, lens, centroids=cents, prune_fraction=0.25,
                          codec=type(tables.codec)(np.asarray(codec.cutoffs),
                                                   np.asarray(codec.weights), 2))
    mono = ti.build_index(emb, lens, centroids=cents, codec=codec, prune_fraction=0.25,
                          device="cpu")
    assert mono.prune_fraction == 0.25 and mono.num_tokens < len(emb)
    for got in [mono] + [tb.build_index_streaming(emb, lens, centroids=cents, codec=codec,
                                                  prune_fraction=0.25, chunk_docs=c,
                                                  device="cpu") for c in (5, 64)]:
        for f in ti.ARRAY_FIELDS:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.static_dict() == {f: getattr(want, f) for f in ti.STATIC_FIELDS}
