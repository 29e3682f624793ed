"""Port vs reference: the vanilla ColBERTv2 baseline
(``repro_torch.core.vanilla`` and the ``vanilla`` backend against
``repro.core.vanilla`` and ``repro.retrieval``) on the same index.

Both sides search the reference's ``build_index`` output, carried across
with ``index_from_numpy``.  Ranked pids must be identical and scores within
rtol = atol = 1e-5: the candidate-embedding scores and the exact MaxSim are
f32 products summed in another order than XLA's.  The port's
``impl="cuda"`` on CPU tensors runs K4's plain version, a table lookup, so
it equals ``impl="ref"`` bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import retrieval as rret  # noqa: E402
from repro.core import index as ri  # noqa: E402
from repro.core import vanilla as rv  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core import vanilla as tv  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)
N_DOCS = 140

#: "loose": clamped to the corpus, nothing is cut; "tight": the embedding
#: candidates (48), the kept embeddings (n_keep = min(48, 4 * 5) = 20) and
#: the passage set (5) are all cut
CAPS = {
    "loose": dict(k=10, nprobe=2, ncandidates=2**13, ndocs_cap=4096),
    "tight": dict(k=3, nprobe=4, ncandidates=48, ndocs_cap=5),
}


@pytest.fixture(scope="module")
def corpus():
    docs, _ = syn.embedding_corpus(N_DOCS, dim=32, min_len=6, max_len=18, seed=1)
    qs, _ = syn.queries_from_docs(docs, 4, q_len=6, seed=2)
    return docs, np.asarray(qs, np.float32)


_INDEXES: dict = {}


def _indexes(docs, nbits):
    """(reference index, the port's copy of it on the CPU), one per nbits."""
    if nbits not in _INDEXES:
        ref = ri.build_index(docs, num_centroids=32, nbits=nbits, kmeans_iters=3)
        arrays = {f: np.asarray(getattr(ref, f)) for f in ti.ARRAY_FIELDS}
        static = {f: getattr(ref, f) for f in ti.STATIC_FIELDS}
        _INDEXES[nbits] = (ref, ti.index_from_numpy(arrays, static, "cpu"))
    return _INDEXES[nbits]


def _uncut_counts(index, q, caps) -> tuple[int, int]:
    """(distinct embedding ids the query's top-nprobe centroids list,
    distinct passages among the best ``4 * ndocs_cap`` of the first
    ``ncandidates``): each above its cap means that cap cuts."""
    _, cids = scoring.stable_topk(scoring.centroid_scores(q, index.centroids).T, caps["nprobe"])
    eids = torch.unique(torch.cat([
        index.eivf_eids[index.eivf_offsets[c]: index.eivf_offsets[c] + index.eivf_lens[c]]
        for c in cids.reshape(-1).tolist()
    ])).long()
    kept = eids[: caps["ncandidates"]]
    emb = index.reconstruct_tokens(kept)
    _, best = scoring.stable_topk((emb @ q.T).amax(dim=-1), 4 * caps["ndocs_cap"])
    return eids.numel(), int(torch.unique(index.tok_pid[kept[best]]).numel())


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("nbits", [2, 4])
@pytest.mark.parametrize("B", [1, 4])
def test_vanilla_engine_matches_reference(corpus, B, nbits, caps):
    docs, qs = corpus
    ref_idx, port_idx = _indexes(docs, nbits)
    qs = qs[:B]
    want_eng = rv.VanillaEngine(ref_idx, rv.VanillaParams(**CAPS[caps]))
    got = {
        impl: tv.VanillaEngine(port_idx, tv.VanillaParams(**CAPS[caps], impl=impl))
        for impl in ("ref", "cuda")
    }
    assert got["ref"]._kwargs() == dict(want_eng._kwargs(), impl="ref")
    if caps == "tight":  # the caps really cut the embeddings and passages
        for q in qs:
            n_eids, n_pids = _uncut_counts(port_idx, torch.from_numpy(q), CAPS[caps])
            assert n_eids > CAPS[caps]["ncandidates"] and n_pids > CAPS[caps]["ndocs_cap"]
    if B == 1:
        want = want_eng.search(jnp.asarray(qs[0]))
        outs = {impl: eng.search(qs[0]) for impl, eng in got.items()}
    else:
        want = want_eng.search_batch(jnp.asarray(qs))
        outs = {impl: eng.search_batch(qs) for impl, eng in got.items()}
    scores, pids = outs["ref"]
    assert pids.dtype == torch.int32 and pids.shape == np.asarray(want[1]).shape
    np.testing.assert_array_equal(pids.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[0]), **TOL)
    assert torch.equal(outs["cuda"][1], pids) and torch.equal(outs["cuda"][0], scores)


def test_vanilla_engine_takes_query_masks(corpus):
    docs, qs = corpus
    ref_idx, port_idx = _indexes(docs, 2)
    qm = np.ones(qs.shape[:2], np.float32)
    qm[:, -2:] = 0.0
    want = rv.VanillaEngine(ref_idx, rv.VanillaParams(**CAPS["loose"])).search_batch(
        jnp.asarray(qs), jnp.asarray(qm)
    )
    got = tv.VanillaEngine(port_idx, tv.VanillaParams(**CAPS["loose"], impl="cuda")).search_batch(qs, qm)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)


def test_vanilla_params_refuse_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        tv.VanillaParams(impl="pallas")


# --------------------------------------------------------------------------
# the facade: save / load through both packages' vanilla backends
# --------------------------------------------------------------------------
FACADE_PARAMS = dict(k=3, nprobe=4, ndocs=5, candidate_cap=48)


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    docs, qs = corpus
    ref_idx, _ = _indexes(docs, 2)
    ref = rret.from_index(ref_idx, backend="vanilla", params=rret.SearchParams(**FACADE_PARAMS))
    path = str(tmp_path_factory.mktemp("vanilla") / "ref")
    ref.save(path)
    return path, ref, qs


def _same(got, want):
    np.testing.assert_array_equal(got.pids.cpu().numpy(), np.asarray(want.pids))
    np.testing.assert_allclose(got.scores.cpu().numpy(), np.asarray(want.scores), **TOL)


def test_vanilla_backend_loads_a_reference_directory(saved):
    path, ref, qs = saved
    r = tret.load(path, device="cpu")
    assert r.backend_name == "vanilla" and r.params == tret.SearchParams(**FACADE_PARAMS)
    res = r.search_batch(qs)
    _same(res, ref.search_batch(jnp.asarray(qs)))
    assert res.backend == "vanilla" and res.t_cs is None and res.latency_ms > 0
    # t_cs is accepted and ignored: vanilla has no pruning stage
    assert torch.equal(r.search_batch(qs, t_cs=0.1).pids, res.pids)
    one = r.search(qs[2])
    assert one.pids.shape == (FACADE_PARAMS["k"],)
    _same(one, ref.search(jnp.asarray(qs[2])))


def test_port_saved_vanilla_directory_loads_in_reference(saved, tmp_path):
    path, ref, qs = saved
    r = tret.load(path, device="cpu")
    out = str(tmp_path / "port")
    r.save(out)
    with open(os.path.join(out, "retriever.json")) as f:
        meta = json.load(f)
    assert meta == dict(format_version=1, backend="vanilla", params=r.params.asdict())
    back = rret.load(out)
    assert back.backend_name == "vanilla"
    _same(r.search_batch(qs), back.search_batch(jnp.asarray(qs)))
    again = tret.load(out, device="cpu")
    assert again.backend_name == "vanilla" and again.params == r.params
    assert torch.equal(again.search_batch(qs).pids, r.search_batch(qs).pids)


def test_vanilla_describe_matches_reference(saved):
    path, ref, _ = saved
    want = ref.describe()
    got = tret.load(path, device="cpu").describe()
    assert got["backend"] == "vanilla" and got["impl"] == "cuda" and got["device"] == "cpu"
    assert got["static_effective"] == dict(want["static_effective"], impl="cuda")
    for key in ("static", "dynamic", "index"):
        assert got[key] == want[key], key
    assert tuple(got["static_fields"]) == tuple(want["static_fields"])
    assert tuple(got["dynamic_fields"]) == tuple(want["dynamic_fields"]) == ()


def test_vanilla_backend_refuses_diagnostics_funnel_and_build(saved):
    path, _, qs = saved
    r = tret.load(path, device="cpu")
    with pytest.raises(ValueError, match="with_diagnostics"):
        r.search_batch(qs, with_diagnostics=True)
    with pytest.raises(ValueError, match="with_funnel"):
        r.search(qs[0], with_funnel=True)
    # build is ported (the streaming builder); it was refused until then
    built = tret.build(np.asarray(qs[0], np.float32), "vanilla", doc_lens=np.array([len(qs[0])]),
                       index=dict(centroids=r.index.centroids), device="cpu")
    assert built.backend_name == "vanilla" and built.index.num_passages == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tret.build(np.asarray(qs[0], np.float32), "vanilla", doc_lens=np.array([len(qs[0])]))
