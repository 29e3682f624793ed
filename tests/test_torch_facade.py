"""Port vs reference: the retrieval facade (``repro_torch.retrieval`` against
``repro.retrieval``) on one saved index directory.

The port's ``plaid`` and ``plaid-cuda`` backends run on ``device="cpu"``
here (``plaid-cuda``'s kernels fall to their plain versions on CPU
tensors); both must rank exactly as the reference ``plaid`` backend does,
through ``search``, ``search_batch``, save / load and ``describe``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import retrieval as rret  # noqa: E402
from repro.core import index as ri  # noqa: E402
from repro.core import indexer as rindexer  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(k=5, nprobe=2, t_cs=0.4, ndocs=40, candidate_cap=64)
BACKENDS = ["plaid", "plaid-cuda"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A reference ``plaid`` retriever saved to disk, and its queries."""
    docs, _ = syn.embedding_corpus(120, dim=32, min_len=6, max_len=18, seed=4)
    qs, _ = syn.queries_from_docs(docs, 3, q_len=6)
    idx = ri.build_index(docs, num_centroids=32, nbits=2, kmeans_iters=3)
    ref = rret.from_index(idx, backend="plaid", params=rret.SearchParams(**PARAMS))
    path = str(tmp_path_factory.mktemp("facade") / "ref")
    ref.save(path)
    return path, ref, np.asarray(qs, np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got.pids.cpu().numpy(), np.asarray(want.pids))
    np.testing.assert_allclose(got.scores.cpu().numpy(), np.asarray(want.scores), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_match_reference_on_a_reference_directory(saved, backend):
    path, ref, qs = saved
    r = tret.load(path, backend=backend, device="cpu")
    assert r.backend_name == backend and r.params == tret.SearchParams(**PARAMS)
    _same(r.search_batch(qs), ref.search_batch(jnp.asarray(qs)))
    _same(r.search_batch(qs, t_cs=0.5), ref.search_batch(jnp.asarray(qs), t_cs=0.5))
    one, want = r.search(qs[1]), ref.search(jnp.asarray(qs[1]))
    assert one.pids.shape == (PARAMS["k"],)
    _same(one, want)
    got_d = r.search_batch(qs, with_diagnostics=True)
    want_d = ref.search_batch(jnp.asarray(qs), with_diagnostics=True)
    assert set(got_d.diagnostics) == set(want_d.diagnostics)
    for name, v in want_d.diagnostics.items():
        np.testing.assert_array_equal(got_d.diagnostics[name], v, err_msg=name)
    assert got_d.latency_ms > 0 and got_d.backend == backend and got_d.t_cs == 0.4


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_saved_directory_loads_in_reference(saved, backend, tmp_path):
    path, ref, qs = saved
    r = tret.load(path, backend=backend, device="cpu")
    out = str(tmp_path / "port")
    r.save(out)
    with open(os.path.join(out, "retriever.json")) as f:
        meta = json.load(f)
    assert meta == dict(format_version=1, backend=backend, params=r.params.asdict())
    # the reference reads the port's directory (as "plaid": it has no
    # "plaid-cuda" backend) and ranks the same
    back = rret.load(out, backend="plaid")
    _same(r.search_batch(qs), back.search_batch(jnp.asarray(qs)))
    # and the port reads it back with its backend and params
    again = tret.load(out, device="cpu")
    assert again.backend_name == backend and again.params == r.params
    assert torch.equal(again.search_batch(qs).pids, r.search_batch(qs).pids)


def test_describe_matches_reference(saved):
    path, ref, _ = saved
    want = ref.describe()
    for backend, impl in zip(BACKENDS, ("ref", "cuda")):
        got = tret.load(path, backend=backend, device="cpu").describe()
        assert got["backend"] == backend and got["impl"] == impl
        assert got["device"] == "cpu"
        for key in ("static", "static_effective", "dynamic", "index"):
            want_v = dict(want[key], impl=impl) if key == "static_effective" else want[key]
            assert got[key] == want_v, key
        assert tuple(got["static_fields"]) == tuple(want["static_fields"])
        assert tuple(got["dynamic_fields"]) == tuple(want["dynamic_fields"])


def test_from_index_and_a_bare_index_directory(saved, tmp_path):
    path, ref, qs = saved
    idx = ti.index_from_numpy(
        {f: np.asarray(getattr(ref.index, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(ref.index, f) for f in ti.STATIC_FIELDS},
        "cpu",
    )
    r = tret.from_index(idx, backend="plaid-cuda", params=tret.SearchParams(**PARAMS))
    _same(r.search_batch(qs), ref.search_batch(jnp.asarray(qs)))
    bare = str(tmp_path / "bare")
    rindexer.save_index(bare, ref.index)  # no retriever.json: sniffed as "plaid"
    loaded = tret.load(bare, device="cpu", params=tret.SearchParams(**PARAMS))
    assert loaded.backend_name == "plaid"
    assert torch.equal(loaded.search_batch(qs).pids, r.search_batch(qs).pids)
    assert tret.list_backends() == sorted(BACKENDS + ["vanilla"])


def test_default_device_is_the_card(saved):
    """Entry points default to ``device="cuda"`` and never fall back to the
    CPU: without a card they raise."""
    path, ref, _ = saved
    arrays = {f: np.asarray(getattr(ref.index, f)) for f in ti.ARRAY_FIELDS}
    static = {f: getattr(ref.index, f) for f in ti.STATIC_FIELDS}
    if torch.cuda.is_available():
        assert tret.load(path).index.device.type == "cuda"
        assert ti.index_from_numpy(arrays, static).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tret.load(path)
    with pytest.raises(RuntimeError, match="cuda"):
        ti.index_from_numpy(arrays, static)


@pytest.mark.parametrize("backend", BACKENDS)
def test_unported_features_are_refused(saved, backend):
    path, ref, qs = saved
    r = tret.load(path, backend=backend, device="cpu")
    # funnel telemetry is ported (it was refused until then); its values
    # are held against the reference in tests/test_torch_funnel.py
    fields = set(ref.search_batch(qs, with_funnel=True).funnel)
    assert set(r.search_batch(qs, with_funnel=True).funnel) == fields
    assert all(np.ndim(v) == 0 for v in r.search(qs[0], with_funnel=True).funnel.values())
    with pytest.raises(NotImplementedError, match="tiered"):
        tret.load(path, backend=backend, device="cpu",
                  params=tret.SearchParams(tiered=True))
    # the streaming build is ported: retrieval.build runs on the CPU when
    # asked (here over the queries as a 3-passage corpus, against r's
    # frozen centroids), on the card by default (no silent fallback)
    built = tret.build(list(qs), backend=backend, device="cpu",
                       index=dict(centroids=r.index.centroids))
    assert built.backend_name == backend and built.index.num_passages == len(qs)
    assert torch.equal(built.index.centroids, r.index.centroids)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tret.build(list(qs), backend=backend)
    with pytest.raises(KeyError, match="unknown retrieval backend"):
        tret.load(path, backend="plaid-pallas", device="cpu")
