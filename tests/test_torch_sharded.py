"""Port vs reference: document sharding (``repro_torch.core.engine_sharded``,
``repro_torch.exec.sharded``, ``repro_torch.launch.mesh``, the
``plaid-sharded`` and ``live-sharded`` backends and the sharded directory
layout against ``repro.core.engine_sharded`` / ``repro.exec.sharded``).

``shard_index`` must give the reference's arrays for 1-4 shards, an
uneven tail and an empty shard included.  One shard equals ``PlaidEngine``
under ``torch.equal`` and the reference's ``make_sharded_search`` on its
one-device mesh.  Two and four shards run on a CPU ``Mesh`` of the host
repeated; the reference runs them on four fake devices in ONE subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_sharding_distributed.py`` does) that hands its results back
through an ``.npz``: pids identical, scores within relative 1e-5, every
``FunnelStats`` field equal, for ``plaid-sharded`` and for
``live-sharded`` with deltas and tombstones.  Sharded directories cross
both ways.  The card's case is in ``tests/test_torch_distributed.py``,
which imports no JAX.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import retrieval as rret  # noqa: E402
from repro.core import engine_sharded as res  # noqa: E402
from repro.core import index as ri  # noqa: E402
from repro.core import indexer as rindexer  # noqa: E402
from repro.core import plaid as rplaid  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro.launch.mesh import make_local_mesh as ref_local_mesh  # noqa: E402
from repro_torch import live as tlive  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import engine_sharded as tes  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import indexer as tindexer  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import plaid as tplaid  # noqa: E402
from repro_torch.distributed import topk as ttopk  # noqa: E402
from repro_torch.exec import sharded as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.obs.funnel import ADDITIVE_FIELDS  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_DOCS, N_BASE, DIM, K = 200, 200, 128, 64
DELTA_DOCS = 60  # passages N_BASE.. N_BASE + 60 arrive as deltas
CAPS = {
    "lossless": dict(k=10, nprobe=8, t_cs=0.3, ndocs=256, candidate_cap=256),
    "truncating": dict(k=5, nprobe=2, t_cs=0.45, ndocs=24, candidate_cap=40),
}
#: (nbits, n_shards, caps, fused) of the plaid-sharded reference runs: at
#: nbits 2 every shard count meets both caps and both fused settings
#: (each reference case compiles a program of its own, ~1.4 s, so the
#: grid is a Latin square, not the product); nbits 4 at both shard counts
PLAID_CASES = [(2, 2, "lossless", False), (2, 2, "truncating", True),
               (2, 4, "lossless", True), (2, 4, "truncating", False),
               (4, 2, "truncating", False), (4, 4, "lossless", False)]
#: (n_shards, n_deltas) of the live-sharded reference runs: each shard
#: count once, with one delta and with three (the port's full 3 x 3 grid,
#: no delta included, is held against a one-shard rebuild in
#: tests/test_torch_live.py)
LIVE_CASES = [(2, 1), (4, 3)]
DEAD = {0: [7, 40, 151], 1: [7, 40, 151, 205], 3: [7, 40, 151, 205, 233, 258]}
TOL = dict(rtol=1e-5, atol=1e-6)


def _port(ref_index):
    return ti.index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS},
        "cpu",
    )


def _delta_bounds(n_deltas):
    edges = np.linspace(N_BASE, N_BASE + DELTA_DOCS, n_deltas + 1).astype(int)
    return list(zip(edges[:-1], edges[1:]))


@pytest.fixture(scope="module")
def corpus():
    docs, _ = syn.embedding_corpus(N_DOCS + DELTA_DOCS, dim=DIM, min_len=8, max_len=32, seed=3)
    qs, _ = syn.queries_from_docs(docs, 8, q_len=8)
    bases = {nbits: ri.build_index(docs[:N_BASE], num_centroids=K, nbits=nbits, kmeans_iters=3)
             for nbits in (2, 4)}
    return docs, np.asarray(qs, np.float32), bases


# --------------------------------------------------------------------------
# the reference on four fake devices, one subprocess for every case
# --------------------------------------------------------------------------
REF_SCRIPT = """
import dataclasses, json, os, sys
# one core before jax starts its threads: the suite runs beside five other
# test workers, and the compiles would otherwise take two or three
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import numpy as np, jax, jax.numpy as jnp
from repro import live, retrieval
from repro.core import engine_sharded, indexer, plaid
from repro.exec.live import mesh_for_shards

tmp = sys.argv[1]
spec = json.load(open(tmp + "/spec.json"))
inp = np.load(tmp + "/inputs.npz")
qs = jnp.asarray(inp["qs"])
masks = jnp.ones(qs.shape[:2], jnp.float32)
docs = np.split(inp["packed"], np.cumsum(inp["lens"])[:-1])
out = {}
bases = {nbits: indexer.load_index(f"{tmp}/base{nbits}") for nbits in (2, 4)}
for nbits, n, caps, fused in spec["plaid"]:
    d, meta, per = engine_sharded.shard_index(bases[nbits], n)
    sp = plaid.SearchParams(**spec["caps"][caps], fused=fused)
    sp = dataclasses.replace(sp, candidate_cap=min(sp.candidate_cap, max(per, 2)))
    fn = engine_sharded.make_sharded_search(
        mesh_for_shards(n), sp, docs_per_shard=per, static_meta=meta, funnel=True)
    s, p, f = fn(d, qs, masks)
    key = f"plaid/{nbits}/{n}/{caps}/{int(fused)}"
    out[key + "/scores"], out[key + "/pids"] = np.asarray(s), np.asarray(p)
    for name, v in f._asdict().items():
        out[key + "/funnel/" + name] = np.asarray(v)
for n, n_deltas in spec["live"]:
    lv = live.LiveIndex(bases[2])
    for a, b in spec["deltas"][str(n_deltas)]:
        lv.add_passages(docs[a:b])
    lv.delete(spec["dead"][str(n_deltas)])
    r = retrieval.from_index(lv, backend="live-sharded", n_shards=n,
                             params=retrieval.SearchParams(**spec["caps"]["lossless"]))
    got = r.search_batch(qs, with_funnel=True)
    key = f"live/{n}/{n_deltas}"
    out[key + "/scores"], out[key + "/pids"] = np.asarray(got.scores), np.asarray(got.pids)
    for name, v in got.funnel.items():
        out[key + "/funnel/" + name] = np.asarray(v)
np.savez(tmp + "/out.npz", **out)
print("OK", len(out))
"""


@pytest.fixture(scope="module")
def ref_runs(corpus, tmp_path_factory):
    docs, qs, bases = corpus
    tmp = str(tmp_path_factory.mktemp("sharded_ref"))
    for nbits, base in bases.items():
        rindexer.save_index(f"{tmp}/base{nbits}", base)
    np.savez(f"{tmp}/inputs.npz", qs=qs, packed=np.concatenate(docs),
             lens=np.asarray([len(d) for d in docs]))
    spec = dict(plaid=PLAID_CASES, live=LIVE_CASES, caps=CAPS,
                deltas={str(n): _delta_bounds(n) for n in (0, 1, 3)},
                dead={str(n): v for n, v in DEAD.items()})
    with open(f"{tmp}/spec.json", "w") as f:
        json.dump(spec, f, default=int)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT), tmp],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(f"{tmp}/out.npz") as z:
        return {k: z[k] for k in z.files}


def _assert_like_ref(got_scores, got_pids, got_funnel, ref, key):
    np.testing.assert_array_equal(got_pids.numpy(), ref[key + "/pids"], err_msg=key)
    np.testing.assert_allclose(got_scores.numpy(), ref[key + "/scores"], **TOL, err_msg=key)
    for name, v in got_funnel.items():
        np.testing.assert_array_equal(v, ref[key + "/funnel/" + name], err_msg=f"{key} {name}")


# --------------------------------------------------------------------------
# shard_index
# --------------------------------------------------------------------------
#: the 200-passage base: even splits at 1, 2 and 4 shards, uneven tails at
#: 3 and 6; 5 passages over 6 shards (per = 1: the last shard is empty)
SHARD_CASES = [(N_BASE, n) for n in (1, 2, 3, 4, 6)] + [(5, 6)]


@pytest.fixture(scope="module")
def tiny_index(corpus):
    """The reference's index of 5 passages (K = 8)."""
    docs, _, _ = corpus
    return ri.build_index(docs[:5], num_centroids=8, nbits=2, kmeans_iters=2)


@pytest.mark.parametrize("n_passages,n_shards", SHARD_CASES)
def test_shard_index_equals_reference_array_for_array(corpus, tiny_index, n_passages,
                                                      n_shards):
    g = corpus[2][2] if n_passages == N_BASE else tiny_index
    want, want_meta, want_per = res.shard_index(g, n_shards)
    got, got_meta, got_per = tes.shard_index(_port(g), n_shards)
    assert (got_meta, got_per) == (want_meta, want_per)
    assert set(got) == set(want)
    for f in want:
        w = np.asarray(want[f])
        np.testing.assert_array_equal(got[f].numpy(), w, err_msg=f)
        assert got[f].numpy().dtype == w.dtype, f
    if n_passages == 5:  # shard 5 holds no passage: zero lengths, no IVF entry
        assert got["doc_lens"][5 * got_per:].sum() == 0
        assert got["ivf_lens"][-g.num_centroids:].sum() == 0


def test_shard_index_past_the_corpus_gives_empty_shards(corpus, tiny_index):
    """5 passages over 4 shards: ``per = 2``, so shard 3 starts past the
    corpus.  The reference's ``shard_index`` raises ``IndexError`` there
    (it reads ``doc_offsets[6]`` of 6); the port clamps the range, gives
    the shard zero passages, and the shards still rank as one index."""
    _, qs, _ = corpus
    g = tiny_index
    with pytest.raises(IndexError):
        res.shard_index(g, 4)
    d, meta, per = tes.shard_index(_port(g), 4)
    assert per == 2 and d["doc_lens"].tolist()[6:] == [0, 0]
    assert d["ivf_lens"][-g.num_centroids:].sum() == 0
    lossless = tret.SearchParams(k=5, nprobe=8, t_cs=-1e9, ndocs=8, candidate_cap=8)
    got = tret.from_index(_port(g), backend="plaid-sharded", n_shards=4, params=lossless)
    want = tret.from_index(_port(g), backend="plaid", params=lossless)
    a, b = got.search_batch(qs), want.search_batch(qs)
    merged = ttopk.merge_topk(b.scores, b.pids, 5)
    assert torch.equal(a.scores, merged[0]) and torch.equal(a.pids, merged[1])


def test_static_meta_and_index_dict_mirror_the_reference(corpus):
    _, _, bases = corpus
    t = _port(bases[2])
    assert tes.static_meta_of(t) == res.static_meta_of(bases[2])
    assert list(tsh.index_as_dict(t)) == list(res._index_as_dict(bases[2]))
    assert tsh.DOC_AXES == res.DOC_AXES


# --------------------------------------------------------------------------
# one shard: PlaidEngine and the reference's one-device mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("funnel", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_one_shard_equals_plaid_engine_and_reference(corpus, fused, funnel):
    _, qs, bases = corpus
    g = bases[2]
    caps = dict(k=5, nprobe=2, t_cs=0.4, ndocs=64, candidate_cap=120)
    masks = np.ones(qs.shape[:2], np.float32)
    rfn = res.make_sharded_search(ref_local_mesh(), rplaid.SearchParams(**caps, fused=fused),
                                  docs_per_shard=g.num_passages,
                                  static_meta=res.static_meta_of(g), funnel=funnel)
    want = rfn(g, jnp.asarray(qs), jnp.asarray(masks))
    t = _port(g)
    tp = tplaid.SearchParams(**caps, fused=fused)
    d, meta, per = tes.shard_index(t, 1)
    fn = tsh.make_sharded_search(tmesh.make_local_mesh("cpu"), tp, docs_per_shard=per,
                                 static_meta=meta, funnel=funnel)
    got = fn(d, torch.from_numpy(qs), torch.from_numpy(masks))
    eng = tplaid.PlaidEngine(t, tp).search_batch(qs, funnel=funnel)
    assert torch.equal(got[0], eng[0]) and torch.equal(got[1], eng[1])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    if funnel:
        for a, b, w in zip(got[2], eng[2], want[2]):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# two and four shards against the reference's fake-device mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", PLAID_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plaid_sharded_equals_reference_mesh(corpus, ref_runs, case):
    nbits, n, caps, fused = case
    _, qs, bases = corpus
    r = tret.from_index(_port(bases[nbits]), backend="plaid-sharded", n_shards=n,
                        params=tret.SearchParams(**CAPS[caps], fused=fused))
    assert r.mesh.devices == (torch.device("cpu"),) * n
    got = r.search_batch(qs, with_funnel=True)
    _assert_like_ref(got.scores, got.pids, got.funnel, ref_runs,
                     f"plaid/{nbits}/{n}/{caps}/{int(fused)}")
    # the same shards searched one by one through the pipeline, then the
    # local merge and the funnel's sum: what the collective case gathers
    d, meta, per = tes.shard_index(_port(bases[nbits]), n)
    p = tsh.clamp_to_shard(tplaid.SearchParams(**CAPS[caps], fused=fused), per)
    q, m = torch.from_numpy(qs), torch.ones(qs.shape[:2])
    outs = [tpipe.run_pipeline(s, q, m, p.t_cs, p, funnel=True)
            for s in tsh.place_shards(tmesh.Mesh(("cpu",) * n), d, meta)]
    pids = torch.cat([ttopk.local_to_global_pids(o[1], s, per) for s, o in enumerate(outs)], 1)
    ws, wp = ttopk.merge_topk(torch.cat([o[0] for o in outs], 1), pids, CAPS[caps]["k"])
    assert torch.equal(got.pids, wp) and torch.equal(got.scores, ws)
    summed = {f: sum(getattr(o[2], f) for o in outs).numpy() for f in ADDITIVE_FIELDS}
    for f, v in summed.items():
        np.testing.assert_array_equal(got.funnel[f], v, err_msg=f)


@pytest.mark.parametrize("case", LIVE_CASES, ids=lambda c: f"shards{c[0]}-deltas{c[1]}")
def test_live_sharded_equals_reference_mesh(corpus, ref_runs, case):
    n, n_deltas = case
    docs, qs, bases = corpus
    lv = tlive.LiveIndex(_port(bases[2]))
    for a, b in _delta_bounds(n_deltas):
        lv.add_passages(docs[a:b])
    lv.delete(DEAD[n_deltas])
    r = tret.from_index(lv, backend="live-sharded", n_shards=n,
                        params=tret.SearchParams(**CAPS["lossless"]))
    assert r.describe()["sharding"] == dict(n_shards=n, mesh={"data": n}, deltas="replicated")
    got = r.search_batch(qs, with_funnel=True)
    _assert_like_ref(got.scores, got.pids, got.funnel, ref_runs, f"live/{n}/{n_deltas}")
    assert not np.isin(got.pids.numpy(), DEAD[n_deltas]).any()


# --------------------------------------------------------------------------
# the backend: facade, describe, refusals
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_plaid_sharded_build_from_index_save_load(corpus, tmp_path, n_shards):
    docs, qs, bases = corpus
    params = tret.SearchParams(**CAPS["lossless"])
    built = tret.build(docs[:N_BASE], backend="plaid-sharded", n_shards=n_shards, device="cpu",
                       params=params, index=dict(num_centroids=K, kmeans_iters=3))
    plain = tret.build(docs[:N_BASE], backend="plaid", device="cpu", params=params,
                       index=dict(num_centroids=K, kmeans_iters=3))
    wrapped = tret.from_index(plain.index, backend="plaid-sharded", n_shards=n_shards,
                              params=params)
    a, b = built.search_batch(qs), wrapped.search_batch(qs)
    assert torch.equal(a.pids, b.pids) and torch.equal(a.scores, b.scores)
    assert a.backend == "plaid-sharded" and a.pids.shape == (qs.shape[0], 10)
    d = built.describe()
    assert d["sharding"] == dict(n_shards=n_shards, docs_per_shard=-(-N_BASE // n_shards),
                                 mesh={"data": n_shards},
                                 candidate_cap_per_shard=min(256, -(-N_BASE // n_shards)))
    assert d["index"]["num_passages"] == n_shards * -(-N_BASE // n_shards)
    path = str(tmp_path / "s")
    built.save(path)
    back = tret.load(path, device="cpu")  # retriever.json
    os.remove(os.path.join(path, "retriever.json"))
    bare = tret.load(path, params=params, device="cpu")  # sniffed from n_shards
    for r in (back, bare):
        assert r.backend_name == "plaid-sharded" and r.n_shards == n_shards
        got = r.search_batch(qs)
        assert torch.equal(got.pids, a.pids) and torch.equal(got.scores, a.scores)
    if n_shards == 1:  # plaid-sharded at one shard is plaid's ranking
        want = plain.search_batch(qs)
        assert torch.equal(a.pids, want.pids) and torch.equal(a.scores, want.scores)


def test_plaid_sharded_single_query_funnel_and_mesh_checks(corpus):
    _, qs, bases = corpus
    t = _port(bases[2])
    params = tret.SearchParams(**CAPS["truncating"])
    r = tret.from_index(t, backend="plaid-sharded", n_shards=2, params=params)
    assert r.impl == "ref" == r.describe()["impl"]  # the plain path on the host
    one = r.search(qs[3], with_funnel=True)
    batch = r.search_batch(qs, with_funnel=True)
    assert torch.equal(one.pids, batch.pids[3]) and torch.equal(one.scores, batch.scores[3])
    assert {f: int(v[3]) for f, v in batch.funnel.items()} == one.funnel
    with pytest.raises(ValueError, match="with_diagnostics"):
        r.search_batch(qs, with_diagnostics=True)
    with pytest.raises(ValueError, match="must equal the mesh"):
        tret.get_backend("plaid-sharded").from_index(
            t, tret.RetrieverConfig(n_shards=2), mesh=tmesh.Mesh(("cpu",) * 3))
    # several shards on one device through an explicit mesh
    three = tret.get_backend("plaid-sharded").from_index(
        t, tret.RetrieverConfig(params=params), mesh=tmesh.Mesh(("cpu",) * 3))
    assert three.n_shards == 3
    implicit = tret.from_index(t, backend="plaid-sharded", n_shards=3, params=params)
    assert torch.equal(three.search_batch(qs).pids, implicit.search_batch(qs).pids)
    with pytest.raises(ValueError, match="does not partition"):
        tret.from_index(t, backend="plaid", n_shards=2)


# --------------------------------------------------------------------------
# sharded directories, both directions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_reference_sharded_directory_loads_in_port(corpus, tmp_path, n_shards):
    _, qs, bases = corpus
    g = bases[2]
    path = str(tmp_path / "ref")
    rindexer.save_sharded(path, g, n_shards)
    assert tret.load(path, device="cpu").backend_name == "plaid-sharded"
    loaded, meta, per = tindexer.load_sharded(path, "cpu")
    want, want_meta, want_per = rindexer.load_sharded(path)
    assert (meta, per) == (want_meta, want_per)
    for f in want:
        np.testing.assert_array_equal(loaded[f].numpy(), np.asarray(want[f]), err_msg=f)
    params = tret.SearchParams(**CAPS["lossless"])
    got = tret.load(path, params=params, device="cpu").search_batch(qs)
    direct = tret.from_index(_port(g), backend="plaid-sharded", n_shards=n_shards, params=params)
    want_r = direct.search_batch(qs)
    assert torch.equal(got.pids, want_r.pids) and torch.equal(got.scores, want_r.scores)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_port_sharded_directory_loads_in_reference(corpus, tmp_path, n_shards):
    _, qs, bases = corpus
    g = bases[2]
    params = tret.SearchParams(**CAPS["lossless"])
    r = tret.from_index(_port(g), backend="plaid-sharded", n_shards=n_shards, params=params)
    path = str(tmp_path / "port")
    r.save(path)
    loaded, meta, per = rindexer.load_sharded(path)
    want, want_meta, want_per = res.shard_index(g, n_shards)
    assert (meta, per) == (want_meta, want_per)
    for f in want:
        np.testing.assert_array_equal(np.asarray(loaded[f]), np.asarray(want[f]), err_msg=f)
    if n_shards == 1:  # the reference's default mesh is this host's one device
        back = rret.load(path)
        assert back.backend_name == "plaid-sharded"
        got = back.search_batch(jnp.asarray(qs))
        mine = r.search_batch(qs)
        np.testing.assert_array_equal(np.asarray(got.pids), mine.pids.numpy())
        np.testing.assert_allclose(np.asarray(got.scores), mine.scores.numpy(), **TOL)


def test_mixed_manifest_is_refused_and_live_stamp_sniffs(corpus, tmp_path):
    _, _, bases = corpus
    path = str(tmp_path / "mixed")
    tret.from_index(_port(bases[2]), backend="live-sharded", n_shards=2).save(path)
    m = json.loads((tmp_path / "mixed" / "manifest.json").read_text())
    assert m["sharding"] == {"n_shards": 2}
    os.remove(os.path.join(path, "retriever.json"))
    assert tret.load(path, device="cpu").backend_name == "live-sharded"
    assert rret.load(path).backend_name == "live-sharded"
    (tmp_path / "mixed" / "manifest.json").write_text(json.dumps(dict(m, n_shards=2)))
    with pytest.raises(ValueError, match="mixed manifest"):
        tret.load(path, device="cpu")


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
def test_mesh_layout_and_factories(monkeypatch):
    m = tmesh.Mesh(["cpu", "cpu", "cpu"])
    assert m.devices == (torch.device("cpu"),) * 3 and m.n_shards == 3
    assert list(m.shard_ids()) == [0, 1, 2] and m.rank == 0 and m.world_size == 1
    assert m.shape == {"data": 3} and tmesh.num_chips(m) == 3
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.Mesh(())
    assert tmesh.make_local_mesh("cpu").devices == (torch.device("cpu"),)
    assert tmesh.mesh_for_shards(4, "cpu").devices == (torch.device("cpu"),) * 4
    assert tmesh.visible_shards("cpu") is None
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() is False and not tmesh.is_multihost()
    # the cards: distinct devices, and no fallback past the visible ones
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.mesh_for_shards(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.visible_shards("cuda") == 2
    with pytest.raises(ValueError, match="exceed the 2 visible card"):
        tmesh.mesh_for_shards(3)
    with pytest.raises(ValueError, match="positive multiple"):
        tmesh.mesh_for_shards(0)


def test_gather_shards_concatenates_in_shard_order():
    m = tmesh.Mesh(("cpu",) * 3)
    parts = [torch.full((2, 2), float(i)) for i in range(3)]
    assert torch.equal(tmesh.gather_shards(m, parts), torch.cat(parts, -1))
    assert torch.equal(tmesh.gather_shards(m, parts, dim=0), torch.cat(parts, 0))
