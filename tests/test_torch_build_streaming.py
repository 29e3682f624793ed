"""The port's streaming build (``repro_torch.build``) against the reference's
(``repro.build``) on the same numpy inputs, and on the card against the
port's own monolithic ``build_index`` (``gpu`` marker: needs a card, skips
here).

Tolerances, with their reasons:

* priorities, reservoir indices and rows: identical (integer hashing; rows
  are copied, never computed);
* one block-ordered Lloyd step: atol 1e-5 on the centroids, as
  ``test_torch_build.py::test_one_lloyd_step_matches_reference`` (cluster
  sums of f32 rows in another order than XLA's);
* frozen-centroid builds, pruned or not, codec fitted from the reservoir or
  frozen: every array identical, dtypes included (assignment, residuals,
  quantiles and compression are per token or bit-matched; the seeded data
  has no near ties);
* trained builds: bit-identical to each other across chunkings; against
  the reference by recall@10, because ``torch.Generator`` and
  ``jax.random`` draw different initial centroids;
* facade searches: pids identical, scores to 1e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax.numpy as jnp
    from repro import build as rb
    from repro import retrieval as rret
    from repro.build import kmeans_mesh as rkm
    from repro.core import index as ri
    from repro.core import indexer as rindexer
except ImportError:
    jnp = rb = rret = rkm = ri = rindexer = None

from repro_torch import build as tb  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.build import kmeans_mesh as tkm  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import indexer as tindexer  # noqa: E402
from repro_torch.core import kmeans as tk  # noqa: E402
from repro_torch.core import residual_codec as trc  # noqa: E402

STATS = ("n_docs", "n_tokens", "n_chunks", "num_centroids", "sample_tokens",
         "peak_chunk_tokens", "trained")


def _corpus(seed, n_docs=220, dim=32, n_topics=12):
    """Per-document (len, dim) f32 unit rows, topic-clustered, 4..39 tokens."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_topics, dim))
    docs = []
    for n in rng.integers(4, 40, n_docs):
        x = centers[rng.integers(n_topics)] + 0.5 * rng.standard_normal((n, dim))
        docs.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
    return docs


def assert_identical(got, want, msg=""):
    """Every array field (values and dtype) and static field of a port index
    against a reference index or another port index."""
    for f in ti.ARRAY_FIELDS:
        a = getattr(got, f).cpu().numpy()
        b = getattr(want, f)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {f}")
    for f in ti.STATIC_FIELDS:
        assert getattr(got, f) == getattr(want, f), (msg, f)


@pytest.fixture(scope="module")
def reference():
    if rb is None:
        pytest.skip("needs jax and the repro package (the reference)")


@pytest.fixture(scope="module")
def corpus():
    return _corpus(3)


@pytest.fixture(scope="module")
def ref_mono(reference, corpus):
    """The reference's monolithic trained build: the frozen tables."""
    return ri.build_index(corpus, num_centroids=64, kmeans_iters=3)


def _tables(ref_index):
    cents = np.array(ref_index.centroids)
    codec = trc.ResidualCodec(torch.tensor(np.asarray(ref_index.cutoffs)),
                              torch.tensor(np.asarray(ref_index.weights)), ref_index.nbits)
    return cents, codec


# --------------------------------------------------------------------------
# pass 1: priorities and the reservoir
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3, -1])
def test_token_priorities_match_reference(reference, seed):
    idx = np.concatenate([np.arange(5000), [2**31, 2**40, 2**62]]).astype(np.int64)
    want = rb.token_priorities(idx, seed)
    got = tb.token_priorities(idx, seed)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == len(idx)  # a bijection: no ties


@pytest.mark.parametrize("capacity", [1, 50, 500, 10**6])
@pytest.mark.parametrize("chunk", [7, 64, 10**6])
def test_reservoir_matches_reference(reference, corpus, capacity, chunk):
    """Kept indices and rows identical to the reference's, rows in ascending
    global order, for tensor and numpy offers."""
    packed = np.concatenate(corpus)
    want = rb.ReservoirSampler(capacity, seed=5)
    got = tb.ReservoirSampler(capacity, seed=5)
    got_np = tb.ReservoirSampler(capacity, seed=5)
    for lo in range(0, len(packed), chunk):
        rows = packed[lo : lo + chunk]
        want.offer(rows, lo)
        got.offer(torch.from_numpy(rows.copy()), lo)
        got_np.offer(rows, lo)
    assert got.n_kept == want.n_kept == min(capacity, len(packed))
    np.testing.assert_array_equal(np.sort(got._idx), np.sort(want._idx))
    for r in (got, got_np):
        s = r.sample()
        assert isinstance(s, torch.Tensor) and s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), want.sample())
    np.testing.assert_array_equal(got.sample().numpy(), packed[np.sort(want._idx)])


# --------------------------------------------------------------------------
# k-means: block-ordered, deterministic cluster sums
# --------------------------------------------------------------------------
def test_cluster_sums_add_rows_in_row_order():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    codes = rng.integers(0, 37, 2000)
    want = np.zeros((40, 16), np.float32)
    for i, c in enumerate(codes):
        want[c] += x[i]
    sums, counts = tk.cluster_sums(torch.from_numpy(x), torch.from_numpy(codes), 40)
    np.testing.assert_array_equal(sums.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(codes, minlength=40))
    assert counts.dtype == torch.float32


@pytest.mark.parametrize("stat_blocks", [1, 3, 8])
def test_block_lloyd_step_matches_reference(reference, stat_blocks):
    """One step of ``kmeans_fit_mesh``'s loop: the reference's
    ``_block_stats`` over weight-0-padded blocks, summed in block order,
    against the port's ``block_stats`` from the same centroids and re-seed
    rows; one centroid is far from every row, so its cluster takes its
    re-seed row."""
    rng = np.random.default_rng(2)
    x = np.concatenate(_corpus(4, n_docs=150))
    n, d = x.shape
    k = 48
    init = x[rng.choice(n, k, replace=False)].copy()
    init[5] = 100.0
    reseed = x[rng.integers(0, n, k)]
    block = -(-n // stat_blocks)
    pad = stat_blocks * block - n
    xb = np.pad(x, ((0, pad), (0, 0))).reshape(stat_blocks, block, d)
    wb = np.pad(np.ones(n, np.float32), (0, pad)).reshape(stat_blocks, block)
    sums = jnp.zeros((k, d), jnp.float32)
    counts = jnp.zeros((k,), jnp.float32)
    for b in range(stat_blocks):
        s, c = rkm._block_stats(jnp.asarray(xb[b]), jnp.asarray(wb[b]), jnp.asarray(init))
        sums, counts = sums + s, counts + c
    want = np.where((np.asarray(counts) > 0)[:, None],
                    np.asarray(sums) / np.maximum(np.asarray(counts), 1.0)[:, None], reseed)
    t_sums, t_counts = tkm.block_stats(torch.from_numpy(x), torch.from_numpy(init), stat_blocks)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(counts))
    got = tk.update_centroids(t_sums, t_counts, torch.from_numpy(reseed))
    np.testing.assert_array_equal(got[5].numpy(), reseed[5])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_multi_gpu_build_is_refused(corpus):
    """A multi-device build is refused only where the reference refuses it:
    a mesh whose device count does not divide ``stat_blocks`` (the block
    decomposition would change with it), and more devices than are
    visible; a mesh of the host repeated is taken."""
    with pytest.raises(ValueError, match="divisible by the mesh device count"):
        tb.kmeans_fit_mesh(torch.zeros(8, 4), 2, generator=torch.Generator(),
                           mesh=tb.build_mesh(3, "cpu"))
    with pytest.raises(ValueError, match="divisible"):
        tb.StreamingIndexBuilder(n_devices=3, num_centroids=8, device="cpu").build(corpus[:20])
    with pytest.raises(ValueError, match="but the mesh has"):
        tb.StreamingIndexBuilder(n_devices=2, mesh=tb.build_mesh(4, "cpu"), device="cpu")
    assert tb.StreamingIndexBuilder(n_devices=4, device="cpu").stats.n_devices == 4
    assert tb.StreamingIndexBuilder(device="cpu").mesh.n_shards == 1  # the host: one


def test_build_mesh_takes_the_visible_cards_and_no_more(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tb.build_mesh(None).devices == tuple(torch.device("cuda", i) for i in range(4))
    assert tb.build_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="exceeds the 4 visible"):
        tb.build_mesh(8)
    from repro_torch.build.streaming import default_n_devices

    assert default_n_devices(torch.device("cuda"), 8) == 4
    assert default_n_devices(torch.device("cuda"), 6) == 3  # divides the blocks
    assert default_n_devices(torch.device("cpu"), 8) == 1


def test_ordered_block_sum_is_one_chain_over_any_split():
    """``ordered_block_sum`` adds block partials left to right from zero
    whatever the split over devices: the sum the one-device build takes."""
    from repro_torch.distributed.reduce import ordered_block_sum
    from repro_torch.launch.mesh import Mesh

    rng = np.random.default_rng(4)
    blocks = torch.from_numpy((rng.standard_normal((8, 5, 3)) * 10.0 ** rng.integers(
        -6, 6, (8, 5, 3))).astype(np.float32))
    want = torch.zeros(5, 3)
    for b in blocks:
        want = want + b
    assert torch.equal(ordered_block_sum(blocks), want)
    for n in (1, 2, 4, 8):
        parts = list(torch.split(blocks, 8 // n))
        assert torch.equal(ordered_block_sum(parts, Mesh(("cpu",) * n)), want), n


@pytest.mark.parametrize("n_devices", [2, 4])
def test_trained_build_is_bit_identical_across_device_counts(corpus, n_devices):
    """Mesh-parallel Lloyd (blocks over the devices, sums in block order)
    and row-split quantization reproduce the one-device build bit for bit,
    at another chunking too."""
    kw = dict(num_centroids=64, kmeans_iters=3, sample_size=3000, device="cpu")
    one, st1 = tb.build_index_streaming(corpus, chunk_docs=33, n_devices=1, return_stats=True,
                                        **kw)
    got, st = tb.build_index_streaming(corpus, chunk_docs=57, n_devices=n_devices,
                                       return_stats=True, **kw)
    assert (st1.n_devices, st.n_devices) == (1, n_devices)
    assert_identical(got, one, f"n_devices={n_devices}")


def test_four_device_frozen_build_equals_monolithic(corpus, ref_mono):
    cents, codec = _tables(ref_mono)
    got = tb.build_index_streaming(corpus, centroids=cents, codec=codec, chunk_docs=41,
                                   n_devices=4, device="cpu")
    assert_identical(got, ref_mono, "4 devices vs the reference's build_index")
    assert_identical(got, ti.build_index(corpus, centroids=cents, codec=codec, device="cpu"),
                     "4 devices vs the port's build_index")


def test_emit_sharded_layout_equals_reference_files(corpus, ref_mono, tmp_path):
    """``emit(layout="sharded")``: a frozen-table build's files equal the
    reference's emit of its own build, array for array; a trained 4-device
    build's equal the one-device build's (the reference's trained mesh
    build raises under jax 0.9)."""
    cents, codec = _tables(ref_mono)
    got = tb.build_index_streaming(corpus, centroids=cents, codec=codec, n_devices=2,
                                   device="cpu")
    want = rb.build_index_streaming(corpus, centroids=cents, codec=ref_mono.codec)
    tb.emit(got, str(tmp_path / "port"), layout="sharded", n_shards=4)
    rb.emit(want, str(tmp_path / "ref"), layout="sharded", n_shards=4)
    a, a_meta, a_per = rindexer.load_sharded(str(tmp_path / "port"))
    b, b_meta, b_per = rindexer.load_sharded(str(tmp_path / "ref"))
    assert (a_meta, a_per) == (b_meta, b_per)
    for f in b:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)
    kw = dict(num_centroids=64, kmeans_iters=3, sample_size=3000, device="cpu")
    builders = [tb.StreamingIndexBuilder(n_devices=n, **kw) for n in (1, 4)]
    for name, bld in zip(("one", "four"), builders):
        bld.build(corpus)
        bld.save(str(tmp_path / name), layout="sharded", n_shards=3)
    one, one_meta, one_per = tindexer.load_sharded(str(tmp_path / "one"), "cpu")
    four, four_meta, four_per = tindexer.load_sharded(str(tmp_path / "four"), "cpu")
    assert (one_meta, one_per) == (four_meta, four_per)
    for f in one:
        assert torch.equal(one[f], four[f]), f


# --------------------------------------------------------------------------
# the whole build against the reference's streaming build
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_docs", [1, 13, 100])
@pytest.mark.parametrize(
    "prune", [(0.0, "attention"), (0.25, "attention"), (0.25, "norm")],
    ids=["unpruned", "pruned-attention", "pruned-norm"],
)
def test_frozen_centroid_build_matches_reference(corpus, ref_mono, chunk_docs, prune):
    """Frozen centroids, the codec fitted from a reservoir smaller than the
    corpus: array-identical to ``repro.build.build_index_streaming``."""
    cents, _ = _tables(ref_mono)
    frac, method = prune
    kw = dict(chunk_docs=chunk_docs, sample_size=2000, prune_fraction=frac,
              prune_method=method)
    want, want_st = rb.build_index_streaming(corpus, centroids=cents, return_stats=True, **kw)
    got, st = tb.build_index_streaming(corpus, centroids=torch.from_numpy(cents),
                                       return_stats=True, device="cpu", **kw)
    assert_identical(got, want, f"chunk_docs={chunk_docs} prune={prune}")
    assert {f: getattr(st, f) for f in STATS} == {f: getattr(want_st, f) for f in STATS}
    assert st.sample_tokens == 2000 < sum(len(d) for d in corpus)
    if frac:
        assert got.num_tokens < sum(len(d) for d in corpus)


@pytest.mark.parametrize("chunk_docs", [7, 64, 10_000])
def test_frozen_tables_build_matches_monolithic(corpus, ref_mono, chunk_docs):
    """Frozen centroids and codec: the port's streaming build equals its own
    monolithic ``build_index`` and the reference's (single pass)."""
    cents, codec = _tables(ref_mono)
    got, st = tb.build_index_streaming(corpus, centroids=cents, codec=codec,
                                       chunk_docs=chunk_docs, return_stats=True, device="cpu")
    assert not st.trained and st.n_tokens == got.num_tokens
    assert_identical(got, ref_mono, f"vs reference, chunk_docs={chunk_docs}")
    assert_identical(got, ti.build_index(corpus, centroids=cents, codec=codec, device="cpu"),
                     f"vs port build_index, chunk_docs={chunk_docs}")


def _recall_at_10(pids, docs, qs):
    """Share of each query's brute-force exact-MaxSim top 10 (over the
    uncompressed embeddings) that ``pids`` finds."""
    hits = []
    for qi, q in enumerate(qs):
        exact = np.array([(q @ d.T).max(axis=1).sum() for d in docs])
        top = set(np.argsort(-exact, kind="stable")[:10].tolist())
        hits.append(len(top & set(pids[qi].tolist())) / 10)
    return float(np.mean(hits))


def test_trained_build_is_chunk_invariant_with_reference_recall(corpus, ref_mono):
    """A trained port build is the same bits at every chunking (the
    reservoir is chunk-invariant, k-means block-ordered), and recalls as
    well as the reference's monolithic trained build."""
    kw = dict(num_centroids=64, kmeans_iters=3, sample_size=3000, device="cpu")
    builds = [tb.build_index_streaming(corpus, chunk_docs=c, **kw) for c in (1, 13, 100, 10_000)]
    for b, c in zip(builds[1:], (13, 100, 10_000)):
        assert_identical(b, builds[0], f"chunk_docs={c} vs 1")
    again = tb.build_index_streaming(corpus, chunk_docs=13, **kw)
    assert_identical(again, builds[0], "a second run")
    rng = np.random.default_rng(5)
    qs = np.stack([corpus[i][rng.integers(0, len(corpus[i]), 8)] for i in rng.choice(len(corpus), 16)])
    qs = qs + 0.05 * rng.standard_normal(qs.shape).astype(np.float32)
    params = dict(k=10, nprobe=64, t_cs=-1e9, ndocs=len(corpus), candidate_cap=len(corpus))
    got = tret.from_index(builds[0], backend="plaid", params=tret.SearchParams(**params))
    want = rret.from_index(ref_mono, backend="plaid", params=rret.SearchParams(**params))
    r_port = _recall_at_10(got.search_batch(qs).pids.numpy(), corpus, qs)
    r_ref = _recall_at_10(np.asarray(want.search_batch(jnp.asarray(qs)).pids), corpus, qs)
    assert r_port >= 0.6 and r_port >= r_ref - 0.05, (r_port, r_ref)


def test_iterator_stream_of_tensors_runs_two_passes(corpus):
    """A corpus that exists only as a stream of tensor chunks builds like
    the same corpus in memory; the stream is read twice."""
    passes = []
    lens = np.array([len(d) for d in corpus], np.int32)

    def factory():
        passes.append(0)
        for lo in range(0, len(corpus), 30):
            yield torch.from_numpy(np.concatenate(corpus[lo : lo + 30])), torch.from_numpy(lens[lo : lo + 30])

    kw = dict(num_centroids=32, kmeans_iters=2, device="cpu")
    got = tb.build_index_streaming(tb.iterator_stream(factory), **kw)
    assert len(passes) == 2
    assert_identical(got, tb.build_index_streaming(np.concatenate(corpus), lens, **kw))


def test_builder_memory_is_sample_plus_chunk_bounded(corpus):
    """On the host the builder's float32 materializations stay O(sample +
    chunk) while the corpus is an order of magnitude bigger."""
    dim = corpus[0].shape[1]
    corpus_bytes = 4 * dim * sum(len(d) for d in corpus)
    builder = tb.StreamingIndexBuilder(num_centroids=32, kmeans_iters=2, sample_size=256,
                                       chunk_docs=8, device="cpu")
    assert builder.build(corpus).num_passages == len(corpus)
    st = builder.stats
    assert 0 < st.peak_host_f32_bytes <= 4 * dim * (256 + 2 * st.peak_chunk_tokens)
    assert st.peak_host_f32_bytes < corpus_bytes / 4
    assert st.trained and st.pass1_s > 0 and st.pass2_s > 0 and st.kmeans_s > 0


# --------------------------------------------------------------------------
# front doors: build_from_encoder, retrieval.build, emit
# --------------------------------------------------------------------------
def test_build_from_encoder_matches_reference(reference):
    """A fake encoder that looks rows up in a fixed unit basis by token id
    (the same f32 rows in both packages), under the reference's frozen
    tables: identical to the reference's ``build_from_encoder``."""
    rng = np.random.default_rng(0)
    dim = 16
    basis = rng.standard_normal((64, dim)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    tokens = rng.integers(0, 64, (120, 8)).astype(np.int32)
    mono = ri.build_index(basis[tokens].reshape(-1, dim), doc_lens=np.full(120, 8, np.int32),
                          num_centroids=16, kmeans_iters=2)
    bj, bt = jnp.asarray(basis), torch.from_numpy(basis)
    want = rindexer.build_from_encoder(lambda t: bj[t % 64], tokens, chunk=16,
                                       centroids=mono.centroids, codec=mono.codec)
    cents, codec = _tables(mono)
    got, st = tindexer.build_from_encoder(lambda t: bt[t.long() % 64], tokens, chunk=16,
                                          centroids=cents, codec=codec, return_stats=True,
                                          device="cpu")
    assert_identical(got, want, "build_from_encoder")
    assert_identical(got, mono, "vs the monolithic build")
    assert not st.trained and st.n_chunks == 8 and st.n_tokens == 960
    with pytest.raises(ValueError, match="every encoder output row"):
        tb.encoder_stream(lambda t: t, tokens, doc_lens=np.full(120, 7, np.int32))


@pytest.mark.parametrize("backend", ["plaid", "plaid-cuda", "vanilla"])
def test_retrieval_build_matches_reference(corpus, ref_mono, backend):
    """``retrieval.build`` with frozen tables in ``index=``: the reference
    facade's pids (``plaid-cuda`` against the reference ``plaid``)."""
    cents, codec = _tables(ref_mono)
    params = dict(k=5, nprobe=4, t_cs=0.3, ndocs=64, candidate_cap=128)
    rng = np.random.default_rng(7)
    qs = np.stack([corpus[i][rng.integers(0, len(corpus[i]), 6)] for i in rng.choice(len(corpus), 4)])
    got = tret.build(corpus, backend=backend, params=tret.SearchParams(**params),
                     index=dict(centroids=cents, codec=codec, chunk_docs=37), device="cpu")
    ref_backend = "vanilla" if backend == "vanilla" else "plaid"
    want = rret.build(corpus, backend=ref_backend, params=rret.SearchParams(**params),
                      index=dict(centroids=ref_mono.centroids, codec=ref_mono.codec,
                                 chunk_docs=37))
    assert got.backend_name == backend
    assert_identical(got.index, want.index, "facade build")
    g, w = got.search_batch(qs), want.search_batch(jnp.asarray(qs))
    np.testing.assert_array_equal(g.pids.numpy(), np.asarray(w.pids))
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), rtol=1e-5, atol=1e-5)


def test_emit_v2_loads_in_reference_and_other_layouts_raise(corpus, ref_mono, tmp_path):
    cents, codec = _tables(ref_mono)
    builder = tb.StreamingIndexBuilder(centroids=cents, codec=codec, chunk_docs=50,
                                       prune_fraction=0.25, device="cpu")
    with pytest.raises(RuntimeError, match="before save"):
        builder.save(str(tmp_path / "early"))
    idx = builder.build(corpus)
    tb.emit(idx, str(tmp_path / "v2"), layout="v2")
    builder.save(str(tmp_path / "saved"))
    for name in ("v2", "saved"):
        back = rindexer.load_index(str(tmp_path / name))
        assert_identical(idx, back, name)
        assert back.prune_fraction == 0.25
    assert_identical(tindexer.load_index(str(tmp_path / "v2"), device="cpu"), idx, "port load")
    # the sharded layout is ported with the sharded engine: the reference's
    # shard_index of the same index, and it sniffs back to plaid-sharded
    tb.emit(idx, str(tmp_path / "sh"), layout="sharded", n_shards=2)
    loaded, meta, per = rindexer.load_sharded(str(tmp_path / "sh"))
    from repro.core import engine_sharded as res

    direct, meta2, per2 = res.shard_index(rindexer.load_index(str(tmp_path / "v2")), 2)
    assert (meta, per) == (meta2, per2)
    for f in direct:
        np.testing.assert_array_equal(np.asarray(loaded[f]), np.asarray(direct[f]), err_msg=f)
    assert tret.load(str(tmp_path / "sh"), device="cpu").backend_name == "plaid-sharded"
    # the live layout is ported with the live index: a lineage-stamped
    # directory that both packages read as a one-segment live index
    lv = tb.emit(idx, str(tmp_path / "l"), layout="live")
    assert lv.num_segments == 1
    from repro.live import LiveIndex as RefLiveIndex

    assert_identical(idx, RefLiveIndex.load(str(tmp_path / "l")).base, "live layout")
    assert tret.load(str(tmp_path / "l"), device="cpu").backend_name == "live"
    with pytest.raises(ValueError, match="n_shards"):
        tb.emit(idx, str(tmp_path / "s"), layout="sharded")
    with pytest.raises(ValueError, match="unknown layout"):
        tb.emit(idx, str(tmp_path / "p"), layout="parquet")
    assert not os.path.exists(tmp_path / "s")
    assert tb.LAYOUTS == rb.LAYOUTS


# --------------------------------------------------------------------------
# On the card: frozen-table identity and trained determinism
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the build's card path runs only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("prune_fraction", [0.0, 0.25])
@pytest.mark.parametrize("chunk_docs", [7, 64, 10_000])
def test_frozen_streaming_matches_build_index_on_card(cuda, prune_fraction, chunk_docs):
    docs = [torch.from_numpy(d).to(cuda) for d in _corpus(8, n_docs=400, dim=128)]
    tables = ti.build_index(docs, num_centroids=256, kmeans_iters=3, device=cuda)
    frozen = dict(centroids=tables.centroids, codec=tables.codec)
    want = ti.build_index(docs, prune_fraction=prune_fraction, device=cuda, **frozen)
    got, st = tb.build_index_streaming(docs, chunk_docs=chunk_docs, prune_fraction=prune_fraction,
                                       return_stats=True, device=cuda, **frozen)
    assert got.device.type == "cuda"
    assert_identical(got, want, f"chunk_docs={chunk_docs} prune={prune_fraction}")
    assert (st.peak_host_f32_bytes > 0) == (prune_fraction > 0)


@pytest.mark.gpu
def test_trained_build_is_deterministic_on_card(cuda):
    docs = _corpus(9, n_docs=600, dim=128)
    packed = torch.from_numpy(np.concatenate(docs)).to(cuda)
    lens = np.array([len(d) for d in docs], np.int32)
    kw = dict(num_centroids=512, kmeans_iters=4, sample_size=8192, device=cuda)
    first = tb.build_index_streaming(packed, lens, chunk_docs=16, **kw)
    for c in (16, 128, 10_000):
        assert_identical(tb.build_index_streaming(packed, lens, chunk_docs=c, **kw), first,
                         f"chunk_docs={c}")
    x = packed[:8192]
    codes = torch.randint(0, 64, (8192,), device=cuda)
    s1, c1 = tk.cluster_sums(x, codes, 64)
    s2, c2 = tk.cluster_sums(x, codes, 64)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    # both devices add each cluster's rows serially in row order
    s_cpu, c_cpu = tk.cluster_sums(x.cpu(), codes.cpu(), 64)
    assert torch.equal(s1.cpu(), s_cpu) and torch.equal(c1.cpu(), c_cpu)
