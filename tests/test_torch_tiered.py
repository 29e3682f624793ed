"""Port vs reference: the tiered index (``repro_torch.core.tiered``,
``repro_torch.exec.tiered``, ``repro_torch.kernels.costs`` and the
``plaid-tiered`` / ``plaid-tiered-cuda`` backends against ``repro.core.
tiered``, ``repro.exec.tiered`` and ``repro.kernels.costs``).

At the reference test's sizes (60 passages, dim 16, 8 centroids), one
reference index carried across with ``index_from_numpy``:

* the port's ``TieredEngine`` gives pids identical to the reference's
  ``TieredEngine`` and scores within relative 1e-5 of them (the port's
  plain stage 4 sums in its kernels' f32 order, not XLA's), and scores and
  pids identical (``torch.equal``) to the port's resident engine, fused and
  not, with every ``FunnelStats`` field equal;
* ``partition_tiered``'s arrays equal the reference's; partitioned search
  at 1, 2 and 3 partitions equals the per-partition resident oracle plus
  ``merge_topk`` exactly, and the reference's executor as above;
* ``TransferStats``, the byte counts and ``tiered_transfer_cost`` equal
  the reference's integers, and the stats equal the model exactly;
* tiered directories cross-load both ways, memory-mapped, with identical
  pids; the resident loaders refuse them and ``load_tiered`` refuses
  resident ones.

The reference's ``test_zero_retrace_across_t_cs_and_batches`` has no
counterpart: the port runs eagerly and never traces (``trace_counts`` stays
``(0, 0)``).  ``test_server_surfaces_transfer_stats`` waits for the serving
tier's port.  The ``gpu`` cases hold ``plaid-tiered-cuda`` against
``plaid-tiered`` and ``plaid-cuda`` on the card, and the staging ring under
a device sleep queued on its copy stream.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax.numpy as jnp

    from repro import retrieval as rret
    from repro.core import index as ri
    from repro.core import plaid as rp
    from repro.core import tiered as rt
    from repro.exec import tiered as rxt
    from repro.kernels import costs as rcosts
except ImportError:
    ri = None

from repro_torch import live as tlive  # noqa: E402
from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import indexer as tindexer  # noqa: E402
from repro_torch.core import pipeline as tpl  # noqa: E402
from repro_torch.core import plaid as tp  # noqa: E402
from repro_torch.core import tiered as tt  # noqa: E402
from repro_torch.constants import NEG  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed.topk import merge_topk  # noqa: E402
from repro_torch.exec import tiered as txt  # noqa: E402
from repro_torch.exec.segments import pow2_bucket  # noqa: E402
from repro_torch.kernels import costs as tcosts  # noqa: E402
from repro_torch.live import manifest as tman  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CAPS = dict(k=12, nprobe=4, t_cs=0.3, ndocs=64, candidate_cap=64)


@pytest.fixture(scope="module")
def corpus():
    if ri is None:
        pytest.skip("needs jax and the repro package (the reference)")
    docs, _ = syn.embedding_corpus(60, dim=16, max_len=12, seed=0)
    qs, _ = syn.queries_from_docs(docs, 6, q_len=8, seed=1)
    base = ri.build_index(docs, num_centroids=8, nbits=2, kmeans_iters=4, seed=0)
    return np.asarray(qs, np.float32), base, _port(base)


def _port(ref_index, device="cpu"):
    return ti.index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in ti.ARRAY_FIELDS},
        {f: getattr(ref_index, f) for f in ti.STATIC_FIELDS},
        device,
    )


def _params(impl="ref", fused=False, **kw):
    return tp.SearchParams(**dict(CAPS, **kw), impl=impl, fused=fused)


def _ref_params(fused=False, **kw):
    return rp.SearchParams(**dict(CAPS, **kw), impl="ref", fused=fused)


def _same_as_ref(got_s, got_p, want_s, want_p):
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def _densify(part: tt.TieredIndex) -> ti.PlaidIndex:
    """Resident view of one partition (the oracle's input)."""
    return dataclasses.replace(
        part.device,
        codes=torch.from_numpy(np.array(part.host_codes)),
        residuals=torch.from_numpy(np.array(part.host_residuals)),
        tok_pid=torch.from_numpy(
            np.repeat(np.arange(part.num_passages, dtype=np.int32), part.host_doc_lens)
        ),
    )


# --------------------------------------------------------------------------
# one partition: the reference's engine and the port's resident engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_engine_equals_reference_and_resident(corpus, impl, fused):
    qs, base, port = corpus
    p = _params(impl, fused)
    want = tp.PlaidEngine(port, p).search_batch(qs, funnel=True)
    eng = tt.TieredEngine(tt.tiered_from_index(port), p)
    got = eng.search_batch(qs, funnel=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w, name in zip(got[2], want[2], got[2]._fields):
        assert torch.equal(g, w), name
    ref_eng = rt.TieredEngine(rt.tiered_from_index(base), _ref_params(fused))
    ref = ref_eng.search_batch(jnp.asarray(qs), funnel=True)
    _same_as_ref(got[0], got[1], ref[0], ref[1])
    for g, w, name in zip(got[2], ref[2], got[2]._fields):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert eng.last_transfer.as_dict() == ref_eng.last_transfer.as_dict()
    # without the funnel, and one query through search()
    s, pid = eng.search_batch(qs, t_cs=0.45)
    ws, wp = tp.PlaidEngine(port, p).search_batch(qs, t_cs=0.45)
    assert torch.equal(s, ws) and torch.equal(pid, wp)
    s1, p1 = eng.search(qs[2])
    assert torch.equal(s1, got[0][2]) and torch.equal(p1, got[1][2])
    assert tt.trace_counts() == (0, 0)
    assert eng.last_copy_ms() is None  # no device copy on the CPU


def test_step_clock_times_the_batch_without_changing_it(corpus):
    """``time_steps`` makes ``search_batch`` keep its own step times (what
    phase ``tiered`` of ``chip_smoke.py`` reports); results are unchanged,
    and on the CPU the device times are None."""
    qs, _, port = corpus
    eng = tt.TieredEngine(tt.tiered_from_index(port), _params())
    want = eng.search_batch(qs)
    assert eng.last_steps() is None  # off by default
    eng.time_steps = True
    got = eng.search_batch(qs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    steps = eng.last_steps()
    assert set(steps) == {"phase_a_ms", "d2h_ms", "gather_ms", "copy_enqueue_ms",
                          "h2d_ms", "phase_b_ms"}
    assert steps["phase_a_ms"] is None and steps["phase_b_ms"] is None
    assert steps["h2d_ms"] is None
    assert all(steps[f] >= 0 for f in ("d2h_ms", "gather_ms", "copy_enqueue_ms"))


def test_strip_payload_and_demotion_share_the_device_tier(corpus):
    _, base, port = corpus
    t = tt.tiered_from_index(port)
    dev = t.device
    assert dev.codes is port.codes and dev.centroids is port.centroids
    assert tuple(dev.residuals.shape) == (1, port.residuals.shape[1])
    assert dev.tok_pid.shape == dev.eivf_eids.shape == (1,)
    np.testing.assert_array_equal(t.host_residuals, np.asarray(base.residuals))
    np.testing.assert_array_equal(t.host_codes, np.asarray(base.codes))
    r = rt.tiered_from_index(base)
    assert (t.num_passages, t.num_tokens, t.payload_itemsize) == (
        r.num_passages, r.num_tokens, r.payload_itemsize)
    assert t.device_nbytes() == r.device_nbytes()
    assert t.resident_nbytes() == r.resident_nbytes()
    assert t.resident_payload_nbytes() == r.resident_payload_nbytes()
    assert t.resident_nbytes() > t.device_nbytes()


# --------------------------------------------------------------------------
# partitions: arrays, the per-partition oracle, the reference's executor
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_parts", [2, 3])
def test_partition_arrays_equal_reference(corpus, n_parts):
    _, base, port = corpus
    got, got_off = txt.partition_tiered(tt.tiered_from_index(port), n_parts)
    want, want_off = rxt.partition_tiered(rt.tiered_from_index(base), n_parts)
    assert got_off == want_off
    for g, w in zip(got, want):
        for f in ti.ARRAY_FIELDS:
            np.testing.assert_array_equal(
                getattr(g.device, f).numpy(), np.asarray(getattr(w.device, f)), err_msg=f)
        assert g.device.static_dict() == {f: getattr(w.device, f) for f in ti.STATIC_FIELDS}
        for f in ("host_codes", "host_residuals", "host_doc_offsets", "host_doc_lens"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
        # host payloads are views of the parent's, device centroids shared
        assert g.host_residuals.base is not None
        assert g.device.centroids is got[0].device.centroids
        assert g.device_nbytes() == w.device_nbytes()
    with pytest.raises(ValueError, match="n_partitions"):
        txt.partition_tiered(tt.tiered_from_index(port), 0)
    with pytest.raises(ValueError, match="cannot split"):
        txt.partition_tiered(tt.tiered_from_index(port), 61)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_partitioned_search_equals_oracle_and_reference(corpus, n_parts, fused):
    qs, base, port = corpus
    p = _params(fused=fused)
    ex = txt.TieredExecutor(tt.tiered_from_index(port), p, n_partitions=n_parts)
    got_s, got_p = ex.search_batch(qs)

    masks = torch.ones(qs.shape[:2])
    if n_parts == 1:
        want_s, want_p = tp.PlaidEngine(port, p).search_batch(qs)
    else:
        parts, offs = txt.partition_tiered(tt.tiered_from_index(port), n_parts)
        all_s, all_p = [], []
        for part, off in zip(parts, offs):
            pp = tp.clamp_params(p, part.num_passages)
            s, pid = tpl.run_pipeline(_densify(part), torch.from_numpy(qs), masks, p.t_cs, pp)
            pad = p.k - s.shape[1]
            s = torch.nn.functional.pad(s, (0, pad), value=NEG)
            pid = torch.nn.functional.pad(pid, (0, pad), value=-1)
            all_s.append(s)
            all_p.append(torch.where(pid >= 0, pid + off, -1))
        want_s, want_p = merge_topk(torch.cat(all_s, 1), torch.cat(all_p, 1), p.k)
    assert torch.equal(got_s, want_s) and torch.equal(got_p, want_p)

    ref = rxt.TieredExecutor(rt.tiered_from_index(base), _ref_params(fused),
                             n_partitions=n_parts)
    _same_as_ref(got_s, got_p, *ref.search_batch(jnp.asarray(qs)))
    assert ex.transfer_totals == ref.transfer_totals
    assert ex.last_transfer_bytes() == ref.last_transfer_bytes()
    # the funnel merges across partitions as the reference's does
    got_f = ex.search_batch(qs, funnel=True)[2]
    want_f = ref.search_batch(jnp.asarray(qs), funnel=True)[2]
    for g, w, name in zip(got_f, want_f, got_f._fields):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# --------------------------------------------------------------------------
# transfer accounting and the budget
# --------------------------------------------------------------------------
def test_transfer_accounting_equals_reference_and_model(corpus):
    qs, base, port = corpus
    eng = tt.TieredEngine(tt.tiered_from_index(port), _params(k=5))
    ref_eng = rt.TieredEngine(rt.tiered_from_index(base), _ref_params(k=5))
    for batch in (qs, qs[:3]):
        eng.search_batch(batch)
        ref_eng.search_batch(jnp.asarray(batch))
        st = eng.last_transfer
        assert st.as_dict() == ref_eng.last_transfer.as_dict()

        # an independent recount from stages 1-3 on the resident index
        pp = tp.clamp_params(_params(k=5), port.num_passages)
        fp, *_ = tpl.select_finalists_impl(
            port, torch.from_numpy(batch), torch.ones(batch.shape[:2]), pp.t_cs,
            params=pp, keep_blocks=False,
        )
        fp = fp.numpy()
        pool = np.unique(fp[fp >= 0])
        lens = port.doc_lens.numpy()[pool]
        pd = port.residuals.shape[1]
        assert st.pool_docs == pool.size and st.slice_tokens == int(lens.sum())
        kw = dict(pool_docs=int(pool.size), slice_tokens=int(lens.sum()), pd=pd,
                  n3=fp.shape[1], B=fp.shape[0],
                  p_cap=pow2_bucket(max(pool.size, 1), lo=1),
                  t_cap=pow2_bucket(max(int(lens.sum()), 1), lo=port.doc_maxlen))
        model = tcosts.tiered_transfer_cost(**kw)
        assert model == rcosts.tiered_transfer_cost(**kw)
        assert st.slice_bytes == model["slice_bytes"]
        assert st.staged_bytes == model["staged_bytes"]
        assert st.slice_bytes < eng.tiered.resident_payload_nbytes()
    assert eng.transfer_totals == ref_eng.transfer_totals
    assert eng.transfer_totals["batches"] == 2
    assert tcosts.tiered_transfer_cost(pool_docs=3, slice_tokens=7, pd=4, n3=2, B=1) == {
        "slice_bytes": 56}
    n, pd = port.num_tokens, port.residuals.shape[1]
    want = rcosts.resident_payload_bytes(num_tokens=n, pd=pd)
    assert tcosts.resident_payload_bytes(num_tokens=n, pd=pd) == want
    assert eng.tiered.resident_payload_nbytes() == want


def test_budget_enforced(corpus):
    _, _, port = corpus
    t = tt.tiered_from_index(port)
    with pytest.raises(tt.TieredBudgetError):
        tt.TieredEngine(t, _params(), device_budget_bytes=16)
    with pytest.raises(tt.TieredBudgetError):
        txt.TieredExecutor(t, _params(), n_partitions=2, device_budget_bytes=16)
    # the device tier always fits its own size, summed over partitions too
    txt.TieredExecutor(t, _params(), device_budget_bytes=t.device_nbytes())
    ex = txt.TieredExecutor(t, _params(), n_partitions=3)
    txt.TieredExecutor(t, _params(), n_partitions=3, device_budget_bytes=ex.device_nbytes())
    with pytest.raises(tt.TieredBudgetError):
        txt.TieredExecutor(t, _params(), n_partitions=3,
                           device_budget_bytes=ex.device_nbytes() - 1)


# --------------------------------------------------------------------------
# the facade
# --------------------------------------------------------------------------
def test_facade_routes_tiered_params(corpus):
    qs, base, port = corpus
    params = tret.SearchParams(**CAPS, tiered=True)
    r = tret.from_index(port, backend="plaid", params=params)
    assert r.backend_name == "plaid-tiered" and r.impl == "ref"
    rc = tret.from_index(port, backend="plaid-cuda", params=params)
    assert rc.backend_name == "plaid-tiered-cuda" and rc.impl == "cuda"
    for other in ("vanilla", "live", "live-cuda"):
        with pytest.raises(ValueError, match="tiered"):
            tret.from_index(port, backend=other, params=params)
    want = tret.from_index(port, backend="plaid", params=params.replace(tiered=False))
    for got in (r, rc):
        a, b = got.search_batch(qs, with_funnel=True), want.search_batch(qs, with_funnel=True)
        assert torch.equal(a.pids, b.pids) and torch.equal(a.scores, b.scores)
        assert a.funnel.keys() == b.funnel.keys()
        for f in a.funnel:
            np.testing.assert_array_equal(a.funnel[f], b.funnel[f], err_msg=f)
        one = got.search(qs[1], with_funnel=True)
        assert torch.equal(one.pids, b.pids[1])
        assert all(isinstance(v, int) for v in one.funnel.values())
    # one batch each: the same results, description and transfer counts
    r = tret.from_index(port, backend="plaid", params=params)
    ref = rret.from_index(base, backend="plaid",
                          params=rret.SearchParams(**CAPS, tiered=True))
    _same_as_ref(*r.search_batch(qs), *ref.search_batch(jnp.asarray(qs)))
    desc, ref_desc = r.describe(), ref.describe()
    assert desc["storage"] == dict(ref_desc["storage"])
    assert desc["transfer"] == ref_desc["transfer"]
    assert desc["index"] == ref_desc["index"]
    assert desc["storage"]["resident_payload_bytes"] > (
        desc["transfer"]["slice_bytes"] / desc["transfer"]["batches"])
    assert r.last_transfer_bytes() == ref.last_transfer_bytes()
    # n_shards sets the partitions
    r3 = tret.from_index(port, tret.RetrieverConfig(backend="plaid", params=params, n_shards=3))
    ex = txt.TieredExecutor(tt.tiered_from_index(port), _params(), n_partitions=3)
    assert r3.describe()["storage"]["n_partitions"] == 3
    assert torch.equal(r3.search_batch(qs).pids, ex.search_batch(qs)[1])


def test_facade_diagnostics_rejected(corpus):
    qs, _, port = corpus
    r = tret.from_index(port, backend="plaid", params=tret.SearchParams(k=5, tiered=True))
    with pytest.raises(ValueError, match="diagnostics"):
        r.search(qs[0], with_diagnostics=True)
    with pytest.raises(ValueError, match="diagnostics"):
        r.search_batch(qs, with_diagnostics=True)


def test_facade_build_routes_to_tiered(corpus):
    qs, base, _ = corpus
    docs, _ = syn.embedding_corpus(60, dim=16, max_len=12, seed=0)
    params = tret.SearchParams(**CAPS, tiered=True)
    got = tret.build(docs, backend="plaid-cuda", params=params, device="cpu",
                     index=dict(centroids=np.asarray(base.centroids)))
    want = tret.build(docs, backend="plaid-cuda", params=params.replace(tiered=False),
                      device="cpu", index=dict(centroids=np.asarray(base.centroids)))
    assert got.backend_name == "plaid-tiered-cuda"
    assert torch.equal(got.search_batch(qs).pids, want.search_batch(qs).pids)


# --------------------------------------------------------------------------
# persistence: both packages' directories, both ways
# --------------------------------------------------------------------------
def test_reference_directory_loads_in_port(corpus, tmp_path):
    qs, base, _ = corpus
    params = rret.SearchParams(**CAPS, tiered=True)
    ref = rret.from_index(base, backend="plaid", params=params)
    want = ref.search_batch(jnp.asarray(qs))
    path = str(tmp_path / "ref")
    ref.save(path)
    got = tret.load(path, device="cpu")
    assert got.backend_name == "plaid-tiered" and got.params.tiered
    assert isinstance(got.tiered.host_residuals, np.memmap)
    assert isinstance(got.tiered.host_codes, np.memmap)
    _same_as_ref(*got.search_batch(qs), want.scores, want.pids)
    # a bare directory (no retriever.json) sniffs tiered off the manifest
    os.remove(os.path.join(path, "retriever.json"))
    bare = tret.load(path, params=tret.SearchParams(**CAPS), device="cpu")
    assert bare.backend_name == "plaid-tiered"
    assert torch.equal(bare.search_batch(qs).pids, got.search_batch(qs).pids)


def test_port_directory_loads_in_reference(corpus, tmp_path):
    qs, base, port = corpus
    r = tret.from_index(port, backend="plaid",
                        params=tret.SearchParams(**CAPS, tiered=True))
    want = r.search_batch(qs)
    path = str(tmp_path / "port")
    r.save(path)
    back = rret.load(path)
    assert back.backend_name == "plaid-tiered" and back.params.tiered
    assert isinstance(back.tiered.host_residuals, np.memmap)
    np.testing.assert_array_equal(np.asarray(back.search_batch(jnp.asarray(qs)).pids),
                                  want.pids.numpy())
    # a plaid-tiered-cuda directory names a backend the reference lacks (as
    # plaid-cuda's does); its arrays load there under plaid-tiered
    cpath = str(tmp_path / "port_cuda")
    tret.from_index(port, backend="plaid-cuda",
                    params=tret.SearchParams(**CAPS, tiered=True)).save(cpath)
    assert json.load(open(os.path.join(cpath, "retriever.json")))["backend"] == (
        "plaid-tiered-cuda")
    back = rret.load(cpath, backend="plaid-tiered")
    np.testing.assert_array_equal(np.asarray(back.search_batch(jnp.asarray(qs)).pids),
                                  want.pids.numpy())
    # the same files as the reference's writer gives a demoted index
    rpath = str(tmp_path / "refsave")
    rt.save_tiered(rpath, rt.tiered_from_index(base))
    seg, rseg = os.path.join(path, "seg_000000"), os.path.join(rpath, "seg_000000")
    assert sorted(os.listdir(seg)) == sorted(os.listdir(rseg))
    for f in tman.TIERED_PAYLOAD_FIELDS:
        np.testing.assert_array_equal(np.load(os.path.join(seg, f"{f}.npy")),
                                      np.load(os.path.join(rseg, f"{f}.npy")), err_msg=f)
    m = json.load(open(os.path.join(path, "manifest.json")))
    assert m == json.load(open(os.path.join(rpath, "manifest.json")))
    assert m["storage"] == "tiered"
    # a resident index saves tiered too, and loads back identical
    rpath2 = str(tmp_path / "resident_in")
    tt.save_tiered(rpath2, port)
    again = tt.load_tiered(rpath2, device="cpu")
    for f in ti.ARRAY_FIELDS:
        if f not in tman.TIERED_PAYLOAD_FIELDS:
            assert torch.equal(getattr(again.device, f), getattr(port, f)), f
    np.testing.assert_array_equal(again.host_residuals, port.residuals.numpy())
    s, pid = tt.TieredEngine(again, _params()).search_batch(qs)
    ws, wp = tp.PlaidEngine(port, _params()).search_batch(qs)
    assert torch.equal(s, ws) and torch.equal(pid, wp)


def test_loaders_refuse_the_other_layout(corpus, tmp_path):
    _, _, port = corpus
    tiered_dir, resident_dir = str(tmp_path / "tiered"), str(tmp_path / "resident")
    tt.save_tiered(tiered_dir, port)
    tindexer.save_index(resident_dir, port)
    for load in (lambda p: tindexer.load_index(p, device="cpu"),
                 lambda p: tman.load_segmented(p, device="cpu"),
                 lambda p: tlive.LiveIndex.load(p, device="cpu"),
                 lambda p: tret.load(p, backend="plaid", device="cpu"),
                 lambda p: tret.load(p, backend="live", device="cpu")):
        with pytest.raises(ValueError, match="load_tiered"):
            load(tiered_dir)
    with pytest.raises(ValueError, match="not a tiered index"):
        tt.load_tiered(resident_dir, device="cpu")
    with pytest.raises(ValueError, match="not a tiered index"):
        tret.load(resident_dir, backend="plaid-tiered", device="cpu")
    assert tret.load(resident_dir, device="cpu").backend_name == "plaid"
    # an unknown storage stamp is refused, not guessed
    mpath = os.path.join(tiered_dir, "manifest.json")
    m = json.load(open(mpath))
    json.dump(dict(m, storage="cold"), open(mpath, "w"))
    with pytest.raises(ValueError, match="unknown storage"):
        tret.load(tiered_dir, device="cpu")
    with pytest.raises(ValueError, match="unknown storage"):
        tman.save_segmented(str(tmp_path / "x"), [port], [0], None, 0, storage="cold")
    json.dump(m, open(mpath, "w"))
    # typed payload errors
    seg = os.path.join(tiered_dir, "seg_000000")
    with open(os.path.join(seg, "residuals.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    with pytest.raises(tman.PayloadCorruptError):
        tt.load_tiered(tiered_dir, device="cpu")
    os.remove(os.path.join(seg, "codes.npy"))
    with pytest.raises(tman.PayloadMissingError):
        tt.load_tiered(tiered_dir, device="cpu")
    # more than one segment: compact first
    json.dump(dict(m, segments=m["segments"] * 2), open(mpath, "w"))
    with pytest.raises(ValueError, match="exactly one"):
        tt.load_tiered(tiered_dir, device="cpu")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card_index():
    docs, _ = syn.embedding_corpus(400, dim=64, min_len=6, max_len=40, seed=5)
    qs, _ = syn.queries_from_docs(docs, 16, q_len=12, seed=6)
    index = ti.build_index(docs, num_centroids=64, nbits=2, kmeans_iters=3, device="cuda")
    return index, torch.as_tensor(np.asarray(qs, np.float32), device="cuda")


@pytest.mark.gpu
def test_tiered_cuda_equals_tiered_and_plaid_cuda_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    index, qs = _card_index()
    for fused in (False, True):
        for k in (5, 40):
            params = tret.SearchParams(k=k, nprobe=4, t_cs=0.4, ndocs=128,
                                       candidate_cap=256, fused=fused, tiered=True)
            cuda = tret.from_index(index, backend="plaid-cuda", params=params)
            plain = tret.from_index(index, backend="plaid", params=params)
            resident = tret.from_index(index, backend="plaid-cuda",
                                       params=params.replace(tiered=False))
            got, want = cuda.search_batch(qs, with_funnel=True), resident.search_batch(
                qs, with_funnel=True)
            assert cuda.backend_name == "plaid-tiered-cuda"
            assert torch.equal(got.pids, want.pids) and torch.equal(got.scores, want.scores)
            for f in got.funnel:
                np.testing.assert_array_equal(got.funnel[f], want.funnel[f], err_msg=f)
            other = plain.search_batch(qs)
            assert torch.equal(got.pids, other.pids) and torch.equal(got.scores, other.scores)
            eng = cuda._executor.engines[0]
            assert eng.last_copy_ms() > 0
            eng.time_steps = True
            again = cuda.search_batch(qs)
            assert torch.equal(again.pids, got.pids) and torch.equal(again.scores, got.scores)
            assert all(v is not None and v >= 0 for v in eng.last_steps().values())


@pytest.mark.gpu
def test_staging_ring_waits_for_the_copy_in_flight():
    """A slot handed out again must not be refilled while a copy that reads
    it is still queued (behind a device sleep on the copy stream), and
    phase B must wait for the copy of its own batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream exists only on the card")
    ring = tt._StagingRing(torch.device("cuda"))
    shapes = dict(codes=(1 << 16,), res=(1 << 16, 16), offs=(9,), lens=(8,), pos=(2, 4))
    slot, staged = ring.take(shapes)
    for i, s in enumerate(staged):
        s.numpy()[...] = np.arange(s.numel(), dtype=np.int64).reshape(s.shape) % 97 + i
    want = [s.clone() for s in staged]
    with torch.cuda.stream(ring.stream):
        torch.cuda._sleep(100_000_000)
    moved = ring.upload(slot, staged)
    ring.take(shapes)  # the other slot
    again, views = ring.take(shapes)  # this slot: waits for its copy first
    assert again is slot
    for v in views:
        v.numpy()[...] = 0
    torch.cuda.synchronize()
    for m, w in zip(moved, want):
        assert torch.equal(m.cpu(), w)
    assert ring.last_copy_ms() > 0

    index, qs = _card_index()
    params = tp.SearchParams(k=10, nprobe=4, t_cs=0.4, ndocs=128, candidate_cap=256,
                             impl="cuda")
    eng = tt.TieredEngine(tt.tiered_from_index(index), params)
    real = eng._staging.upload

    def delayed(slot, staged):
        with torch.cuda.stream(eng._staging.stream):
            torch.cuda._sleep(50_000_000)
        return real(slot, staged)

    eng._staging.upload = delayed
    resident = tp.PlaidEngine(index, params)
    for lo in (0, 5, 10):  # three different batches: different slices
        got = eng.search_batch(qs[lo : lo + 6])
        want = resident.search_batch(qs[lo : lo + 6])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
