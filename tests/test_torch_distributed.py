"""Two processes on gloo: the port's document sharding across a process
group (``repro_torch.launch.mesh``, the collective cases of
``distributed.topk.merge_topk``, ``distributed.reduce.ordered_block_sum``
and ``obs.funnel.psum_partitions``, and the ``plaid-sharded`` /
``live-sharded`` backends) against the same two shards in one process.

Each rank is spawned with ``torch.multiprocessing``, joins through a
``file://`` rendezvous in the test's temporary directory (no TCP port, so
parallel test workers cannot collide), calls ``init_distributed`` and
``retrieval.build(..., backend="plaid-sharded")`` on its shard, and
writes what it computed to an ``.npz``; every ``join`` has a timeout.
The ``gpu`` case holds ``plaid-sharded`` with ``impl="cuda"`` (K1-K3 on
every shard) against ``plaid-cuda`` on the card; this file imports no JAX,
so it runs where only the port is installed.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import retrieval as tret  # noqa: E402
from repro_torch.core import engine_sharded as tes  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed import reduce as treduce  # noqa: E402
from repro_torch.distributed import topk as ttopk  # noqa: E402
from repro_torch.exec import sharded as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.obs import funnel as tfunnel  # noqa: E402

WORLD = 2
JOIN_TIMEOUT_S = 240
N_DOCS, DIM, K = 150, 64, 32
PARAMS = dict(k=8, nprobe=4, t_cs=0.3, ndocs=64, candidate_cap=128)
INDEX = dict(num_centroids=K, kmeans_iters=3)


def _inputs():
    docs, _ = syn.embedding_corpus(N_DOCS + 20, dim=DIM, min_len=6, max_len=24, seed=11)
    qs, _ = syn.queries_from_docs(docs, 6, q_len=6)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((4, 3, 5)).astype(np.float32)  # 4 blocks, 2 a rank
    tuples = (rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
              rng.permutation(WORLD * 6 * 5).reshape(WORLD, 6, 5).astype(np.int32))
    return [np.asarray(d, np.float32) for d in docs], np.asarray(qs, np.float32), blocks, tuples


def _stats(rank):
    """A per-shard FunnelStats: doc counts that differ by rank, centroid
    counts equal on every shard (the centroids replicate)."""
    return tfunnel.FunnelStats(*(
        torch.full((6,), (i + 1) * (10 if f in tfunnel.REPLICATED_FIELDS else rank + 1),
                   dtype=torch.int32)
        for i, f in enumerate(tfunnel.FunnelStats._fields)))


def _search(r, qs):
    res = r.search_batch(qs, with_funnel=True)
    return res.scores.numpy(), res.pids.numpy(), res.funnel


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    assert tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    assert not tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank)  # idempotent
    assert tmesh.is_multihost()
    docs, qs, blocks, (scores, pids) = _inputs()
    params = tret.SearchParams(**PARAMS)
    out = {}
    r = tret.build(docs[:N_DOCS], backend="plaid-sharded", n_shards=WORLD, device="cpu",
                   params=params, index=INDEX)
    assert list(r.mesh.shard_ids()) == [rank] and r.mesh.n_shards == WORLD
    out["scores"], out["pids"], funnel = _search(r, qs)
    out.update({"funnel/" + f: v for f, v in funnel.items()})
    mesh = r.mesh
    out["block_sum"] = treduce.ordered_block_sum(
        [torch.from_numpy(blocks[2 * rank : 2 * rank + 2])], mesh).numpy()
    ps = tfunnel.psum_partitions([_stats(rank)], mesh)
    out.update({"psum/" + f: v.numpy() for f, v in ps._asdict().items()})
    ms, mp_ = ttopk.merge_topk([torch.from_numpy(scores[rank])],
                               [torch.from_numpy(pids[rank])], 7, mesh=mesh)
    out["merge_scores"], out["merge_pids"] = ms.numpy(), mp_.numpy()
    # each rank writes its own shard, then reads only its own back
    r.save(f"{tmp}/saved")
    torch.distributed.barrier()
    back = tret.load(f"{tmp}/saved", device="cpu")
    out["loaded_scores"], out["loaded_pids"], _ = _search(back, qs)
    # live-sharded: the base sharded over the ranks, a delta replicated
    plain = tret.build(docs[:N_DOCS], backend="plaid", device="cpu", params=params, index=INDEX)
    lv = tret.from_index(plain.index, backend="live-sharded", n_shards=WORLD, params=params)
    lv.add_passages(docs[N_DOCS:])
    lv.delete_passages([3, N_DOCS + 2])
    out["live_scores"], out["live_pids"], _ = _search(lv, qs)
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _spawn(tmp):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, tmp)) for rank in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, f"rank(s) still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn(str(tmp_path_factory.mktemp("gloo")))


def test_two_gloo_ranks_search_like_two_shards_in_one_process(ranks):
    docs, qs, _, _ = _inputs()
    params = tret.SearchParams(**PARAMS)
    want = tret.build(docs[:N_DOCS], backend="plaid-sharded", n_shards=WORLD, device="cpu",
                      params=params, index=INDEX)
    w_scores, w_pids, w_funnel = _search(want, qs)
    plain = tret.build(docs[:N_DOCS], backend="plaid", device="cpu", params=params, index=INDEX)
    lv = tret.from_index(plain.index, backend="live-sharded", n_shards=WORLD, params=params)
    lv.add_passages(docs[N_DOCS:])
    lv.delete_passages([3, N_DOCS + 2])
    l_scores, l_pids, _ = _search(lv, qs)
    for got in ranks:
        for key in ("", "loaded_"):
            np.testing.assert_array_equal(got[key + "pids"], w_pids)
            np.testing.assert_array_equal(got[key + "scores"], w_scores)
        for f, v in w_funnel.items():
            np.testing.assert_array_equal(got["funnel/" + f], v, err_msg=f)
        np.testing.assert_array_equal(got["live_pids"], l_pids)
        np.testing.assert_array_equal(got["live_scores"], l_scores)


def test_two_gloo_ranks_collectives_equal_the_local_ones(ranks):
    _, _, blocks, (scores, pids) = _inputs()
    one = tmesh.Mesh(("cpu",) * WORLD)
    want_sum = treduce.ordered_block_sum(torch.from_numpy(blocks))
    assert torch.equal(want_sum, treduce.ordered_block_sum(
        [torch.from_numpy(blocks[:2]), torch.from_numpy(blocks[2:])], one))
    want_ps = tfunnel.psum_partitions([_stats(r) for r in range(WORLD)], one)
    ws, wp = ttopk.merge_topk(torch.from_numpy(np.concatenate(scores, -1)),
                              torch.from_numpy(np.concatenate(pids, -1)), 7)
    for got in ranks:
        np.testing.assert_array_equal(got["block_sum"], want_sum.numpy())
        for f, v in want_ps._asdict().items():
            np.testing.assert_array_equal(got["psum/" + f], v.numpy(), err_msg=f)
        np.testing.assert_array_equal(got["merge_pids"], wp.numpy())
        np.testing.assert_array_equal(got["merge_scores"], ws.numpy())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.gpu
def test_plaid_sharded_cuda_equals_plaid_cuda_on_card():
    """``impl="cuda"`` at one shard is ``plaid-cuda`` under ``torch.equal``;
    two shards sharing the card equal the shards searched one by one
    through ``plaid-cuda`` plus the local merge, and ``impl="ref"``'s pids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    docs, _ = syn.embedding_corpus(600, dim=128, min_len=8, max_len=64, seed=5)
    qs, _ = syn.queries_from_docs(docs, 16, q_len=32)
    qs = torch.from_numpy(np.asarray(qs, np.float32)).cuda()
    idx = tret.build(docs, backend="plaid-cuda", device="cuda",
                     index=dict(num_centroids=256, kmeans_iters=3)).index
    for fused in (False, True):
        params = tret.SearchParams(k=10, nprobe=4, t_cs=0.4, ndocs=128, candidate_cap=256,
                                   fused=fused)
        cls = tret.get_backend("plaid-sharded")
        one = cls.from_index(idx, tret.RetrieverConfig(params=params, n_shards=1), impl="cuda")
        want = tret.from_index(idx, backend="plaid-cuda", params=params).search_batch(qs)
        got = one.search_batch(qs)
        assert torch.equal(got.pids, want.pids) and torch.equal(got.scores, want.scores)
        mesh = tmesh.Mesh(("cuda:0", "cuda:0"))
        two = cls.from_index(idx, tret.RetrieverConfig(params=params), mesh=mesh, impl="cuda")
        ref = cls.from_index(idx, tret.RetrieverConfig(params=params), mesh=mesh, impl="ref")
        got2 = two.search_batch(qs)
        d, meta, per = tes.shard_index(idx, 2)
        p = dataclasses.replace(params, candidate_cap=min(256, per))
        parts = [tret.from_index(s, backend="plaid-cuda", params=p).search_batch(qs)
                 for s in tsh.place_shards(mesh, d, meta)]
        ws, wp = ttopk.merge_topk(
            torch.cat([o.scores for o in parts], 1),
            torch.cat([ttopk.local_to_global_pids(o.pids, s, per) for s, o in enumerate(parts)], 1),
            10)
        assert torch.equal(got2.pids, wp) and torch.equal(got2.scores, ws)
        r2 = ref.search_batch(qs)
        assert torch.equal(got2.pids, r2.pids)
        torch.testing.assert_close(got2.scores, r2.scores, rtol=1e-5, atol=1e-6)
