"""The dry-run planner (``repro_torch.launch.dryrun``), its counter
(``launch.meta_cost``), the dry mesh (``launch.mesh.make_dry_mesh``) and
the kernels' meta paths and cost models (``kernels.costs``).

* The plan: for every cell that is not skipped, on both production meshes,
  each leaf's per-rank shape and dtype under the rules
  (``cells.cell_plan``) equals the reference's ``NamedSharding.
  shard_shape`` of the same leaf, built in ONE subprocess on 512 fake XLA
  devices (``eval_shape`` and ``tree_shardings``, no compile; ~5 s).  The
  encoder's tree has no ``lm_head`` in the port, which is the only leaf
  the reference has beside the port's.
* The counter: on a dry 1 x 1 mesh the meta-traced flops of a reduced LM
  train step equal ``FlopCounterMode``'s count of the same step run for
  real on the CPU; on a dry 1 x 2 mesh its ``coll_counts`` and
  ``coll_bytes`` equal a tally of the same step on a real 1 x 2 gloo
  group (one spawn); the depth and microbatch extrapolation equals a whole
  trace; ``roofline_terms`` on hand-worked numbers.
* The kernels: every name of ``kernels.ops._COUNTERS`` has a
  ``costs.KERNEL_COSTS`` model; each meta path gives its plain version's
  output shape and dtype and charges its model, counting no launch; a CPU
  tensor never takes it.
* The sweep: every LM serving cell and both search cells are ``ok`` on
  both meshes, one LM train cell of each kind (dense, MoE) too, every
  recsys and SchNet cell as well (a recsys rank holding the plan's bytes
  but for the leaves the port keeps whole), and every ``fail`` of the
  other families is a ``NotImplementedError`` naming its ROADMAP item.

This file imports no JAX (the reference's plan comes from a subprocess),
so its ``gpu`` case runs on the card: the search cells at reduced width,
``impl="cuda"`` against ``impl="ref"``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import _build, costs, ops, ref  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import meta_cost  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT_S = 240
#: the names of a cell's arguments, by kind, as the plan keys them
ARG_NAMES = {"train": ("params", "opt", "batch"), "prefill": ("params", "tokens"),
             "decode": ("params", "cache", "tokens", "n"), "encode": ("params", "tokens"),
             "search": ("index", "qs", "masks"), "serve": ("params", "batch"),
             "retrieval": ("params", "batch"), "full_graph": ("params", "opt", "batch"),
             "minibatch": ("params", "opt", "batch"), "molecule": ("params", "opt", "batch")}
PLAN_CELLS = [(a, c.name) for a in tconfigs.ARCH_IDS for c in tconfigs.get(a).CELLS
              if not c.skip]

_REF_PLAN = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro import configs
from repro.distributed import sharding
from repro.launch import cells
from repro.launch.mesh import make_production_mesh
SERVE = {"prefill", "decode", "serve", "retrieval", "search", "encode"}
names = json.loads(sys.argv[2])
out = {}
for arch in configs.ARCH_IDS:
    for name, cell in configs.cells_of(arch).items():
        if cell.skip:
            continue
        for mp in (0, 1):
            mesh = make_production_mesh(multi_pod=bool(mp))
            rules = dict(sharding.SERVE_RULES) if cell.kind in SERVE else {}
            with sharding.use_mesh(mesh, rules):
                b = cells.build_cell(arch, name, mode="dry", mesh=mesh)
            leaves = {}
            for path, s in jax.tree_util.tree_leaves_with_path(b.args):
                keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
                keys[0] = names[cell.kind][int(keys[0])]
                leaves["/".join(keys)] = [list(s.sharding.shard_shape(s.shape)), str(s.dtype)]
            out[f"{arch}|{name}|{mp}"] = leaves
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def ref_plan(tmp_path_factory):
    path = tmp_path_factory.mktemp("plan") / "plan.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_PLAN, str(path), json.dumps(ARG_NAMES)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch,cell", PLAN_CELLS, ids=[f"{a}-{c}" for a, c in PLAN_CELLS])
def test_the_plan_equals_the_reference_shard_shapes(ref_plan, arch, cell):
    kind = tconfigs.cells_of(arch)[cell].kind
    for mp in (0, 1):
        with sharding.use_mesh(tmesh.make_dry_mesh(multi_pod=bool(mp)), dryrun.dry_rules(kind)):
            plan = tcells.cell_plan(arch, cell)
        want = ref_plan[f"{arch}|{cell}|{mp}"]
        extra = set(want) - set(plan)
        assert set(plan) <= set(want), sorted(set(plan) - set(want))
        if arch == "plaid-colbertv2":
            assert all(k.endswith("backbone/lm_head") for k in extra), sorted(extra)
        else:
            assert not extra, sorted(extra)
        for k, (shape, dt) in plan.items():
            assert [list(shape), str(dt).replace("torch.", "")] == want[k], (k, mp)


def _reduced_lm(arch: str, **changes):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced_config(), **changes)
    return cfg, tconfigs.cells_of(arch)["train_4k"]


def test_meta_flops_of_a_train_step_equal_flop_counter_mode_on_the_cpu():
    cfg, cell = _reduced_lm("yi-34b")
    p = cell.reduced
    with sharding.use_mesh(tmesh.make_dry_mesh(shape={"data": 1, "model": 1}), {}):
        dry = tcells._lm_dry("yi-34b", cfg, cell, p)
        got = dryrun.count(dry)
    full_micro = p["global_batch"]  # one row a microbatch on one rank
    real = tcells._lm_cell("yi-34b", cfg, cell, dict(p, n_micro=full_micro), torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        real.fn(*real.args)
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["flops_by_dtype"] == {"float32": float(fc.get_total_flops())}
    assert got["coll_bytes"] == 0 and got["hbm_bytes"] > 0 and got["mem_temp"] > 0


def _tally_rank(rank: int, tmp: str) -> None:
    """One rank of a real 1 x 2 gloo mesh: the reduced LM train step of
    ``test_collectives_...`` on zero weights, each collective tallied as
    the counter counts it."""
    assert tmesh.init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo")
    import torch.distributed as dist

    tally = {"counts": {}, "bytes": 0.0}

    def add(kind, nbytes):
        tally["counts"][kind] = tally["counts"].get(kind, 0) + 1
        tally["bytes"] += nbytes

    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "all_to_all_single")}

    def all_reduce(t, *a, **kw):
        add("all-reduce", 2.0 * t.numel() * t.element_size())
        return real["all_reduce"](t, *a, **kw)

    def all_gather(out, t, *a, **kw):
        add("all-gather", float(sum(o.numel() * o.element_size() for o in out)))
        return real["all_gather"](out, t, *a, **kw)

    def all_to_all_single(out, t, *a, **kw):
        add("all-to-all", float(out.numel() * out.element_size()))
        return real["all_to_all_single"](out, t, *a, **kw)

    dist.all_reduce, dist.all_gather, dist.all_to_all_single = all_reduce, all_gather, all_to_all_single
    mesh = tmesh.make_production_mesh(device="cpu", model=2)
    for arch in ("yi-34b", "granite-moe-1b-a400m"):
        cfg, cell = _reduced_lm(arch)
        with sharding.use_mesh(mesh, {}):
            built = tcells._lm_dry(arch, cfg, cell, cell.reduced, device=torch.device("cpu"))
            tally = {"counts": {}, "bytes": 0.0}
            built.fn(*built.args)
        with open(os.path.join(tmp, f"{arch}-rank{rank}.json"), "w") as f:
            json.dump(tally, f)
    dist.destroy_process_group()


def test_collectives_of_a_train_step_equal_a_real_gloo_group(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tally_rank, args=(r, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    for arch in ("yi-34b", "granite-moe-1b-a400m"):
        cfg, cell = _reduced_lm(arch)
        with sharding.use_mesh(tmesh.make_dry_mesh(shape={"data": 1, "model": 2}), {}):
            got = dryrun.count(tcells._lm_dry(arch, cfg, cell, cell.reduced))
        want = json.loads((tmp_path / f"{arch}-rank0.json").read_text())
        assert got["coll_counts"] == want["counts"] and sum(want["counts"].values()) > 0, arch
        assert got["coll_bytes"] == want["bytes"], arch
        assert json.loads((tmp_path / f"{arch}-rank1.json").read_text()) == want


@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-moe-16b"])
def test_the_depth_and_microbatch_extrapolation_equals_a_whole_trace(arch):
    """A reduced LM at 5 layers past its dense ones and 5 microbatches on a
    dry 1 x 2 mesh: the planner's four small traces, extrapolated, give
    every count of the whole trace."""
    base = tconfigs.get(arch).reduced_config()
    first = base.first_dense if base.n_experts else 0
    cfg, cell = _reduced_lm(arch, n_layers=first + 5)
    p = dict(cell.reduced, global_batch=5)
    with sharding.use_mesh(tmesh.make_dry_mesh(shape={"data": 1, "model": 2}), {}):
        whole = dryrun.count(tcells._lm_dry(arch, cfg, cell, p))
        pts, ws = dryrun.extrapolation_points(first, cfg.n_layers, 5)
        assert len(pts) == 4
        parts = [dryrun.count(tcells._lm_dry(arch, cfg, cell, p, layers=L, n_micro=n))
                 for L, n in pts]
    got = dryrun.combine(parts, ws)
    for key in ("flops", "hbm_bytes", "coll_bytes", "mem_args", "mem_out", "mem_temp", "ops"):
        assert got[key] == pytest.approx(whole[key], rel=1e-9), key
    for key in ("flops_by_dtype", "coll_detail", "coll_counts", "coll_axes"):
        assert got[key].keys() == whole[key].keys(), key
        for k in whole[key]:
            assert got[key][k] == pytest.approx(whole[key][k], rel=1e-9), (key, k)


def test_roofline_terms_on_hand_worked_numbers():
    rl = meta_cost.roofline_terms(
        per_chip_flops={torch.bfloat16: 989e12, torch.float32: 67e12},  # 1 s + 1 s
        per_chip_bytes=3.35e12,  # 1 s of HBM
        per_chip_coll_bytes={8: 450e9, 16: 100e9},  # 1 s of NVLink + 2 s of NIC
        model_flops=256 * 989e12, n_chips=256)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == (2.0, 1.0, 3.0)
    assert rl.dominant == "collective" and rl.bound_s == 3.0
    assert rl.model_flops == 989e12 and rl.hlo_flops == 989e12 + 67e12
    assert rl.useful_ratio == pytest.approx(989 / 1056)
    assert rl.roofline_fraction == pytest.approx(1 / 3)
    flat = meta_cost.roofline_terms(per_chip_flops=989e12, per_chip_bytes=0.0,
                                    per_chip_coll_bytes=450e9, model_flops=0.0, n_chips=1)
    assert (flat.compute_s, flat.collective_s, flat.dominant) == (1.0, 1.0, "compute")
    assert meta_cost.link_bw(8) == 450e9 and meta_cost.link_bw(9) == 50e9


def test_every_kernel_has_a_cost_model():
    assert set(costs.KERNEL_COSTS) == set(ops._COUNTERS)


def _kernel_cases(g):
    """(name, wrapper call, plain call) on small seeded CPU inputs."""
    B, K, nq, nd, L, d, nbits = 2, 16, 4, 6, 5, 8, 2
    pd = d * nbits // 8
    s_cq = torch.randn(B, K, nq, generator=g)
    codes = torch.randint(-1, K, (B, nd, L), generator=g, dtype=torch.int32)
    keep = torch.rand(B, K, generator=g) > 0.3
    qm = torch.ones(B, nq)
    q = torch.randn(B, nq, d, generator=g)
    res = torch.randint(0, 256, (B, nd, L, pd), generator=g, dtype=torch.uint8)
    valid = codes >= 0
    cents = torch.randn(K, d, generator=g)
    w = torch.randn(2**nbits, generator=g)
    nt = 40
    lens = torch.tensor([5, 10, 3, 12, 10], dtype=torch.int32)
    offs = torch.cat([torch.zeros(1, dtype=torch.int32), torch.cumsum(lens, 0).to(torch.int32)])
    codes_tok = torch.randint(0, K, (nt,), generator=g, dtype=torch.int32)
    res_tok = torch.randint(0, 256, (nt, pd), generator=g, dtype=torch.uint8)
    pids = torch.tensor([[0, 3, -1], [4, 1, 2]], dtype=torch.int32)
    qq = torch.randn(1, 7, 2, 8, generator=g)
    kk = torch.randn(1, 7, 1, 8, generator=g)
    vv = torch.randn(1, 7, 1, 8, generator=g)
    from repro_torch.kernels import decompress as dec, flash_attention as fa
    from repro_torch.kernels import fused_score as fs, maxsim as ms
    return [
        ("centroid_interaction_batched", lambda *a: ms.centroid_interaction_batched(*a),
         (s_cq, codes, keep, qm)),
        ("centroid_interaction", lambda *a: ms.centroid_interaction(*a),
         (s_cq[0], codes[0], keep[0], qm[0])),
        ("decompress_and_score_batched",
         lambda *a: dec.decompress_and_score_batched(*a, nbits=nbits),
         (q, qm, codes, res, valid, cents, w)),
        ("decompress_and_score", lambda *a: dec.decompress_and_score(*a, nbits=nbits),
         (q[0], qm[0], codes[0], res[0], valid[0], cents, w)),
        ("decompress_residuals", lambda *a: dec.decompress_residuals(*a, nbits=nbits),
         (res.reshape(-1, pd), w)),
        ("gather_decompress_maxsim",
         lambda *a: fs.gather_decompress_maxsim(*a, nbits=nbits, doc_maxlen=12),
         (q, qm, pids, codes_tok, res_tok, offs, lens, cents, w)),
        ("flash_attention", lambda *a: fa.flash_attention(*a, causal=True), (qq, kk, vv)),
    ]


def test_each_meta_path_gives_the_plain_versions_shape_and_charges_its_model():
    g = torch.Generator().manual_seed(0)
    cases = _kernel_cases(g)
    assert {n for n, _, _ in cases} == set(ops._COUNTERS)
    for name, call, args in cases:
        plain = call(*args)  # CPU tensors: the plain version
        meta_args = tuple(a.to("meta") for a in args)
        before = ops.launch_counts()
        with meta_cost.MetaCounter(meta_args) as c:
            got = call(*meta_args)
        assert ops.launch_counts() == before, name  # no launch counted
        assert got.device.type == "meta" and got.shape == plain.shape, name
        assert got.dtype == plain.dtype, name
        k = c.kernels[name]
        assert k["launches"] == 1 and k["hbm_bytes"] > 0, (name, k)
        assert c.hbm_bytes >= k["hbm_bytes"] and c.total_flops >= k["flops"], name


def test_a_cpu_tensor_never_takes_the_meta_path(monkeypatch):
    g = torch.Generator().manual_seed(1)

    def refuse(*a, **kw):
        raise AssertionError("a CPU call took the meta path")

    monkeypatch.setattr(_build, "dry_launch", refuse)
    for name, call, args in _kernel_cases(g):
        assert not _build.on_meta(args[0])
        got = call(*args)
        assert got.device.type == "cpu", name
    s_cq, codes, keep, qm = _kernel_cases(torch.Generator().manual_seed(2))[0][2]
    assert torch.equal(ops.centroid_interaction_batched(s_cq, codes, qm, keep),
                       ref.centroid_interaction_batched_ref(s_cq, codes, keep, qm))


def test_the_cost_models_are_the_chip_bounds_formulas():
    """K1's and K2's models at hand-counted data-dependent counts."""
    c = costs.centroid_interaction_batched_cost(B=2, nd=3, L=4, K=10, nq=5, rows=7, flags=9,
                                                kept=11)
    assert c["hbm_bytes"] == 2 * 3 * 4 * 4 + 7 * 5 * 4 + 9 + 2 * 5 * 4 + 2 * 3 * 4
    assert c["bound_ops"] == 11 * 5 + 2 * 3 * 5 * 3
    assert c["flops"] == 2.0 * 2 * 32 * 4 * 5  # nd padded to the doc block
    s = costs.decompress_and_score_batched_cost(B=2, nd=3, L=4, pd=32, K=10, d=128, nq=5,
                                                nbits=2, tokens=13, rows=6)
    assert s["hbm_bytes"] == 13 * 36 + 6 * 128 * 4 + 2 * 5 * 129 * 4 + 6 * 4 + 2 * 3 * 4
    assert s["bound_ops"] == 2.0 * 13 * 5 * 128 + 13 * 5
    f = costs.flash_attention_cost(B=1, S=4, H=2, Hkv=1, dh=8, causal=True, itemsize=2)
    assert f == dict(hbm_bytes=float((2 * 64 + 2 * 32) * 2), flops=4.0 * 2 * 16 * 8 * 0.5,
                     bound_ops=4.0 * 2 * 16 * 8 * 0.5)


def test_the_dry_mesh_is_one_rank_of_the_production_mesh():
    m = tmesh.make_dry_mesh(multi_pod=True, rank=37)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.world_size == 512
    assert m.coords() == {"pod": 0, "data": 2, "model": 5} and m.rank == 37
    assert m.sub("model").world_size == 16 and m.sub("model").rank == 5
    assert m.sub("pod", "data").world_size == 32 and m.sub("pod", "data").rank == 2
    assert tmesh.axis_index(m, "data") == 2 and m.devices == (torch.device("meta"),)
    with sharding.use_mesh(m, {}):
        assert sharding.model_mesh().world_size == 16
        assert sharding.data_mesh().shape == {"pod": 2, "data": 16}
    x = torch.empty(3, 4, device="meta")
    with meta_cost.MetaCounter() as c:
        assert tmesh.all_reduce_sum(m, x, axis="model").shape == (3, 4)
        assert tmesh.all_gather(m, x, axis=("pod", "data")).shape == (32, 3, 4)
        assert tmesh.gather_shards(m, [x], dim=0).shape == (512 * 3, 4)
    assert c.coll_detail == {"all-reduce": 2 * 48.0, "all-gather": 32 * 48.0 + 512 * 48.0}
    assert c.coll_counts == {"all-reduce": 1, "all-gather": 2}
    assert c.coll_axes == {"model": 96.0, "pod,data": 32 * 48.0, "pod,data,model": 512 * 48.0}


SWEEP = ([(a, c.name) for a in ("yi-34b", "granite-34b", "h2o-danube-3-4b",
                                 "granite-moe-1b-a400m", "deepseek-moe-16b")
          for c in tconfigs.get(a).CELLS if c.kind != "train"]
         + [("granite-34b", "train_4k"), ("granite-moe-1b-a400m", "train_4k")]
         + [(a, c.name) for a in ("plaid-colbertv2", "schnet", "xdeepfm", "bst", "bert4rec",
                                  "wide-deep") for c in tconfigs.get(a).CELLS])


@pytest.mark.parametrize("arch,cell", SWEEP, ids=[f"{a}-{c}" for a, c in SWEEP])
def test_the_sweep_records_are_ok_or_fail_naming_their_item(arch, cell):
    fam = tconfigs.get(arch).FAMILY
    for mp in (False, True):
        rec = dryrun.run_cell(arch, cell, mp, verbose=False)
        assert rec["status"] in ("ok", "skip", "fail"), rec
        if fam == "lm" or cell.startswith("search"):
            assert rec["status"] in ("ok", "skip"), rec
        if rec["status"] == "fail":
            assert rec["error"].startswith("NotImplementedError") and rec["item"], rec
            assert rec["item"].startswith("8.5."), rec
            assert rec["mem_args_plan"] > 0
        if rec["status"] == "ok":
            assert rec["flops"] > 0 and rec["hbm_bytes"] > 0 and rec["mem_args"] > 0
            assert rec["mem_args_plan"] > 0 and rec["dominant"] in ("compute", "memory",
                                                                     "collective")
            json.dumps(rec)


FAMILY_MESH = [(a, c.name) for a in ("wide-deep", "xdeepfm", "bst", "bert4rec", "schnet")
               for c in tconfigs.get(a).CELLS]
#: what a rank of the port holds unsplit where the plan splits it, by cell
#: kind: the global batch of a train step (every process is handed it) with
#: the "embed_fsdp" leaves whole over "data" (ROADMAP Queue 1 item 8.5.2),
#: and a retrieval cell's candidate ids
WHOLE_IN_THE_PORT = {"train": {"embed_fsdp": None, "batch": None}, "serve": {},
                     "retrieval": {"candidates": None}, "encode": {}}


@pytest.mark.parametrize("arch,cell", FAMILY_MESH, ids=[f"{a}-{c}" for a, c in FAMILY_MESH])
def test_the_recsys_and_schnet_records_are_ok_on_both_meshes(arch, cell):
    """The recsys family over several processes and SchNet's edge split:
    every record ``ok`` on 16 x 16 and 2 x 16 x 16.  Wide&Deep's and
    xDeepFM's ranks hold what the plan holds but for WHOLE_IN_THE_PORT,
    byte for byte (serve_p99: ~0.35 GB, not the whole 5.54 GB table)."""
    kind = tconfigs.cells_of(arch)[cell].kind
    for multi in (False, True):
        rec = dryrun.run_cell(arch, cell, multi, verbose=False)
        assert rec["status"] == "ok", rec
        if arch not in ("wide-deep", "xdeepfm"):
            continue
        mesh = tmesh.make_dry_mesh(multi_pod=multi)
        with sharding.use_mesh(mesh, dict(dryrun.dry_rules(kind), **WHOLE_IN_THE_PORT[kind])):
            held = tcells.plan_bytes(tcells.cell_plan(arch, cell))
        assert rec["mem_args"] == held, (rec["mem_args"], held, rec["mem_args_plan"])
        assert (rec["mem_args"] > rec["mem_args_plan"]) == (kind == "train"), rec
        if arch == "wide-deep" and cell == "serve_p99":
            assert 0.3e9 < rec["mem_args"] < 0.4e9, rec


@pytest.mark.parametrize("cell", ["train_triples", "encode_corpus"])
def test_the_colbert_records_are_ok_on_both_meshes(cell):
    """ColBERTv2 on the model axis (ROADMAP Queue 1 item 8.5.5): both
    records ``ok`` on 16 x 16 and 2 x 16 x 16, a rank holding what the plan
    holds but for WHOLE_IN_THE_PORT, byte for byte (the encoder's weights
    in bf16 and its rows of the batch, as planned), and its layers'
    products summed over ``"model"``."""
    kind = tconfigs.cells_of("plaid-colbertv2")[cell].kind
    for multi in (False, True):
        rec = dryrun.run_cell("plaid-colbertv2", cell, multi, verbose=False)
        assert rec["status"] == "ok", rec
        mesh = tmesh.make_dry_mesh(multi_pod=multi)
        with sharding.use_mesh(mesh, dict(dryrun.dry_rules(kind), **WHOLE_IN_THE_PORT[kind])):
            held = tcells.plan_bytes(tcells.cell_plan("plaid-colbertv2", cell))
        assert rec["mem_args"] == held, (rec["mem_args"], held, rec["mem_args_plan"])
        assert (rec["mem_args"] > rec["mem_args_plan"]) == (kind == "train"), rec
        assert rec["coll_axes"]["model"] > 0, rec


def test_the_search_cells_launch_k1_and_k2_meta_paths():
    rec = dryrun.run_cell("plaid-colbertv2", "search_140m", False)
    assert rec["kernels"]["centroid_interaction_batched"]["launches"] == 2  # stages 2 and 3
    assert rec["kernels"]["decompress_and_score_batched"]["launches"] == 1  # stage 4
    assert rec["mem_args"] == rec["mem_args_plan"]  # one shard a rank, as planned
    assert rec["coll_counts"] == {"all-gather": 2}  # the merge's scores and pids


def test_the_cli_writes_one_record_a_cell(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "plaid-colbertv2", "--shape", "search_9m", "--both-meshes",
                        "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["mesh"] for r in lines] == ["16x16", "2x16x16"]
    assert all(r["status"] == "ok" for r in lines)
    assert capsys.readouterr().out.count("\n") == 2
    dryrun.main(["--arch", "yi-34b", "--shape", "train_4k", "--strategy", "zero3",
                 "--out", str(tmp_path / "z.jsonl")])
    z = json.loads((tmp_path / "z.jsonl").read_text())
    assert z["status"] == "fail" and z["item"] == "8.5.2", z


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["search_9m", "search_140m"])
def test_search_cells_cuda_equal_ref_on_card(cell):
    """The reduced search cells through K1 and K2 (``impl="cuda"``) equal
    the same cell with ``impl="ref"`` on the card: pids and scores bit for
    bit (the kernels' contract with their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arch = "plaid-colbertv2"
    c = tconfigs.cells_of(arch)[cell]
    cfg = tconfigs.get(arch).reduced_config()
    index = tcells.search_index(c.reduced, "cuda")
    got_cell = tcells.retrieval_cell(arch, cfg, c, c.reduced, "cuda", index=index)
    want_cell = tcells.retrieval_cell(arch, cfg, c, c.reduced, "cuda", index=index, impl="ref")
    ops.reset_launch_counts()
    gs, gp = got_cell.fn(*got_cell.args)
    counts = ops.launch_counts()
    assert counts["centroid_interaction_batched"] == 2, counts  # stages 2 and 3
    assert counts["decompress_and_score_batched"] == 1, counts  # stage 4
    ws, wp = want_cell.fn(*want_cell.args)
    assert torch.equal(gp, wp) and torch.equal(gs, ws)
    assert bool((gp >= 0).all()) and bool(torch.isfinite(gs).all())
