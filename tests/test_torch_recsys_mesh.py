"""The recsys family over several processes (``repro_torch.models.recsys``
on a ``("data", "model")`` mesh, ``launch.cells.recsys_cell(mesh=)``,
``launch.train --mesh single --model m``) against the reference
(``repro.models.recsys``) on one device.

Four gloo ranks are spawned ONCE for the module (``torch.multiprocessing``,
``file://`` rendezvous, the join limited to JOIN_S).  Ranks 0-1 run a 1 x 2
mesh and ranks 2-3 a 2 x 1 mesh at the same time (a process group each),
then all four a 2 x 2 mesh and ``launch.train`` over the four at model
extents 1 and 2.  Each rank takes the reference's reduced
``init_params(PRNGKey(0))`` trees as numpy, keeps its piece of every leaf
(``recsys.place_params``: the tables by rows, the dense layers by
``"mlp"``; BERT4Rec's 202 item rows split in two), and computes the loss
and its gradients, one AdamW step (2 microbatches), the serve cell's
scores of its rows and the retrieval cell's top-k, gathering split leaves
whole and summing shares over the data axis; the results come back
through an ``.npz`` a rank.  The parent runs the reference meanwhile
(``value_and_grad(train_loss)``, ``make_train_step``, ``serve_scores``
and ``retrieval_scores``, each jitted) on the same numpy inputs.  Besides
the four reduced configs, BST at width 12 over 3 heads splits a head
between the two processes of a model group (``recsys._attend``'s gathered
path).

Tolerances, f32: losses, scores, gradients and the stepped weights rtol
1e-5 / atol 1e-6 (XLA and PyTorch sum in other orders, and the ranks'
partial sums add one more); top-k positions identical.  ``launch.train``'s
losses over the ranks against its own one-process run (rtol 1e-5; the
one-process run is held to the reference by ``tests/test_torch_recsys.py``).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import recsys as rR  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import recsys as tR  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

CUT = "bst-cut-heads"  # BST at width 12 over 3 heads: a head split in two
ARCHS = ["xdeepfm", "bst", "bert4rec", "wide-deep", CUT]
TRAIN_ARCHS = ARCHS[:4]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}  # (data, model)
WORLD = 4
B, N_MICRO = 8, 2  # the step's global batch and microbatches
N_CAND, TOP_K = 300, 20  # the ties case: repeats within and across the data pieces
TRAIN_STEPS, TRAIN_B = 2, 8
TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_S = 240


def base_arch(arch):
    return "bst" if arch == CUT else arch


def cfgs(arch):
    r, t = (rconfigs.get(base_arch(arch)).reduced_config(),
            tconfigs.get(base_arch(arch)).reduced_config())
    if arch == CUT:
        r, t = (dataclasses.replace(c, name=CUT, embed_dim=12, n_heads=3) for c in (r, t))
    return r, t


def inputs_of(arch) -> dict:
    """The reference's tree, the step's batch, the ties case and the cells'
    batches (numpy)."""
    rcfg, tcfg = cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(rR.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg))
    x = dict(tree=tree, cfg=tcfg, batch=next(tsyn.recsys_batches(tcfg, B, seed=1)))
    rng = np.random.default_rng(4)
    b = {k: v[:1] for k, v in next(tsyn.recsys_batches(tcfg, 2, seed=4)).items() if k != "labels"}
    cand = rng.integers(0, tcfg.item_vocab or tcfg.hash_size, N_CAND).astype(np.int32)
    cand[100:110] = cand[5]  # ties in the first piece,
    cand[200:205] = cand[5]  # and in the second
    x["ret"] = dict(b, candidate_ids=cand)
    cells = tconfigs.cells_of(base_arch(arch))
    for name in ("serve_p99", "retrieval_cand"):
        c = cells[name]
        built = tcells.recsys_cell(arch, tcfg, c, c.reduced, "cpu",
                                   params=tR.params_from_numpy(tree, "cpu"))
        x[name] = {k: v.numpy() for k, v in built.args[1].items()}
    return x


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _sum_data(t):
    data = sharding.data_mesh()
    return t if data is None else tmesh.all_reduce_sum(data, t)


def _rank_arch(name, mesh, arch, x, out):
    cfg = x["cfg"]
    whole = tR.params_from_numpy(x["tree"], "cpu")
    params, place = tR.place_params(whole, cfg)
    key = f"{name}/{arch}"
    out[f"{key}/split"] = np.array([p.split for p in ttree.leaves(place)] if place else [])
    loss_fn = lambda p, b: tR.train_loss(p, cfg, b)  # noqa: E731
    (loss, _), grads = tloop.value_and_grad(loss_fn, params, _tb(x["batch"]))
    out[f"{key}/loss"] = _sum_data(loss).numpy()
    if place is not None:
        grads = sharding.gather_tree(grads, place)
    for i, g in enumerate(ttree.leaves(grads)):
        out[f"{key}/grad/{i}"] = _sum_data(g).numpy()

    opt = topt.adamw(topt.AdamWConfig())
    step = tloop.make_train_step(loss_fn, opt, n_micro=N_MICRO, placements=place)
    p1, _, m = step(params, tloop.init_opt_state(opt, params), _tb(x["batch"]))
    tloop.assert_replicas_agree(p1, mesh, place)
    out[f"{key}/step_loss"] = m["loss"].numpy()
    whole1 = p1 if place is None else sharding.gather_tree(p1, place)
    for i, p in enumerate(ttree.leaves(whole1)):
        out[f"{key}/param/{i}"] = p.numpy()

    cells = tconfigs.cells_of(base_arch(arch))
    with torch.no_grad():
        c = cells["serve_p99"]
        built = tcells.recsys_cell(arch, cfg, c, c.reduced, "cpu", params=whole, mesh=mesh)
        out[f"{key}/serve"] = built.fn(*built.args).numpy()
        out[f"{key}/serve_rows"] = np.array(tcells._data_rows(c.reduced["batch"]).indices(
            c.reduced["batch"]))
        c = cells["retrieval_cand"]
        built = tcells.recsys_cell(arch, cfg, c, c.reduced, "cpu", params=whole, mesh=mesh)
        s, i = built.fn(*built.args)
        out[f"{key}/cell_topk"], out[f"{key}/cell_topk_scores"] = i.numpy(), s.numpy()
        s, i = tR.retrieval_scores(params, cfg, _tb(x["ret"]), top_k=TOP_K)
        out[f"{key}/topk"], out[f"{key}/topk_scores"] = i.numpy(), s.numpy()


def _rank_train_cli(rank, tmp, out):
    for arch in TRAIN_ARCHS:
        for model in (1, 2):
            res = ttrain.run(["--arch", arch, "--reduced", "--device", "cpu", "--mesh", "single",
                              "--model", str(model), "--steps", str(TRAIN_STEPS),
                              "--batch", str(TRAIN_B), "--ckpt-dir", f"{tmp}/ckpt/{arch}{model}"])
            out[f"train/{arch}/{model}"] = np.array(res["losses"])


def _rank_main(rank, tmp, inputs):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    try:
        out = {}
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        name = "1x2" if rank < 2 else "2x1"
        data, model = MESHES[name]
        mesh = tmesh.Mesh((torch.device("cpu"),), pairs[rank // 2], (("data", data), ("model", model)))
        for mname, m in ((name, mesh), ("2x2", tmesh.make_production_mesh(device="cpu", model=2))):
            out[f"{mname}/coords"] = np.array([m.coords()["data"], m.coords()["model"]])
            with sharding.use_mesh(m):
                for arch, x in inputs.items():
                    _rank_arch(mname, m, arch, x, out)
        _rank_train_cli(rank, tmp, out)
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _join(procs, tmp):
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    assert not alive, f"rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(len(procs))]


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------
def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _reference(arch, x) -> dict:
    rcfg, _ = cfgs(arch)
    params = jax.tree_util.tree_map(jnp.asarray, x["tree"])
    loss_fn = lambda p, b: rR.train_loss(p, rcfg, b)  # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, _jb(x["batch"]))
    opt = ropt.adamw(ropt.AdamWConfig())
    step = jax.jit(rloop.make_train_step(loss_fn, opt, n_micro=N_MICRO))
    p1, _, m = step(params, rloop.init_opt_state(opt, params), _jb(x["batch"]))
    top = tconfigs.cells_of(base_arch(arch))["retrieval_cand"].reduced["top_k"]

    def serve_and_retrieve(p, serve, cell, ties):
        return (rR.serve_scores(p, rcfg, serve), rR.retrieval_scores(p, rcfg, cell, top_k=top),
                rR.retrieval_scores(p, rcfg, ties, top_k=TOP_K))

    serve, (cs, ci), (ts, ti) = jax.jit(serve_and_retrieve)(
        params, _jb(x["serve_p99"]), _jb(x["retrieval_cand"]), _jb(x["ret"]))
    leaves = lambda t: [np.asarray(v) for v in jax.tree_util.tree_leaves(t)]  # noqa: E731
    return dict(loss=float(loss), grads=leaves(grads), step_loss=float(m["loss"]),
                params=leaves(p1), serve=np.asarray(serve), cell_topk=np.asarray(ci),
                cell_topk_scores=np.asarray(cs), topk=np.asarray(ti), topk_scores=np.asarray(ts))


def _train_one_process(arch, tmp) -> list:
    return ttrain.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", str(TRAIN_STEPS),
                       "--batch", str(TRAIN_B), "--ckpt-dir", f"{tmp}/one/{arch}"])["losses"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"ranks": [each rank's record], "ref": {arch: ...}, "one": {arch:
    launch.train's one-process losses}}; the reference runs while the
    ranks do."""
    tmp = str(tmp_path_factory.mktemp("recsys_mesh"))
    inputs = {arch: inputs_of(arch) for arch in ARCHS}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, inputs)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {arch: _reference(arch, x) for arch, x in inputs.items()}
        one = {arch: _train_one_process(arch, tmp) for arch in TRAIN_ARCHS}
    finally:
        recs = _join(procs, tmp)
    return dict(ranks=recs, ref=ref, one=one, inputs=inputs)


def mesh_ranks(ranks, mesh):
    """The records of the ranks that ran ``mesh``."""
    recs = ranks["ranks"]
    return {"1x2": recs[:2], "2x1": recs[2:], "2x2": recs}[mesh]


CASES = [(m, a) for m in MESHES for a in ARCHS]


def close(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **TOL)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_lie_row_major_and_split_the_leaves_the_rules_split(ranks, mesh):
    """Each rank's (data, model) coordinates are row-major; on a model
    extent of 2 every table, BERT4Rec's 202 items included, and every
    dense layer the rules split is split, the MLP's 1-wide output whole."""
    data, model = MESHES[mesh]
    for r, rec in enumerate(mesh_ranks(ranks, mesh)):
        np.testing.assert_array_equal(rec[f"{mesh}/coords"], divmod(r, model))
        for arch in ARCHS:
            split = rec[f"{mesh}/{arch}/split"]
            if model == 1:
                assert split.size == 0
                continue
            _, tcfg = cfgs(arch)
            with sharding.use_mesh(tmesh.make_dry_mesh(shape={"data": data, "model": model})):
                want = [p.split for p in ttree.leaves(tR.placements(tcfg))]
            assert split.tolist() == want and any(want) and not all(want), arch


@pytest.mark.parametrize("mesh,arch", CASES)
def test_loss_and_every_gathered_gradient_match_the_reference(ranks, mesh, arch):
    want = ranks["ref"][arch]
    for rec in mesh_ranks(ranks, mesh):
        close(rec[f"{mesh}/{arch}/loss"], want["loss"], "loss")
        for i, g in enumerate(want["grads"]):
            close(rec[f"{mesh}/{arch}/grad/{i}"], g, f"gradient {i}")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_one_adamw_step_matches_the_reference_step(ranks, mesh, arch):
    """Two microbatches of four rows, each split over the data axis; the
    replicas were checked bit-identical on the ranks."""
    want = ranks["ref"][arch]
    for rec in mesh_ranks(ranks, mesh):
        close(rec[f"{mesh}/{arch}/step_loss"], want["step_loss"], "step loss")
        for i, p in enumerate(want["params"]):
            close(rec[f"{mesh}/{arch}/param/{i}"], p, f"parameter {i}")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_the_serve_cell_scores_each_ranks_rows_as_the_reference(ranks, mesh, arch):
    want = ranks["ref"][arch]["serve"]
    for rec in mesh_ranks(ranks, mesh):
        lo, hi, _ = rec[f"{mesh}/{arch}/serve_rows"]
        assert hi - lo == len(want) // MESHES[mesh][0]
        close(rec[f"{mesh}/{arch}/serve"], want[lo:hi], "scores")


@pytest.mark.parametrize("mesh,arch", CASES)
def test_retrieval_top_k_positions_are_the_references(ranks, mesh, arch):
    """The retrieval cell (512 candidates, top 10) and 300 candidates with
    repeats inside and across the data pieces (top 20): positions
    identical, ties toward the lower position."""
    want = ranks["ref"][arch]
    for rec in mesh_ranks(ranks, mesh):
        for k in ("cell_topk", "topk"):
            np.testing.assert_array_equal(rec[f"{mesh}/{arch}/{k}"], want[k], err_msg=k)
            close(rec[f"{mesh}/{arch}/{k}_scores"], want[f"{k}_scores"], k)


@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_launch_train_over_four_processes_matches_one_process(ranks, arch, model):
    """``launch.train --mesh single --model m`` over four processes (4 x 1
    and 2 x 2): every rank's losses those of the one-process run."""
    for rec in ranks["ranks"]:
        np.testing.assert_allclose(rec[f"train/{arch}/{model}"], ranks["one"][arch], rtol=1e-5)


def test_param_shapes_are_the_initial_trees_shapes():
    for arch in ARCHS:
        _, tcfg = cfgs(arch)
        tree = tR.init_params(tcfg, torch.Generator().manual_seed(0))
        shapes = ttree.tree_map(lambda t: tuple(t.shape), tree)
        assert ttree.leaves(shapes) == ttree.leaves(tR.param_shapes(tcfg)), arch
