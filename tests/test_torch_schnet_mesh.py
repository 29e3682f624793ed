"""SchNet's edge split over several processes (``repro_torch.models.schnet``
on a ``("data", "model")`` mesh, ``launch.cells.gnn_cell(mesh=)``) against
the reference (``repro.models.schnet``) on one device.

Four gloo ranks are spawned ONCE for the module (``torch.multiprocessing``,
``file://`` rendezvous, the join limited to JOIN_S).  Ranks 0-1 run a 1 x 2
mesh and ranks 2-3 a 2 x 1 mesh at the same time (a process group each),
then all four a 2 x 2 mesh; ``"edges"`` maps to every axis, so the edges
split in two, two and four.  For the reduced ``molecule``,
``full_graph_sm`` and ``minibatch_lg`` cells, and 3 molecules with 33 edges
(which the ranks pad with masked edges), each rank computes the loss and
its gradients (its share summed over the data axis), one AdamW step and
the cell's own donating step (``gnn_cell(mesh=)``, its loss).  The parent
runs the reference meanwhile (``value_and_grad(train_loss)`` and
``make_train_step``, jitted) on the same numpy inputs and weights.

Tolerances, f32: rtol 1e-5 / atol 1e-6 (XLA's ``segment_sum`` and
PyTorch's ``index_add`` add in other orders, and the ranks' partial
aggregates add one more).
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
from repro.models import schnet as rS  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import graphs as tgraphs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import schnet as tS  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

ODD = "molecule_33_edges"
CELLS = ["molecule", "full_graph_sm", "minibatch_lg", ODD]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}  # (data, model)
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_S = 240


def cell_of(name):
    return tconfigs.cells_of("schnet")["molecule" if name == ODD else name]


def inputs_of(name) -> dict:
    """The cell's config, the reference's tree for it and the batch (numpy)."""
    c = cell_of(name)
    tcfg, _, _ = tcells.gnn_shape(tconfigs.get("schnet").reduced_config(), c.kind, c.reduced)
    rcfg = dataclasses.replace(rconfigs.get("schnet").reduced_config(), d_feat=tcfg.d_feat,
                               n_classes=tcfg.n_classes)
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(rS.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg))
    batch = (tgraphs.molecule_batch(3, 7, 11, seed=4) if name == ODD
             else tcells.gnn_batch(c.kind, c.reduced))
    return dict(cfg=tcfg, rcfg=rcfg, tree=tree, batch=batch)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _sum_data(t):
    data = sharding.data_mesh()
    return t if data is None else tmesh.all_reduce_sum(data, t)


def _rank_cell(mname, mesh, name, x, out):
    cfg = x["cfg"]
    key = f"{mname}/{name}"
    params = tS.params_from_numpy(x["tree"], "cpu")
    out[f"{key}/edge_shards"] = np.array(tS.edge_mesh().world_size)
    loss_fn = lambda p, b: tS.train_loss(p, cfg, b)  # noqa: E731
    (loss, _), grads = tloop.value_and_grad(loss_fn, params, _tb(x["batch"]))
    out[f"{key}/loss"] = _sum_data(loss).numpy()
    for i, g in enumerate(ttree.leaves(grads)):
        out[f"{key}/grad/{i}"] = _sum_data(g).numpy()
    place = None
    if sharding.model_mesh() is not None:
        place = sharding.tree_shardings(tS.param_axes(cfg),
                                        ttree.tree_map(lambda t: tuple(t.shape), params))
    opt = topt.adamw(topt.AdamWConfig())
    step = tloop.make_train_step(loss_fn, opt, placements=place)
    p1, _, m = step(params, tloop.init_opt_state(opt, params), _tb(x["batch"]))
    tloop.assert_replicas_agree(p1, mesh, place)
    out[f"{key}/step_loss"] = m["loss"].numpy()
    for i, p in enumerate(ttree.leaves(p1)):
        out[f"{key}/param/{i}"] = p.numpy()
    c = cell_of(name)
    built = tcells.gnn_cell("schnet", tconfigs.get("schnet").reduced_config(), c, c.reduced, "cpu",
                            batch=x["batch"], params=tS.params_from_numpy(x["tree"], "cpu"),
                            mesh=mesh)
    _, _, m = built.fn(*built.args)
    out[f"{key}/cell_loss"] = m["loss"].numpy()


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
            with sharding.use_mesh(m):
                for cell, x in inputs.items():
                    _rank_cell(mname, m, cell, x, out)
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
def _reference(x) -> dict:
    rcfg = x["rcfg"]
    params = jax.tree_util.tree_map(jnp.asarray, x["tree"])
    batch = {k: jnp.asarray(v) for k, v in x["batch"].items()}
    loss_fn = lambda p, b: rS.train_loss(p, rcfg, b)  # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    opt = ropt.adamw(ropt.AdamWConfig())
    p1, _, m = jax.jit(rloop.make_train_step(loss_fn, opt))(
        params, rloop.init_opt_state(opt, params), batch)
    leaves = lambda t: [np.asarray(v) for v in jax.tree_util.tree_leaves(t)]  # noqa: E731
    return dict(loss=float(loss), grads=leaves(grads), step_loss=float(m["loss"]),
                params=leaves(p1))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"ranks": [each rank's record], "ref": {cell: ...}}; the reference
    runs while the ranks do."""
    tmp = str(tmp_path_factory.mktemp("schnet_mesh"))
    inputs = {name: inputs_of(name) for name in CELLS}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, inputs)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {name: _reference(x) for name, x in inputs.items()}
    finally:
        recs = _join(procs, tmp)
    return dict(ranks=recs, ref=ref)


def mesh_ranks(ranks, mesh):
    recs = ranks["ranks"]
    return {"1x2": recs[:2], "2x1": recs[2:], "2x2": recs}[mesh]


CASES = [(m, c) for m in MESHES for c in CELLS]


def close(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **TOL)


@pytest.mark.parametrize("mesh,cell", CASES)
def test_loss_and_every_gradient_over_split_edges_match_the_reference(ranks, mesh, cell):
    """Each rank's loss and gradients, summed over the data axis, are the
    whole graph's once (the edge all-reduce and the data sum do not count
    the node-space gradients twice)."""
    want = ranks["ref"][cell]
    for rec in mesh_ranks(ranks, mesh):
        assert int(rec[f"{mesh}/{cell}/edge_shards"]) == np.prod(MESHES[mesh])
        close(rec[f"{mesh}/{cell}/loss"], want["loss"], "loss")
        for i, g in enumerate(want["grads"]):
            close(rec[f"{mesh}/{cell}/grad/{i}"], g, f"gradient {i}")


@pytest.mark.parametrize("mesh,cell", CASES)
def test_one_adamw_step_and_the_cells_step_match_the_reference(ranks, mesh, cell):
    """One AdamW step's loss and weights (replicas bit-identical on the
    ranks), and the cell's own donating step's loss."""
    want = ranks["ref"][cell]
    for rec in mesh_ranks(ranks, mesh):
        close(rec[f"{mesh}/{cell}/step_loss"], want["step_loss"], "step loss")
        close(rec[f"{mesh}/{cell}/cell_loss"], want["loss"], "cell loss")
        for i, p in enumerate(want["params"]):
            close(rec[f"{mesh}/{cell}/param/{i}"], p, f"parameter {i}")
