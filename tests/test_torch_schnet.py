"""The port's SchNet (``repro_torch.models.schnet``), its config and cells,
and the graph generators (``repro_torch.data.graphs``) against the
reference (``repro.models.schnet``, ``repro.data.graphs``): both regimes
at the reduced config in f32 on the reference's ``init_params(PRNGKey(0))``
tree carried across as numpy.

Tolerances: outputs, losses and every gradient within rtol 1e-5 / atol
1e-6 (XLA's ``segment_sum`` and PyTorch's ``index_add`` add in another
order); the generators' arrays identical.  The card's case imports no JAX
and skips without CUDA.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.data import graphs as rgraphs
    from repro.launch import cells as rcells
    from repro.models import schnet as rS
except ImportError:
    jax = jnp = rconfigs = rgraphs = rcells = rS = None

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import graphs as tgraphs  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import schnet as tS  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
needs_ref = pytest.mark.skipif(jax is None, reason="needs the JAX reference")
CELLS = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def cell_of(name):
    return tconfigs.cells_of("schnet")[name]


def ref_tree(rcfg):
    tree = jax.jit(rS.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg)
    return jax.tree_util.tree_map(np.asarray, tree)


def regimes():
    """(reference config, port config, numpy batch) of each cell's reduced
    shape, from the port's cell batches."""
    rbase = rconfigs.get("schnet").reduced_config()
    tbase = tconfigs.get("schnet").reduced_config()
    out = {}
    for name in ("molecule", "full_graph_sm", "minibatch_lg"):
        c = cell_of(name)
        tcfg, _, _ = tcells.gnn_shape(tbase, c.kind, c.reduced)
        rcfg = dataclasses.replace(rbase, d_feat=tcfg.d_feat, n_classes=tcfg.n_classes)
        out[name] = (rcfg, tcfg, tcells.gnn_batch(c.kind, c.reduced))
    return out


# --------------------------------------------------------------------------
# configs, data
# --------------------------------------------------------------------------
@needs_ref
def test_config_cells_axes_and_param_counts_equal_the_reference():
    rmod, tmod = rconfigs.get("schnet"), tconfigs.get("schnet")
    assert tmod.FAMILY == rmod.FAMILY == "gnn"
    for which in ("full_config", "reduced_config"):
        r, t = getattr(rmod, which)(), getattr(tmod, which)()
        for f in ("name", "n_interactions", "d_hidden", "n_rbf", "cutoff", "max_z", "d_feat",
                  "n_classes"):
            assert getattr(t, f) == getattr(r, f), (which, f)
        assert t.num_params() == r.num_params()
    assert [(c.name, c.kind, c.full, c.reduced, c.skip) for c in tmod.CELLS] == [
        (c.name, c.kind, c.full, c.reduced, c.skip) for c in rmod.CELLS]
    for rcfg, tcfg, _ in regimes().values():
        assert tS.param_axes(tcfg) == rS.param_axes(rcfg)
        mine = tS.numpy_params(tS.init_params(tcfg, torch.Generator().manual_seed(0)))
        want = ref_tree(rcfg)
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
        assert [(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(mine)] == [
            (x.shape, x.dtype) for x in jax.tree_util.tree_leaves(want)]


@needs_ref
@pytest.mark.parametrize("power_law", [True, False])
def test_graph_generators_are_the_reference_draws(power_law):
    want = rgraphs.random_graph(300, 2000, 7, 5, seed=3, power_law=power_law)
    got = tgraphs.random_graph(300, 2000, 7, 5, seed=3, power_law=power_law)
    for f in ("edge_src", "edge_dst", "feat", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype
    for a, b in zip(got.csr(), want.csr()):
        np.testing.assert_array_equal(a, b)
    bare = tgraphs.random_graph(50, 100, seed=1)
    assert bare.feat is None and bare.labels is None
    seeds = np.arange(0, 40, 3)
    wb = rgraphs.neighbor_sample(want, seeds, (5, 3), seed=2)
    gb = tgraphs.neighbor_sample(got, seeds, (5, 3), seed=2)
    assert sorted(gb) == sorted(wb)
    for k in wb:
        np.testing.assert_array_equal(np.asarray(gb[k]), np.asarray(wb[k]), err_msg=k)
    wm, gm = rgraphs.molecule_batch(3, 7, 11, seed=4), tgraphs.molecule_batch(3, 7, 11, seed=4)
    for k in wm:
        assert gm[k].dtype == wm[k].dtype
        np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)


@needs_ref
def test_radial_basis_and_softplus_follow_the_reference():
    for n, c in ((300, 10.0), (20, 10.0)):  # the full and reduced configs'
        np.testing.assert_array_equal(tS.rbf_centers(n, c).numpy(),
                                      np.asarray(jnp.linspace(0.0, c, n)))
    d = np.array([0.0, 0.3, 2.5, 9.9, 14.0], np.float32)
    np.testing.assert_allclose(tS.rbf_expand(torch.from_numpy(d), 300, 10.0).numpy(),
                               np.asarray(rS.rbf_expand(jnp.asarray(d), 300, 10.0)), **TOL)
    # above 20 F.softplus returns x; the reference's softplus does not
    x = np.array([-30.0, -2.0, 0.0, 1.5, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(tS.shifted_softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(rS.shifted_softplus(jnp.asarray(x))), rtol=1e-6)
    t = torch.from_numpy(x).requires_grad_(True)
    tS.shifted_softplus(t).sum().backward()
    want = jax.grad(lambda v: rS.shifted_softplus(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert float(t.grad[2]) == 0.5  # at 0: sigmoid(0), as jax.nn.softplus's


# --------------------------------------------------------------------------
# the model in both regimes
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("cell", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_forward_loss_and_every_gradient_match_the_reference(cell):
    rcfg, tcfg, b = regimes()[cell]
    tree = ref_tree(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tp = tS.params_from_numpy(tree, "cpu")
    np.testing.assert_allclose(tS.forward(tp, tcfg, tb).numpy(),
                               np.asarray(rS.forward(params, rcfg, jb)), **TOL)
    (want, _), wgrads = jax.value_and_grad(lambda p: rS.train_loss(p, rcfg, jb),
                                           has_aux=True)(params)
    (got, _), grads = tloop.value_and_grad(lambda p, bb: tS.train_loss(p, tcfg, bb), tp, tb)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    g, w = ttree.leaves(grads), jax.tree_util.tree_leaves(wgrads)
    assert len(g) == len(w)
    for a, bb in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL)


@needs_ref
def test_smoke_cells_match_the_reference(monkeypatch):
    """Every SchNet cell in smoke mode: the batches bit for bit, the model
    FLOPs, and one donating step's loss on the reference's weights."""
    seen = []
    real_init = rS.init_params

    def init(key, cfg):  # the reference's tree, jitted; its config noted
        seen.append(cfg)
        return jax.jit(real_init, static_argnums=1)(key, cfg)

    monkeypatch.setattr(rS, "init_params", init)
    for name in CELLS:
        want = rcells.build_cell("schnet", name, mode="smoke")
        got = tcells.build_cell("schnet", name, device="cpu")
        assert (got.cell, got.kind) == (want.cell, want.kind)
        assert got.model_flops == want.model_flops, name
        wb, gb = want.args[2], got.args[2]
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]), err_msg=k)
        tp = tS.params_from_numpy(jax.tree_util.tree_map(np.asarray, want.args[0]), "cpu")
        assert [x.shape for x in ttree.leaves(tp)] == [x.shape for x in ttree.leaves(got.args[0])]
        _, _, gm = got.fn(tp, tloop.init_opt_state(tcells._default_optimizer(), tp), gb)
        _, _, wm = jax.jit(want.fn)(*want.args)
        np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), **TOL)
    assert [c.d_feat for c in seen] == [33, 33, 25, 0]


@needs_ref
def test_model_flops_of_the_full_cells_equal_the_reference():
    base_r, base_t = rconfigs.get("schnet").full_config(), tconfigs.get("schnet").full_config()
    for c in tconfigs.get("schnet").CELLS:
        tcfg, N, E = tcells.gnn_shape(base_t, c.kind, c.full)
        rcfg = dataclasses.replace(base_r, d_feat=tcfg.d_feat, n_classes=tcfg.n_classes)
        for train in (True, False):
            assert tcells.schnet_flops(tcfg, N, E, train) == rcells._schnet_flops(
                rcfg, N, E, train), c.name


def _edge_rank(rank, tmp, tree, batch):
    """One of two gloo ranks of a 2 x 1 mesh: SchNet's forward and loss with
    the edges split in two, written to ``{tmp}/rank{rank}.npz``."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo")
    try:
        cfg = tconfigs.get("schnet").reduced_config()
        mesh = tmesh.make_production_mesh(device="cpu")
        params = tS.params_from_numpy(tree, "cpu")
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        with tsharding.use_mesh(mesh):
            out = tS.forward(params, cfg, b)
            loss, _ = tS.train_loss(params, cfg, b)
            shards = tS.edge_mesh().world_size
        np.savez(f"{tmp}/rank{rank}.npz", out=out.numpy(), loss=loss.numpy(), shards=shards)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@needs_ref
def test_an_edge_split_over_a_mesh_is_refused_naming_the_roadmap(tmp_path):
    """The refusal of an edge split is gone: on a 2 x 1 mesh of two gloo
    ranks (``"edges"`` over both) the forward over 21 edges, split 11 + 10
    and padded, equals the reference's, and each rank's loss is half the
    reference's (its share: the data axis sums the two).  One edge shard
    (no mesh) takes the single-device path."""
    import torch.multiprocessing as mp

    rcfg = rconfigs.get("schnet").reduced_config()
    cfg = tconfigs.get("schnet").reduced_config()
    tree = ref_tree(rcfg)
    batch = tgraphs.molecule_batch(3, 5, 7, seed=2)
    procs = [mp.get_context("spawn").Process(target=_edge_rank, args=(r, str(tmp_path), tree, batch))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        want_out = np.asarray(rS.forward(params, rcfg, jb))
        want_loss = float(rS.train_loss(params, rcfg, jb)[0])
    finally:
        for p in procs:
            p.join(240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    assert not alive and [p.exitcode for p in procs] == [0, 0], [p.exitcode for p in procs]
    for r in range(2):
        rec = np.load(tmp_path / f"rank{r}.npz")
        assert int(rec["shards"]) == 2
        np.testing.assert_allclose(rec["out"], want_out, **TOL)
        np.testing.assert_allclose(float(rec["loss"]), want_loss / 2, **TOL)
    assert tS.edge_mesh() is None
    with tsharding.use_mesh(types.SimpleNamespace(shape={"data": 1, "model": 1},
                                                  axis_names=("data", "model"))):
        assert tS.edge_mesh() is None  # one edge shard: the single-device path
        params = tS.init_params(cfg, torch.Generator().manual_seed(0))
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        assert torch.isfinite(tS.forward(params, cfg, b)).all()


def test_launch_train_sends_schnet_to_its_cells_as_the_reference_does():
    with pytest.raises(ValueError, match="use examples/ for family gnn"):
        ttrain.run(["--arch", "schnet", "--reduced", "--device", "cpu", "--steps", "1"])


# --------------------------------------------------------------------------
# on the card: a reduced step equals the host's
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_reduced_step_on_the_card_equals_the_host(cell):
    """One AdamW step of each regime's reduced cell on the card and on the
    host from the same weights and batch: the losses rtol 1e-5, the
    parameters rtol 1e-4 / atol 1e-6 (``index_add`` on the card sums with
    atomics in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a step on the card with the host's")
    c = cell_of(cell)
    cfg, _, _ = tcells.gnn_shape(tconfigs.get("schnet").reduced_config(), c.kind, c.reduced)
    tree = tS.numpy_params(tS.init_params(cfg, torch.Generator().manual_seed(0)))
    b = tcells.gnn_batch(c.kind, c.reduced)
    out = {}
    for dev in ("cpu", "cuda"):
        opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, 10)))
        params = tS.params_from_numpy(tree, dev)
        step = tloop.make_train_step(lambda p, bb: tS.train_loss(p, cfg, bb), opt)
        p, _, m = step(params, tloop.init_opt_state(opt, params),
                       {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        out[dev] = (float(m["loss"]), ttree.leaves(ttree.to_numpy(p)))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def _card_rank(rank, tmp, tree, batch):
    """One of two gloo ranks sharing ``cuda:0`` on a 1 x 2 mesh: the
    molecule cell's donating step (``gnn_cell(mesh=)``), the edges split."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    tmesh.init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo")
    try:
        torch.cuda.set_device(0)
        c = cell_of("molecule")
        mesh = tmesh.make_production_mesh(device="cuda", model=2)
        built = tcells.gnn_cell("schnet", tconfigs.get("schnet").reduced_config(), c, c.reduced,
                                "cuda", batch=batch, params=tS.params_from_numpy(tree, "cuda"),
                                mesh=mesh)
        params, _, m = built.fn(*built.args)
        np.savez(f"{tmp}/rank{rank}.npz", np.array(float(m["loss"])),
                 *ttree.leaves(ttree.to_numpy(params)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_the_molecule_cell_over_two_ranks_on_the_card_equals_the_host(tmp_path):
    """The ``molecule`` cell's step with its edges split over two gloo ranks
    sharing the card against the same cell in one process on the host,
    from the same weights and batch: the losses rtol 1e-5, the weights
    after the step rtol 1e-4 / atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs two ranks on the card against the host")
    import torch.multiprocessing as mp

    c = cell_of("molecule")
    base = tconfigs.get("schnet").reduced_config()
    tree = tS.numpy_params(tS.init_params(base, torch.Generator().manual_seed(0)))
    b = tcells.gnn_batch(c.kind, c.reduced)
    procs = [mp.get_context("spawn").Process(target=_card_rank, args=(r, str(tmp_path), tree, b))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        built = tcells.gnn_cell("schnet", base, c, c.reduced, "cpu", batch=b,
                                params=tS.params_from_numpy(tree, "cpu"))
        host, _, m = built.fn(*built.args)
    finally:
        for p in procs:
            p.join(240)
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert [p.exitcode for p in procs] == [0, 0], [p.exitcode for p in procs]
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
        np.testing.assert_allclose(float(got[0]), float(m["loss"]), rtol=1e-5)
        for g, w in zip(got[1:], ttree.leaves(ttree.to_numpy(host)), strict=True):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
