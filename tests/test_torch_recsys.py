"""The port's recsys family (``repro_torch.models.recsys``, its configs,
``recsys_batches``, ``launch.train`` and ``launch.cells``) against the
reference (``repro.models.recsys``): xDeepFM, BST, BERT4Rec and
Wide&Deep at their reduced configs in f32, the reference's
``init_params(PRNGKey(0))`` tree carried across as numpy, the same
numpy-seeded batches.

Tolerances: logits, scores, losses and every gradient within rtol 1e-5 /
atol 1e-6 (f32: XLA and PyTorch sum products, softmaxes and segment sums
in another order); top-k positions identical; three ``launch.train``
steps' losses within 1e-5.  The card's case imports no JAX and skips
without CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.data import synthetic as rsyn
    from repro.launch import cells as rcells
    from repro.models import recsys as rR
    from repro.training import loop as rloop
    from repro.training import optimizer as ropt
except ImportError:
    jax = jnp = rconfigs = rsyn = rcells = rR = rloop = ropt = None

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import recsys as tR  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

ARCHS = ["xdeepfm", "bst", "bert4rec", "wide-deep"]
TOL = dict(rtol=1e-5, atol=1e-6)
B = 8
needs_ref = pytest.mark.skipif(jax is None, reason="needs the JAX reference")

_INIT = {}


def ref_tree(arch):
    """The reference's reduced ``init_params(PRNGKey(0))`` tree as numpy."""
    if arch not in _INIT:
        rcfg = rconfigs.get(arch).reduced_config()
        tree = jax.jit(rR.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg)
        _INIT[arch] = jax.tree_util.tree_map(np.asarray, tree)
    return _INIT[arch]


def cfgs(arch):
    return rconfigs.get(arch).reduced_config(), tconfigs.get(arch).reduced_config()


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def assert_trees_close(got, want, **tol):
    g, w = ttree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# configs, data
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_the_reference(arch):
    rmod, tmod = rconfigs.get(arch), tconfigs.get(arch)
    assert tmod.FAMILY == rmod.FAMILY == "recsys"
    for which in ("full_config", "reduced_config"):
        r, t = getattr(rmod, which)(), getattr(tmod, which)()
        for f in ("name", "interaction", "n_sparse", "embed_dim", "hash_size", "mlp", "n_dense",
                  "cin_layers", "seq_len", "n_blocks", "n_heads", "item_vocab", "mask_frac"):
            assert getattr(t, f) == getattr(r, f), (which, f)
        assert t.num_params() == r.num_params() and t._mlp_in() == r._mlp_in()
    assert [(c.name, c.kind, c.full, c.reduced, c.skip) for c in tmod.CELLS] == [
        (c.name, c.kind, c.full, c.reduced, c.skip) for c in rmod.CELLS]
    # the port's seeded tree has the reference's structure, shapes and dtypes
    mine = tR.numpy_params(tR.init_params(tmod.reduced_config(), torch.Generator().manual_seed(0)))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref_tree(arch))
    assert [(x.shape, x.dtype) for x in jax.tree_util.tree_leaves(mine)] == [
        (x.shape, x.dtype) for x in jax.tree_util.tree_leaves(ref_tree(arch))]
    assert tR.param_axes(tmod.full_config()) == rR.param_axes(rmod.full_config())


@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_batches_are_the_reference_draws(arch):
    rcfg, tcfg = cfgs(arch)
    r, t = rsyn.recsys_batches(rcfg, B, seed=3), tsyn.recsys_batches(tcfg, B, seed=3)
    for _ in range(3):
        want, got = next(r), next(t)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if tcfg.interaction == "bidir-seq":  # the [MASK] row is item_vocab
        masked = got["labels"] >= 0
        assert masked.any() and (got["seq_ids"][masked] == tcfg.item_vocab).all()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    rcfg, tcfg = cfgs(arch)
    tree = ref_tree(arch)
    b = next(rsyn.recsys_batches(rcfg, B, seed=1))
    (want, _), wgrads = jax.value_and_grad(
        lambda p: rR.train_loss(p, rcfg, jbatch(b)), has_aux=True)(jax.tree_util.tree_map(
            jnp.asarray, tree))
    (got, metrics), grads = tloop.value_and_grad(
        lambda p, bb: tR.train_loss(p, tcfg, bb), tR.params_from_numpy(tree, "cpu"), tbatch(b))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(metrics["loss"]) == float(got)
    assert all(g.dtype == torch.float32 and g.layout == torch.strided for g in ttree.leaves(grads))
    assert_trees_close(grads, wgrads, **TOL)


@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_served_scores_match_the_reference(arch):
    rcfg, tcfg = cfgs(arch)
    tree = ref_tree(arch)
    b = next(rsyn.recsys_batches(rcfg, 16, seed=2))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tR.params_from_numpy(tree, "cpu")
    np.testing.assert_allclose(tR.pointwise_logits(tp, tcfg, tbatch(b)).numpy(),
                               np.asarray(rR.pointwise_logits(params, rcfg, jbatch(b))), **TOL)
    np.testing.assert_allclose(tR.serve_scores(tp, tcfg, tbatch(b)).numpy(),
                               np.asarray(rR.serve_scores(params, rcfg, jbatch(b))), **TOL)
    if tcfg.interaction == "bidir-seq":  # the masked-position CE at a smaller cap
        labels = b["labels"]
        (want, _), (got, _) = (rR.train_loss(params, rcfg, jbatch(b), max_masked=2),
                               tR.train_loss(tp, tcfg, tbatch(b), max_masked=2))
        np.testing.assert_allclose(float(got), float(want), **TOL)
        assert (labels >= 0).sum(axis=1).max() > 2  # the cap drops masked slots


@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_top_k_matches_the_reference(arch):
    rcfg, tcfg = cfgs(arch)
    tree = ref_tree(arch)
    rng = np.random.default_rng(4)
    b = {k: v[:1] for k, v in next(rsyn.recsys_batches(rcfg, 2, seed=4)).items() if k != "labels"}
    cand = rng.integers(0, tcfg.item_vocab or tcfg.hash_size, 300).astype(np.int32)
    cand[100:110] = cand[5]  # repeated candidates tie: the lower position first
    b["candidate_ids"] = cand
    ws, wi = rR.retrieval_scores(jax.tree_util.tree_map(jnp.asarray, tree), rcfg, jbatch(b),
                                 top_k=20)
    gs, gi = tR.retrieval_scores(tR.params_from_numpy(tree, "cpu"), tcfg, tbatch(b), top_k=20)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


# --------------------------------------------------------------------------
# launch.train and the cells
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_three_steps_match_the_reference_step(arch, monkeypatch, tmp_path, capsys):
    """``launch.train --arch <id> --reduced --device cpu --steps 3`` on the
    reference's weights (``init_params`` handed the carried tree) against
    the reference's jitted step on its own batches: the losses within
    1e-5, the final checkpoint restored value for value."""
    rcfg, tcfg = cfgs(arch)
    tree = ref_tree(arch)
    monkeypatch.setattr(tR, "init_params", lambda cfg, gen: tR.params_from_numpy(tree, "cpu"))
    out = ttrain.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                      "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(tree))  # the reference's count
    assert lines[0] == f"arch={arch} params={n_ref:,} steps=3"
    opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(3e-4, 20, 3)))
    step = jax.jit(rloop.make_train_step(lambda p, bb: rR.train_loss(p, rcfg, bb), opt))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = rloop.init_opt_state(opt, params)
    it, want = rsyn.recsys_batches(rcfg, 8), []
    for _ in range(3):
        params, state, m = step(params, state, jbatch(next(it)))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5, atol=1e-5)
    assert_trees_close(out["state"]["params"], params, rtol=1e-4, atol=1e-6)
    restored, n = tckpt.restore(str(tmp_path), out["state"])
    assert n == 3
    for a, b in zip(ttree.leaves(restored), ttree.leaves(out["state"])):
        assert torch.equal(a, b)


@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_match_the_reference(arch, monkeypatch):
    """Every recsys cell in smoke mode: the same batches bit for bit, the
    same model FLOPs, and the port's callable on the reference's weights
    gives the reference's outputs (a train cell: one donating step)."""
    rcfg, tcfg = cfgs(arch)
    tree = ref_tree(arch)
    monkeypatch.setattr(rR, "init_params", lambda key, cfg: jax.tree_util.tree_map(
        jnp.asarray, tree))
    for cell in tconfigs.get(arch).CELLS:
        want = rcells.build_cell(arch, cell.name, mode="smoke")
        got = tcells.build_cell(arch, cell.name, device="cpu")
        assert (got.arch, got.cell, got.kind) == (want.arch, want.cell, want.kind)
        assert got.model_flops == want.model_flops, cell.name
        wb, gb = want.args[-1], got.args[-1]
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]), err_msg=k)
        tp = tR.params_from_numpy(tree, "cpu")
        if cell.kind == "train":
            _, _, wm = jax.jit(want.fn)(*want.args)
            _, _, gm = got.fn(tp, tloop.init_opt_state(tcells._default_optimizer(), tp), gb)
            np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]), **TOL)
        elif cell.kind == "serve":
            np.testing.assert_allclose(got.fn(tp, gb).numpy(), np.asarray(want.fn(*want.args)),
                                       **TOL)
        else:
            (ws, wi), (gs, gi) = want.fn(*want.args), got.fn(tp, gb)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


@needs_ref
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_of_the_full_cells_equal_the_reference(arch):
    rcfg, tcfg = rconfigs.get(arch).full_config(), tconfigs.get(arch).full_config()
    assert tcells.recsys_example_flops(tcfg) == rcells._recsys_example_flops(rcfg)
    for c in tconfigs.get(arch).CELLS:
        p = c.full
        if c.kind == "train":
            want = 3.0 * p["batch"] * rcells._recsys_example_flops(rcfg)
            if rcfg.interaction == "bidir-seq":
                m = max(int(2 * rcfg.mask_frac * rcfg.seq_len), 1)
                want = 3.0 * p["batch"] * (rcells._recsys_example_flops(rcfg)
                                          + 2 * m * (rcfg.item_vocab + 2) * rcfg.embed_dim)
        elif c.kind == "serve":
            want = p["batch"] * rcells._recsys_example_flops(rcfg)
        else:
            per = (2 * rcfg.embed_dim if rcfg.interaction == "bidir-seq"
                   else rcells._recsys_example_flops(rcfg))
            want = float(p["n_candidates"]) * per
        assert tcells.recsys_flops(tcfg, c.kind, p) == want, c.name


def test_embedding_bag_sums_and_means_by_bag():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([0, 5, 2, 2, 1])
    bags = torch.tensor([0, 0, 2, 2, 2])
    got = tR.embedding_bag(table, ids, bags, 4)
    want = torch.stack([table[0] + table[5], torch.zeros(2), 2 * table[2] + table[1],
                        torch.zeros(2)])
    assert torch.equal(got, want)
    mean = tR.embedding_bag(table, ids, bags, 4, weights=torch.full((5,), 2.0), mode="mean")
    assert torch.equal(mean, torch.stack([want[0], want[1], want[2] * 2 / 3, want[3]]))


@needs_ref
def test_the_recsys_family_refuses_a_data_mesh(monkeypatch):
    """The refusal of a data mesh is gone: under a mesh that splits the
    batch over two processes (each stood in for here by its rank and size)
    ``train_loss`` takes that process's rows of the global batch, and the
    two shares' losses and gradients sum to the reference's global ones
    (the BCE over the global batch's size; BERT4Rec's cross-entropy over
    the global batch's masked count).  ``tests/test_torch_recsys_mesh.py``
    runs real process groups."""
    import types

    for arch in ("wide-deep", "bert4rec"):
        rcfg, tcfg = cfgs(arch)
        tree = ref_tree(arch)
        b = next(rsyn.recsys_batches(rcfg, B, seed=1))
        (want, _), wgrads = jax.jit(jax.value_and_grad(
            lambda p, bb: rR.train_loss(p, rcfg, bb), has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, tree), jbatch(b))
        shares = []
        for rank in range(2):
            monkeypatch.setattr(tR.sharding, "data_mesh",
                                lambda r=rank: types.SimpleNamespace(rank=r, world_size=2))
            shares.append(tloop.value_and_grad(lambda p, bb: tR.train_loss(p, tcfg, bb),
                                               tR.params_from_numpy(tree, "cpu"), tbatch(b)))
        monkeypatch.undo()
        (l0, _), g0 = shares[0]
        (l1, _), g1 = shares[1]
        assert float(l0) != float(l1), arch  # two different halves of the batch
        np.testing.assert_allclose(float(l0 + l1), float(want), **TOL)
        assert_trees_close(ttree.tree_map(torch.add, g0, g1), wgrads, **TOL)


# --------------------------------------------------------------------------
# on the card: a reduced step equals the host's
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_step_on_the_card_equals_the_host(arch):
    """One AdamW step (2 microbatches, f32) of the reduced config on the
    card and on the host from the same weights and batch: the losses rtol
    1e-5, the parameters rtol 1e-4 / atol 1e-6 (the card's segment sums and
    gathers' backward add with atomics, in no fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a step on the card with the host's")
    cfg = tconfigs.get(arch).reduced_config()
    tree = tR.numpy_params(tR.init_params(cfg, torch.Generator().manual_seed(0)))
    b = next(tsyn.recsys_batches(cfg, 16, seed=1))
    out = {}
    for dev in ("cpu", "cuda"):
        opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, 10)))
        params = tR.params_from_numpy(tree, dev)
        step = tloop.make_train_step(lambda p, bb: tR.train_loss(p, cfg, bb), opt, n_micro=2)
        p, _, m = step(params, tloop.init_opt_state(opt, params), tbatch(b, dev))
        out[dev] = (float(m["loss"]), ttree.leaves(ttree.to_numpy(p)))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def _card_rank(rank, tmp, arch, tree, batch):
    """One of two gloo ranks sharing ``cuda:0`` on a 1 x 2 mesh: one AdamW
    step of the reduced config from ``tree``, the weights gathered whole."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as tmesh

    tmesh.init_distributed(f"file://{tmp}/rendezvous", 2, rank, backend="gloo")
    try:
        torch.cuda.set_device(0)
        cfg = tconfigs.get(arch).reduced_config()
        mesh = tmesh.make_production_mesh(device="cuda", model=2)
        with sharding.use_mesh(mesh):
            params, place = tR.place_params(tR.params_from_numpy(tree, "cuda"), cfg)
            opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, 10)))
            step = tloop.make_train_step(lambda p, bb: tR.train_loss(p, cfg, bb), opt, n_micro=2,
                                         placements=place)
            p, _, m = step(params, tloop.init_opt_state(opt, params), tbatch(batch, "cuda"))
            whole = ttree.leaves(ttree.to_numpy(sharding.gather_tree(p, place)))
        np.savez(f"{tmp}/rank{rank}.npz", np.array(float(m["loss"])), *whole)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_two_ranks_on_the_card_equal_the_host(tmp_path):
    """BERT4Rec's reduced config (its 202 items split in two) over two gloo
    ranks sharing the card (NCCL refuses two ranks on one card) against one
    process on the host, from the same weights and batch: the losses rtol
    1e-5, the gathered weights after one AdamW step rtol 1e-4 / atol
    1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs two ranks on the card against the host")
    import torch.multiprocessing as mp

    arch = "bert4rec"
    cfg = tconfigs.get(arch).reduced_config()
    tree = tR.numpy_params(tR.init_params(cfg, torch.Generator().manual_seed(0)))
    b = next(tsyn.recsys_batches(cfg, 16, seed=1))
    procs = [mp.get_context("spawn").Process(target=_card_rank, args=(r, str(tmp_path), arch, tree, b))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(1e-3, 2, 10)))
        params = tR.params_from_numpy(tree, "cpu")
        step = tloop.make_train_step(lambda p, bb: tR.train_loss(p, cfg, bb), opt, n_micro=2)
        host, _, m = step(params, tloop.init_opt_state(opt, params), tbatch(b))
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
