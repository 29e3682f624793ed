"""The retrieval family's cells of the port (``repro_torch.launch.cells``)
against the reference's (``repro.launch.cells``) in smoke mode, and every
arch's cell list and the retrieval cells' model FLOPs.

The reduced cells run on the reference's weights, training state and
index carried across as numpy (the two packages draw different random
weights and their k-means different samples): ``train_triples``' loss and
updated parameters (atol 1e-7) and ``encode_corpus``' embeddings (atol
1e-6) at rtol 1e-5 (f32: the frameworks sum in another order), the search
cells' pids identical and scores at rtol 1e-5 (atol 1e-6) on a one-device
mesh.  The batches, tokens,
corpora and queries are the same numpy draws, checked bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import cells as rcells  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

ARCH = "plaid-colbertv2"
RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cells_of_every_arch_equal_the_reference(arch):
    got, want = tconfigs.cells_of(arch), rconfigs.cells_of(arch)
    assert list(got) == list(want)
    for name, c in got.items():
        w = want[name]
        assert (c.name, c.kind, c.full, c.reduced, c.skip) == (w.name, w.kind, w.full, w.reduced,
                                                              w.skip), name


@pytest.mark.parametrize("cell", ["train_triples", "encode_corpus", "search_9m", "search_140m"])
def test_model_flops_of_the_full_cells_equal_the_reference(cell):
    rcfg, tcfg = rconfigs.get(ARCH).full_config(), tconfigs.get(ARCH).full_config()
    c = tconfigs.cells_of(ARCH)[cell]
    p = c.full
    if c.kind == "train":
        tokens = p["global_batch"] * (p["q_len"] + p["nway"] * p["d_len"])
        want = 3.0 * rcells._colbert_fwd_flops(dataclasses.replace(rcfg, nway=p["nway"]), tokens)
    elif c.kind == "encode":
        want = rcells._colbert_fwd_flops(rcfg, p["batch"] * p["d_len"])
    else:
        for ns in (1, 256, 512):
            assert tcells.retrieval_flops(tcfg, "search", p, ns) == rcells._plaid_search_flops(p, ns)
        want = rcells._plaid_search_flops(p, 1)
    assert tcells.retrieval_flops(tcfg, c.kind, p) == want


def test_train_triples_matches_the_reference():
    want_cell = rcells.build_cell(ARCH, "train_triples", mode="smoke")
    got_cell = tcells.build_cell(ARCH, "train_triples", mode="smoke", device="cpu")
    assert got_cell.model_flops == want_cell.model_flops
    params, opt, batch = want_cell.args
    for k, v in batch.items():  # colbert_batches: the same draws
        np.testing.assert_array_equal(got_cell.args[2][k].numpy(), np.asarray(v), err_msg=k)
    ccfg = dataclasses.replace(tconfigs.get(ARCH).reduced_config(), nway=2)
    _, state = tcol.train_state_from_numpy({"params": _np(params), "opt": _np(opt)}, ccfg, "cpu")
    want_p, want_opt, want_m = jax.jit(want_cell.fn)(params, opt, batch)
    got_p, got_opt, got_m = got_cell.fn(state["params"], state["opt"], got_cell.args[2])
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=RTOL)
    got_np = ttree.to_numpy({"params": got_p, "opt": {k: got_opt[k] for k in ("mu", "nu")}})
    want_np = _np({"params": want_p, "opt": {k: want_opt[k] for k in ("mu", "nu")}})
    leaves = jax.tree_util.tree_leaves_with_path(want_np)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got_np))
    for path, w in leaves:
        g = got_np
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7, err_msg=jax.tree_util.keystr(path))
    assert int(got_opt["step"]) == int(want_opt["step"]) == 1


def test_encode_corpus_matches_the_reference():
    want_cell = rcells.build_cell(ARCH, "encode_corpus", mode="smoke")
    got_cell = tcells.build_cell(ARCH, "encode_corpus", mode="smoke", device="cpu")
    assert got_cell.model_flops == want_cell.model_flops
    params, tokens = want_cell.args
    np.testing.assert_array_equal(got_cell.args[1].numpy(), np.asarray(tokens))
    model = got_cell.args[0]
    tcol.assign_params(model, ttree.from_numpy(_np(params), tcol.train_params(model)))
    assert model.cfg.backbone.attn_impl == "flash"  # K7's plain version on the host
    want = np.asarray(jax.jit(want_cell.fn)(params, tokens))
    got = got_cell.fn(model, got_cell.args[1]).numpy()
    assert got.shape == want.shape == (8, 16, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("cell", ["search_9m", "search_140m"])
def test_search_cells_match_the_reference(cell):
    want_cell = rcells.build_cell(ARCH, cell, mode="smoke", mesh=make_local_mesh())
    idx, qs, masks = want_cell.args
    port_idx = tindex.index_from_numpy(
        {f: np.asarray(getattr(idx, f)) for f in tindex.ARRAY_FIELDS},
        {f: getattr(idx, f) for f in tindex.STATIC_FIELDS if hasattr(idx, f)}, device="cpu")
    c = tconfigs.cells_of(ARCH)[cell]
    packed, lens, port_qs = tcells.search_corpus(c.reduced)
    np.testing.assert_array_equal(lens, np.asarray(idx.doc_lens))
    got_cell = tcells.retrieval_cell(ARCH, tconfigs.get(ARCH).reduced_config(), c, c.reduced,
                                     "cpu", index=(port_idx, port_qs))
    assert got_cell.model_flops == want_cell.model_flops
    np.testing.assert_array_equal(got_cell.args[1].numpy(), np.asarray(qs))
    np.testing.assert_array_equal(got_cell.args[2].numpy(), np.asarray(masks))
    ws, wp = want_cell.fn(*want_cell.args)
    gs, gp = got_cell.fn(*got_cell.args)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL, atol=1e-6)
    assert gp.shape == (c.reduced["n_queries"], c.reduced["k"]) and bool((gp >= 0).all())


def test_search_cell_builds_its_index_as_the_reference_does():
    """The port's own smoke index: the reference's corpus (embedding_corpus
    seed 0, 4..avg_doclen tokens) through build_index at the cell's K and
    nbits; its search runs impl="ref" on the host."""
    c = tconfigs.cells_of(ARCH)["search_140m"]
    built = tcells.build_cell(ARCH, "search_140m", device="cpu")
    index = built.args[0]
    p = c.reduced
    assert index["centroids"].shape == (p["n_centroids"], 128)
    assert index["residuals"].shape[1] == 128 * p["nbits"] // 8
    assert index["doc_lens"].shape == (p["docs_per_shard"],)
    scores, pids = built.fn(*built.args)
    assert pids.shape == (p["n_queries"], p["k"]) and bool(torch.isfinite(scores).all())
