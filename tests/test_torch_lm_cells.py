"""The port's cell builder (``repro_torch.launch.cells``) against the
reference's (``repro.launch.cells``) in smoke mode: every prefill and
decode cell of the five LM archs, at the reduced configs, run on the
reference's weights carried across as numpy, outputs within rtol = atol =
1e-5 (f32: the frameworks sum in another order), the same model FLOPs.

The reference's ``build_cell`` draws its weights with the eager
``init_params`` (~10 s an arch here); the tests hand it the same function
jitted and memoized per config, so each arch's tree is drawn once.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.launch import cells as rcells  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

LM_ARCHS = ["h2o-danube-3-4b", "yi-34b", "granite-34b", "granite-moe-1b-a400m",
            "deepseek-moe-16b"]
SERVE_CELLS = [(a, c.name) for a in LM_ARCHS for c in tconfigs.get(a).CELLS
               if c.kind in ("prefill", "decode")]


_REF_INIT = rT.init_params


@functools.lru_cache(maxsize=None)
def _jitted_init(cfg):
    return jax.jit(_REF_INIT, static_argnums=1)(jax.random.PRNGKey(0), cfg)


@pytest.fixture
def ref_init(monkeypatch):
    """The reference's ``init_params`` for PRNGKey(0), jitted and memoized."""
    key0 = jax.random.PRNGKey(0)

    def init(key, cfg):
        assert bool((key == key0).all())
        return _jitted_init(cfg)

    monkeypatch.setattr(rT, "init_params", init)


@pytest.mark.parametrize("arch,cell", SERVE_CELLS, ids=[f"{a}-{c}" for a, c in SERVE_CELLS])
def test_smoke_cell_matches_reference(ref_init, arch, cell):
    want_cell = rcells.build_cell(arch, cell, mode="smoke")
    got_cell = tcells.build_cell(arch, cell, mode="smoke", device="cpu")
    assert (got_cell.arch, got_cell.cell, got_cell.kind) == (want_cell.arch, want_cell.cell,
                                                            want_cell.kind)
    assert got_cell.model_flops == want_cell.model_flops
    params = want_cell.args[0]
    model = tT.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 got_cell.args[0].cfg, device="cpu")
    for got_a, want_a in zip(got_cell.args[1:], want_cell.args[1:]):  # tokens, cache, n
        got_np = got_a if isinstance(got_a, int) else (
            {k: v.numpy() for k, v in got_a.items()} if isinstance(got_a, dict) else got_a.numpy())
        jax.tree_util.tree_map(np.testing.assert_array_equal, got_np,
                               jax.tree_util.tree_map(np.asarray, want_a))
    want = jax.jit(want_cell.fn)(params, *want_cell.args[1:])
    got = got_cell.fn(model, *got_cell.args[1:])
    if want_cell.kind == "prefill":
        want, got = (want,), (got,)
    else:  # (logits, cache)
        got = (got[0], {k: v.numpy() for k, v in got[1].items()})
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert all(np.isfinite(np.asarray(w)).all() for w in jax.tree_util.tree_leaves(want))


def test_cells_the_port_lacks_raise_naming_the_roadmap():
    # dry mode and the retrieval family's cells build now (ROADMAP Queue 1
    # item 8.5.1): rank 0's piece of a 16 x 16 mesh on meta, and the encoder
    with tsharding.use_mesh(tmesh.make_dry_mesh(), dict(tsharding.SERVE_RULES)):
        dry = tcells.build_cell("yi-34b", "prefill_32k", mode="dry")
        assert dry.args[1].shape == (2, 32768) and dry.args[1].device.type == "meta"
        assert dry.plan["params/embed"] == ((4000, 7168), torch.bfloat16)
        # the encoder on a model mesh (ROADMAP Queue 1 item 8.5.5): rank 0's
        # piece of the batch and of each weight, on meta
        enc = tcells.build_cell("plaid-colbertv2", "encode_corpus", mode="dry")
        assert enc.args[1].shape == (256, 180) and enc.args[1].device.type == "meta"
        wq = enc.args[0].backbone.layers[0].attn_wq
        assert wq.device.type == "meta" and wq.shape == (768, 3, 64) and wq.dtype == torch.bfloat16
        assert enc.args[0].proj.shape == (768, 128)
    enc = tcells.build_cell("plaid-colbertv2", "encode_corpus", device="cpu")
    assert enc.kind == "encode" and enc.fn(*enc.args).shape == (8, 16, 16)
    # the recsys and GNN cells are ported (ROADMAP Queue 1 item 9)
    served = tcells.build_cell("xdeepfm", "serve_p99", device="cpu")
    assert served.kind == "serve" and served.fn(*served.args).shape == (16,)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_of_the_full_cells_equal_the_reference(arch):
    rcfg, tcfg = rconfigs.get(arch).full_config(), tconfigs.get(arch).full_config()
    for c in tconfigs.get(arch).CELLS:
        S, B = c.full["seq_len"], c.full["global_batch"]
        if c.kind == "train":
            s_eff = min(S, rcfg.window) if rcfg.window else S
            want = 6.0 * rcfg.active_params() * B * S + 3 * rcells._lm_attn_flops(
                rcfg, B, S, s_eff / 2)
        elif c.kind == "prefill":
            s_eff = min(S, rcfg.window) if rcfg.window else S
            want = 2.0 * rcfg.active_params() * B * S + rcells._lm_attn_flops(rcfg, B, S, s_eff / 2)
        else:
            Sc = rT.cache_seq_len(rcfg, S)
            want = 2.0 * rcfg.active_params() * B + rcfg.n_layers * 4.0 * B * Sc * (
                rcfg.n_heads * rcfg.d_head)
        assert tcells.lm_model_flops(tcfg, c.kind, S, B) == want, c.name
        assert tT.cache_seq_len(tcfg, S) == rT.cache_seq_len(rcfg, S)
