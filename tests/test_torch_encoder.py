"""The port's ColBERT encoder against the reference (``repro.models.layers``,
``transformer``, ``colbert``, ``configs.colbertv2``): the same weights,
carried across as numpy, and the same seeded inputs.

Tolerances, with their reasons:

* f32 layers and f32 models: atol = rtol = 2e-5.  The same operations in
  the same order per element, but XLA and PyTorch sum matmuls and means in
  another order; through two layers that moves the last few f32 bits.
* bf16 layers: one bf16 ulp (rtol 2^-7) plus 1e-6: both frameworks round
  an f32 (or f32-accumulated) result to bf16 once.
* the full-width bf16 encoder: per-token cosine >= 0.999 and max abs
  <= 2e-2 on the unit vectors, because bf16 products and sums round at
  different places in the two frameworks and the differences pass through
  a whole layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.models import layers as rL  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)
BACKBONE_FIELDS = [f.name for f in dataclasses.fields(tT.TransformerConfig)]


def port_backbone(rcfg, **over):
    """The port's config for a reference ``TransformerConfig``."""
    kw = {f: getattr(rcfg, f) for f in BACKBONE_FIELDS if f != "dtype"}
    kw["dtype"] = getattr(torch, jnp.dtype(rcfg.dtype).name)
    kw.update(over)
    return tT.TransformerConfig(**kw)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def backbone_tree(rcfg, rng):
    """The reference's ``transformer.init_params`` tree, drawn with numpy:
    its shapes, scales and zero padding (lm_head included)."""
    d, dh, hkv, nl = rcfg.d_model, rcfg.d_head, rcfg.n_kv_heads, rcfg.n_layers
    g, gp, hp, dff = rcfg.n_heads // hkv, rcfg.group_pad, rcfg.padded_heads, rcfg.d_ff
    scale = (2.0 / (d + rcfg.n_heads * dh)) ** 0.5
    fscale = (2.0 / (d + dff)) ** 0.5

    def normal(shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    wq = np.zeros((nl, d, hkv, gp, dh), np.float32)
    wq[:, :, :, :g] = normal((nl, d, hkv, g, dh), scale)
    wo = np.zeros((nl, hkv, gp, dh, d), np.float32)
    wo[:, :, :g] = normal((nl, hkv, g, dh, d), scale)
    embed = np.zeros((rcfg.padded_vocab, d), np.float32)
    embed[: rcfg.vocab] = normal((rcfg.vocab, d), 0.02)
    return {
        "embed": embed,
        "final_norm": {"g": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)},
        "lm_head": normal((d, rcfg.padded_vocab), 0.02),
        "dense_layers": {
            "attn": {"wq": wq.reshape(nl, d, hp, dh), "wk": normal((nl, d, hkv, dh), scale),
                     "wv": normal((nl, d, hkv, dh), scale), "wo": wo.reshape(nl, hp, dh, d)},
            "ln1": {"g": (1 + 0.1 * rng.standard_normal((nl, d))).astype(np.float32)},
            "ln2": {"g": (1 + 0.1 * rng.standard_normal((nl, d))).astype(np.float32)},
            "ffn": {k: {"w": normal(shape, fscale)} for k, shape in
                    (("wi", (nl, d, dff)), ("wg", (nl, d, dff)), ("wo", (nl, dff, d)))},
        },
    }


def colbert_tree(rcfg, seed):
    rng = np.random.default_rng(seed)
    d, out = rcfg.backbone.d_model, rcfg.out_dim
    return {"backbone": backbone_tree(rcfg.backbone, rng),
            "proj": (rng.standard_normal((d, out)) * (2.0 / (d + out)) ** 0.5).astype(np.float32)}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("which", ["full_config", "reduced_config"])
def test_configs_match_reference(which):
    ref, port = getattr(rcfgs, which)(), getattr(tcfgs, which)()
    assert port.out_dim == ref.out_dim
    assert port.backbone == port_backbone(ref.backbone)
    for prop in ("d_head", "group_pad", "padded_heads", "padded_vocab"):
        assert getattr(port.backbone, prop) == getattr(ref.backbone, prop), prop


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.2).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    wi, wg = ((rng.standard_normal((48, 64)) * 0.2).astype(np.float32) for _ in range(2))
    wo = (rng.standard_normal((64, 48)) * 0.2).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)

    got = tL.dense(torch.from_numpy(w), xt, tdt)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(rL.dense({"w": jnp.asarray(w)}, xj, jdt)), **tol)

    got = tL.rmsnorm(torch.from_numpy(g), xt)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(rL.rmsnorm({"g": jnp.asarray(g)}, xj)), **tol)

    got = tL.swiglu(*(torch.from_numpy(a) for a in (wi, wg, wo)), xt, tdt)
    want = rL.swiglu({"wi": {"w": jnp.asarray(wi)}, "wg": {"w": jnp.asarray(wg)},
                      "wo": {"w": jnp.asarray(wo)}}, xj, jdt)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    else:
        # XLA rounds silu's sigmoid to bf16 before its product, PyTorch does
        # not, so hidden units differ by up to one bf16 ulp (2^-7 relative);
        # the last product sums 64 of them: bound each output by one ulp of
        # every summand plus one ulp of the result
        h = np.asarray(jnp.asarray(xj @ jnp.asarray(wi, jdt), jnp.float32))
        h = h * np.asarray(jax.nn.silu(jnp.asarray(xj @ jnp.asarray(wg, jdt), jnp.float32)))
        bound = 2.0**-7 * (np.abs(h) @ np.abs(wo) + np.abs(_np(want))) + 1e-6
        assert (np.abs(_np(got) - _np(want)) <= bound).all()

    heads = rng.standard_normal((2, 37, 3, 16)).astype(np.float32)
    pos = np.arange(37, dtype=np.int32)[None, :]
    got = tL.apply_rope(torch.from_numpy(heads).to(tdt), torch.from_numpy(pos), 10000.0)
    want = rL.apply_rope(jnp.asarray(heads, jdt), jnp.asarray(pos), 10000.0)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(tL.rope_freqs(16).numpy(), np.asarray(rL.rope_freqs(16)), rtol=1e-6)


# --------------------------------------------------------------------------
# transformer.forward and colbert.encode, reduced widths, f32
# --------------------------------------------------------------------------
GQA_CAUSAL = rT.TransformerConfig(
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
    tp_multiple=8, dtype=jnp.float32, q_chunk=8, k_chunk=8,
)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("backbone", ["colbert_reduced", "gqa_causal_padded"])
def test_forward_matches_reference_f32(backbone, attn_impl):
    rcfg = rcfgs.reduced_config().backbone if backbone == "colbert_reduced" else GQA_CAUSAL
    rcfg = dataclasses.replace(rcfg, attn_impl=attn_impl)
    rng = np.random.default_rng(0)
    params = backbone_tree(rcfg, rng)
    toks = rng.integers(0, rcfg.vocab, (3, 16)).astype(np.int32)
    want, _ = jax.jit(rT.forward, static_argnums=1)(to_jax(params), rcfg, jnp.asarray(toks))
    model = tT.params_from_numpy(params, port_backbone(rcfg), device="cpu")
    got = model(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (3, 16, rcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_encode_with_mask_matches_reference():
    rcfg, tcfg = rcfgs.reduced_config(), tcfgs.reduced_config()
    params = colbert_tree(rcfg, 2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rcfg.backbone.vocab, (4, 12)).astype(np.int32)
    lens = np.array([12, 7, 1, 10])
    mask = (np.arange(12)[None, :] < lens[:, None]).astype(np.float32)
    want = jax.jit(rcol.encode, static_argnums=1)(
        to_jax(params), rcfg, jnp.asarray(toks), jnp.asarray(mask))
    model = tcol.params_from_numpy(params, tcfg, device="cpu")
    got = tcol.encode(model, toks, mask)
    assert got.dtype == torch.float32 and got.shape == (4, 12, rcfg.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    norms = got.norm(dim=-1)
    torch.testing.assert_close(norms[torch.from_numpy(mask) > 0], torch.ones(int(lens.sum())))
    assert (got[torch.from_numpy(mask) == 0] == 0).all()


def test_full_width_encoder_one_layer_bf16():
    """ColBERTv2's widths (d 768, 12 heads padded to 48, d_ff 3072, vocab
    30528), one layer, bf16, K7 as the attention on both sides."""
    rcfg = rcfgs.full_config()
    rcfg = dataclasses.replace(
        rcfg, backbone=dataclasses.replace(rcfg.backbone, n_layers=1, attn_impl="flash")
    )
    tcfg = tcfgs.full_config()
    tcfg = dataclasses.replace(
        tcfg, backbone=dataclasses.replace(tcfg.backbone, n_layers=1, attn_impl="flash")
    )
    assert tcfg.backbone.padded_heads == 48 and tcfg.backbone.dtype == torch.bfloat16
    params = colbert_tree(rcfg, 4)
    toks = np.random.default_rng(5).integers(0, rcfg.backbone.vocab, (2, 32)).astype(np.int32)
    want = np.asarray(jax.jit(rcol.encode, static_argnums=1)(to_jax(params), rcfg, jnp.asarray(toks)))
    model = tcol.params_from_numpy(params, tcfg, device="cpu")
    got = tcol.encode(model, toks).numpy()
    assert got.shape == want.shape == (2, 32, 128)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    assert np.abs(got - want).max() <= 2e-2


def test_maxsim_scores_match_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 5, 16)).astype(np.float32)
    d = rng.standard_normal((4, 7, 16)).astype(np.float32)
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = rcol.maxsim_scores(jnp.asarray(q), jnp.asarray(d), None if m is None else jnp.asarray(m))
        got = tcol.maxsim_scores(torch.from_numpy(q), torch.from_numpy(d),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced_ref_params():
    """The reference's own ``colbert.init_params`` tree at reduced widths."""
    init = jax.jit(rcol.init_params, static_argnums=1)
    return to_numpy(init(jax.random.PRNGKey(6), rcfgs.reduced_config()))


def test_params_from_numpy_round_trips_every_leaf_bit_for_bit(reduced_ref_params):
    tcfg = tcfgs.reduced_config()
    tree = reduced_ref_params
    back = tcol.params_from_numpy(tree, tcfg, device="cpu").numpy_params()
    want = dict(tree, backbone={k: v for k, v in tree["backbone"].items() if k != "lm_head"})
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want_leaves) == len(got_leaves) == 12
    for path, leaf in want_leaves:
        got = got_leaves[path]
        assert got.dtype == leaf.dtype == np.float32, path
        np.testing.assert_array_equal(got.view(np.uint32), leaf.view(np.uint32), err_msg=str(path))


def test_params_from_numpy_refuses_wrong_shapes(reduced_ref_params):
    tree = dict(reduced_ref_params, proj=reduced_ref_params["proj"][:, :-1])
    with pytest.raises(ValueError, match="proj"):
        tcol.params_from_numpy(tree, tcfgs.reduced_config(), device="cpu")


def test_padded_heads_stay_inert():
    """Padded query heads (wq columns zero, wo rows zero) add nothing: the
    port's init leaves them zero, and garbage in the padded wq columns does
    not change the output because their wo rows are zero."""
    cfg = tT.TransformerConfig(n_layers=2, d_model=48, n_heads=3, n_kv_heads=3, d_ff=64,
                               vocab=50, tp_multiple=8, causal=False, dtype=torch.float32,
                               attn_impl="flash")
    assert cfg.group_pad == 8 and cfg.padded_heads == 24
    model = tT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 50, (2, 9)))
    before = model(toks)
    for lay in model.layers:
        wq = lay.attn_wq.view(48, 3, 8, 16)
        wo = lay.attn_wo.view(3, 8, 16, 48)
        assert (wq[:, :, 1:] == 0).all() and (wo[:, 1:] == 0).all()
        assert (wq[:, :, :1] != 0).any() and (wo[:, :1] != 0).any()
        wq[:, :, 1:] = torch.randn(48, 3, 7, 16)
    torch.testing.assert_close(model(toks), before, rtol=0, atol=0)


def test_port_init_matches_reference_shapes_and_scales(reduced_ref_params):
    rcfg = rcfgs.reduced_config()
    ref = reduced_ref_params
    port = tcol.init_params(tcfgs.reduced_config(), torch.Generator().manual_seed(8), device="cpu")
    got = port.numpy_params()
    ref_shapes = {p: v.shape for p, v in jax.tree_util.tree_leaves_with_path(ref)
                  if "lm_head" not in jax.tree_util.keystr(p)}
    assert {p: v.shape for p, v in jax.tree_util.tree_leaves_with_path(got)} == ref_shapes
    emb = got["backbone"]["embed"]
    assert (emb[rcfg.backbone.vocab:] == 0).all()
    assert abs(emb[: rcfg.backbone.vocab].std() - 0.02) < 0.002
    d, out = rcfg.backbone.d_model, rcfg.out_dim
    assert abs(got["proj"].std() - (2.0 / (d + out)) ** 0.5) < 0.03


def test_moe_layers_train_and_serve():
    """A forward pass through MoE layers that builds a graph trains them:
    with remat on, the gradient of the hidden states and the aux value
    reaches the router and every expert weight of each layer, and without
    a graph the model serves."""
    cfg = tT.TransformerConfig(n_experts=4, top_k=2, dtype=torch.float32)
    model = tT.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_()
    assert cfg.remat and all(lay.moe for lay in model.layers)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    h, aux = model.hidden(toks)
    assert float(aux) > 0
    (h.square().sum() + aux).backward()
    for lay in model.layers:
        for name in ("moe_router", "moe_wi", "moe_wg", "moe_wo"):
            assert getattr(lay, name).grad.abs().max() > 0, name
    with torch.no_grad():
        assert model(toks).shape == (2, 8, cfg.d_model)
