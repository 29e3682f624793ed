"""The port's LM family against the reference (``repro.models.transformer``,
``repro.configs.<lm arch>``): the five LM archs at their reduced configs in
f32, the reference's ``init_params(PRNGKey(0))`` tree carried across as
numpy, the same numpy-seeded tokens.

Tolerances, with their reasons:

* f32: rtol = atol = 1e-5.  The same operations in the same order per
  element, but XLA and PyTorch sum matmuls, means and softmaxes in another
  order; through two or three layers that moves the last f32 bits (the
  largest difference seen is ~5e-6).
* MoE routing: expert ids and keep masks identical (``stable_topk`` breaks
  ties toward the lower expert as ``jax.lax.top_k`` does).
* bf16 (one case, tiny width): within 1e-2 + 2^-7 of the value (logits
  below 0.6 in size; measured 0.0039 for the prefill, 0.0059 over the
  decode steps, and one ulp, 0.0156, for a cached k above 2).  Both
  frameworks round every product and the residual stream to bf16, but
  at different places, and the differences pass through two layers and
  the head.

Cases that run K7 at the LM prefill shapes need a card (``gpu``) and skip
here; they import no JAX, so they run where only the port is installed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.models import layers as rL
    from repro.models import transformer as rT
except ImportError:
    jax = jnp = rconfigs = rL = rT = None

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-2)
LM_ARCHS = ["h2o-danube-3-4b", "yi-34b", "granite-34b", "granite-moe-1b-a400m",
            "deepseek-moe-16b"]
#: K7 with the reference in interpret mode: head padding, MQA, MoE
FLASH_ARCHS = ["yi-34b", "granite-34b", "granite-moe-1b-a400m"]
IMPL_CASES = [(a, "chunked") for a in LM_ARCHS] + [(a, "flash") for a in FLASH_ARCHS]
needs_ref = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def port_cfg(rcfg, **over):
    """The port's config for a reference ``TransformerConfig``."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(tT.TransformerConfig)
          if f.name != "dtype"}
    kw["dtype"] = getattr(torch, jnp.dtype(rcfg.dtype).name)
    kw.update(over)
    return tT.TransformerConfig(**kw)


_TREES: dict = {}


def ref_tree(arch):
    """The reference's ``init_params(PRNGKey(0))`` tree of the arch's
    reduced config, as numpy (jitted: its eager init takes ~10 s)."""
    if arch not in _TREES:
        rcfg = rconfigs.get(arch).reduced_config()
        tree = jax.jit(rT.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg)
        _TREES[arch] = jax.tree_util.tree_map(np.asarray, tree)
    return _TREES[arch]


def pair(arch, **over):
    """(reference config, its jax params, the port's model) on the same weights."""
    rcfg = dataclasses.replace(rconfigs.get(arch).reduced_config(), **over)
    tree = ref_tree(arch)
    model = tT.params_from_numpy(tree, port_cfg(rcfg), device="cpu")
    return rcfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=err_msg, **(tol or TOL))


# --------------------------------------------------------------------------
# configs, registry, parameter counts
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_and_cells_equal_the_reference(arch):
    rmod, tmod = rconfigs.get(arch), tconfigs.get(arch)
    assert tmod.FAMILY == rmod.FAMILY == "lm"
    for which in ("full_config", "reduced_config"):
        assert getattr(tmod, which)() == port_cfg(getattr(rmod, which)()), which
    assert [dataclasses.asdict(c) for c in tmod.CELLS] == [dataclasses.asdict(c) for c in rmod.CELLS]


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_of_the_full_configs_equal_the_reference(arch):
    rcfg, tcfg = rconfigs.get(arch).full_config(), tconfigs.get(arch).full_config()
    assert tcfg.num_params() == rcfg.num_params()
    assert tcfg.active_params() == rcfg.active_params()
    tied = dataclasses.replace(tcfg, tied_embeddings=True)
    assert tied.num_params() == dataclasses.replace(rcfg, tied_embeddings=True).num_params()


def test_registry_resolves_the_lm_ids_and_names_item_9_for_the_rest():
    """Every id resolves: the LM ids to the LM family, and the ids ROADMAP
    Queue 1 item 9 ported to their families (no refusal is left)."""
    for arch in LM_ARCHS:
        assert tconfigs.get(arch).FAMILY == "lm"
    families = {"schnet": "gnn", "xdeepfm": "recsys", "bst": "recsys", "bert4rec": "recsys",
                "wide-deep": "recsys"}
    for arch, family in families.items():
        mod = tconfigs.get(arch)
        assert mod.FAMILY == family and mod.full_config().name == arch


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_round_trip_leaf_for_leaf(arch):
    tree = ref_tree(arch)
    rcfg = rconfigs.get(arch).reduced_config()
    back = tT.params_from_numpy(tree, port_cfg(rcfg), device="cpu").numpy_params()
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    assert ("lm_head" in back) and (("moe_layers" in back) == bool(rcfg.n_experts))
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype == np.float32, path
        np.testing.assert_array_equal(got[path].view(np.uint32), leaf.view(np.uint32),
                                      err_msg=str(path))


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_init_matches_reference_shapes_scales_and_dtype(arch):
    rcfg = rconfigs.get(arch).reduced_config()
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced_config(), dtype=torch.bfloat16)
    model = tT.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu",
                           head=True, param_dtype=tcfg.dtype)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tree = tT.params_tree(model, tT.param_paths(tcfg, head=True))
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        ttree.to_numpy(ttree.tree_map(lambda t: t.float(), tree)))}
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(ref_tree(arch))}
    assert {k: v.shape for k, v in got.items()} == want
    emb, head = got["['embed']"], got["['lm_head']"]
    assert (emb[rcfg.vocab:] == 0).all() and (head[:, rcfg.vocab:] == 0).all()
    assert abs(emb[: rcfg.vocab].std() - 0.02) < 0.003


@needs_ref
@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-moe-16b"])
def test_param_axes_are_the_reference_per_layer(arch):
    rcfg = rconfigs.get(arch).reduced_config()
    want = rT.param_axes(rcfg)
    got = tT.param_axes(port_cfg(rcfg), head=True)
    for path, w in jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda t: isinstance(t, tuple)):
        node = got
        for k in path:
            node = node[k.key]
        if w[0] == "layers":
            assert node == [w[1:]] * len(node) and node, path
        else:
            assert node == w, path


# --------------------------------------------------------------------------
# forward, logits, prefill, decode
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("arch,impl", IMPL_CASES)
def test_forward_matches_reference(arch, impl):
    rcfg, params, model = pair(arch, attn_impl=impl)
    toks = tokens(rcfg.vocab, (2, 24))
    want_h, want_aux = jax.jit(rT.forward, static_argnums=1)(params, rcfg, jnp.asarray(toks))
    before = tfa.launches
    got_h, got_aux = model.hidden(torch.from_numpy(toks))
    assert tfa.launches == before  # the host runs K7's plain version: no launch
    assert got_h.shape == (2, 24, rcfg.d_model) and got_h.dtype == torch.float32
    close(got_h, want_h)
    close(got_aux, want_aux)
    assert (float(want_aux) > 0) == bool(rcfg.n_experts)


@needs_ref
@pytest.mark.parametrize("arch,impl", IMPL_CASES)
def test_logits_and_prefill_match_reference(arch, impl):
    rcfg, params, model = pair(arch, attn_impl=impl)
    toks = tokens(rcfg.vocab, (2, 24), seed=1)
    h, _ = jax.jit(rT.forward, static_argnums=1)(params, rcfg, jnp.asarray(toks))
    want = jax.jit(rT.logits_fn, static_argnums=1)(params, rcfg, h)
    got = tT.logits_fn(model, torch.from_numpy(np.array(h)))
    assert got.shape == (2, 24, rcfg.padded_vocab)
    close(got, want)
    if rcfg.padded_vocab != rcfg.vocab:
        assert (got[..., rcfg.vocab:] == -1e9).all()
    want_p = jax.jit(lambda p, t: rT.prefill(p, rcfg, t))(params, jnp.asarray(toks))
    close(tT.prefill(model, torch.from_numpy(toks)), want_p)


def _decode_against_reference(arch, steps, batch, seq_len, **over):
    rcfg, params, model = pair(arch, **over)
    toks = tokens(rcfg.vocab, (batch, steps), seed=2)
    rcache = rT.init_cache(rcfg, batch, seq_len)
    tcache = tT.init_cache(model.cfg, batch, seq_len, device="cpu")
    assert tuple(tcache["k"].shape) == rcache["k"].shape and tcache["k"].dtype == torch.float32
    step = jax.jit(lambda p, c, t, n: rT.decode_step(p, rcfg, c, t, n))
    for t in range(steps):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, tcache = tT.decode_step(model, tcache, torch.from_numpy(toks[:, t]), t)
        close(got, want, err_msg=f"logits, step {t}")
        close(tcache["k"], rcache["k"], err_msg=f"k cache, step {t}")
        close(tcache["v"], rcache["v"], err_msg=f"v cache, step {t}")
    return rcfg, model, toks, got


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_match_reference(arch):
    """16 steps from an empty cache: logits and the whole cache at every
    step; the last step's logits equal the prefill's (the reference's own
    check, tests/test_transformer.py, which sets capacity_factor 4: no
    expert drops a choice, whether a group holds one token or eight)."""
    rcfg, model, toks, got = _decode_against_reference(arch, 16, 2, 16, capacity_factor=4.0)
    close(got, tT.prefill(model, torch.from_numpy(toks)), rtol=1e-4, atol=1e-4)


@needs_ref
def test_h2o_decode_past_its_window_matches_reference():
    """The long_500k reduced cell (B 1, seq 128): a ring of window = 16
    slots, 40 steps, so the ring turns over twice and RoPE keeps the
    absolute position."""
    p = tconfigs.cells_of("h2o-danube-3-4b")["long_500k"].reduced
    rcfg = rconfigs.get("h2o-danube-3-4b").reduced_config()
    assert tT.cache_seq_len(port_cfg(rcfg), p["seq_len"]) == rcfg.window == 16
    _decode_against_reference("h2o-danube-3-4b", 40, p["global_batch"], p["seq_len"])


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_decode_equals_its_prefill(arch):
    """The reference's check in the port alone, on weights the port drew."""
    cfg = dataclasses.replace(tconfigs.get(arch).reduced_config(), capacity_factor=4.0)
    model = tT.init_params(cfg, torch.Generator().manual_seed(3), device="cpu", head=True)
    toks = torch.from_numpy(tokens(cfg.vocab, (2, 16), seed=4))
    cache = tT.init_cache(cfg, 2, 16, device="cpu")
    for t in range(16):
        got, cache = tT.decode_step(model, cache, toks[:, t], t)
    torch.testing.assert_close(got, tT.prefill(model, toks), rtol=1e-4, atol=1e-4)


@needs_ref
def test_bf16_prefill_and_decode_track_the_reference():
    """yi-34b's reduced widths (head padding) in bf16, f32 weights cast at
    use on both sides (the reference's ``astype``; the port's cached cast)."""
    rcfg, params, model = pair("yi-34b", dtype=jnp.bfloat16)
    assert model.cfg.dtype == torch.bfloat16
    toks = tokens(rcfg.vocab, (2, 12), seed=5)
    want = jax.jit(lambda p, t: rT.prefill(p, rcfg, t))(params, jnp.asarray(toks))
    got = tT.prefill(model, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    close(got, want, **BF16_TOL)
    rcache, tcache = rT.init_cache(rcfg, 2, 12), tT.init_cache(model.cfg, 2, 12, device="cpu")
    assert tcache["k"].dtype == torch.bfloat16
    step = jax.jit(lambda p, c, t, n: rT.decode_step(p, rcfg, c, t, n))
    for t in range(12):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        got, tcache = tT.decode_step(model, tcache, torch.from_numpy(toks[:, t]), t)
        close(got, want, **BF16_TOL)
    close(tcache["k"], rcache["k"].astype(jnp.float32), **BF16_TOL)


@needs_ref
@pytest.mark.parametrize("lens", ["scalar", "per_row"])
def test_decode_attention_matches_reference(lens):
    """GQA (8 query heads over 2), a 24-slot cache: valid prefixes of 17
    slots (a scalar) or of 24 / 5 / 1 slots (one a row)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 24, 2, 16)).astype(np.float32) for _ in range(2))
    n = 17 if lens == "scalar" else np.array([24, 5, 1], np.int32)
    want = rL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n))
    got = tL.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              n if lens == "scalar" else torch.from_numpy(n))
    close(got, want)


# --------------------------------------------------------------------------
# MoE routing
# --------------------------------------------------------------------------
def ref_routing(router, xg, rcfg, cap):
    """The reference ``moe_einsum``'s router and GShard slots
    (``repro/models/transformer.py:293-310``), returning what it keeps
    internal: expert ids (G, g, k) and keep masks (G, g, k)."""
    logits = jnp.einsum("Ngd,de->Nge", xg, router)
    probs = jax.nn.softmax(logits, -1)
    _, ids = jax.lax.top_k(probs, rcfg.top_k)
    counts = jnp.zeros((xg.shape[0], rcfg.n_experts), jnp.int32)
    keep = []
    for j in range(rcfg.top_k):
        oh = jax.nn.one_hot(ids[:, :, j], rcfg.n_experts, dtype=jnp.int32)
        pos = jnp.cumsum(oh, axis=1) - oh + counts[:, None, :]
        keep.append((pos * oh).sum(-1) < cap)
        counts = counts + oh.sum(axis=1)
    return np.asarray(ids), np.asarray(jnp.stack(keep, -1))


@needs_ref
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
@pytest.mark.parametrize("case", ["overflow", "zero_router"])
def test_moe_routing_and_output_match_reference(arch, case):
    """Capacity overflow (capacity_factor 0.5: each expert takes a quarter
    of a group's choices) and a zero router (every score ties, so each
    token picks experts 0..k-1): identical expert ids and keep masks, and
    the layer's output and aux value within f32 tolerance."""
    cf = 0.5 if case == "overflow" else 1.25
    rcfg, _, model = pair(arch, capacity_factor=cf)
    lay = model.layers[-1]
    assert lay.moe
    if case == "zero_router":
        lay.moe_router.zero_()
    w = {n: getattr(lay, n) for n in lay.names}
    rparams = _ref_moe_params(lay)
    x = np.random.default_rng(6).standard_normal((2, 20, rcfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(rT.moe_einsum, static_argnums=2)(rparams, jnp.asarray(x), rcfg)
    got, *stats = tT.moe_ffn(w, torch.from_numpy(x), model.cfg, model.cast)
    got_aux = tT.moe_aux([stats], model.cfg.n_experts)
    close(got, want)
    close(got_aux, want_aux)
    g = min(rcfg.moe_group, 20)
    ng = -(-20 // g)
    xg = np.pad(x, ((0, 0), (0, ng * g - 20), (0, 0))).reshape(2 * ng, g, rcfg.d_model)
    cap = max(int(np.ceil(g * rcfg.top_k * rcfg.capacity_factor / rcfg.n_experts)), 1)
    want_ids, want_keep = ref_routing(rparams["router"], jnp.asarray(xg), rcfg, cap)
    _, _, ids, _, keep = tT.moe_route(lay.moe_router, torch.from_numpy(xg), model.cfg, cap)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()  # choices were dropped
    if case == "zero_router":
        assert (want_ids == np.arange(rcfg.top_k)).all()


def _ref_moe_params(lay):
    """A MoE layer's ``moe`` subtree in the reference's layout, as jax arrays."""
    p = {n: jnp.asarray(getattr(lay, f"moe_{n}").detach().numpy()) for n in ("router", "wi", "wg", "wo")}
    if hasattr(lay, "moe_shared_wi"):
        p["shared"] = {n: {"w": jnp.asarray(getattr(lay, f"moe_shared_{n}").detach().numpy())}
                       for n in ("wi", "wg", "wo")}
    return p


# --------------------------------------------------------------------------
# on the card: K7 at the LM prefill shapes
# --------------------------------------------------------------------------
#: B, S, H (padded), Hkv, dh of each LM prefill K7 runs: yi-34b's prefill_32k
#: at batch 1, granite-34b (MQA 48:1), granite-moe-1b (B 8), deepseek (MHA)
LM_FLASH_SHAPES = {
    "yi-34b": (1, 32768, 64, 8, 128),
    "granite-34b": (1, 4096, 48, 1, 128),
    "granite-moe-1b-a400m": (8, 4096, 16, 8, 64),
    "deepseek-moe-16b": (1, 4096, 16, 16, 128),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(LM_FLASH_SHAPES))
def test_k7_at_lm_prefill_shapes_matches_plain_on_card(cuda, arch):
    """bf16, causal: within one bf16 ulp of the plain version (rtol 2^-7,
    atol 1e-6); S 4,096's last 77 rows alone also at a ragged S."""
    B, S, H, Hkv, dh = LM_FLASH_SHAPES[arch]
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(B, S, h, dh, generator=g, device=cuda).bfloat16() for h in (H, Hkv, Hkv))
    for s in (S, S - 77):
        got = tfa.flash_attention(q[:, :s], k[:, :s], v[:, :s], causal=True)
        want = tref.flash_attention_ref(q[:, :s], k[:, :s], v[:, :s], causal=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("lens", ["scalar", "per_row"])
def test_bf16_decode_attention_on_card_matches_the_host(cuda, lens):
    """Decode attention over bf16 caches on the card (the ``out_dtype=
    float32`` products over strided cache views) against the same call on
    the host, whose products run on f32 copies; q holds bf16 values in f32,
    so both outputs are f32 accumulators'.  Yi-34b's head layout (64 padded
    heads over 8), 8,192 slots: max |diff| within 1e-3 of the largest
    |output| (rounding the scores or the output to bf16 puts it 3e-3 to 5e-3
    away)."""
    B, S, H, Hkv, dh = 4, 8192, 64, 8, 128
    g = torch.Generator(device=cuda).manual_seed(11)
    k, v = (torch.randn(B, S, Hkv, dh, generator=g, device=cuda).bfloat16() for _ in range(2))
    q = torch.randn(B, 1, H, dh, generator=g, device=cuda).bfloat16().float()
    n = S - 3 if lens == "scalar" else torch.tensor([S, 1, 5000, S - 1], device=cuda)
    got = tL.decode_attention(q, k, v, n)
    want = tL.decode_attention(q.cpu(), k.cpu(), v.cpu(), n if lens == "scalar" else n.cpu())
    assert got.dtype == want.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())
