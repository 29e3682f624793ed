"""The port's ColBERT training loss and its gradients against the reference
(``repro.models.colbert.train_loss`` under ``jax.value_and_grad``), the
training batches (``colbert_batches``), the arch registry, and the
trainable encoder's rules: padded heads train, K7 refuses a backward pass,
remat changes no gradient.

The same weights (the reference's ``init_params`` at reduced widths,
carried across as numpy) and the same seeded batches go to both packages.

Tolerances, with their reasons.  In f32 (XLA and PyTorch sum matmuls and
means in another order, which moves the last bits of each layer, and the
backward pass compounds it over two layers): the loss rtol 1e-5; a
gradient rtol 1e-4 and atol 1e-6, except the embedding table's, whose
atol is 1e-5 of its largest magnitude: an f32 sum rounds at the size of
its largest terms, not of its result, and an embedding row's gradient sums
every occurrence of its token; where those cancel, a flat 1e-6 failed 4 of
4,096 elements (2.7e-6 off beside a largest magnitude of 0.73).

In bf16 (the compute dtype of the full config) the two packages round in
different places: XLA on the CPU expands ``jax.nn.silu`` into four bf16
roundings where ``F.silu`` rounds once, and fuses elementwise chains; a
batch's bf16 gradient then departs from the f32 gradient by 2-36% of its
norm in either package (MaxSim's max switches between near-tied tokens),
and the port's and the reference's bf16 gradients differ by as much.  So
the bf16 cases hold the loss to one bf16 rounding (rtol 2**-8), and the
gradients, summed over 8 batches, to the reference's own bf16 error:
each leaf's distance from the reference's f32 gradient at most 1.5 times
the reference's bf16 gradient's (measured 0.77-1.36), and at most 0.15 of
its norm from the reference's bf16 gradient (measured 0.09).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.models import layers as rL  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL, EMBED_ATOL_OF_MAX = 1e-4, 1e-6, 1e-5
B, Q_LEN, D_LEN = 4, 6, 13  # neither length a multiple of the chunk (8)


def with_backbone(cfg, **over):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **over))


def ref_tree(rcfg, seed=0):
    init = jax.jit(rcol.init_params, static_argnums=1)
    return jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(seed), rcfg))


def masked_batch(vocab, nway, seed=1):
    """A ``colbert_batches`` batch with padded query and passage tokens."""
    b = next(rsyn.colbert_batches(vocab, B, q_len=Q_LEN, d_len=D_LEN, nway=nway, seed=seed))
    rng = np.random.default_rng(seed)
    b["q_mask"][1, 4:] = 0
    b["q_mask"][3, 2:] = 0
    d_lens = rng.integers(D_LEN // 2, D_LEN + 1, (B, nway))
    d_lens[0, 0] = D_LEN
    b["d_mask"] = (np.arange(D_LEN)[None, None, :] < d_lens[..., None]).astype(np.float32)
    b["target_scores"] = rng.standard_normal((B, nway)).astype(np.float32) * 2
    return b


_REF_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(rcol.train_loss, has_aux=True), static_argnums=1)


def ref_value_and_grad(tree, rcfg, batch):
    (loss, metrics), grads = _REF_VALUE_AND_GRAD(jax.tree_util.tree_map(jnp.asarray, tree), rcfg,
                                                 {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_value_and_grad(tree, tcfg, batch):
    model, state = tcol.train_state_from_numpy({"params": tree}, tcfg, device="cpu")
    (loss, metrics), grads = tloop.value_and_grad(
        tcol.loss_fn(model), state["params"], {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, tcol.numpy_train_state(grads)


def assert_grads_close(got: dict, want):
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert leaves
    for path, w in leaves:
        g, w = got, np.asarray(w)
        for k in path:
            g = g[k.key]
        name = jax.tree_util.keystr(path)
        atol = EMBED_ATOL_OF_MAX * np.abs(w).max() if name == "['backbone']['embed']" else GRAD_ATOL
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# data, configs, registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_colbert_batches_equal_reference(seed):
    kw = dict(q_len=8, d_len=16, nway=3, seed=seed)
    want, got = rsyn.colbert_batches(128, 5, **kw), tsyn.colbert_batches(128, 5, **kw)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("which", ["full_config", "reduced_config"])
def test_training_fields_match_reference(which):
    ref, port = getattr(rcfgs, which)(), getattr(tcfgs, which)()
    for f in ("out_dim", "nway", "use_ib_negatives", "distill"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.backbone.remat == ref.backbone.remat
    assert tcfgs.FAMILY == rcfgs.FAMILY


def test_arch_registry_resolves_colbert_and_names_the_roadmap_for_the_rest():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert tconfigs.get("plaid-colbertv2") is tcfgs
    for arch in tconfigs.ARCH_IDS:  # every id resolves to the reference's family
        assert tconfigs.get(arch).FAMILY == rconfigs.get(arch).FAMILY
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("bert-large")


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ib,distill", [(True, True), (True, False), (False, True), (False, False)])
def test_train_loss_and_grads_match_reference(ib, distill):
    rcfg = dataclasses.replace(rcfgs.reduced_config(), use_ib_negatives=ib, distill=distill)
    tcfg = dataclasses.replace(tcfgs.reduced_config(), use_ib_negatives=ib, distill=distill)
    tree = ref_tree(rcfg)
    batch = masked_batch(rcfg.backbone.vocab, rcfg.nway)
    want_loss, want_m, want_g = ref_value_and_grad(tree, rcfg, batch)
    got_loss, got_m, got_g = port_value_and_grad(tree, tcfg, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    np.testing.assert_allclose(got_m["ce"], want_m["ce"], **LOSS_TOL)
    np.testing.assert_allclose(got_m["kd"], want_m["kd"], rtol=1e-5, atol=1e-7)
    assert (got_m["kd"] != 0) == distill
    assert_grads_close(got_g, want_g)
    assert not np.any(got_g["backbone"]["lm_head"])  # the encoder never reads it


def test_tied_maxsim_maxima_split_the_gradient_as_jax_does():
    """A passage whose token vectors repeat: each query token's max is
    tied; JAX gives every tied maximum an equal share of the gradient, and
    so must the port (``amax``, not ``max(dim=)``)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 5, 8)).astype(np.float32)
    d = rng.standard_normal((4, 3, 8)).astype(np.float32)
    d = np.concatenate([d, d[:, ::-1]], axis=1)  # every vector twice
    mask = np.ones((4, 6), np.float32)
    mask[2, 5] = 0
    w = rng.standard_normal((3, 4)).astype(np.float32)

    def ref(q, d):
        return (rcol.maxsim_scores(q, d, jnp.asarray(mask)) * w).sum()

    want_v, (want_gq, want_gd) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(d))
    tq, td = (torch.from_numpy(x).requires_grad_() for x in (q, d))
    got_v = (tcol.maxsim_scores(tq, td, torch.from_numpy(mask)) * torch.from_numpy(w)).sum()
    got_v.backward()
    np.testing.assert_allclose(float(got_v.detach()), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want_gq), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_gd), rtol=1e-6, atol=1e-7)
    # every valid vector of a tied pair got half: the pair's grads are equal
    np.testing.assert_array_equal(td.grad[:, :3].numpy()[[0, 1, 3]],
                                  td.grad[:, 3:].numpy()[[0, 1, 3], ::-1])


def test_train_loss_with_tied_passage_tokens_matches_reference():
    """The whole loss with exact MaxSim ties: ``wq = 0`` makes attention
    uniform, so a token's vector depends only on its id, and passages that
    repeat a token tie their maxima in both packages."""
    rcfg, tcfg = rcfgs.reduced_config(), tcfgs.reduced_config()
    tree = ref_tree(rcfg, seed=3)
    tree["backbone"]["dense_layers"]["attn"]["wq"][:] = 0
    batch = masked_batch(rcfg.backbone.vocab, rcfg.nway, seed=5)
    batch["d_mask"][:] = 1
    batch["d_tokens"][:, :, 7:] = batch["d_tokens"][:, :, 1:7]  # six tokens twice
    model, _ = tcol.train_state_from_numpy({"params": tree}, tcfg, device="cpu")
    d = tcol.encode(model, batch["d_tokens"].reshape(-1, D_LEN))
    assert torch.equal(d[:, 7:], d[:, 1:7])  # the ties are exact
    want_loss, _, want_g = ref_value_and_grad(tree, rcfg, batch)
    got_loss, _, got_g = port_value_and_grad(tree, tcfg, batch)
    np.testing.assert_allclose(got_loss, want_loss, **LOSS_TOL)
    assert_grads_close(got_g, want_g)


CHUNKED_CASES = {  # B, S, H, Hkv, dh, causal, window, q_chunk, k_chunk
    "bidirectional_padded": (2, 13, 4, 4, 8, False, None, 8, 8),
    "causal_gqa_padded": (2, 11, 4, 2, 8, True, None, 4, 8),
    "window_masked_rows": (1, 19, 2, 1, 8, True, 3, 4, 4),
}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_attention_grads_are_finite_and_match_reference(case):
    """The ``-inf`` guards on padded and fully masked rows give finite
    gradients, equal to ``jax.grad`` of the reference."""
    Bn, S, H, Hkv, dh, causal, window, qc, kc = CHUNKED_CASES[case]
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((Bn, S, h, dh)).astype(np.float32) for h in (H, Hkv, Hkv))
    w = rng.standard_normal((Bn, S, H, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, k_chunk=kc)

    def ref(q, k, v):
        return (rL.chunked_attention(q, k, v, **kw) * w).sum()

    want = jax.grad(ref, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tL.chunked_attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_attention_bf16_grads_match_reference(case):
    """The chunked attention's backward pass on bf16 inputs (scores and the
    softmax in f32, the gradients rounded to bf16 once): within one bf16
    rounding of ``jax.grad`` of the reference (measured: equal but for 0.1%
    of one tensor's elements, one bf16 step apart)."""
    Bn, S, H, Hkv, dh, causal, window, qc, kc = CHUNKED_CASES[case]
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((Bn, S, h, dh)).astype(np.float32) for h in (H, Hkv, Hkv))
    w = rng.standard_normal((Bn, S, H, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, k_chunk=kc)

    def ref(q, k, v):
        return (rL.chunked_attention(q, k, v, **kw).astype(jnp.float32) * w).sum()

    want = jax.grad(ref, argnums=(0, 1, 2))(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    (tL.chunked_attention(tq, tk, tv, **kw).float() * torch.from_numpy(w)).sum().backward()
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        r = np.asarray(ref_g, np.float32)
        np.testing.assert_allclose(got.float().numpy(), r, rtol=2**-8, atol=2**-8 * np.abs(r).max())


def test_remat_changes_no_gradient():
    tcfg = tcfgs.reduced_config()
    tree = ref_tree(rcfgs.reduced_config())
    batch = masked_batch(tcfg.backbone.vocab, tcfg.nway)
    loss_on, _, g_on = port_value_and_grad(tree, tcfg, batch)
    loss_off, _, g_off = port_value_and_grad(tree, with_backbone(tcfg, remat=False), batch)
    assert loss_on == loss_off
    for a, b in zip(jax.tree_util.tree_leaves(g_on), jax.tree_util.tree_leaves(g_off)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the trainable encoder's rules
# --------------------------------------------------------------------------
def test_padded_heads_train_like_the_reference():
    """2 heads padded to 4 (``tp_multiple=4``): the padded ``wo`` slots
    start at zero and are nonzero after one AdamW step, the padded ``wq``
    slots after two, with the reference's values in both."""
    over = dict(n_heads=2, n_kv_heads=2, tp_multiple=4)
    rcfg, tcfg = with_backbone(rcfgs.reduced_config(), **over), with_backbone(tcfgs.reduced_config(), **over)
    assert tcfg.backbone.padded_heads == 4 and tcfg.backbone.group_pad == 2
    tree = ref_tree(rcfg)
    sched = dict(peak_lr=1e-3, warmup=0, total=10)
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(**sched)))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**sched)))
    r_step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, rcfg, b), r_opt))
    model, state = tcol.train_state_from_numpy({"params": tree}, tcfg, device="cpu")
    t_step = tloop.make_train_step(tcol.loss_fn(model), t_opt)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs, tp = rloop.init_opt_state(r_opt, rp), state["params"]
    ts = tloop.init_opt_state(t_opt, tp)
    batches = rsyn.colbert_batches(rcfg.backbone.vocab, B, q_len=8, d_len=16, nway=rcfg.nway, seed=2)
    d, dh = rcfg.backbone.d_model, rcfg.backbone.d_head
    for n_step in (1, 2):
        b = next(batches)
        rp, rs, _ = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, _ = t_step(tp, ts, b)
        got = tcol.numpy_train_state(tp)["backbone"]["dense_layers"]["attn"]
        want = jax.tree_util.tree_map(np.asarray, rp)["backbone"]["dense_layers"]["attn"]
        # kv-group-major: head (kvh, j) at kvh * 2 + j; j = 1 is padding
        wo_pad = got["wo"].reshape(-1, 2, 2, dh, d)[:, :, 1]
        wq_pad = got["wq"].reshape(-1, d, 2, 2, dh)[:, :, :, 1]
        assert np.abs(wo_pad).min() > 0 and np.abs(wo_pad).max() > 5e-4
        assert (np.abs(wq_pad).max() > 0) == (n_step == 2)
        np.testing.assert_allclose(got["wo"], want["wo"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["wq"], want["wq"], rtol=1e-4, atol=1e-6)


def test_training_through_flash_attention_raises():
    """K7 has no backward pass (neither has the reference's Pallas kernel):
    a training forward through it raises; it does not fall back to the
    chunked attention.  The serving encode still runs through it."""
    tcfg = with_backbone(tcfgs.reduced_config(), attn_impl="flash")
    tree = ref_tree(rcfgs.reduced_config())
    batch = masked_batch(tcfg.backbone.vocab, tcfg.nway)
    with pytest.raises(NotImplementedError, match="no backward"):
        port_value_and_grad(tree, tcfg, batch)
    model = tcol.params_from_numpy(tree, tcfg, device="cpu")
    assert torch.isfinite(tcol.encode(model, batch["q_tokens"])).all()
    model.requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        model(batch["q_tokens"])


# --------------------------------------------------------------------------
# the bf16 path: the full config's compute dtype, remat on, and the
# reference's one-time bf16 cast of the parameters (make_train_step's
# cast_dtype, the reference's C5 path)
# --------------------------------------------------------------------------
CASTS = {"none": (None, None), "cast_bf16": (jnp.bfloat16, torch.bfloat16)}


def bf16_configs():
    return (with_backbone(rcfgs.reduced_config(), dtype=jnp.bfloat16),
            with_backbone(tcfgs.reduced_config(), dtype=torch.bfloat16))


@pytest.fixture(scope="module")
def bf16_batches():
    """The reference's f32 gradients on 8 batches at one state (the bf16
    gradients are judged by their distance from these)."""
    r16, _ = bf16_configs()
    tree = ref_tree(r16)
    batches = [masked_batch(r16.backbone.vocab, r16.nway, seed=s) for s in range(1, 9)]
    return tree, [(b, ref_value_and_grad(tree, rcfgs.reduced_config(), b)[2]) for b in batches]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("cast", list(CASTS))
def test_bf16_loss_and_grads_track_reference(bf16_batches, cast):
    """bf16 compute with the f32 weights cast inside the graph (``none``),
    or cast once before the forward pass (``cast_bf16``): the gradient
    reaches every weight the reference's reaches, in the reference's dtype,
    and is as close to the f32 gradient as the reference's own bf16
    gradient is (tolerances in the module's docstring)."""
    r16, t16 = bf16_configs()
    r_cast, t_cast = CASTS[cast]
    assert t16.backbone.remat
    tree, batches = bf16_batches
    model, state = tcol.train_state_from_numpy({"params": tree}, t16, device="cpu")
    loss_fn = tcol.loss_fn(model)
    r_tree = tree if r_cast is None else jax.tree_util.tree_map(lambda a: a.astype(r_cast), tree)
    sq: dict = {}  # leaf -> [|port - ref16|^2, |port - ref32|^2, |ref16 - ref32|^2, |ref32|^2]
    for batch, want32 in batches:
        want_loss, _, want16 = ref_value_and_grad(r_tree, r16, batch)
        (loss, _), grads = tloop.value_and_grad(
            loss_fn, state["params"], {k: torch.as_tensor(v) for k, v in batch.items()}, t_cast)
        np.testing.assert_allclose(float(loss), want_loss, rtol=2**-8)
        got_dtypes = {str(g.dtype).removeprefix("torch.") for g in ttree.leaves(grads)}
        assert got_dtypes == {str(w.dtype) for w in jax.tree_util.tree_leaves(want16)}
        got = _named(ttree.to_numpy(ttree.tree_map(lambda g: g.float(), grads)))
        want16, want32 = _named(want16), _named(want32)
        assert got.keys() == want32.keys()
        for name, w32 in want32.items():
            g, w16 = got[name], want16[name]
            assert (g != 0).sum() >= 0.99 * (w16 != 0).sum(), name  # the gradient reached it
            acc = sq.setdefault(name, np.zeros(4))
            acc += [np.sum((g - w16) ** 2), np.sum((g - w32) ** 2), np.sum((w16 - w32) ** 2),
                    np.sum(w32**2)]
    for name, (d_ref16, d_port, d_ref, norm) in sq.items():
        if name == "['backbone']['lm_head']":
            assert d_ref16 == d_port == norm == 0  # the encoder never reads it
            continue
        assert d_port > 0, name  # the port computed in bf16, not f32
        assert np.sqrt(d_port) <= 1.5 * np.sqrt(d_ref), (name, np.sqrt(d_port / norm), np.sqrt(d_ref / norm))
        assert np.sqrt(d_ref16 / norm) <= 0.15, (name, np.sqrt(d_ref16 / norm))


@pytest.mark.parametrize("cast", list(CASTS))
def test_bf16_train_steps_track_reference(cast):
    """Two AdamW steps in bf16 (remat on) from one state, with the f32
    weights kept f32.  A first AdamW step moves each weight by lr * g / (|g|
    + eps), i.e. by +-lr: where the two packages' bf16 gradients differ in
    sign (a gradient near 0), the weights end 2 lr apart, and no further;
    a second step adds at most 2 lr more (|m^ / sqrt(v^)| <= 1.0002 at step
    2 for b1 0.9, b2 0.95).  So: every weight within 2 lr, then 4 lr, of the
    reference's; at most a quarter of them (measured 3-9%) moved apart at
    step 1; the losses within one bf16 step (2**-7, measured <= 5.2e-3)."""
    r16, t16 = bf16_configs()
    r_cast, t_cast = CASTS[cast]
    lr = 1e-4
    tree = ref_tree(r16)
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.constant_schedule(lr)))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.constant_schedule(lr)))
    r_step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, r16, b), r_opt,
                                           cast_dtype=r_cast))
    model, state = tcol.train_state_from_numpy({"params": tree}, t16, device="cpu")
    t_step = tloop.make_train_step(tcol.loss_fn(model), t_opt, cast_dtype=t_cast)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs, tp = rloop.init_opt_state(r_opt, rp), state["params"]
    ts = tloop.init_opt_state(t_opt, tp)
    batches = rsyn.colbert_batches(r16.backbone.vocab, B, q_len=8, d_len=16, nway=r16.nway, seed=3)
    for n_step in (1, 2):
        b = next(batches)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(tp, ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=2**-7)
        got, want = _named(ttree.to_numpy(tp)), _named(rp)
        assert {str(p.dtype) for p in ttree.leaves(tp)} == {"torch.float32"}
        moved = []
        for name, w in want.items():
            d = np.abs(got[name] - w)
            assert d.max() <= 2 * n_step * lr * (1 + 1e-3) + 1e-6 * np.abs(w).max(), (name, n_step, d.max() / lr)
            moved.append((d > 1e-3 * lr).mean())
        if n_step == 1:
            assert max(moved) <= 0.25, moved
