"""LM training in the port (``repro_torch.models.transformer.lm_loss``, the
MoE router and aux loss under grad, ``data.synthetic.lm_batches``,
``launch.train``'s LM family, ``launch.cells``' train cells) against the
reference (``jax.value_and_grad(repro.models.transformer.lm_loss)``,
``repro.training.loop.make_train_step``): the five LM archs' reduced
configs, the reference's ``init_params(PRNGKey(0))`` tree carried across
as numpy, the same numpy-seeded batches.

Tolerances, with their reasons (those of ``tests/test_torch_train_loss.py``
and ``tests/test_torch_training.py``).  In f32, XLA and PyTorch sum
matmuls, means and softmaxes in another order, which moves the last bits
of each layer, and the backward pass compounds it: the loss, ``nll`` and
``aux`` rtol 1e-5; a gradient rtol 1e-4 and atol 1e-6, except the
embedding table's, whose atol is 1e-5 of its largest magnitude (an f32 sum
rounds at the size of its largest terms, and an embedding row's gradient
sums every occurrence of its token).  MoE gradients are compared on equal
routing: the expert ids and keep masks of every MoE layer are asserted
identical first (``stable_topk`` breaks ties toward the lower expert as
``jax.lax.top_k`` does).  Train steps: the losses rtol 1e-5 and the
parameters rtol 1e-4, atol 1e-6 after each of three AdamW steps, except
for at most a thousandth of them, each within twice the learning rates
stepped so far (the rule of ``tests/test_torch_data_parallel.py``).  Those
few follow AdamW's normalisation: a weight moves by lr * m / (sqrt(v) +
eps), so where a gradient element is within a few eps of 0 its last bits
move the weight by a share of lr (measured: 1 of 14,336 elements of a
yi-34b leaf, 3.5e-6 off at lr 1e-3 after one step).  int8
steps start from the reference's state (int8 rounding turns the
frameworks' ~1e-6 gradient differences into whole quantization steps
where a value lies near a half-step): the loss rtol 1e-5; the error
feedback within one quantization step of its block everywhere, and
within a thousandth of one on all but a thousandth of the elements; the
weights rtol 1e-4, atol 1e-6 on all but a thousandth of the elements,
those within 2.5 lr (an AdamW step moves a weight by at most 1.17 lr
for b1 0.9, b2 0.95, whatever gradient one rounding changed).  Measured
on h2o-danube-3-4b (119,104 elements): at most 2 error-feedback elements
and 1 weight outside, that weight ~1 lr off after the first step, where
a gradient rounded to 0 in one package and to one step in the other;
none on granite-moe-1b or deepseek-moe-16b.  bf16 (dense configs only): the loss
within one bf16 rounding, rtol 2^-8; MoE configs are compared in f32 only,
since one bf16 rounding flips near-tied routing choices.

Two gloo ranks run in ONE module-scoped spawn (``torch.multiprocessing``,
``file://`` rendezvous, each join limited), as
``tests/test_torch_data_parallel.py`` does.  The card-against-host case is
marked ``gpu`` and skips here.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu case
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.data import synthetic as rsyn
    from repro.launch import cells as rcells
    from repro.models import layers as rL
    from repro.models import transformer as rT
    from repro.training import checkpoint as rck
    from repro.training import loop as rloop
    from repro.training import optimizer as ropt
except ImportError:
    jax = jnp = rconfigs = rsyn = rcells = rL = rT = rck = rloop = ropt = None
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

LM_ARCHS = ["h2o-danube-3-4b", "yi-34b", "granite-34b", "granite-moe-1b-a400m",
            "deepseek-moe-16b"]
DENSE_ARCHS, MOE_ARCHS = LM_ARCHS[:3], LM_ARCHS[3:]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL, EMBED_ATOL_OF_MAX = 1e-4, 1e-6, 1e-5
PARAM_RTOL, PARAM_ATOL, OUTLIER_SHARE = 1e-4, 1e-6, 1e-3
B, S = 4, 24  # S: neither a multiple of the chunk (16) nor of granite-moe's group (8)
SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
needs_ref = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def port_cfg(rcfg, **over):
    """The port's config for a reference ``TransformerConfig``."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(tT.TransformerConfig)
          if f.name != "dtype"}
    kw["dtype"] = getattr(torch, jnp.dtype(rcfg.dtype).name)
    kw.update(over)
    return tT.TransformerConfig(**kw)


def configs(arch, **over):
    """(reference config, port config) of the arch's reduced config."""
    rcfg = dataclasses.replace(rconfigs.get(arch).reduced_config(), **over)
    return rcfg, port_cfg(rcfg)


_INIT = {}


def ref_tree(rcfg, seed=0):
    """The reference's ``init_params(PRNGKey(seed))`` tree, as numpy
    (jitted: its eager init takes ~10 s an arch)."""
    key = (rcfg, seed)
    if key not in _INIT:
        tree = jax.jit(rT.init_params, static_argnums=1)(jax.random.PRNGKey(seed), rcfg)
        _INIT[key] = jax.tree_util.tree_map(np.asarray, tree)
    return _INIT[key]


def lm_batch(vocab, seed=1, batch=B, seq=S, masked=False):
    b = next(rsyn.lm_batches(vocab, batch, seq, seed=seed))
    if masked:  # half the tokens masked
        rng = np.random.default_rng(seed)
        b["mask"] = (rng.random((batch, seq)) < 0.5).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad_fn(rcfg):
    def loss(p, b):
        return rT.lm_loss(p, rcfg, b["tokens"], b["targets"], b.get("mask"))

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def ref_value_and_grad(tree, rcfg, batch):
    (loss, metrics), grads = _ref_value_and_grad_fn(rcfg)(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_value_and_grad(tree, tcfg, batch):
    model, state = tT.train_state_from_numpy({"params": tree}, tcfg, device="cpu")
    (loss, metrics), grads = tloop.value_and_grad(
        tT.loss_fn(model), state["params"], {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, ttree.to_numpy(grads)


def named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(got: dict, want):
    got, want = named(got), named(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        atol = EMBED_ATOL_OF_MAX * np.abs(w).max() if name == "['embed']" else GRAD_ATOL
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def assert_params_close(got: dict, want: dict, steps: int = 1, err="", bound=None):
    """The weights after ``steps`` steps on ``SCHED`` (module docstring);
    ``bound`` replaces twice the learning rates stepped as the bound of
    the few elements outside the tolerance."""
    assert got.keys() == want.keys()
    lr_sum = sum(float(topt.cosine_schedule(**SCHED)(n)) for n in range(1, steps + 1))
    bound = 2 * lr_sum if bound is None else bound
    outside, n, worst = 0, 0, 0.0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        outside += int((d > PARAM_ATOL + PARAM_RTOL * np.abs(w)).sum())
        n += d.size
        worst = max(worst, float(d.max()))
    assert outside <= OUTLIER_SHARE * n, (err, outside, n)
    assert worst <= bound, (err, worst, bound)


def block_steps(deq: np.ndarray, block: int = 256) -> np.ndarray:
    """Each element's int8 quantization step, from the dequantized values:
    a block's largest |value| quantizes to 127 exactly, so its step is
    that value / 127 (blocks of the flattened leaf, across a layer stack's
    layers, as both packages quantize it)."""
    flat = deq.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
    return np.repeat(np.abs(blocks).max(1) / 127, block)[: flat.size].reshape(deq.shape)


def seeing(opt):
    """``opt`` and a dict that holds the gradients its last ``update`` saw
    (after int8 compression, the dequantized ones)."""
    seen = {}

    def update(grads, state, params, **kw):
        seen["grads"] = grads
        return opt.update(grads, state, params, **kw)

    return topt.Optimizer(opt.init, update), seen


def assert_int8_step_close(tp, ts, deq, rp, rs, lr, err=""):
    """One int8 step's output against the reference's (module docstring):
    the error feedback within one quantization step of its block, and
    within a thousandth of one on all but ``OUTLIER_SHARE`` of the
    elements; the weights as :func:`assert_params_close`, the few outside
    within 2.5 lr."""
    deq, got_ef, want_ef = named(ttree.to_numpy(deq)), named(ttree.to_numpy(ts["ef"])), named(rs["ef"])
    assert got_ef.keys() == want_ef.keys() == deq.keys()
    far, n = 0, 0
    for name, w in want_ef.items():
        q = block_steps(deq[name])
        off = np.abs(got_ef[name] - w)
        assert (off <= 1.01 * q).all(), (err, name)
        far += int((off > 1e-3 * q).sum())
        n += off.size
    assert far <= OUTLIER_SHARE * n, (err, far, n)
    assert_params_close(named(ttree.to_numpy(tp)), named(rp), err=err, bound=2.5 * lr)


class PortRoutes:
    """Records the expert ids and keep masks of the port's MoE layers in
    the forward pass (``moe_route``; a remat recomputation in the backward
    pass calls it again, after the forward's calls)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = tT.moe_route

        def spy(router, xg, cfg, cap):
            out = orig(router, xg, cfg, cap)
            self.calls.append((out[2].numpy(), out[4].numpy()))
            return out

        monkeypatch.setattr(tT, "moe_route", spy)


def ref_routes(tree, rcfg, tokens):
    """Each reference MoE layer's expert ids and keep masks for ``tokens``,
    from its own layer functions run layer by layer (``forward`` scans)."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    pos = jnp.arange(tokens.shape[1], dtype=jnp.int32)[None, :]
    h = params["embed"].astype(rcfg.dtype)[jnp.asarray(tokens)]
    out = []
    for stack, moe in (("dense_layers", False), ("moe_layers", True)):
        if stack not in params:
            continue
        n = jax.tree_util.tree_leaves(params[stack])[0].shape[0]
        for i in range(n):
            lp = jax.tree_util.tree_map(lambda a: a[i], params[stack])
            if moe:
                x1 = rL.rmsnorm(lp["ln1"], h)
                hh = h + rT.attention_block(lp["attn"], x1, rcfg, pos).astype(h.dtype)
                out.append(_ref_routing(lp["moe"]["router"], rL.rmsnorm(lp["ln2"], hh), rcfg))
            h, _ = rT.layer_apply(lp, h, rcfg, pos, moe)
    return out


def _ref_routing(router, x, rcfg):
    """The reference ``moe_einsum``'s expert ids and keep masks for x (B, S, d)."""
    Bn, Sn, d = x.shape
    g = min(rcfg.moe_group, Sn)
    ng = -(-Sn // g)
    xg = jnp.pad(x, ((0, 0), (0, ng * g - Sn), (0, 0))).reshape(Bn * ng, g, d)
    cap = max(int(np.ceil(g * rcfg.top_k * rcfg.capacity_factor / rcfg.n_experts)), 1)
    probs = jax.nn.softmax(jnp.einsum("Ngd,de->Nge", xg.astype(jnp.float32), router), -1)
    _, ids = jax.lax.top_k(probs, rcfg.top_k)
    counts = jnp.zeros((xg.shape[0], rcfg.n_experts), jnp.int32)
    keep = []
    for j in range(rcfg.top_k):
        oh = jax.nn.one_hot(ids[:, :, j], rcfg.n_experts, dtype=jnp.int32)
        pos = jnp.cumsum(oh, axis=1) - oh + counts[:, None, :]
        keep.append((pos * oh).sum(-1) < cap)
        counts = counts + oh.sum(axis=1)
    return np.asarray(ids), np.asarray(jnp.stack(keep, -1))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("vocab", [131, 256])
def test_lm_batches_equal_reference(vocab):
    want, got = rsyn.lm_batches(vocab, 5, 16, seed=3), tsyn.lm_batches(vocab, 5, 16, seed=3)
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g) == {"tokens", "targets"}
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------
@needs_ref
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, masked, monkeypatch):
    rcfg, tcfg = configs(arch)
    tree = ref_tree(rcfg)
    batch = lm_batch(rcfg.vocab, masked=masked)
    routes = PortRoutes(monkeypatch)
    got_loss, got_m, got_g = port_value_and_grad(tree, tcfg, batch)
    if rcfg.n_experts:  # equal routing first, then the gradients on it
        want_routes = ref_routes(tree, rcfg, batch["tokens"])
        assert len(want_routes) == tcfg.n_moe_layers and len(routes.calls) >= len(want_routes)
        for (gi, gk), (wi, wk) in zip(routes.calls, want_routes):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gk, wk)
        assert got_m["aux"] > 0
    else:
        assert got_m["aux"] == 0
    want_loss, want_m, want_g = ref_value_and_grad(tree, rcfg, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    assert_grads_close(got_g, want_g)
    if rcfg.n_experts:  # the router and every expert trained
        for name in ("router", "wi", "wg", "wo"):
            assert np.abs(got_g["moe_layers"]["moe"][name]).max() > 0, name


@needs_ref
@pytest.mark.parametrize("arch", ["yi-34b", "granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_remat_changes_no_loss_or_gradient(arch):
    rcfg, tcfg = configs(arch)
    assert tcfg.remat
    tree = ref_tree(rcfg)
    batch = lm_batch(rcfg.vocab, masked=True)
    loss_on, m_on, g_on = port_value_and_grad(tree, tcfg, batch)
    loss_off, m_off, g_off = port_value_and_grad(tree, dataclasses.replace(tcfg, remat=False), batch)
    assert (loss_on, m_on) == (loss_off, m_off)
    for a, b in zip(jax.tree_util.tree_leaves(g_on), jax.tree_util.tree_leaves(g_off)):
        np.testing.assert_array_equal(a, b)


@needs_ref
@pytest.mark.parametrize("arch,over", [("granite-moe-1b-a400m", {}),
                                       ("yi-34b", {"vocab": 61})], ids=["granite-moe", "yi-61"])
def test_padded_vocab_gets_no_gradient(arch, over):
    """The padded head columns and embedding rows (vocab 131 -> 132, 61 ->
    64) get zero gradient, the loss ignores the padded logits, and the
    gradients equal the reference's."""
    rcfg, tcfg = configs(arch, **over)
    assert tcfg.padded_vocab > tcfg.vocab
    tree = ref_tree(rcfg)
    batch = lm_batch(rcfg.vocab)
    loss, _, g = port_value_and_grad(tree, tcfg, batch)
    assert np.isfinite(loss)
    assert not g["lm_head"][:, tcfg.vocab:].any() and not g["embed"][tcfg.vocab:].any()
    assert np.abs(g["lm_head"][:, : tcfg.vocab]).max() > 0
    _, _, want = ref_value_and_grad(tree, rcfg, batch)
    assert_grads_close(g, want)


@needs_ref
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_loss_tracks_reference(arch):
    """The dense configs in bf16 (the full configs' compute dtype, f32
    weights cast in the graph): the loss within one bf16 rounding, and a
    gradient on every weight the reference's reaches."""
    rcfg, tcfg = configs(arch, dtype=jnp.bfloat16)
    tree = ref_tree(configs(arch)[0])
    batch = lm_batch(rcfg.vocab, masked=True)
    got_loss, got_m, got_g = port_value_and_grad(tree, tcfg, batch)
    want_loss, want_m, want_g = ref_value_and_grad(tree, rcfg, batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2**-8)
    np.testing.assert_allclose(got_m["nll"], want_m["nll"], rtol=2**-8)
    got, want = named(got_g), named(want_g)
    for name, w in want.items():
        assert (got[name] != 0).sum() >= 0.99 * (np.asarray(w) != 0).sum(), name


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------
def _opts():
    return (ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(**SCHED))),
            topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**SCHED))))


@functools.lru_cache(maxsize=None)
def _ref_step(rcfg, n_micro, compression):
    r_opt, _ = _opts()
    return jax.jit(rloop.make_train_step(
        lambda p, b: rT.lm_loss(p, rcfg, b["tokens"], b["targets"]), r_opt, n_micro=n_micro,
        compression=compression))


def _ref_init_state(tree, compression=None):
    r_opt, _ = _opts()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return params, rloop.init_opt_state(r_opt, params, compression)


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_steps_match_reference(arch):
    """Three AdamW steps with 2 microbatches from one state."""
    rcfg, tcfg = configs(arch)
    tree = ref_tree(rcfg)
    rp, rs = _ref_init_state(tree)
    r_step = _ref_step(rcfg, 2, None)
    model, state = tT.train_state_from_numpy(
        {"params": tree, "opt": jax.tree_util.tree_map(np.asarray, rs)}, tcfg, device="cpu")
    t_step = tloop.make_train_step(tT.loss_fn(model), _opts()[1], n_micro=2)
    tp, ts = state["params"], state["opt"]
    for i in range(3):
        b = lm_batch(rcfg.vocab, seed=10 + i)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(tp, ts, b)
        assert set(tm) == set(rm) and int(tm["step"]) == int(rm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
        assert_params_close(named(ttree.to_numpy(tp)), named(rp), i + 1, f"step {i}")


@needs_ref
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-1b-a400m"])
def test_int8_train_steps_match_reference(arch):
    """int8 compression with error feedback, two steps, each from the
    reference's state carried over anew (module docstring)."""
    rcfg, tcfg = configs(arch)
    rp, rs = _ref_init_state(ref_tree(rcfg), "int8")
    r_step = _ref_step(rcfg, 1, "int8")
    for i in range(2):
        b = lm_batch(rcfg.vocab, seed=20 + i)
        model, state = tT.train_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, {"params": rp, "opt": rs}), tcfg, device="cpu")
        opt, seen = seeing(_opts()[1])
        t_step = tloop.make_train_step(tT.loss_fn(model), opt, compression="int8")
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(state["params"], state["opt"], b)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
        lr = float(topt.cosine_schedule(**SCHED)(i + 1))
        assert_int8_step_close(tp, ts, seen["grads"], rp, rs, lr, f"step {i}")
        assert np.abs(ttree.to_numpy(ts["ef"])["lm_head"]).max() > 0


def test_donated_step_equals_the_functional_step():
    """``donate=True`` writes the moments and the parameters in place and
    gives the functional step's bits (the optimizer's update in groups of
    leaves, ``GROUP_ELEMS``, shrunk here so that the tree spans several)."""
    cfg = tconfigs.get("deepseek-moe-16b").reduced_config()
    model = tT.init_params(cfg, torch.Generator().manual_seed(3), "cpu", head=True)
    b = next(tsyn.lm_batches(cfg.vocab, 4, 16, seed=5))
    opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**SCHED)))
    out = {}
    for donate in (False, True):
        params = ttree.tree_map(lambda t: t.clone(), tT.train_params(model))
        state = tloop.init_opt_state(opt, params)
        step = tloop.make_train_step(tT.loss_fn(model), opt, n_micro=2, donate=donate)
        for _ in range(2):
            new_p, new_s, m = step(params, state, b)
            assert (new_p is params) == donate
            params, state = new_p, new_s
        out[donate] = (params, state, float(m["loss"]))
    groups = topt.GROUP_ELEMS
    try:
        topt.GROUP_ELEMS = 4096
        assert len(topt._groups(ttree.leaves(out[True][0]))) > 3
        params = ttree.tree_map(lambda t: t.clone(), tT.train_params(model))
        state = tloop.init_opt_state(opt, params)
        step = tloop.make_train_step(tT.loss_fn(model), opt, n_micro=2)
        for _ in range(2):
            params, state, m = step(params, state, b)
        out["grouped"] = (params, state, float(m["loss"]))
    finally:
        topt.GROUP_ELEMS = groups
    for case in (True, "grouped"):
        assert out[case][2] == out[False][2]
        pair = lambda o: ttree.leaves({"params": o[0], "opt": o[1]})  # noqa: E731
        for a, w in zip(pair(out[case]), pair(out[False])):
            assert torch.equal(a, w), case


@needs_ref
def test_loss_falls_over_twenty_steps():
    """The counterpart of the reference's ``test_lm_loss_decreases_with_
    training``: one fixed batch, AdamW at a constant 3e-3, 20 steps; the
    port's losses track the reference's and fall below 0.7 of the first."""
    rcfg, tcfg = configs("granite-moe-1b-a400m")
    tree = ref_tree(rcfg)
    b = lm_batch(rcfg.vocab, seed=4, batch=8, seq=16)
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.constant_schedule(3e-3)))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.constant_schedule(3e-3)))
    r_step = jax.jit(rloop.make_train_step(
        lambda p, bb: rT.lm_loss(p, rcfg, bb["tokens"], bb["targets"]), r_opt))
    model, state = tT.train_state_from_numpy({"params": tree}, tcfg, device="cpu")
    t_step = tloop.make_train_step(tT.loss_fn(model), t_opt)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs, tp = r_opt.init(rp), state["params"]
    ts = t_opt.init(tp)
    got, want = [], []
    for _ in range(20):
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(tp, ts, b)
        got.append(float(tm["loss"]))
        want.append(float(rm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < 0.7 * got[0], got


# --------------------------------------------------------------------------
# the train cells and launch.train
# --------------------------------------------------------------------------
_REF_INIT = rT.init_params if rT is not None else None


@functools.lru_cache(maxsize=None)
def _jitted_init(cfg):
    return jax.jit(_REF_INIT, static_argnums=1)(jax.random.PRNGKey(0), cfg)


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_cell_matches_reference(arch, monkeypatch):
    """``build_cell(arch, "train_4k")`` in smoke mode: the reference's batch
    and model FLOPs; its step on the reference's weights (its cell draws
    them with ``init_params``, memoized and jitted here) equals the
    reference cell's step."""
    monkeypatch.setattr(rT, "init_params", lambda key, cfg: _jitted_init(cfg))
    want = rcells.build_cell(arch, "train_4k", mode="smoke")
    got = tcells.build_cell(arch, "train_4k", device="cpu")
    assert (got.arch, got.cell, got.kind) == (want.arch, want.cell, want.kind) == (
        arch, "train_4k", "train")
    assert got.model_flops == want.model_flops
    rp, rs, rb = want.args
    tp, ts, tb = got.args
    assert set(tb) == set(rb)
    for k in rb:
        assert tb[k].dtype == torch.int32
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(rb[k]), err_msg=k)
    rcfg = rconfigs.get(arch).reduced_config()
    _, state = tT.train_state_from_numpy({"params": jax.tree_util.tree_map(np.asarray, rp)},
                                         port_cfg(rcfg), device="cpu")
    assert all(a.shape == b.shape for a, b in zip(ttree.leaves(state["params"]), ttree.leaves(tp)))
    rp2, _, rm = jax.jit(want.fn)(rp, rs, rb)
    tp2, ts2, tm = got.fn(state["params"], ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    assert_params_close(named(ttree.to_numpy(tp2)), named(rp2))
    assert int(ts2["step"]) == 1


@needs_ref
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_launch_train_trains_each_lm_arch_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <lm id> --reduced
    --device cpu --steps 3``, in-process: the reference's three lines, its
    parameter count, finite losses, a final checkpoint."""
    out = ttrain.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                      "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        ref_tree(rconfigs.get(arch).reduced_config())))
    assert lines[0] == f"arch={arch} params={n_ref:,} steps=3"
    assert lines[1].startswith("done: 3 steps in ") and "restarts=0, stragglers=0" in lines[1]
    assert lines[2] == f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}"
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003"]
    assert out["cfg"].dtype == torch.float32 and "lm_head" in out["state"]["params"]


def test_launch_train_refuses_the_families_it_lacks(tmp_path):
    """The recsys family trains (ROADMAP Queue 1 item 9); the GNN family is
    refused as the reference's ``data_for`` refuses it."""
    out = ttrain.run(["--arch", "xdeepfm", "--reduced", "--device", "cpu", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError, match="use examples/ for family gnn"):
        ttrain.data_for(None, 4, "gnn", torch.device("cpu"))


def test_full_lm_configs_train_in_f32(monkeypatch):
    """A full LM config trains in float32 (the reference's launch.train casts its
    compute dtype), a reduced one as it is."""
    seen = []
    monkeypatch.setattr(ttrain, "_train", lambda args, cfg, family, dev, mesh: seen.append(cfg))
    ttrain.run(["--arch", "granite-moe-1b-a400m", "--device", "cpu"])
    ttrain.run(["--arch", "granite-moe-1b-a400m", "--device", "cpu", "--reduced"])
    assert seen[0].dtype == torch.float32 and seen[0].d_model == 1024
    assert seen[1] == tconfigs.get("granite-moe-1b-a400m").reduced_config()


# --------------------------------------------------------------------------
# two gloo ranks over the data mesh
# --------------------------------------------------------------------------
DP_ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
WORLD, DP_STEPS, DP_B = 2, 3, 4
JOIN_TIMEOUT_S = 240


def _t_opt():
    return topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**SCHED)))


def _flat(tree) -> dict:
    return named(ttree.to_numpy(tree))


def _rank_main(rank, tmp, inputs):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    try:
        mesh = tmesh.make_production_mesh(device="cpu")
        assert mesh.shape == {"data": WORLD, "model": 1} and mesh.rank == rank
        out = {}
        for arch, (tree, batches, lb) in inputs.items():
            model, state = tT.train_state_from_numpy({"params": tree},
                                                     tconfigs.get(arch).reduced_config(), "cpu")
            with sharding.use_mesh(mesh):
                with torch.no_grad():  # this rank's share of the global batch's loss
                    loss, m = tT.lm_loss(model, lb["tokens"], lb["targets"], lb["mask"])
                out.update({f"{arch}/share/loss": float(loss), f"{arch}/share/nll": float(m["nll"]),
                            f"{arch}/share/aux": float(m["aux"])})
                opt = _t_opt()
                step = tloop.make_train_step(tT.loss_fn(model), opt, n_micro=2)
                p, o = state["params"], tloop.init_opt_state(opt, state["params"])
                for i, b in enumerate(batches):
                    p, o, mm = step(p, o, b)
                    tloop.assert_replicas_agree(p, mesh)
                    out[f"{arch}/loss/{i}"] = float(mm["loss"])
                    out.update({f"{arch}/params/{i}/{k}": v for k, v in _flat(p).items()})
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    if jax is None:
        pytest.skip("needs the JAX reference")
    tmp = str(tmp_path_factory.mktemp("lm_dp"))
    inputs = {}
    for arch in DP_ARCHS:
        rcfg = configs(arch)[0]
        inputs[arch] = (ref_tree(rcfg, seed=2),
                        [lm_batch(rcfg.vocab, seed=30 + i, batch=DP_B) for i in range(DP_STEPS)],
                        lm_batch(rcfg.vocab, seed=40, batch=DP_B, masked=True))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, inputs)) for r in range(WORLD)]
    for p in procs:
        p.start()
    ref = {}
    try:  # the reference runs while the ranks do
        for arch, (tree, batches, lb) in inputs.items():
            rcfg = configs(arch)[0]
            loss, m = jax.jit(lambda p, b: rT.lm_loss(p, rcfg, b["tokens"], b["targets"], b["mask"]))(
                jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in lb.items()})
            ref[f"{arch}/loss"] = (float(loss), float(m["nll"]), float(m["aux"]))
            rp, rs = _ref_init_state(tree)
            r_step = _ref_step(rcfg, 2, None)
            for i, b in enumerate(batches):
                rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
                ref[f"{arch}/step/{i}"] = (float(rm["loss"]), named(rp))
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    assert not alive, f"rank(s) still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]
    return dict(ref=ref, ranks=ranks)


@needs_ref
@pytest.mark.parametrize("arch", DP_ARCHS)
def test_two_ranks_shares_sum_to_the_reference_global_loss(dp_runs, arch):
    """Each rank's ``lm_loss`` on half the rows of a masked global batch:
    the shares of the loss, the nll and the aux (counts all-reduced, a
    product of two global means) sum to the reference's global values."""
    want = dp_runs["ref"][f"{arch}/loss"]
    shares = [[float(r[f"{arch}/share/{k}"]) for k in ("loss", "nll", "aux")]
              for r in dp_runs["ranks"]]
    got = np.sum(shares, axis=0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert want[2] > 0 and min(s[2] for s in shares) > 0


@needs_ref
@pytest.mark.parametrize("arch", DP_ARCHS)
def test_two_ranks_take_the_reference_global_batch_step(dp_runs, arch):
    got = dp_runs["ranks"][0]
    for i in range(DP_STEPS):
        want_loss, want_params = dp_runs["ref"][f"{arch}/step/{i}"]
        np.testing.assert_allclose(float(got[f"{arch}/loss/{i}"]), want_loss, rtol=LOSS_RTOL)
        pre = f"{arch}/params/{i}/"
        params = {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}
        assert_params_close(params, want_params, i + 1, f"step {i}")


@needs_ref
def test_lm_replicas_stay_bit_identical(dp_runs):
    a, b = dp_runs["ranks"]
    assert a.keys() == b.keys()
    for key in a:
        if "/share/" not in key:  # each rank's loss share is its own
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_lm_state():
    """The reference's deepseek-moe (reduced) training state after two int8
    steps (params, mu, nu, step and ef all nonzero), as numpy."""
    if jax is None:
        pytest.skip("needs the JAX reference")
    rcfg = configs("deepseek-moe-16b")[0]
    params, state = _ref_init_state(ref_tree(rcfg, seed=1), "int8")
    step = _ref_step(rcfg, 1, "int8")
    for i in range(2):
        b = lm_batch(rcfg.vocab, seed=50 + i)
        params, state, _ = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
    return rcfg, jax.tree_util.tree_map(np.array, {"params": params, "opt": state})


@needs_ref
def test_reference_lm_checkpoint_restores_into_the_port_and_steps_on(ref_lm_state, tmp_path):
    rcfg, state = ref_lm_state
    rck.save(str(tmp_path), 2, state)
    model, template = tT.train_state_from_numpy(jax.tree_util.tree_map(np.zeros_like, state),
                                                port_cfg(rcfg), device="cpu")
    got, step = tck.restore(str(tmp_path), template)
    assert step == 2 and isinstance(got["params"]["moe_layers"]["moe"]["router"], list)
    got_np, want_np = named(ttree.to_numpy(got)), named(state)
    assert got_np.keys() == want_np.keys()
    for k, w in want_np.items():
        assert got_np[k].dtype == w.dtype
        np.testing.assert_array_equal(got_np[k], w, err_msg=k)
    b = lm_batch(rcfg.vocab, seed=52)
    rp, rs, rm = _ref_step(rcfg, 1, "int8")(*jax.tree_util.tree_map(
        jnp.asarray, (state["params"], state["opt"])), {k: jnp.asarray(v) for k, v in b.items()})
    opt, seen = seeing(_t_opt())
    t_step = tloop.make_train_step(tT.loss_fn(model), opt, compression="int8")
    tp, ts, tm = t_step(got["params"], got["opt"], b)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    lr = float(topt.cosine_schedule(**SCHED)(3))
    assert_int8_step_close(tp, ts, seen["grads"], rp, rs, lr)
    assert int(ts["step"]) == 3


@needs_ref
def test_port_lm_checkpoint_restores_into_the_reference(ref_lm_state, tmp_path):
    rcfg, state = ref_lm_state
    _, port_state = tT.train_state_from_numpy(state, port_cfg(rcfg), device="cpu")
    tck.save(str(tmp_path), 7, port_state)
    got, step = rck.restore(str(tmp_path), jax.tree_util.tree_map(np.zeros_like, state))
    assert step == 7
    for k, w in named(state).items():
        np.testing.assert_array_equal(named(got)[k], w, err_msg=k)


# --------------------------------------------------------------------------
# on the card: a reduced step equals the host's
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares a step on the card with the host's")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_step_on_the_card_equals_the_host(cuda, arch):
    """One AdamW step with 2 microbatches (f32) on the card and on the host
    from the same weights and batch: the losses rtol 1e-5, the parameters
    rtol 1e-4 and atol 1e-6 but for a thousandth of them, each within 2 lr
    (the card's MoE backward sums with atomics, in no fixed order)."""
    cfg = tconfigs.get(arch).reduced_config()
    tree = tT.init_params(cfg, torch.Generator().manual_seed(0), "cpu", head=True).numpy_params()
    b = next(tsyn.lm_batches(cfg.vocab, B, S, seed=1))
    out = {}
    for dev in ("cpu", cuda):
        model, state = tT.train_state_from_numpy({"params": tree}, cfg, dev)
        opt = _t_opt()
        step = tloop.make_train_step(tT.loss_fn(model), opt, n_micro=2)
        p, _, m = step(state["params"], tloop.init_opt_state(opt, state["params"]), b)
        out[str(dev)] = (float(m["loss"]), ttree.leaves(ttree.to_numpy(p)))
    (cpu_loss, cpu_p), (card_loss, card_p) = out["cpu"], out[str(cuda)]
    assert np.isfinite(card_loss)
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=LOSS_RTOL)
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(card_p, cpu_p)])
    w = np.concatenate([np.abs(x).ravel() for x in cpu_p])
    assert (d > PARAM_ATOL + PARAM_RTOL * w).sum() <= OUTLIER_SHARE * d.size
    assert d.max() <= 2 * float(topt.cosine_schedule(**SCHED)(1))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_train_mesh_single_trains_an_moe_lm_over_two_ranks(tmp_path):
    """``launch.train --mesh single`` for deepseek-moe-16b (reduced) over
    two processes with torchrun's variables: rank 0 alone prints, and the
    loss line is the one-process run's (the same global batches; the aux's
    counts summed over the ranks)."""
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    args = ["--arch", "deepseek-moe-16b", "--reduced", "--steps", "3", "--device", "cpu",
            "--n-micro", "2"]
    base = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh", "single",
         "--ckpt-dir", str(tmp_path / "dp")],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--ckpt-dir", str(tmp_path / "one")],
                         env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=240)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert one.returncode == 0, one.stderr[-2000:]
    lead = outs[0][0].strip().splitlines()
    assert lead[0].endswith("steps=3 mesh={'data': 2, 'model': 1}"), lead
    assert outs[1][0].strip() == ""
    assert lead[2] == one.stdout.strip().splitlines()[2]
