"""Tensor and expert parallelism for the LM family (the ``"model"`` mesh
axis) against the reference on one device.

Gloo ranks are spawned once a mesh shape (``torch.multiprocessing``,
``file://`` rendezvous, each join limited to JOIN_S), one after another:
1 x 2, 2 x 2 and 1 x 4 ``("data", "model")`` meshes of one host process a
rank.  Each rank takes the reference's reduced ``init_params`` trees of the
five LM archs as numpy, keeps its piece of each leaf, and runs prefill, 16
decode steps (h2o: 24, so its 16-slot ring turns over; on 1 x 4 its two
KV heads do not divide the axis and the ring is sequence-sharded), the
loss and its gradients, three AdamW steps with clipping, and a checkpoint;
the ranks gather logits, caches, gradients and weights whole and write
them to an ``.npz``.  The parent runs the reference meanwhile (``jit`` of
``prefill``, ``decode_step``, ``value_and_grad(lm_loss)`` and
``make_train_step``) on the same numpy inputs.

Tolerances, in f32, rtol 1e-5 (XLA and PyTorch sum in other orders,
and the ranks' partial sums add one more order): logits, caches, the
loss, nll and aux; gradients with atol 1e-6, the embedding's atol 1e-5
of its largest magnitude (an f32 sum rounds at the size of its largest
terms, and an embedding row's gradient sums every occurrence of its
token); weights after the steps with atol 1e-6 on all but a thousandth
of the elements, those within twice the learning rates stepped (AdamW
moves a weight by lr * m / (sqrt(v) + eps), so where a gradient element
is within a few eps of 0 its last bits move the weight by a share of lr;
``tests/test_torch_lm_train.py`` holds the one-process port so).  MoE
gradients are compared on equal routing: every MoE layer's expert ids
and keep masks are asserted equal to the reference's first.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch.multiprocessing as mp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.distributed import sharding as rshard  # noqa: E402
from repro.models import layers as rL  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

ARCHS = ["h2o-danube-3-4b", "yi-34b", "granite-34b", "granite-moe-1b-a400m", "deepseek-moe-16b"]
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}  # (data, model)
PREFILL = (2, 16)  # B, S
DECODE_B, DECODE_STEPS, RING_STEPS = 2, 16, 24  # h2o decodes RING_STEPS
#: caches of other sizes, decoded from slot 0: a model without a window
#: fills them, h2o's ring turns over in ODD_RING_STEPS.  granite-34b's one
#: KV head splits 10 slots into runs of 5 over a model extent of 2, and 12
#: into runs of 3 over 4 (odd runs); 10 does not divide 4 and stays whole
ODD_ARCHS, ODD_SLOTS, ODD_RING_STEPS = ("granite-34b", "h2o-danube-3-4b"), (10, 12), 16
LOSS_B, LOSS_S = 4, 24  # the batch splits over data 2
TRAIN_STEPS, CLIP = 3, 0.5
SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL, EMBED_ATOL_OF_MAX = 1e-5, 1e-6, 1e-5
PARAM_RTOL, PARAM_ATOL, OUTLIER_SHARE = 1e-5, 1e-6, 1e-3
JOIN_S = 240
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def steps_of(arch):
    return RING_STEPS if arch == "h2o-danube-3-4b" else DECODE_STEPS


def odd_steps(arch, slots):
    return ODD_RING_STEPS if arch == "h2o-danube-3-4b" else slots


def named(tree, pre="") -> dict:
    """A numpy tree's leaves by their path, ``a/b/c``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(named(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.array(v)  # a copy: a host tensor's numpy() shares its memory
    return out


def _opt(mod):
    return mod.adamw(mod.AdamWConfig(schedule=mod.cosine_schedule(**SCHED), clip_norm=CLIP))


def inputs_of(arch) -> dict:
    """The arch's reference tree (``init_params(PRNGKey(0))``, jitted) and
    the numpy inputs every rank and the reference take."""
    rcfg = rconfigs.get(arch).reduced_config()
    tree = jax.tree_util.tree_map(
        np.asarray, jax.jit(rT.init_params, static_argnums=1)(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(7)
    loss_b = next(rsyn.lm_batches(rcfg.vocab, LOSS_B, LOSS_S, seed=11))
    loss_b["mask"] = (rng.random((LOSS_B, LOSS_S)) < 0.5).astype(np.float32)
    return dict(
        tree=tree,
        prefill=rng.integers(0, rcfg.vocab, PREFILL).astype(np.int32),
        decode=rng.integers(0, rcfg.vocab, (DECODE_B, steps_of(arch))).astype(np.int32),
        loss=loss_b,
        train=[next(rsyn.lm_batches(rcfg.vocab, LOSS_B, LOSS_S, seed=20 + i))
               for i in range(TRAIN_STEPS)])


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _rank_main(rank, tmp, data, model, inputs):
    torch.set_num_threads(1)
    world = data * model
    tmesh.init_distributed(f"file://{tmp}/rendezvous", world, rank, backend="gloo")
    try:
        mesh = tmesh.make_production_mesh(device="cpu", model=model)
        out = {"coords": np.array([mesh.coords()["data"], mesh.coords()["model"],
                                   tmesh.axis_index(mesh, "model"), mesh.sub("model").rank,
                                   mesh.sub("data").rank])}
        routes = []
        orig = tT.moe_route

        def spy(router, xg, cfg, cap):
            res = orig(router, xg, cfg, cap)
            routes.append((res[2].numpy(), res[4].numpy()))
            return res

        tT.moe_route = spy
        with sharding.use_mesh(mesh):
            for arch, x in inputs.items():
                _rank_arch(arch, x, mesh, rank, tmp, out, routes)
            refused = []
            with sharding.use_mesh(mesh, sharding.ZERO3_RULES):
                try:
                    tcol.init_params(tconfigs.get("plaid-colbertv2").reduced_config(),
                                     torch.Generator().manual_seed(0), device="cpu")
                except NotImplementedError as e:
                    refused.append(str(e))
            out["refusals"] = np.array(json.dumps(refused))
        x = torch.randn(1000, generator=torch.Generator().manual_seed(rank))
        out["psum_in"], out["psum"] = x.numpy(), tcomp.compressed_psum(x, mesh).numpy()
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _rank_arch(arch, x, mesh, rank, tmp, out, routes):
    cfg = tconfigs.get(arch).reduced_config()
    data_sub = mesh.sub("data")
    model = tT.params_from_numpy(x["tree"], cfg, "cpu")
    place = model.placement_tree()
    out[f"{arch}/specs"] = np.array(json.dumps({n: p.spec for n, p in model.placements.items()}))
    out[f"{arch}/prefill"] = tT.prefill(model, torch.from_numpy(x["prefill"])).numpy()
    steps = x["decode"].shape[1]
    cache = tT.init_cache(cfg, DECODE_B, DECODE_STEPS, "cpu")
    out[f"{arch}/cache_local"] = np.array(cache["k"].shape)
    for t in range(steps):
        logits, cache = tT.decode_step(model, cache, torch.from_numpy(x["decode"][:, t]), t)
        whole = tT.gather_cache(model, cache)
        out[f"{arch}/decode/{t}"] = logits.numpy()
        out[f"{arch}/k/{t}"], out[f"{arch}/v/{t}"] = whole["k"].numpy(), whole["v"].numpy()
    for slots in ODD_SLOTS if arch in ODD_ARCHS else ():
        key = f"{arch}/odd{slots}"
        cache = tT.init_cache(cfg, DECODE_B, slots, "cpu")
        out[f"{key}/local"] = np.array(cache["k"].shape)
        try:  # a piece without its whole slot count
            tT.decode_step(model, {n: c.clone() for n, c in cache.items()},
                           torch.from_numpy(x["decode"][:, 0]), 0)
            out[f"{key}/plain_dict"] = np.array("decoded")
        except ValueError as e:
            out[f"{key}/plain_dict"] = np.array(str(e))
        for t in range(odd_steps(arch, slots)):
            logits, cache = tT.decode_step(model, cache, torch.from_numpy(x["decode"][:, t]), t)
            out[f"{key}/decode/{t}"] = logits.numpy()
        whole = tT.gather_cache(model, cache)
        out[f"{key}/k"], out[f"{key}/v"] = whole["k"].numpy(), whole["v"].numpy()

    # the loss and its gradients: this rank's rows' share, summed over data
    model, state = tT.train_state_from_numpy({"params": x["tree"]}, cfg, "cpu")
    del routes[:]
    (loss, m), grads = tloop.value_and_grad(
        tT.loss_fn(model), state["params"], {k: torch.from_numpy(v) for k, v in x["loss"].items()})
    n_moe = cfg.n_moe_layers
    for i, (ids, keep) in enumerate(routes[:n_moe]):  # the forward's calls
        out[f"{arch}/ids/{i}"], out[f"{arch}/keep/{i}"] = ids, keep
    shares = torch.stack([loss, m["nll"], m["aux"]])
    out[f"{arch}/loss"] = tmesh.all_reduce_sum(data_sub, shares).numpy()
    grads = sharding.gather_tree(grads, place)
    for k, v in named(ttree.to_numpy(grads)).items():
        out[f"{arch}/grad/{k}"] = tmesh.all_reduce_sum(data_sub, torch.from_numpy(v)).numpy()

    # three AdamW steps with clipping; replicas checked after each
    opt = _opt(topt)
    step = tloop.make_train_step(tT.loss_fn(model), opt, param_axes=tT.param_axes(cfg, True),
                                 placements=place, donate=True)
    p, o = state["params"], tloop.init_opt_state(opt, state["params"])
    for i, b in enumerate(x["train"]):
        p, o, mm = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
        tloop.assert_replicas_agree(p, mesh, place)
        out[f"{arch}/step_loss/{i}"] = np.array(float(mm["loss"]))
        for k, v in named(ttree.to_numpy(sharding.gather_tree(p, place))).items():
            out[f"{arch}/params/{i}/{k}"] = v

    # a checkpoint of the state: gathered by all, written by rank 0, restored
    # by every rank into its pieces
    state = {"params": p, "opt": o}
    splace = tT.state_placements(model, state)
    whole = tck.gather(state, splace)
    ckpt = f"{tmp}/ckpt/{arch}"
    if rank == 0:
        tck.save(ckpt, TRAIN_STEPS, whole)
    torch.distributed.barrier()
    back, at = tck.restore(ckpt, state, shardings=splace)
    out[f"{arch}/restored_equal"] = np.array(at == TRAIN_STEPS and all(
        torch.equal(a, b) for a, b in zip(ttree.leaves(back), ttree.leaves(state))))


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------
def _ref_routes(params, rcfg, tokens):
    """Each reference MoE layer's expert ids and keep masks for ``tokens``
    (B, S), from its layer functions run one by one."""
    pos = jnp.arange(tokens.shape[1], dtype=jnp.int32)[None, :]
    h = params["embed"].astype(rcfg.dtype)[jnp.asarray(tokens)]
    out = []
    for stack, moe in (("dense_layers", False), ("moe_layers", True)):
        if stack not in params:
            continue
        for i in range(jax.tree_util.tree_leaves(params[stack])[0].shape[0]):
            lp = jax.tree_util.tree_map(lambda a: a[i], params[stack])
            if moe:
                hh = h + rT.attention_block(lp["attn"], rL.rmsnorm(lp["ln1"], h), rcfg,
                                            pos).astype(h.dtype)
                x = rL.rmsnorm(lp["ln2"], hh)
                Bn, Sn, d = x.shape
                g = min(rcfg.moe_group, Sn)
                ng = -(-Sn // g)
                xg = jnp.pad(x, ((0, 0), (0, ng * g - Sn), (0, 0))).reshape(Bn * ng, g, d)
                cap = max(int(np.ceil(g * rcfg.top_k * rcfg.capacity_factor / rcfg.n_experts)), 1)
                probs = jax.nn.softmax(jnp.einsum("Ngd,de->Nge", xg.astype(jnp.float32),
                                                  lp["moe"]["router"]), -1)
                _, ids = jax.lax.top_k(probs, rcfg.top_k)
                counts = jnp.zeros((xg.shape[0], rcfg.n_experts), jnp.int32)
                keep = []
                for j in range(rcfg.top_k):
                    oh = jax.nn.one_hot(ids[:, :, j], rcfg.n_experts, dtype=jnp.int32)
                    at = jnp.cumsum(oh, axis=1) - oh + counts[:, None, :]
                    keep.append((at * oh).sum(-1) < cap)
                    counts = counts + oh.sum(axis=1)
                out.append((ids, jnp.stack(keep, -1)))
            h, _ = rT.layer_apply(lp, h, rcfg, pos, moe)
    return out


def _reference(arch, x) -> dict:
    rcfg = rconfigs.get(arch).reduced_config()
    params = jax.tree_util.tree_map(jnp.asarray, x["tree"])
    out = {"prefill": np.asarray(jax.jit(lambda p, t: rT.prefill(p, rcfg, t))(
        params, jnp.asarray(x["prefill"])))}
    cache = rT.init_cache(rcfg, DECODE_B, DECODE_STEPS)
    step = jax.jit(lambda p, c, t, n: rT.decode_step(p, rcfg, c, t, n))
    for t in range(x["decode"].shape[1]):
        logits, cache = step(params, cache, jnp.asarray(x["decode"][:, t]), jnp.int32(t))
        out[f"decode/{t}"] = np.asarray(logits)
        out[f"k/{t}"], out[f"v/{t}"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    for slots in ODD_SLOTS if arch in ODD_ARCHS else ():
        cache = rT.init_cache(rcfg, DECODE_B, slots)
        for t in range(odd_steps(arch, slots)):
            logits, cache = step(params, cache, jnp.asarray(x["decode"][:, t]), jnp.int32(t))
            out[f"odd{slots}/decode/{t}"] = np.asarray(logits)
        out[f"odd{slots}/k"], out[f"odd{slots}/v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rT.lm_loss(p, rcfg, b["tokens"], b["targets"], b["mask"]), has_aux=True))
    (loss, m), grads = vg(params, {k: jnp.asarray(v) for k, v in x["loss"].items()})
    out["loss"] = np.array([float(loss), float(m["nll"]), float(m["aux"])])
    first = dict(x["train"][0], mask=np.ones((LOSS_B, LOSS_S), np.float32))
    out["first_grad_norm"] = float(ropt.global_norm(vg(params, first)[1]))
    out["grads"] = named(jax.tree_util.tree_map(np.asarray, grads))
    out["routes"] = [tuple(map(np.asarray, r)) for r in jax.jit(
        _ref_routes, static_argnums=1)(params, rcfg, jnp.asarray(x["loss"]["tokens"]))]
    r_opt = _opt(ropt)
    r_step = jax.jit(rloop.make_train_step(
        lambda p, b: rT.lm_loss(p, rcfg, b["tokens"], b["targets"]), r_opt))
    p, s = params, rloop.init_opt_state(r_opt, params)
    for i, bb in enumerate(x["train"]):
        p, s, mm = r_step(p, s, {k: jnp.asarray(v) for k, v in bb.items()})
        out[f"step_loss/{i}"] = float(mm["loss"])
        out[f"params/{i}"] = named(jax.tree_util.tree_map(np.asarray, p))
    out["state"] = jax.tree_util.tree_map(np.asarray, {"params": p, "opt": s})
    return out


def _spawn(tmp, data, model, inputs):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, data, model, inputs))
             for r in range(data * model)]
    for p in procs:
        p.start()
    return procs


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


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """{"inputs", "ref": {arch: ...}, "ranks": {mesh: [rank records]},
    "tmp": {mesh: its directory}}; the meshes run one after another, the
    reference while the first one's ranks do."""
    inputs = {arch: inputs_of(arch) for arch in ARCHS}
    tmps = {name: str(tmp_path_factory.mktemp(f"tp_{name}")) for name in MESHES}
    ranks = {}
    names = list(MESHES)
    procs = _spawn(tmps[names[0]], *MESHES[names[0]], inputs)
    try:
        ref = {arch: _reference(arch, x) for arch, x in inputs.items()}
    finally:
        ranks[names[0]] = _join(procs, tmps[names[0]])
    for name in names[1:]:
        ranks[name] = _join(_spawn(tmps[name], *MESHES[name], inputs), tmps[name])
    return dict(inputs=inputs, ref=ref, ranks=ranks, tmp=tmps)


CASES = [(m, a) for m in MESHES for a in ARCHS]


def close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=err_msg, **(tol or TOL))


# --------------------------------------------------------------------------
# the mesh and the specs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_lie_row_major_on_the_mesh_and_refuse_what_is_not_ported(tp, mesh):
    data, model = MESHES[mesh]
    for r, rec in enumerate(tp["ranks"][mesh]):
        d, m = divmod(r, model)
        np.testing.assert_array_equal(rec["coords"], [d, m, m, m, d])
        refused = json.loads(str(rec["refusals"]))
        assert len(refused) == 1, refused  # the FSDP rules (the encoder builds on the mesh)
        assert "embed_fsdp" in refused[0] and "Queue 1 item 8.5.2" in refused[0]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_compressed_psum_averages_over_the_data_axis_alone(tp, mesh):
    """``compressed_psum`` on a model mesh: the int8 mean over the ranks of
    one model index (a data group), within its two quantizations (2.5 int8
    steps of the largest value), and no other rank's input in it."""
    data, model = MESHES[mesh]
    ranks = tp["ranks"][mesh]
    for r, rec in enumerate(ranks):
        peers = [ranks[d * model + r % model]["psum_in"] for d in range(data)]
        want = np.mean(peers, axis=0)
        if data == 1:
            np.testing.assert_array_equal(rec["psum"], rec["psum_in"])
        step = np.abs(peers).max() / 127
        assert np.abs(rec["psum"] - want).max() <= 2.5 * step + 1e-6
        others = [ranks[q]["psum_in"] for q in range(len(ranks)) if q % model != r % model]
        if others:
            assert np.abs(rec["psum"] - np.mean(others + peers, axis=0)).max() > 2.5 * step


def _ref_leaf_specs(arch, data, model) -> dict:
    """The reference's ``logical_to_spec`` of every leaf of the arch's
    reduced tree on an AbstractMesh of the mesh's shape, by the port's
    parameter names (a stacked leaf's leading "layers" entry dropped)."""
    rcfg = rconfigs.get(arch).reduced_config()
    shapes = jax.eval_shape(lambda: rT.init_params(jax.random.PRNGKey(0), rcfg))
    paths = tT.param_paths(tconfigs.get(arch).reduced_config(), True)
    axes = rT.param_axes(rcfg)
    ctx = rshard._CTX
    prev = (ctx.mesh, ctx.rules)
    ctx.mesh, ctx.rules = AbstractMesh((data, model), ("data", "model")), dict(rshard.DEFAULT_RULES)
    try:
        out = {}
        for name, (path, layer) in paths.items():
            ax, shp = axes, shapes
            for k in path:
                ax, shp = ax[k], shp[k]
            spec = tuple(rshard.logical_to_spec(ax, shape=shp.shape))
            out[name] = [p[0] if isinstance(p, tuple) and len(p) == 1 else p
                         for p in (spec[1:] if layer is not None else spec)]
        return out
    finally:
        ctx.mesh, ctx.rules = prev


@pytest.mark.parametrize("mesh,arch", CASES)
def test_each_leaf_is_split_as_the_reference_specs_it(tp, mesh, arch):
    want = _ref_leaf_specs(arch, *MESHES[mesh])
    for rec in tp["ranks"][mesh]:
        got = json.loads(str(rec[f"{arch}/specs"]))
        assert got == want
    assert any("model" in s for s in want.values())


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("slot", [0, 5, 7, 15, 16, 40])
def test_cache_update_equals_the_reference_bit_for_bit(slot, seq_sharded):
    """The reference's ``_cache_update`` on the whole (B, 16, Hkv, dh) cache
    against the port's in-place write that decode calls (``_cache_write_``)
    on a copy of the whole cache and, sequence-sharded, on a copy of each
    of four pieces of 4 slots (``offset``), concatenated."""
    rng = np.random.default_rng(slot)
    cache = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    new = rng.standard_normal((2, 1, 3, 8)).astype(np.float32)
    want = np.asarray(rT._cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.int32(slot),
                                       seq_sharded))
    got = torch.from_numpy(cache.copy())
    tT._cache_write_(got, torch.from_numpy(new), slot, seq_sharded)
    np.testing.assert_array_equal(got.numpy(), want)
    if seq_sharded:
        pieces = [torch.from_numpy(cache[:, i * 4:(i + 1) * 4].copy()) for i in range(4)]
        for i, piece in enumerate(pieces):
            tT._cache_write_(piece, torch.from_numpy(new), slot, True, offset=i * 4)
        np.testing.assert_array_equal(torch.cat(pieces, dim=1).numpy(), want)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_matches_reference(tp, mesh, arch):
    want = tp["ref"][arch]["prefill"]
    for rec in tp["ranks"][mesh]:
        close(rec[f"{arch}/prefill"], want)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_decode_steps_and_gathered_cache_match_reference(tp, mesh, arch):
    """Every step's logits and whole cache; the cache each rank holds is its
    piece (KV heads, or a run of slots when the KV heads do not divide the
    model extent)."""
    ref, (data, model) = tp["ref"][arch], MESHES[mesh]
    cfg = tconfigs.get(arch).reduced_config()
    for rec in tp["ranks"][mesh]:
        for t in range(steps_of(arch)):
            close(rec[f"{arch}/decode/{t}"], ref[f"decode/{t}"], err_msg=f"logits, step {t}")
            close(rec[f"{arch}/k/{t}"], ref[f"k/{t}"], err_msg=f"k, step {t}")
            close(rec[f"{arch}/v/{t}"], ref[f"v/{t}"], err_msg=f"v, step {t}")
        L, B, Sc, Hkv, dh = ref["k/0"].shape
        heads = cfg.n_kv_heads % model == 0
        want = (L, B, Sc, Hkv // model, dh) if heads else (L, B, Sc // model, Hkv, dh)
        np.testing.assert_array_equal(rec[f"{arch}/cache_local"], want)


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES for a in ODD_ARCHS])
def test_decode_on_caches_of_other_sizes_matches_reference(tp, mesh, arch):
    """Caches of ODD_SLOTS slots: every step's logits and the whole cache
    after them, and the piece each rank holds: its KV heads, its run of
    slots where the model extent divides the slots (an odd run included,
    whose shape alone cannot tell it from an unsplit cache), else the
    whole cache; a sequence-sharded piece handed over as a plain dict, its
    whole slot count lost, is refused."""
    ref, (data, model) = tp["ref"][arch], MESHES[mesh]
    cfg = tconfigs.get(arch).reduced_config()
    for slots in ODD_SLOTS:
        key = f"odd{slots}"
        Sc = tT.cache_seq_len(cfg, slots)
        heads = cfg.n_kv_heads % model == 0
        here = Sc // model if not heads and Sc % model == 0 else Sc
        want_shape = (cfg.n_layers, DECODE_B, here,
                      cfg.n_kv_heads // model if heads else cfg.n_kv_heads, cfg.d_head)
        for rec in tp["ranks"][mesh]:
            np.testing.assert_array_equal(rec[f"{arch}/{key}/local"], want_shape)
            refused = str(rec[f"{arch}/{key}/plain_dict"])
            assert ("whole slot count" in refused) == (not heads), refused
            for t in range(odd_steps(arch, slots)):
                close(rec[f"{arch}/{key}/decode/{t}"], ref[f"{key}/decode/{t}"],
                      err_msg=f"{slots} slots, logits, step {t}")
            close(rec[f"{arch}/{key}/k"], ref[f"{key}/k"], err_msg=f"{slots} slots, k")
            close(rec[f"{arch}/{key}/v"], ref[f"{key}/v"], err_msg=f"{slots} slots, v")
    if arch == "granite-34b":  # one KV head: some cache splits into odd runs
        assert any(n % model == 0 and (n // model) % 2 for n in ODD_SLOTS)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh,arch", CASES)
def test_loss_and_gathered_gradients_match_reference(tp, mesh, arch):
    """The loss, nll and aux shares summed over the data axis, and the
    gradients gathered over "model" and summed over "data", on a masked
    batch; MoE routing asserted equal first."""
    ref, (data, model) = tp["ref"][arch], MESHES[mesh]
    ranks = tp["ranks"][mesh]
    for i, (wi, wk) in enumerate(ref["routes"]):  # each data rank routes its rows
        rows = [ranks[d * model] for d in range(data)]
        np.testing.assert_array_equal(np.concatenate([r[f"{arch}/ids/{i}"] for r in rows]), wi)
        np.testing.assert_array_equal(np.concatenate([r[f"{arch}/keep/{i}"] for r in rows]), wk)
    for rec in ranks:
        np.testing.assert_allclose(rec[f"{arch}/loss"], ref["loss"], rtol=LOSS_RTOL)
        for name, w in ref["grads"].items():
            atol = EMBED_ATOL_OF_MAX * np.abs(w).max() if name == "embed" else GRAD_ATOL
            np.testing.assert_allclose(rec[f"{arch}/grad/{name}"], w, rtol=GRAD_RTOL, atol=atol,
                                       err_msg=name)
    if ref["routes"]:
        assert ref["loss"][2] > 0


@pytest.mark.parametrize("mesh,arch", CASES)
def test_adamw_steps_with_clipping_match_reference(tp, mesh, arch):
    ref = tp["ref"][arch]
    assert ref["first_grad_norm"] > CLIP  # the clip binds
    lr_sum = 0.0
    for i in range(TRAIN_STEPS):
        lr_sum += float(topt.cosine_schedule(**SCHED)(i + 1))
        for rec in tp["ranks"][mesh]:
            np.testing.assert_allclose(float(rec[f"{arch}/step_loss/{i}"]), ref[f"step_loss/{i}"],
                                       rtol=LOSS_RTOL)
            outside, n, worst = 0, 0, 0.0
            for name, w in ref[f"params/{i}"].items():
                d = np.abs(rec[f"{arch}/params/{i}/{name}"] - w)
                outside += int((d > PARAM_ATOL + PARAM_RTOL * np.abs(w)).sum())
                n += d.size
                worst = max(worst, float(d.max()))
            assert outside <= OUTLIER_SHARE * n, (i, outside, n)
            assert worst <= 2 * lr_sum, (i, worst)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_mesh_checkpoint_restores_into_one_process_and_the_reference(tp, arch):
    """The 1 x 2 ranks' checkpoint (the whole leaves, gathered) restores on
    the ranks into their pieces, bit for bit; into the port on one process
    and into the reference it is the state the ranks stepped to."""
    mesh = "1x2"
    ckpt = os.path.join(tp["tmp"][mesh], "ckpt", arch)
    assert all(bool(r[f"{arch}/restored_equal"]) for r in tp["ranks"][mesh])
    last = tp["ranks"][mesh][0]
    want = {k[len(f"{arch}/params/{TRAIN_STEPS - 1}/"):]: v for k, v in last.items()
            if k.startswith(f"{arch}/params/{TRAIN_STEPS - 1}/")}
    x = tp["inputs"][arch]
    cfg = tconfigs.get(arch).reduced_config()
    model, template = tT.train_state_from_numpy(
        {"params": x["tree"], "opt": tp["ref"][arch]["state"]["opt"]}, cfg, "cpu")
    state, at = tck.restore(ckpt, template)
    assert at == TRAIN_STEPS and int(state["opt"]["step"]) == TRAIN_STEPS
    got = named(ttree.to_numpy(state["params"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rstate, rat = rck.restore(ckpt, tp["ref"][arch]["state"])
    assert rat == TRAIN_STEPS
    for k, v in named(jax.tree_util.tree_map(np.asarray, rstate["params"])).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# --------------------------------------------------------------------------
# the training driver on a model mesh
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_train_model_two_trains_an_moe_lm_over_two_ranks(tmp_path):
    """``launch.train --mesh single --model 2`` for deepseek-moe-16b
    (reduced) over two processes with torchrun's variables: a 1 x 2 mesh,
    rank 0 alone prints, the loss line is the one-process run's, and the
    checkpoint holds the whole leaves, equal to the one-process run's to
    the steps' tolerance."""
    args = ["--arch", "deepseek-moe-16b", "--reduced", "--steps", "3", "--device", "cpu"]
    base = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh", "single",
         "--model", "2", "--ckpt-dir", str(tmp_path / "tp")],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--ckpt-dir", str(tmp_path / "one")],
                         env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=JOIN_S)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert one.returncode == 0, one.stderr[-2000:]
    lead, solo = outs[0][0].strip().splitlines(), one.stdout.strip().splitlines()
    assert lead[0].endswith("steps=3 mesh={'data': 1, 'model': 2}"), lead
    assert lead[0].split(" mesh=")[0] == solo[0]  # the same parameter count
    assert outs[1][0].strip() == ""
    assert lead[2] == solo[2]
    cfg = tconfigs.get("deepseek-moe-16b").reduced_config()
    like = tT.train_params(tT.Transformer(cfg, "cpu", head=True))
    a, _ = tck.restore(str(tmp_path / "tp"), {"params": like})
    b, _ = tck.restore(str(tmp_path / "one"), {"params": like})
    for x, y in zip(ttree.leaves(a), ttree.leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=PARAM_RTOL, atol=1e-5)
