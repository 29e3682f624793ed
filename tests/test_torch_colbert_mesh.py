"""ColBERTv2 on a ``("data", "model")`` mesh (``repro_torch.models.colbert``
with a backbone split over ``"model"``, ``launch.cells.retrieval_cell(
mesh=)``, ``launch.train --mesh single --model 2``) and int8 gradient
compression on a model axis (``training.loop``) against the reference
(``repro.models.colbert``, ``repro.training.loop``) on one device.

Four gloo ranks are spawned ONCE for the module (``torch.multiprocessing``,
``file://`` rendezvous, the join limited to JOIN_S).  Ranks 0-1 run a 1 x 2
mesh and ranks 2-3 a 2 x 1 mesh at the same time (a process group each),
then all four a 2 x 2 mesh and ``launch.train`` over the four at a model
extent of 2.  Each rank takes the reference's reduced
``colbert.init_params(PRNGKey(0))`` tree as numpy, keeps its piece of
every leaf (4 heads over 4 KV heads and the 128-row vocabulary split in
two), and computes: ``encode``'s vectors of its rows over the data axis;
``train_loss``'s loss, ``ce`` and ``kd`` with in-batch negatives and
without, and their gradients; three AdamW steps with clipping; one int8
step from a state with a nonzero error feedback; the train and encode
cells.  Ranks 0-1 also take one int8 step of the reduced
``granite-moe-1b-a400m`` on 1 x 2.  Split leaves are gathered whole and
shares summed over the data axis; the results come back through an
``.npz`` a rank.  The parent runs the reference meanwhile (``encode``,
``value_and_grad(train_loss)`` and ``make_train_step``, each jitted) on the
same numpy inputs.

Tolerances, f32, those of ``tests/test_torch_tensor_parallel.py``: vectors,
losses rtol 1e-5 (XLA and PyTorch sum in other orders, and the ranks'
partial sums add one more); gradients atol 1e-6, the embedding's atol
1e-5 of its largest magnitude; the stepped weights atol 1e-6 on all but a
thousandth of the elements, those within twice the learning rates
stepped.  An int8 step is held as ``tests/test_torch_training.py`` holds
the one-process int8 step (int8 rounding turns the frameworks' ~1e-6
gradient differences into whole quantization steps): the loss rtol 1e-4,
the error feedback within one quantization step of its block and within a
thousandth of one on all but 1% of a leaf, the weights rtol 1e-4 / atol
2.5 lr.  The cells and ``launch.train`` against their own one-process runs
(rtol 1e-5).
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
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

ARCH, LM = "plaid-colbertv2", "granite-moe-1b-a400m"
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}  # (data, model)
WORLD = 4
ENC_B, ENC_S = 4, 12  # the encoded rows split over data 2
LOSS_B, Q_LEN, D_LEN = 4, 8, 16
TRAIN_STEPS, CLIP = 3, 0.5
SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
CLI_STEPS = 3
RTOL = 1e-5
GRAD_ATOL, EMBED_ATOL_OF_MAX = 1e-6, 1e-5
PARAM_ATOL, OUTLIER_SHARE = 1e-6, 1e-3
INT8_RTOL, INT8_FAR_SHARE = 1e-4, 0.01
JOIN_S = 240


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


def _lr(step: int) -> float:
    return float(topt.cosine_schedule(**SCHED)(step))


def _jit_init(init, rcfg):
    return jax.tree_util.tree_map(np.asarray, jax.jit(init, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))


def _int8_state(tree, rng) -> dict:
    """A state whose moments are zero and whose error feedback is drawn
    (a gradient's magnitude), so the step reads a carried error."""
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    ef = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), tree)
    return {"params": tree, "opt": {"mu": zeros, "nu": zeros, "step": np.int32(0), "ef": ef}}


def colbert_batch(vocab, seed) -> dict:
    """A ``colbert_batches`` batch with padded tails in the masks."""
    b = next(rsyn.colbert_batches(vocab, LOSS_B, q_len=Q_LEN, d_len=D_LEN, nway=2, seed=seed))
    rng = np.random.default_rng(seed)
    b["d_mask"] = (np.arange(D_LEN) < rng.integers(D_LEN // 2, D_LEN + 1, (LOSS_B, 2, 1))
                   ).astype(np.float32)
    b["q_mask"] = (np.arange(Q_LEN) < rng.integers(Q_LEN // 2, Q_LEN + 1, (LOSS_B, 1))
                   ).astype(np.float32)
    return b


def make_inputs() -> dict:
    rcfg = rconfigs.get(ARCH).reduced_config()
    tree = _jit_init(rcol.init_params, rcfg)
    rng = np.random.default_rng(5)
    vocab = rcfg.backbone.vocab
    lcfg = rconfigs.get(LM).reduced_config()
    ltree = _jit_init(rT.init_params, lcfg)
    return dict(
        tree=tree,
        enc_tokens=rng.integers(0, vocab, (ENC_B, ENC_S)).astype(np.int32),
        enc_mask=(np.arange(ENC_S) < rng.integers(4, ENC_S + 1, (ENC_B, 1))).astype(np.float32),
        loss=colbert_batch(vocab, 11),
        train=[colbert_batch(vocab, 20 + i) for i in range(TRAIN_STEPS)],
        int8=_int8_state(tree, rng), int8_batch=colbert_batch(vocab, 30),
        lm_int8=_int8_state(ltree, rng),
        lm_int8_batch=next(rsyn.lm_batches(lcfg.vocab, LOSS_B, 24, seed=31)))


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------
def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _sum_data(t):
    data = sharding.data_mesh()
    return t if data is None else tmesh.all_reduce_sum(data, t)


def _whole(tree, place):
    return ttree.to_numpy(tree if place is None else sharding.gather_tree(tree, place))


def seeing(opt):
    """``opt`` and a dict that holds the gradients its last ``update`` saw
    (after int8 compression, the dequantized ones)."""
    seen = {}

    def update(grads, state, params, **kw):
        seen["grads"] = grads
        return opt.update(grads, state, params, **kw)

    return topt.Optimizer(opt.init, update), seen


def _int8_step(lib, cfg, state_np, batch, out, key):
    """One int8 step from ``state_np`` (a reference state as numpy): the
    loss, and the weights, error feedback and dequantized gradients whole."""
    model, state = lib.train_state_from_numpy(state_np, cfg, "cpu")
    splace = lib.state_placements(model, state)
    place = None if splace is None else splace["params"]
    opt, seen = seeing(_opt(topt))
    step = tloop.make_train_step(lib.loss_fn(model), opt, compression="int8", placements=place)
    p, o, m = step(state["params"], state["opt"], _tb(batch))
    out[f"{key}/loss"] = m["loss"].numpy()
    for part, tree in (("params", p), ("ef", o["ef"]), ("deq", seen["grads"])):
        for k, v in named(_whole(tree, place)).items():
            out[f"{key}/{part}/{k}"] = v


def _rank_colbert(name, mesh, x, out):
    cfg = tconfigs.get(ARCH).reduced_config()
    model = tcol.params_from_numpy(x["tree"], cfg, "cpu")
    rows = tcells._data_rows(ENC_B)
    out[f"{name}/enc_rows"] = np.array(rows.indices(ENC_B))
    out[f"{name}/encode"] = tcol.encode(model, torch.from_numpy(x["enc_tokens"][rows]),
                                        torch.from_numpy(x["enc_mask"][rows])).numpy()
    place = model.placement_tree()
    out[f"{name}/split"] = np.array([] if place is None else [p.split for p in ttree.leaves(place)])

    for ib in (True, False):
        c = dataclasses.replace(cfg, use_ib_negatives=ib)
        model, state = tcol.train_state_from_numpy({"params": x["tree"]}, c, "cpu")
        splace = tcol.state_placements(model, state)
        (loss, m), grads = tloop.value_and_grad(tcol.loss_fn(model), state["params"], _tb(x["loss"]))
        out[f"{name}/ib{ib}/loss"] = _sum_data(torch.stack([loss, m["ce"], m["kd"]])).numpy()
        for k, v in named(_whole(grads, splace and splace["params"])).items():
            out[f"{name}/ib{ib}/grad/{k}"] = _sum_data(torch.from_numpy(v)).numpy()

    # three AdamW steps with clipping; the replicas checked after each
    model, state = tcol.train_state_from_numpy({"params": x["tree"]}, cfg, "cpu")
    splace = tcol.state_placements(model, state)
    place = splace and splace["params"]
    opt = _opt(topt)
    step = tloop.make_train_step(tcol.loss_fn(model), opt, placements=place, donate=True)
    p, o = state["params"], tloop.init_opt_state(opt, state["params"])
    for i, b in enumerate(x["train"]):
        p, o, mm = step(p, o, _tb(b))
        tloop.assert_replicas_agree(p, mesh, place)
        out[f"{name}/step_loss/{i}"] = mm["loss"].numpy()
        for k, v in named(_whole(p, place)).items():
            out[f"{name}/params/{i}/{k}"] = v

    _int8_step(tcol, cfg, x["int8"], x["int8_batch"], out, f"{name}/int8")

    cells = tconfigs.cells_of(ARCH)
    B = cells["encode_corpus"].reduced["batch"]
    out[f"{name}/cell_rows"] = np.array(tcells._data_rows(B).indices(B))
    for cname in ("encode_corpus", "train_triples"):
        c = cells[cname]
        built = tcells.retrieval_cell(ARCH, cfg, c, c.reduced, "cpu", mesh=mesh)
        res = built.fn(*built.args)
        out[f"{name}/cell/{cname}"] = (res if c.kind == "encode" else res[2]["loss"]).numpy()


def _rank_main(rank, tmp, x):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    try:
        out = {}
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        name = "1x2" if rank < 2 else "2x1"
        data, model = MESHES[name]
        mesh = tmesh.Mesh((torch.device("cpu"),), pairs[rank // 2], (("data", data), ("model", model)))
        with sharding.use_mesh(mesh):
            _rank_colbert(name, mesh, x, out)
            if name == "1x2":
                _int8_step(tT, tconfigs.get(LM).reduced_config(), x["lm_int8"],
                           x["lm_int8_batch"], out, "lm_int8")
        m22 = tmesh.make_production_mesh(device="cpu", model=2)
        with sharding.use_mesh(m22):
            _rank_colbert("2x2", m22, x, out)
        res = ttrain.run(["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "single",
                          "--model", "2", "--steps", str(CLI_STEPS), "--ckpt-dir", f"{tmp}/ckpt"])
        out["cli/losses"] = np.array(res["losses"])
        out["cli/split"] = np.array([p.split for p in ttree.leaves(res["placements"])])
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
# the reference, and the port's one-process cells and CLI
# --------------------------------------------------------------------------
def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _ref_int8(loss, state_np, batch):
    r_step = jax.jit(rloop.make_train_step(loss, _opt(ropt), compression="int8"))
    p, s, m = r_step(*jax.tree_util.tree_map(jnp.asarray, (state_np["params"], state_np["opt"])),
                     _jb(batch))
    return dict(loss=float(m["loss"]), params=named(jax.tree_util.tree_map(np.asarray, p)),
                ef=named(jax.tree_util.tree_map(np.asarray, s["ef"])))


def _reference(x) -> dict:
    rcfg = rconfigs.get(ARCH).reduced_config()
    params = jax.tree_util.tree_map(jnp.asarray, x["tree"])
    out = {"encode": np.asarray(jax.jit(lambda p, t, m: rcol.encode(p, rcfg, t, m))(
        params, jnp.asarray(x["enc_tokens"]), jnp.asarray(x["enc_mask"])))}
    for ib in (True, False):
        c = dataclasses.replace(rcfg, use_ib_negatives=ib)
        vg = jax.jit(jax.value_and_grad(lambda p, b: rcol.train_loss(p, c, b), has_aux=True))
        (loss, m), grads = vg(params, _jb(x["loss"]))
        out[f"ib{ib}/loss"] = np.array([float(loss), float(m["ce"]), float(m["kd"])])
        out[f"ib{ib}/grads"] = named(jax.tree_util.tree_map(np.asarray, grads))
    loss = lambda p, b: rcol.train_loss(p, rcfg, b)  # noqa: E731
    r_opt = _opt(ropt)
    r_step = jax.jit(rloop.make_train_step(loss, r_opt))
    p, s = params, rloop.init_opt_state(r_opt, params)
    for i, b in enumerate(x["train"]):
        p, s, mm = r_step(p, s, _jb(b))
        out[f"step_loss/{i}"] = float(mm["loss"])
        out[f"params/{i}"] = named(jax.tree_util.tree_map(np.asarray, p))
    out["int8"] = _ref_int8(loss, x["int8"], x["int8_batch"])
    lcfg = rconfigs.get(LM).reduced_config()
    out["lm_int8"] = _ref_int8(lambda p, b: rT.lm_loss(p, lcfg, b["tokens"], b["targets"]),
                               x["lm_int8"], x["lm_int8_batch"])
    return out


def _one_process(tmp) -> dict:
    """The port's train and encode cells, and ``launch.train``, on one
    process."""
    cfg = tconfigs.get(ARCH).reduced_config()
    cells = tconfigs.cells_of(ARCH)
    out = {}
    for cname in ("encode_corpus", "train_triples"):
        c = cells[cname]
        built = tcells.retrieval_cell(ARCH, cfg, c, c.reduced, "cpu")
        res = built.fn(*built.args)
        out[cname] = (res if c.kind == "encode" else res[2]["loss"]).numpy()
    out["cli"] = ttrain.run(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                             str(CLI_STEPS), "--ckpt-dir", f"{tmp}/one"])["losses"]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{"ranks": [each rank's record], "ref": the reference's results,
    "one": the port's one-process cells and CLI}; the reference runs while
    the ranks do."""
    tmp = str(tmp_path_factory.mktemp("colbert_mesh"))
    x = make_inputs()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, x)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = _reference(x)
        one = _one_process(tmp)
    finally:
        recs = _join(procs, tmp)
    return dict(ranks=recs, ref=ref, one=one, inputs=x)


def mesh_ranks(ranks, mesh):
    """The records of the ranks that ran ``mesh``."""
    recs = ranks["ranks"]
    return {"1x2": recs[:2], "2x1": recs[2:], "2x2": recs}[mesh]


def close(got, want, msg="", rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def assert_params_close(got: dict, want: dict, steps: int, err=""):
    """The weights after ``steps`` steps (module docstring)."""
    assert got.keys() == want.keys()
    bound = 2 * sum(_lr(n) for n in range(1, steps + 1))
    outside, n, worst = 0, 0, 0.0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        outside += int((d > PARAM_ATOL + RTOL * np.abs(w)).sum())
        n += d.size
        worst = max(worst, float(d.max()))
    assert outside <= OUTLIER_SHARE * n, (err, outside, n)
    assert worst <= bound, (err, worst, bound)


def block_steps(deq: np.ndarray, block: int = 256) -> np.ndarray:
    """Each element's int8 quantization step, from the dequantized values
    (blocks of the flattened leaf, across a layer stack's layers)."""
    flat = deq.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
    return np.repeat(np.abs(blocks).max(1) / 127, block)[: flat.size].reshape(deq.shape)


def assert_int8_step_close(rec, key, want):
    got = {part: {k[len(f"{key}/{part}/"):]: v for k, v in rec.items()
                  if k.startswith(f"{key}/{part}/")} for part in ("params", "ef", "deq")}
    close(rec[f"{key}/loss"], want["loss"], "loss", rtol=INT8_RTOL)
    assert got["ef"].keys() == want["ef"].keys() == got["deq"].keys()
    for name, w in want["ef"].items():
        q = block_steps(got["deq"][name])
        off = np.abs(got["ef"][name] - w)
        assert (off <= 1.01 * q).all(), name
        assert (off > 1e-3 * q).mean() <= INT8_FAR_SHARE, name
    assert got["params"].keys() == want["params"].keys()
    for name, w in want["params"].items():
        close(got["params"][name], w, name, rtol=INT8_RTOL, atol=2.5 * _lr(1))
    assert max(np.abs(v).max() for v in got["ef"].values()) > 0


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_split_the_backbone_and_keep_the_projection_whole(ranks, mesh):
    """On a model extent of 2 the attention, MLP and vocabulary split; the
    norms and ``proj`` (``("embed_fsdp", None)``: ``"data"`` alone) do not."""
    _, model = MESHES[mesh]
    for rec in mesh_ranks(ranks, mesh):
        split = rec[f"{mesh}/split"]
        if model == 1:
            assert split.size == 0
            continue
        assert split.any() and not split.all()
        assert not split[-1]  # proj, the last leaf in the reference's order
    for rec in ranks["ranks"]:
        assert rec["cli/split"].any() and not rec["cli/split"].all()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_encode_vectors_of_each_ranks_rows_match_the_reference(ranks, mesh):
    data, _ = MESHES[mesh]
    want = ranks["ref"]["encode"]
    for rec in mesh_ranks(ranks, mesh):
        lo, hi, _ = rec[f"{mesh}/enc_rows"]
        assert hi - lo == ENC_B // data
        close(rec[f"{mesh}/encode"], want[lo:hi], "vectors", atol=1e-6)


@pytest.mark.parametrize("ib", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_ce_kd_and_gathered_gradients_match_the_reference(ranks, mesh, ib):
    want = ranks["ref"]
    for rec in mesh_ranks(ranks, mesh):
        close(rec[f"{mesh}/ib{ib}/loss"], want[f"ib{ib}/loss"], "loss, ce, kd")
        grads = want[f"ib{ib}/grads"]
        got = {k: rec[f"{mesh}/ib{ib}/grad/{k}"] for k in grads}
        for name, w in grads.items():
            atol = EMBED_ATOL_OF_MAX * np.abs(w).max() if name == "backbone/embed" else GRAD_ATOL
            close(got[name], w, name, atol=atol)
        assert not np.abs(got["backbone/lm_head"]).any()  # the encoder does not read it


@pytest.mark.parametrize("mesh", list(MESHES))
def test_three_adamw_steps_with_clipping_match_the_reference(ranks, mesh):
    want = ranks["ref"]
    for rec in mesh_ranks(ranks, mesh):
        for i in range(TRAIN_STEPS):
            close(rec[f"{mesh}/step_loss/{i}"], want[f"step_loss/{i}"], f"loss {i}")
            got = {k: rec[f"{mesh}/params/{i}/{k}"] for k in want[f"params/{i}"]}
            assert_params_close(got, want[f"params/{i}"], i + 1, f"step {i}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_an_int8_step_quantizes_each_split_leaf_whole(ranks, mesh):
    """int8 with error feedback: each split gradient and its feedback
    gathered whole over ``"model"`` and quantized as the reference's leaf."""
    for rec in mesh_ranks(ranks, mesh):
        assert_int8_step_close(rec, f"{mesh}/int8", ranks["ref"]["int8"])


def test_an_lm_int8_step_on_a_model_axis_matches_the_reference(ranks):
    """The reduced granite-moe-1b-a400m on 1 x 2 (experts, the vocabulary
    and the MLP split), one int8 step."""
    for rec in mesh_ranks(ranks, "1x2"):
        assert_int8_step_close(rec, "lm_int8", ranks["ref"]["lm_int8"])


@pytest.mark.parametrize("cell", ["encode_corpus", "train_triples"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_cells_on_a_mesh_match_one_process(ranks, mesh, cell):
    """``retrieval_cell(mesh=)``: the encode cell's rows over the data axis
    and the train cell's loss, against the same cells on one process."""
    want = ranks["one"][cell]
    for rec in mesh_ranks(ranks, mesh):
        got = rec[f"{mesh}/cell/{cell}"]
        if cell == "encode_corpus":
            lo, hi, _ = rec[f"{mesh}/cell_rows"]
            assert hi - lo == len(want) // MESHES[mesh][0]
            close(got, want[lo:hi], "vectors", atol=1e-6)
        else:
            close(got, want, "loss")


def test_launch_train_over_a_model_axis_matches_one_process(ranks):
    """``launch.train --arch plaid-colbertv2 --reduced --mesh single --model
    2`` over four processes (2 x 2): every rank's losses those of the
    one-process run."""
    for rec in ranks["ranks"]:
        close(rec["cli/losses"], ranks["one"]["cli"], "losses")
