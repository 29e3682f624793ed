"""Data-parallel ColBERTv2 training over two gloo ranks
(``repro_torch.training.loop`` under a ``("data", "model")`` mesh of 2 x 1,
``models.colbert.train_loss``'s row split and differentiable passage
gather, ``distributed.sharding``, ``restore(shardings=)``) against the
reference's single-device global-batch step (``repro.training.loop``
jitted on one device) and the port's single-process step, on the same
state and the same global batches.

The reduced config in f32, with in-batch negatives and distillation on (so
every query is scored against both ranks' passages), on batches with
padded passages and random teacher scores.  The ranks are spawned once
(``torch.multiprocessing``, ``file://`` rendezvous in the test's
temporary directory, each join limited); each restores the reference's
checkpoint onto its device (``tree_shardings``) and takes 3 steps in each
case: ``n_micro`` 1 and 2, and int8 compression.

Tolerances, against the reference's step and the single-process step
after each step (f32: the two ranks' halves sum their gradients in another
order than one pass over the batch does, and XLA sums in another order
than PyTorch): losses rtol 1e-5; weights atol 1e-6, except for at most a
thousandth of them, each within twice the learning rates stepped so far.
Those few follow AdamW's normalisation: a weight moves by lr * m / (sqrt(v)
+ eps), so where a gradient element is within a few eps of 0 its last
bits, or (int8) one quantization step that they tip, move the weight by a
share of lr, never by more than ~lr a step.  Measured: none in the plain
case, 1-2 elements of 29,344 with n_micro 2 (1.6e-5 from the reference's,
after step 1 and no further), up to 12 with int8 (1.2e-4).  The replicas
bit-identical after every step; a checkpoint written at world 2 restores
at world 1 bit for bit and steps on.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

WORLD, STEPS, B = 2, 3, 4
JOIN_TIMEOUT_S = 240
CASES = {"plain": (1, None), "micro2": (2, None), "int8": (1, "int8")}
SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
LOSS_RTOL, PARAM_ATOL, OUTLIER_SHARE = 1e-5, 1e-6, 1e-3


def _batches():
    """STEPS global batches: ``colbert_batches`` with padded passages and
    random teacher scores."""
    cfg = rcfgs.reduced_config()
    it = rsyn.colbert_batches(cfg.backbone.vocab, B, q_len=8, d_len=16, nway=cfg.nway, seed=3)
    rng = np.random.default_rng(4)
    out = []
    for _ in range(STEPS):
        b = next(it)
        lens = rng.integers(9, 17, (B, cfg.nway))
        b["d_mask"] = (np.arange(16)[None, None, :] < lens[..., None]).astype(np.float32)
        b["target_scores"] = rng.standard_normal((B, cfg.nway)).astype(np.float32) * 2
        out.append(b)
    return out


def _ref_state(compression):
    """The reference's initial training state, as numpy."""
    init = jax.jit(rcol.init_params, static_argnums=1)
    params = init(jax.random.PRNGKey(2), rcfgs.reduced_config())
    opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(**SCHED)))
    return jax.tree_util.tree_map(
        np.array, {"params": params, "opt": rloop.init_opt_state(opt, params, compression)})


def _t_opt():
    return topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**SCHED)))


def _state_axes(cfg, compression):
    """Logical axes of the port's state carried from the reference (whose
    params hold the backbone's ``lm_head``)."""
    axes = tcol.param_axes(cfg)
    axes["backbone"]["lm_head"] = ("embed_fsdp", "vocab")
    opt = topt.opt_state_axes(axes)
    if compression:
        opt["ef"] = axes
    return {"params": axes, "opt": opt}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(ttree.to_numpy(tree))}


def _rank_main(rank, tmp, states, batches):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    try:
        mesh = tmesh.make_production_mesh(device="cpu")
        assert mesh.shape == {"data": WORLD, "model": 1} and mesh.rank == rank
        cfg = tcfgs.reduced_config()
        out = {}
        for case, (n_micro, comp) in CASES.items():
            model, template = tcol.train_state_from_numpy(states[case], cfg, device="cpu")
            axes = _state_axes(cfg, comp)
            with sharding.use_mesh(mesh):
                state, _ = tck.restore(f"{tmp}/ref_{case}", template,
                                       shardings=sharding.tree_shardings(axes))
                out[f"{case}/restored_equal"] = all(
                    torch.equal(a, b) for a, b in zip(ttree.leaves(state), ttree.leaves(template)))
                step = tloop.make_train_step(tcol.loss_fn(model), _t_opt(), n_micro=n_micro,
                                             compression=comp, param_axes=axes["params"])
                p, o = state["params"], state["opt"]
                for i, b in enumerate(batches):
                    p, o, m = step(p, o, b)
                    tloop.assert_replicas_agree(p, mesh)
                    out[f"{case}/loss/{i}"] = float(m["loss"])
                    out.update({f"{case}/params/{i}/{k}": v for k, v in _flat(p).items()})
                if case == "plain" and rank == 0:
                    tck.save(f"{tmp}/world2", STEPS, {"params": p, "opt": o})
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _spawn(tmp, states, batches):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp, states, batches)) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, f"rank(s) still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]


def _ref_run(state, n_micro, compression, batches):
    rcfg = rcfgs.reduced_config()
    opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(**SCHED)))
    step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, rcfg, b), opt,
                                         n_micro=n_micro, compression=compression))
    p, o = jax.tree_util.tree_map(jnp.asarray, (state["params"], state["opt"]))
    losses, params = [], []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        params.append({jax.tree_util.keystr(k): np.asarray(v)
                       for k, v in jax.tree_util.tree_leaves_with_path(p)})
    return losses, params


def _port_run(state, n_micro, compression, batches):
    model, st = tcol.train_state_from_numpy(state, tcfgs.reduced_config(), device="cpu")
    step = tloop.make_train_step(tcol.loss_fn(model), _t_opt(), n_micro=n_micro,
                                 compression=compression)
    p, o = st["params"], st["opt"]
    losses, params = [], []
    for b in batches:
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        params.append(_flat(p))
    return losses, params, (model, p, o)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    batches = _batches()
    states = {case: _ref_state(comp) for case, (_, comp) in CASES.items()}
    for case, st in states.items():
        rck.save(f"{tmp}/ref_{case}", 0, st)
    procs = _spawn(tmp, states, batches)
    try:  # the references run while the ranks do
        ref = {case: _ref_run(states[case], n, c, batches) for case, (n, c) in CASES.items()}
        port = {case: _port_run(states[case], n, c, batches) for case, (n, c) in CASES.items()}
    finally:
        _join(procs)
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]
    return dict(tmp=tmp, batches=batches, states=states, ref=ref, port=port, ranks=ranks)


def _rank_params(got, case, i):
    pre = f"{case}/params/{i}/"
    return {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}


def _assert_weights_close(got: dict, want: dict, step: int):
    """The weights after ``step`` (0-based) steps (module docstring)."""
    assert got.keys() == want.keys()
    lr_sum = sum(float(topt.cosine_schedule(**SCHED)(n)) for n in range(1, step + 2))
    diff = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want.items()])
    outliers = int((diff > PARAM_ATOL).sum())
    assert outliers <= OUTLIER_SHARE * diff.size, (step, outliers, diff.size)
    assert diff.max() <= 2 * lr_sum, (step, diff.max(), lr_sum)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_take_the_reference_global_batch_step(runs, case):
    want_losses, want_params = runs["ref"][case]
    got = runs["ranks"][0]
    assert bool(got[f"{case}/restored_equal"])  # the reference's checkpoint, at world 2
    for i in range(STEPS):
        np.testing.assert_allclose(float(got[f"{case}/loss/{i}"]), want_losses[i], rtol=LOSS_RTOL)
        _assert_weights_close(_rank_params(got, case, i), want_params[i], i)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_take_the_single_process_step(runs, case):
    want_losses, want_params, _ = runs["port"][case]
    got = runs["ranks"][0]
    for i in range(STEPS):
        np.testing.assert_allclose(float(got[f"{case}/loss/{i}"]), want_losses[i], rtol=LOSS_RTOL)
        _assert_weights_close(_rank_params(got, case, i), want_params[i], i)


def test_replicas_stay_bit_identical(runs):
    a, b = runs["ranks"]
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_checkpoint_at_world_two_restores_at_world_one_and_steps_on(runs, tmp_path):
    """Rank 0 wrote the state after 3 steps; one process restores it (a
    re-mesh to world 1) bit for bit and takes a 4th step that tracks the
    single-process run's."""
    model, p, o = runs["port"]["plain"][2]
    with sharding.use_mesh(tmesh.make_local_mesh("cpu")):
        restored, step = tck.restore(os.path.join(runs["tmp"], "world2"), {"params": p, "opt": o},
                                     shardings=sharding.tree_shardings(
                                         _state_axes(tcfgs.reduced_config(), None)))
    assert step == STEPS
    for name, w in _flat(restored["params"]).items():
        np.testing.assert_array_equal(w, runs["ranks"][0][f"plain/params/{STEPS - 1}/{name}"])
    assert int(restored["opt"]["step"]) == STEPS
    b = runs["batches"][0]
    step_fn = tloop.make_train_step(tcol.loss_fn(model), _t_opt())
    from_disk = step_fn(restored["params"], restored["opt"], b)
    in_memory = step_fn(p, o, b)
    torch.testing.assert_close(from_disk[2]["loss"], in_memory[2]["loss"], rtol=LOSS_RTOL, atol=0)
    _assert_weights_close(_flat(from_disk[0]), _flat(in_memory[0]), STEPS)
