"""Checkpoints and supervised restart (``repro_torch.training.checkpoint``,
``fault_tolerance``) against the reference's (``repro.training``).

A training state written by either package restores in the other, leaf for
leaf and bit for bit: the same step directories, flat keys and stacked
layer arrays.  ``run_supervised`` restarts as the reference's does on the
same failures, and ``StepWatchdog`` flags the same steps on the same
synthetic step times (no wall-clock threshold).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.training import checkpoint as rck  # noqa: E402
from repro.training import fault_tolerance as rft  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402
from repro_torch.training import fault_tolerance as tft  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores


@pytest.fixture(scope="module")
def ref_state():
    """The reference's training state after two int8 steps (params, mu,
    nu, step and ef all nonzero), as numpy."""
    rcfg = rcfgs.reduced_config()
    params = jax.jit(rcol.init_params, static_argnums=1)(jax.random.PRNGKey(1), rcfg)
    opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.constant_schedule(1e-3)))
    state = rloop.init_opt_state(opt, params, "int8")
    step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, rcfg, b), opt,
                                         compression="int8"))
    batches = rsyn.colbert_batches(rcfg.backbone.vocab, 4, q_len=8, d_len=16, nway=rcfg.nway)
    for _ in range(2):
        params, state, _ = step(params, state, {k: jnp.asarray(v) for k, v in next(batches).items()})
    return jax.tree_util.tree_map(np.array, {"params": params, "opt": state})


def _assert_trees_equal(got, want):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got_leaves) == {p for p, _ in want_leaves}
    for path, w in want_leaves:
        g = np.asarray(got_leaves[path])
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_reference_checkpoint_restores_into_the_port(ref_state, tmp_path):
    rck.save(str(tmp_path), 2, ref_state)
    _, template = tcol.train_state_from_numpy(
        jax.tree_util.tree_map(np.zeros_like, ref_state), tcfgs.reduced_config(), device="cpu")
    got, step = tck.restore(str(tmp_path), template)
    assert step == 2
    layers = got["params"]["backbone"]["dense_layers"]["attn"]["wq"]
    assert isinstance(layers, list) and len(layers) == 2 and isinstance(layers[0], torch.Tensor)
    assert got["opt"]["step"].dtype == torch.int32
    _assert_trees_equal(tcol.numpy_train_state(got), ref_state)


def test_port_checkpoint_restores_into_the_reference(ref_state, tmp_path):
    _, state = tcol.train_state_from_numpy(ref_state, tcfgs.reduced_config(), device="cpu")
    tck.save(str(tmp_path), 7, state)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    rck.save(str(tmp_path / "ref"), 7, ref_state)
    with open(tmp_path / "ref" / "step_00000007" / "manifest.json") as f:
        assert manifest == json.load(f)  # the same step and flat keys
    got, step = rck.restore(str(tmp_path), jax.tree_util.tree_map(np.zeros_like, ref_state))
    assert step == 7
    _assert_trees_equal(got, ref_state)


def test_restored_state_trains_on(ref_state, tmp_path):
    """A state restored from the reference's checkpoint takes the next step
    as the state carried over in memory does, bit for bit."""
    tcfg = tcfgs.reduced_config()
    rck.save(str(tmp_path), 2, ref_state)
    model, state = tcol.train_state_from_numpy(ref_state, tcfg, device="cpu")
    restored, _ = tck.restore(str(tmp_path), state)
    opt = topt.adamw(topt.AdamWConfig(schedule=topt.constant_schedule(1e-3)))
    step = tloop.make_train_step(tcol.loss_fn(model), opt, compression="int8")
    b = next(rsyn.colbert_batches(tcfg.backbone.vocab, 4, q_len=8, d_len=16, nway=tcfg.nway, seed=9))
    a = step(state["params"], state["opt"], b)
    r = step(restored["params"], restored["opt"], b)
    for x, y in zip(ttree.leaves({"p": a[0], "o": a[1]}), ttree.leaves({"p": r[0], "o": r[1]})):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# atomicity, GC, partial writes
# --------------------------------------------------------------------------
def _steps_on_disk(d):
    return sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("step_"))


@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_atomicity_and_gc(tmp_path, async_write):
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))},
            "stack": [torch.full((3,), float(i)) for i in range(4)]}
    mgr = tck.CheckpointManager(str(tmp_path), keep=2, async_write=async_write)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert _steps_on_disk(tmp_path) == [2, 3]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    restored, step = tck.restore(str(tmp_path), tree)
    assert step == 3
    assert torch.equal(restored["a"], tree["a"]) and torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert [float(t[0]) for t in restored["stack"]] == [0.0, 1.0, 2.0, 3.0]
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert z["stack"].shape == (4, 3)  # one array, leading L axis


def test_checkpoint_restore_ignores_partial_write(tmp_path):
    tck.save(str(tmp_path), 1, {"a": torch.arange(3)})
    os.makedirs(tmp_path / "step_00000002.tmp")  # a write that crashed
    os.makedirs(tmp_path / "step_00000003")  # no manifest: incomplete
    assert tck.latest_step(str(tmp_path)) == rck.latest_step(str(tmp_path)) == 1
    got, step = tck.restore(str(tmp_path), {"a": torch.zeros(3, dtype=torch.int64)})
    assert step == 1 and torch.equal(got["a"], torch.arange(3))
    assert tck.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "missing"), {})


# --------------------------------------------------------------------------
# run_supervised and StepWatchdog
# --------------------------------------------------------------------------
def _supervised(pkg, zeros, tmp, fail_at, **kw):
    failed, restored = set(), []

    def step(state, batch):
        if batch in fail_at and batch not in failed:
            failed.add(batch)
            raise RuntimeError("chip lost")
        return {"x": state["x"] + batch}

    state, final, restarts = pkg.run_supervised(
        step, {"x": zeros}, list(range(8)), ckpt_dir=tmp, ckpt_every=2,
        on_restore=lambda s, st: restored.append((float(s["x"]), st)), **kw)
    return float(state["x"]), final, restarts, restored, _steps_on_disk(tmp)


def test_run_supervised_restarts_as_the_reference_does(tmp_path):
    """Failures at batches 3 and 6: each restores the newest checkpoint
    and drops its batch; the run completes."""
    want = _supervised(rft, jnp.zeros(()), str(tmp_path / "ref"), {3, 6})
    got = _supervised(tft, torch.zeros(()), str(tmp_path / "port"), {3, 6})
    assert got == want
    assert got[2] == 2 and got[1] == 8
    assert got[3] == [(1.0, 2), (10.0, 6)]  # x after batches 0-1, then 0-5 less 3


def test_run_supervised_gives_up_after_max_restarts(tmp_path):
    def step(state, batch):
        raise RuntimeError("persistent failure")

    for pkg, zeros in ((rft, jnp.zeros(())), (tft, torch.zeros(()))):
        with pytest.raises(RuntimeError, match="persistent"):
            pkg.run_supervised(step, {"x": zeros}, list(range(6)),
                               ckpt_dir=str(tmp_path / pkg.__name__), max_restarts=2)


def test_run_supervised_with_an_injected_failure_restores_the_training_state(ref_state, tmp_path):
    """The port's train step under ``run_supervised``: a failure after the
    checkpoint at step 2 restores that state (checked against what was
    saved) and the run completes with one restart."""
    tcfg = tcfgs.reduced_config()
    model, state = tcol.train_state_from_numpy(ref_state, tcfg, device="cpu")
    opt = topt.adamw(topt.AdamWConfig(schedule=topt.constant_schedule(1e-3)))
    step = tloop.make_train_step(tcol.loss_fn(model), opt, compression="int8")
    it = rsyn.colbert_batches(tcfg.backbone.vocab, 4, q_len=8, d_len=16, nway=tcfg.nway, seed=2)
    batches = [next(it) for _ in range(4)]
    saved = []

    def step_fn(s, b):
        p, o, _ = step(s["params"], s["opt"], b)
        out = {"params": p, "opt": o}
        saved.append(tcol.numpy_train_state(out))
        return out

    def inject(n):
        if n == 2 and not restored:
            raise RuntimeError("injected")

    restored = []
    final_state, final, restarts = tft.run_supervised(
        step_fn, state, batches, ckpt_dir=str(tmp_path), ckpt_every=2,
        failure_injector=inject, on_restore=lambda s, st: restored.append((s, st)))
    assert (final, restarts) == (4, 1) and restored[0][1] == 2
    _assert_trees_equal(tcol.numpy_train_state(restored[0][0]), saved[1])
    assert int(final_state["opt"]["step"]) == int(ref_state["opt"]["step"]) + 3
    assert _steps_on_disk(tmp_path) == [2, 4]


def test_step_watchdog_flags_the_reference_stragglers():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.9, 1.1, 60)) + [5.0, 1.0, 2.6, 3.0] + list(rng.uniform(1, 2, 20))
    times[2] = 9.0  # before 5 observations: never a straggler
    want, got = rft.StepWatchdog(threshold=2.5, window=10), tft.StepWatchdog(threshold=2.5, window=10)
    flags = [(want.observe(i, t), got.observe(i, t)) for i, t in enumerate(times)]
    assert all(w == g for w, g in flags)
    assert got.stragglers == want.stragglers and len(got.stragglers) >= 2
    assert all(s[0] != 2 for s in got.stragglers)
