"""The port's training substrate against the reference: AdamW, its
schedules, the global-norm clip and ``apply_updates``
(``repro.training.optimizer``), int8 compression with error feedback
(``repro.distributed.compression``), the train step
(``repro.training.loop``) and ``launch/train.py``.

Tolerances, with their reasons:

* the optimizer on the same numpy gradients: 1e-6 (f32; ``pow``, ``cos``
  and the global norm's sum order may differ by an ulp);
* ``quantize`` / ``dequantize``: bit for bit against the reference's code
  run op by op.  Under ``jax.jit`` XLA rewrites ``x / 127`` as ``x * (1 /
  127)``, which moves some scales by one ulp, so the comparison does not
  jit the reference;
* five train steps (reduced ColBERTv2 in f32): losses rtol 1e-4.  Without
  compression both packages run free from one carried-over state.  With
  int8 each step starts from the reference's state carried over anew:
  the frameworks' gradients differ by ~1e-6, and int8 rounding turns an
  element near a half-step into a whole quantization step, so free-running
  int8 losses drift apart by ~2e-4 within five steps.  Each int8 step's
  output is held to the reference's before the next carry: the error
  feedback within one quantization step (its block's scale), and within a
  thousandth of one in all but 1% of a leaf's elements, the weights
  within rtol 1e-4 and 2.5 lr (an AdamW step moves a weight by at most
  1.17 lr for b1 0.9, b2 0.95, whatever gradient one rounding changed).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.distributed import compression as rcomp  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402

torch.set_num_threads(2)  # the test workers share the host's cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(tree):
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _n(tree):
    return ttree.tree_map(lambda t: t.numpy(), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# --------------------------------------------------------------------------
# schedules and AdamW
# --------------------------------------------------------------------------
SCHEDULES = {
    "cosine": (lambda m: m.cosine_schedule(3e-4, 20, 100)),
    "cosine_floor0": (lambda m: m.cosine_schedule(1.0, 10, 110, floor=0.0)),
    "linear": (lambda m: m.linear_schedule(2.0, 5, 105)),
    "constant": (lambda m: m.constant_schedule(1e-3)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    want, got = SCHEDULES[name](ropt), SCHEDULES[name](topt)
    for step in (0, 1, 4, 5, 10, 19, 20, 21, 57, 100, 105, 110, 130):
        w = float(want(jnp.int32(step)))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=1e-9, err_msg=str(step))
        assert float(got(step)) == float(g)


def _opt_case(rng):
    params = {"layer": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                        "b": rng.standard_normal(6).astype(np.float32)},
              "stack": [rng.standard_normal((3, 2)).astype(np.float32) for _ in range(2)]}
    ref_params = dict(params, stack=np.stack(params["stack"]))
    return params, ref_params


@pytest.mark.parametrize("grad_scale", [0.01, 100.0])  # clip idle / clip active
def test_adamw_matches_reference_over_steps(grad_scale):
    rng = np.random.default_rng(0)
    params, ref_params = _opt_case(rng)
    cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(1e-2, 2, 10), **cfg))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(1e-2, 2, 10), **cfg))
    rp, tp = _j(ref_params), _t(params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for _ in range(4):
        g = ttree.tree_map(lambda p: (rng.standard_normal(p.shape) * grad_scale).astype(np.float32), params)
        rg = dict(g, stack=np.stack(g["stack"]))
        np.testing.assert_allclose(float(topt.global_norm(_t(g))),
                                   float(ropt.global_norm(_j(rg))), rtol=1e-6)
        r_up, rs = r_opt.update(_j(rg), rs, rp)
        t_up, ts = t_opt.update(_t(g), ts, tp)
        rp, tp = ropt.apply_updates(rp, r_up), topt.apply_updates(tp, t_up)
        for got, want in ((t_up, r_up), (ts["mu"], rs["mu"]), (ts["nu"], rs["nu"]), (tp, rp)):
            got = _n(got)
            got = dict(got, stack=np.stack(got["stack"]))
            for path, w in jax.tree_util.tree_leaves_with_path(want):
                gg = got
                for k in path:
                    gg = gg[k.key]
                np.testing.assert_allclose(gg, np.asarray(w), **OPT_TOL)
        assert int(ts["step"]) == int(rs["step"])


def test_apply_updates_casts_back_to_each_parameter_dtype():
    p = {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16), "b": torch.tensor([1.0, -1.0])}
    u = {"a": torch.tensor([0.001, 0.5]), "b": torch.tensor([0.25, 0.5])}
    got = topt.apply_updates(p, u)
    want = ropt.apply_updates({"a": jnp.asarray([1.0, 2.0], jnp.bfloat16), "b": jnp.asarray([1.0, -1.0])},
                              {"a": jnp.asarray([0.001, 0.5]), "b": jnp.asarray([0.25, 0.5])})
    assert got["a"].dtype == torch.bfloat16 and got["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["a"].float().numpy(), np.asarray(want["a"], np.float32))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


# --------------------------------------------------------------------------
# int8 compression with error feedback
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((777,), 1.0), ((33, 256), 1e-3), ((5, 7, 9), 1e3),
                                         ((256,), 0.0), ((2, 300), 1e-30)])
def test_quantize_bit_identical_to_reference(shape, scale):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    # block 0's max is 127 * scale: at scale 1 its scale is 1 and these
    # values sit half-way between two int8 steps (round half to even)
    x.reshape(-1)[:6] = np.float32([127.0, 0.5, 1.5, 2.5, -0.5, -1.5]) * np.float32(scale)
    rq, rs, rn = rcomp.quantize(jnp.asarray(x))
    tq, ts, tn = tcomp.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tn == rn
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(rs).view(np.uint32))
    rd, td = rcomp.dequantize(rq, rs, rn, shape), tcomp.dequantize(tq, ts, tn, shape)
    np.testing.assert_array_equal(td.numpy().view(np.uint32), np.asarray(rd).view(np.uint32))


def test_error_feedback_matches_reference_over_three_steps():
    """Bit for bit, with a layer stack (a list in the port, one stacked
    array in the reference) whose layers' 300 values do not fill whole
    blocks of 256: the stack is quantized as ONE leaf, its blocks running
    across the layer boundary, as the reference's."""
    rng = np.random.default_rng(5)
    r_ef = t_ef = None
    for _ in range(3):
        g = {"a": rng.standard_normal(300), "b": {"c": rng.standard_normal((17, 19))},
             "stack": [rng.standard_normal((3, 100)) for _ in range(2)]}
        g = ttree.tree_map(lambda x: (x * 0.1).astype(np.float32), g)
        r_out, r_ef = rcomp.compress_decompress_with_feedback(_j(ttree.to_numpy(g)), r_ef)
        t_out, t_ef = tcomp.compress_decompress_with_feedback(_t(g), t_ef)
        assert isinstance(t_out["stack"], list) and isinstance(t_ef["stack"], list)
        for got, want in ((t_out, r_out), (t_ef, r_ef)):
            for path, w in jax.tree_util.tree_leaves_with_path(want):
                gg = ttree.to_numpy(got)
                for k in path:
                    gg = gg[k.key]
                np.testing.assert_array_equal(gg.view(np.uint32), np.asarray(w).view(np.uint32),
                                              err_msg=jax.tree_util.keystr(path))
    assert np.abs(t_ef["a"].numpy()).max() > 0


# --------------------------------------------------------------------------
# the train step: reduced ColBERTv2, f32
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced_tree():
    init = jax.jit(rcol.init_params, static_argnums=1)
    return jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0), rcfgs.reduced_config()))


SCHED = dict(peak_lr=1e-3, warmup=2, total=10)
t_opt_lr = topt.cosine_schedule(**SCHED)


def _steps(n_micro, compression):
    rcfg, tcfg = rcfgs.reduced_config(), tcfgs.reduced_config()
    sched = SCHED
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(**sched)))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(**sched)))
    r_step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, rcfg, b), r_opt,
                                           n_micro=n_micro, compression=compression))
    return rcfg, tcfg, r_opt, t_opt, r_step


def _block_scales(deq: np.ndarray, block: int = 256) -> np.ndarray:
    """Each element's quantization step, from the dequantized values: a
    block's largest |value| quantizes to 127 exactly, so its step is that
    value / 127."""
    flat = deq.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % block)).reshape(-1, block)
    return np.repeat(np.abs(blocks).max(1) / 127, block)[: flat.size].reshape(deq.shape)


def _by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(ttree.to_numpy(tree))}


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_track_reference(reduced_tree, n_micro, compression):
    rcfg, tcfg, r_opt, t_opt, r_step = _steps(n_micro, compression)
    rp = _j(reduced_tree)
    rs = rloop.init_opt_state(r_opt, rp, compression)
    model, state = tcol.train_state_from_numpy(
        {"params": reduced_tree, "opt": jax.tree_util.tree_map(np.array, rs)}, tcfg, device="cpu")
    seen = {}

    def update(grads, opt_state, params):  # the optimizer, seeing the dequantized gradients
        seen["grads"] = grads
        return t_opt.update(grads, opt_state, params)

    t_step = tloop.make_train_step(tcol.loss_fn(model), topt.Optimizer(t_opt.init, update),
                                   n_micro=n_micro, compression=compression)
    tp, ts = state["params"], state["opt"]
    assert set(ts) == set(rs)
    batches = rsyn.colbert_batches(rcfg.backbone.vocab, 4, q_len=8, d_len=16, nway=rcfg.nway, seed=3)
    losses = []
    for _ in range(5):
        b = next(batches)
        if compression:  # int8: each step from the reference's state (docstring)
            _, carried = tcol.train_state_from_numpy(
                jax.tree_util.tree_map(np.array, {"params": rp, "opt": rs}), tcfg, device="cpu")
            tp, ts = carried["params"], carried["opt"]
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(tp, ts, b)
        assert set(tm) == set(rm)
        assert int(tm["step"]) == int(rm["step"])
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-4)
        losses.append(float(tm["loss"]))
        if compression:  # this step's output against the reference's, before the next carry
            lr = float(t_opt_lr(int(tm["step"])))
            deq, got_ef, want_ef = _by_path(seen["grads"]), _by_path(ts["ef"]), _by_path(rs["ef"])
            assert got_ef.keys() == want_ef.keys() == deq.keys()
            for name, w in want_ef.items():
                step = _block_scales(deq[name])
                off = np.abs(got_ef[name] - w)
                assert (off <= 1.01 * step).all(), name
                assert (off > 1e-3 * step).mean() <= 0.01, name  # measured: one element a leaf
            got_p, want_p = _by_path(tp), _by_path(rp)
            for name, w in want_p.items():
                np.testing.assert_allclose(got_p[name], w, rtol=1e-4, atol=2.5 * lr, err_msg=name)
    assert losses[-1] < losses[0]
    if compression:
        assert np.abs(ttree.leaves(ts["ef"])[0].numpy()).max() > 0


def test_microbatches_equal_one_batch_without_in_batch_negatives(reduced_tree):
    """With in-batch negatives a microbatch's loss sees only its own
    passages, so only ``use_ib_negatives=False`` makes 2 microbatches the
    same function as one batch."""
    tcfg = dataclasses.replace(tcfgs.reduced_config(), use_ib_negatives=False)
    opt = topt.adamw(topt.AdamWConfig(schedule=topt.constant_schedule(1e-3)))
    b = next(rsyn.colbert_batches(tcfg.backbone.vocab, 4, q_len=8, d_len=16, nway=tcfg.nway, seed=4))
    out = {}
    for n in (1, 2, 4):
        model, state = tcol.train_state_from_numpy({"params": reduced_tree}, tcfg, device="cpu")
        p = state["params"]
        out[n] = tloop.make_train_step(tcol.loss_fn(model), opt, n_micro=n)(
            p, tloop.init_opt_state(opt, p), b)
    for n in (2, 4):
        np.testing.assert_allclose(float(out[n][2]["loss"]), float(out[1][2]["loss"]), rtol=1e-6)
        for a, w in zip(ttree.leaves(out[n][0]), ttree.leaves(out[1][0])):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)
        assert set(out[n][2]) == {"loss", "step"}


def test_train_step_refuses_what_is_not_ported(reduced_tree):
    """A mesh whose "model" axis splits weights (tensor parallelism, FSDP)
    is refused when the step runs on it; ``param_axes`` itself is
    accepted, as are a bad compression's and a bad split's refusals."""
    opt = topt.adamw(topt.AdamWConfig())
    tp = tmesh.Mesh(("cpu",) * 4, axes=(("data", 2), ("model", 2)))
    axes_step = tloop.make_train_step(lambda p, b: None, opt, param_axes={})
    with tsharding.use_mesh(tp), pytest.raises(NotImplementedError, match=r"Queue 1 item 8\.5\.6"):
        axes_step({}, {}, {})
    with pytest.raises(ValueError, match="compression"):
        tloop.make_train_step(lambda p, b: None, opt, compression="fp8")
    model, state = tcol.train_state_from_numpy({"params": reduced_tree}, tcfgs.reduced_config(),
                                               device="cpu")
    step = tloop.make_train_step(tcol.loss_fn(model), opt, n_micro=3)
    b = next(rsyn.colbert_batches(128, 4, q_len=8, d_len=16, nway=2))
    with pytest.raises(ValueError, match="n_micro"):
        step(state["params"], tloop.init_opt_state(opt, state["params"]), b)


def test_opt_state_structure_matches_reference(reduced_tree):
    r_opt = ropt.adamw(ropt.AdamWConfig())
    want = jax.tree_util.tree_map(np.asarray, rloop.init_opt_state(r_opt, _j(reduced_tree), "int8"))
    model = tcol.params_from_numpy(reduced_tree, tcfgs.reduced_config(), device="cpu")
    params = tcol.train_params(model)
    got = tcol.numpy_train_state(tloop.init_opt_state(topt.adamw(topt.AdamWConfig()), params, "int8"))
    no_head = {k: v for k, v in want["mu"]["backbone"].items() if k != "lm_head"}
    for key in ("mu", "nu", "ef"):
        w = dict(want[key], backbone=no_head)
        assert jax.tree_util.tree_structure(got[key]) == jax.tree_util.tree_structure(w), key
        for a, b in zip(jax.tree_util.tree_leaves(got[key]), jax.tree_util.tree_leaves(w)):
            assert a.shape == b.shape and a.dtype == b.dtype and not a.any()
    assert got["step"].dtype == want["step"].dtype and got["step"].shape == ()


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------
def test_launch_train_runs_reduced_steps_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "plaid-colbertv2",
         "--reduced", "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--ckpt-every", "2", "--compression", "int8"],
        capture_output=True, text=True, env=env, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("arch=plaid-colbertv2 params=") and lines[0].endswith("steps=3")
    assert lines[1].startswith("done: 3 steps in ") and "restarts=0, stragglers=0" in lines[1]
    assert lines[2].startswith("loss ") and " -> " in lines[2]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002", "step_00000003"]
    # a 1 x 1 ("data", "model") mesh trains on one device, as without one
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "plaid-colbertv2", "--reduced", "--steps", "3", "--device", "cpu",
                        "--mesh", "local", "--ckpt-dir", str(tmp_path / "local")],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    local = r.stdout.strip().splitlines()
    assert local[0].endswith("steps=3 mesh={'data': 1, 'model': 1}")
    assert local[2].startswith("loss ")
