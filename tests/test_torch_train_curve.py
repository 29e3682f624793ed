"""Fifty bf16 training steps at ``launch/train.py``'s peak learning rate:
the port's loss curve against the reference's, from one state over the
same batches.

The question it settles: at full width and peak lr 3e-4 the port's
ColBERTv2 loss climbed above its start (an H100 run), and full width
cannot run through the reference here.  The reduced config in bf16 (the
full config's compute dtype, remat on), ``launch/train.py``'s batches (B 8
of 8-token queries and 16-token passages) and its cosine schedule (20
warm-up steps) run in both packages from the reference's initial
weights.  If the port departed from the reference, the curves would part;
they track each other, and both end higher than they start, so the climb
is the objective's at this learning rate, not the port's.

Tolerances: each step's loss within 2**-4 relative (bf16's roundings
differ between XLA and PyTorch, and 50 steps compound them through the
weights; measured at most 2.9%), and the mean over the first and over the
last ten steps within 1% (measured 0.1%).

    PYTHONPATH=src python tests/test_torch_train_curve.py   # prints both curves
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import colbertv2 as rcfgs  # noqa: E402
from repro.data import synthetic as rsyn  # noqa: E402
from repro.models import colbert as rcol  # noqa: E402
from repro.training import loop as rloop  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

STEPS, B, LR, WARMUP = 50, 8, 3e-4, 20
STEP_RTOL, MEAN_RTOL, WINDOW = 2.0**-4, 1e-2, 10


def curves():
    """(the reference's losses, the port's) over STEPS bf16 steps."""
    torch.set_num_threads(2)
    r16 = rcfgs.reduced_config()
    r16 = dataclasses.replace(r16, backbone=dataclasses.replace(r16.backbone, dtype=jnp.bfloat16))
    t16 = tcfgs.reduced_config()
    t16 = dataclasses.replace(t16, backbone=dataclasses.replace(t16.backbone, dtype=torch.bfloat16))
    tree = jax.tree_util.tree_map(
        np.array, jax.jit(rcol.init_params, static_argnums=1)(jax.random.PRNGKey(0), r16))
    r_opt = ropt.adamw(ropt.AdamWConfig(schedule=ropt.cosine_schedule(LR, WARMUP, STEPS)))
    t_opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(LR, WARMUP, STEPS)))
    r_step = jax.jit(rloop.make_train_step(lambda p, b: rcol.train_loss(p, r16, b), r_opt))
    model, state = tcol.train_state_from_numpy({"params": tree}, t16, device="cpu")
    t_step = tloop.make_train_step(tcol.loss_fn(model), t_opt)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs, tp = rloop.init_opt_state(r_opt, rp), state["params"]
    ts = tloop.init_opt_state(t_opt, tp)
    batches = rsyn.colbert_batches(r16.backbone.vocab, B, q_len=8, d_len=16, nway=r16.nway)
    ref, port = [], []
    for _ in range(STEPS):
        b = next(batches)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = t_step(tp, ts, b)
        ref.append(float(rm["loss"]))
        port.append(float(tm["loss"]))
    return np.asarray(ref), np.asarray(port)


def test_bf16_loss_curve_at_peak_lr_tracks_the_reference():
    ref, port = curves()
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, rtol=STEP_RTOL)
    for window in (slice(0, WINDOW), slice(STEPS - WINDOW, STEPS)):
        np.testing.assert_allclose(port[window].mean(), ref[window].mean(), rtol=MEAN_RTOL)


if __name__ == "__main__":
    ref, port = curves()
    for i, (r, p) in enumerate(zip(ref, port)):
        print(f"step {i:2d}  reference {r:.6f}  port {p:.6f}  rel {abs(p / r - 1):.2e}")
    print(f"max rel {np.max(np.abs(port / ref - 1)):.4f}")
    for name, w in (("first", slice(0, WINDOW)), ("last", slice(STEPS - WINDOW, STEPS))):
        print(f"{name} {WINDOW} mean: reference {ref[w].mean():.6f}  port {port[w].mean():.6f}")
