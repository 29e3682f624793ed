"""Training on the card (``gpu`` cases; they skip without one).  Imports no
JAX: the CPU run of the port is the reference here, as the CPU tests hold
that run against the JAX package.

* The reduced config in f32, three steps on ``cuda`` and on ``cpu`` from
  one state: losses within rtol 1e-4 (TF32 stays off around the port's f32
  products, forward and backward; cuBLAS and the CPU sum in other orders).
* ``n_micro`` 4 against 1 on one batch at reduced width, in-batch
  negatives off (with them, a microbatch's loss sees only its own
  passages): loss rtol 1e-5; parameters rtol 1e-5 plus 1e-6, a thousandth
  of the first step's lr: that step moves a weight by lr * g / (|g| +
  eps), which follows the last bits of a g near 0.
* ColBERTv2's full widths (12 layers, d 768, 48 padded heads, vocab
  30528, bf16) at B = 8 queries of 32 tokens and passages of 180, peak lr
  1e-5 (larger rates make this temperature-free MaxSim loss climb before
  it falls): the losses are finite, and the mean loss over four held-out
  batches is lower after four steps than before (each step's own loss is
  on a new batch and swings by +-1 from batch to batch).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import colbertv2 as tcfgs  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import colbert as tcol  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import tree as ttree  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(cfg, device, seed=0):
    model = tcol.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    state = tcol.numpy_train_state({"params": tcol.train_params(model)})
    return tcol.train_state_from_numpy(state, cfg, device=device)


def _run(cfg, device, steps, n_micro=1, batch=4, q_len=8, d_len=16, lr=1e-3, held_out=None):
    """Train from the seeded state; returns the step losses and the
    parameters, or with ``held_out`` batches the mean held-out loss before
    and after the steps."""
    model, state = _state(cfg, device)
    opt = topt.adamw(topt.AdamWConfig(schedule=topt.cosine_schedule(lr, 1, 10)))
    step = tloop.make_train_step(tcol.loss_fn(model), opt, n_micro=n_micro)
    p, o = state["params"], tloop.init_opt_state(opt, state["params"])
    it = tsyn.colbert_batches(cfg.backbone.vocab, batch, q_len=q_len, d_len=d_len,
                              nway=cfg.nway, seed=1)
    before = held_out and _held_out_loss(cfg, state["params"], held_out, device)
    losses = []
    for _ in range(steps):
        p, o, m = step(p, o, next(it))
        losses.append(float(m["loss"]))
    if held_out:
        return losses, (before, _held_out_loss(cfg, p, held_out, device))
    return losses, p


def _held_out_loss(cfg, params, batches, device):
    judge = tcol.assign_params(tcol.ColBERT(cfg, tT.Transformer(cfg.backbone, device)), params)
    with torch.no_grad():
        return sum(float(tcol.train_loss(judge, cfg, b)[0]) for b in batches) / len(batches)


@pytest.mark.gpu
def test_reduced_steps_on_the_card_equal_the_cpu(card):
    cfg = tcfgs.reduced_config()
    on_card, _ = _run(cfg, card, 3)
    on_cpu, _ = _run(cfg, "cpu", 3)
    for a, b in zip(on_card, on_cpu):
        assert a == pytest.approx(b, rel=1e-4)


@pytest.mark.gpu
def test_microbatches_equal_one_batch_on_the_card(card):
    cfg = dataclasses.replace(tcfgs.reduced_config(), use_ib_negatives=False)
    one, p1 = _run(cfg, card, 1, n_micro=1, batch=8)
    four, p4 = _run(cfg, card, 1, n_micro=4, batch=8)
    assert four[0] == pytest.approx(one[0], rel=1e-5)
    for a, b in zip(ttree.leaves(p4), ttree.leaves(p1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_full_width_loss_is_finite_and_falls(card):
    cfg = tcfgs.full_config()
    it = tsyn.colbert_batches(cfg.backbone.vocab, 8, q_len=32, d_len=180, nway=cfg.nway, seed=9)
    held_out = [{k: torch.as_tensor(v, device=card) for k, v in next(it).items()} for _ in range(4)]
    losses, (before, after) = _run(cfg, card, 4, batch=8, q_len=32, d_len=180, lr=1e-5,
                                   held_out=held_out)
    assert all(torch.isfinite(torch.tensor(x)) for x in losses)
    assert after < before
