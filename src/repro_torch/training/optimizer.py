"""AdamW and learning-rate schedules over trees of tensors (the counterpart
of ``repro.training.optimizer``): ``Optimizer(init, update)`` pairs, as
optax has them.

The reference's semantics, in its f32 order:

* the step is incremented before ``schedule(step)`` is read;
* gradients are clipped to ``clip_norm`` by their global norm, with a
  ``1e-9`` floor under the norm (under tensor parallelism ``update``'s
  ``placements`` make it the whole tree's norm);
* the decoupled weight decay sits inside the update,
  ``-lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)``;
* updates are added in f32 and cast back to each parameter's dtype.

``torch.optim.AdamW`` is not used: it applies the decay as a separate
multiply and has no global-norm clip.  The arithmetic runs as
``torch._foreach_*`` over groups of leaves of at most ``GROUP_ELEMS``
elements (a few launches a group, not a few per tensor; a pass over the
whole tree at once would hold about nine f32 copies of it in temporaries,
52 bytes a parameter at its peak).  ``update`` is functional and returns
new tensors; ``update(..., inplace=True)`` writes ``mu`` and ``nu`` into
the state it was handed instead, and :func:`apply_updates_` the updates
into the parameters (a train step that donates its inputs).  The grouping
and the in-place forms change no bit: each element sees the same f32
operations in the same order.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.training import tree as T


class Optimizer(typing.NamedTuple):
    init: typing.Callable
    update: typing.Callable  # (grads, state, params) -> (updates, state)


# --------------------------------------------------------------------------
# Schedules: step (an int tensor or number) -> f32 learning rate
# --------------------------------------------------------------------------
def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        dec = peak_lr * torch.clamp(1 - (step - warmup) / max(total - warmup, 1), 0, 1)
        return torch.where(step < warmup, warm, dec)

    return lr


def constant_schedule(lr_val: float):
    return lambda step: torch.full((), lr_val, dtype=torch.float32, device=_f32(step).device)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: typing.Callable = dataclasses.field(
        default_factory=lambda: constant_schedule(1e-3)
    )
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def global_norm(tree, placements=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.

    Under tensor parallelism the leaves are this process's slices and
    ``placements`` their ``sharding.Placement`` objects, in ``leaves``
    order: the squares of the split leaves are summed over the
    ``"model"`` sub-mesh; a replicated leaf counts once."""
    sq = [torch.sum(torch.square(x.float())) for x in T.leaves(tree)]
    if placements is None:
        return torch.sqrt(torch.stack(sq).sum())
    zero = torch.zeros((), device=sq[0].device)
    parts = sum((q for q, p in zip(sq, placements) if p.split), zero)
    whole = sum((q for q, p in zip(sq, placements) if not p.split), zero)
    return torch.sqrt(mesh_mod.all_reduce_sum(placements[0].model, parts) + whole)


#: leaves an update pass takes at a time (f32 elements; a larger leaf alone)
GROUP_ELEMS = 1 << 26


def _groups(xs: list) -> list[slice]:
    """Runs of consecutive leaves of at most ``GROUP_ELEMS`` elements."""
    out, start, n = [], 0, 0
    for i, x in enumerate(xs):
        if i > start and n + x.numel() > GROUP_ELEMS:
            out.append(slice(start, i))
            start, n = i, 0
        n += x.numel()
    return out + [slice(start, len(xs))] if xs else out


def adamw(cfg: AdamWConfig) -> Optimizer:
    def init(params):
        zeros = lambda: T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        first = T.leaves(params)[0]
        return {"mu": zeros(), "nu": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=first.device)}

    def update(grads, state, params, *, inplace: bool = False, placements=None):
        step = state["step"] + 1
        gs = T.leaves(grads)
        gn = global_norm(gs, placements)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, stepf)
        bc2 = 1 - torch.pow(cfg.b2, stepf)
        neg_lr = -cfg.schedule(step)
        mus, nus, ps = T.leaves(state["mu"]), T.leaves(state["nu"]), T.leaves(params)
        mu, nu, updates = [], [], []
        for sl in _groups(gs):
            g = torch._foreach_mul([x.float() for x in gs[sl]], scale)
            if inplace:
                m, v = mus[sl], nus[sl]
                torch._foreach_mul_(m, cfg.b1)
                torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
                torch._foreach_mul_(v, cfg.b2)
                torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2), g))
            else:
                m = torch._foreach_add(torch._foreach_mul(mus[sl], cfg.b1),
                                       torch._foreach_mul(g, 1 - cfg.b1))
                v = torch._foreach_add(torch._foreach_mul(nus[sl], cfg.b2),
                                       torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2), g))
            del g
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), cfg.eps)
            adam = torch._foreach_div(torch._foreach_div(m, bc1), den)
            del den
            decay = torch._foreach_mul([p.float() for p in ps[sl]], cfg.weight_decay)
            updates += torch._foreach_mul(torch._foreach_add(adam, decay), neg_lr)
            mu += m
            nu += v
        if inplace:
            mu, nu = mus, nus
        return T.unflatten(params, updates), {
            "mu": T.unflatten(params, mu), "nu": T.unflatten(params, nu), "step": step,
        }

    return Optimizer(init=init, update=update)


def opt_state_axes(param_axes_tree):
    """Optimizer-state logical axes mirror the param axes (mu/nu)."""
    return {"mu": param_axes_tree, "nu": param_axes_tree, "step": ()}


def apply_updates(params, updates):
    """``(p.float() + u).to(p.dtype)`` leaf by leaf."""
    ps = T.leaves(params)
    new = torch._foreach_add([p.float() for p in ps], T.leaves(updates))
    return T.unflatten(params, [n.to(p.dtype) for n, p in zip(new, ps)])


def apply_updates_(params, updates):
    """:func:`apply_updates` written into ``params``' tensors; returns
    ``params``."""
    pairs = list(zip(T.leaves(params), T.leaves(updates)))
    f32 = [(p, u) for p, u in pairs if p.dtype == torch.float32]
    if f32:
        torch._foreach_add_([p for p, _ in f32], [u for _, u in f32])
    for p, u in pairs:
        if p.dtype != torch.float32:
            p.copy_(p.float() + u)
    return params
