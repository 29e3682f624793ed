"""Cell builder of the port (the counterpart of ``repro.launch.cells``): one
(arch x input-shape) cell -> a callable and its inputs.

Ported: smoke mode (the reduced config, seeded weights and tensors, one
real step) of the LM family's ``train``, ``prefill`` and ``decode`` cells,
with the reference's model FLOPs.  A train cell's callable is a
``make_train_step`` over ``_default_optimizer()`` with the cell's
``n_micro`` and ``cast_dtype=cfg.dtype``, and its arguments ``(params,
opt_state, batch)``; the step updates the first two in place, as the
reference's cell donates them (``donate_argnums`` ``(0, 1)``).  Not yet: dry mode (the full config lowered for the
multi-pod dry-run) and the retrieval family's cells, ROADMAP Queue 1 item
8.5; the recsys and GNN families, item 9.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.configs.common import ShapeCell
from repro_torch.models import transformer as T
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass
class BuiltCell:
    arch: str
    cell: str
    kind: str
    fn: typing.Callable
    args: tuple
    model_flops: float = 0.0


def _lm_attn_flops(cfg: T.TransformerConfig, B, Sq, Skv_avg) -> float:
    return cfg.n_layers * 4.0 * B * Sq * Skv_avg * cfg.n_heads * cfg.d_head


def _default_optimizer() -> opt_lib.Optimizer:
    return opt_lib.adamw(
        opt_lib.AdamWConfig(schedule=opt_lib.cosine_schedule(3e-4, 100, 10000))
    )


def _train_pieces(loss_fn, params, n_micro: int, batch: dict, cast_dtype=None):
    """A train cell's step and arguments, the reference's smoke-mode
    ``_train_pieces``: AdamW on the default schedule, fresh state, the
    parameters and state donated to the step."""
    optimizer = _default_optimizer()
    step = train_loop.make_train_step(loss_fn, optimizer, n_micro=n_micro,
                                      cast_dtype=cast_dtype, donate=True)
    return step, (params, optimizer.init(params), batch)


def lm_model_flops(cfg: T.TransformerConfig, kind: str, seq_len: int, batch: int) -> float:
    """The reference's model FLOPs of one LM step: a train step of
    ``batch`` x ``seq_len`` tokens (6 N per token plus three times the
    prefill's attention), a prefill (2 N per token plus causal attention
    over half the keys, or the window), or one decode step against a cache
    of ``cache_seq_len`` slots (2 N per row plus attention over the
    cache)."""
    if kind == "train":
        s_eff = min(seq_len, cfg.window) if cfg.window else seq_len
        return 6.0 * cfg.active_params() * batch * seq_len + 3 * _lm_attn_flops(
            cfg, batch, seq_len, s_eff / 2)
    if kind == "prefill":
        s_eff = min(seq_len, cfg.window) if cfg.window else seq_len
        return 2.0 * cfg.active_params() * batch * seq_len + _lm_attn_flops(
            cfg, batch, seq_len, s_eff / 2)
    if kind == "decode":
        Sc = T.cache_seq_len(cfg, seq_len)
        return 2.0 * cfg.active_params() * batch + cfg.n_layers * 4.0 * batch * Sc * (
            cfg.n_heads * cfg.d_head)
    raise ValueError(kind)


def _lm_cell(arch, cfg: T.TransformerConfig, cell: ShapeCell, p, device) -> BuiltCell:
    S, B = p["seq_len"], p["global_batch"]
    kind = cell.kind
    flops = lm_model_flops(cfg, kind, S, B)
    if kind == "train":
        model = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device, head=True)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32,
                                    device=device) for k in ("tokens", "targets")}
        fn, args = _train_pieces(T.loss_fn(model), T.train_params(model), p.get("n_micro", 1),
                                 batch, cast_dtype=cfg.dtype)
        return BuiltCell(arch, cell.name, kind, fn, args, flops)
    model = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                          head=True, param_dtype=cfg.dtype)
    if kind == "prefill":
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)),
                                 dtype=torch.int32, device=device)
        return BuiltCell(arch, cell.name, kind, T.prefill, (model, tokens), flops)
    if kind == "decode":
        cache = T.init_cache(cfg, B, S, device)
        tokens = torch.zeros((B,), dtype=torch.int32, device=device)
        return BuiltCell(arch, cell.name, kind, T.decode_step,
                         (model, cache, tokens, min(S - 1, 5)), flops)
    raise ValueError(kind)


def build_cell(arch_id: str, cell_name: str, *, mode: str = "smoke",
               device: str | torch.device = "cuda") -> BuiltCell:
    """The cell's callable and inputs: ``fn(*args)`` runs one step."""
    if mode != "smoke":
        raise NotImplementedError(
            f"mode {mode!r}: the dry-run cells are not ported (ROADMAP Queue 1 item 8.5)")
    mod = config_registry.get(arch_id)
    if mod.FAMILY != "lm":
        raise NotImplementedError(
            f"{arch_id}: only the LM family's cells are ported (the retrieval cells: "
            "ROADMAP Queue 1 item 8.5)")
    cell = config_registry.cells_of(arch_id)[cell_name]
    return _lm_cell(arch_id, mod.reduced_config(), cell, cell.reduced, resolve_device(device))
