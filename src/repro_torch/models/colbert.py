"""ColBERT late-interaction encoder in PyTorch (the counterpart of the
encoder half of ``repro.models.colbert``).

A bidirectional transformer backbone (``models.transformer`` with
``causal=False``), a linear projection to ``out_dim`` and L2 normalisation:
the token vectors PLAID indexes and searches.  ``train_loss`` waits for the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import ieee_f32_matmul
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ColBERTConfig:
    backbone: T.TransformerConfig = dataclasses.field(
        default_factory=lambda: T.TransformerConfig(causal=False)
    )
    out_dim: int = 128

    @property
    def name(self):
        return "colbertv2"


class ColBERT(nn.Module):
    """The backbone and its ``(d_model, out_dim)`` float32 projection."""

    def __init__(self, cfg: ColBERTConfig, backbone: T.Transformer):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        self.proj = nn.Parameter(
            torch.zeros((cfg.backbone.d_model, cfg.out_dim), device=backbone.device),
            requires_grad=False,
        )

    @property
    def device(self) -> torch.device:
        return self.backbone.device

    def numpy_params(self) -> dict:
        """The reference's ``colbert.init_params`` tree as numpy (``lm_head``
        excepted)."""
        return {"backbone": self.backbone.numpy_params(), "proj": self.proj.cpu().numpy()}


@torch.no_grad()
def encode(model: ColBERT, tokens, mask=None) -> torch.Tensor:
    """tokens (B, S) -> unit-norm token vectors (B, S, out_dim) f32, on the
    model's device (tokens and mask are moved there).

    The projection runs in the compute dtype, then ``.float()``; rows are
    divided by ``max(norm, 1e-6)``; ``mask`` (B, S) zeroes padded tokens.
    """
    dev = model.device
    tokens = torch.as_tensor(tokens, device=dev)
    h = model.backbone(tokens)
    dt = model.cfg.backbone.dtype
    with ieee_f32_matmul():
        e = (h.to(dt) @ model.backbone.compute_weight(model.proj)).float()
    e = e / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    if mask is not None:
        e = e * torch.as_tensor(mask, device=dev).to(e.dtype)[..., None]
    return e


def maxsim_scores(q_emb: torch.Tensor, d_emb: torch.Tensor, d_mask=None) -> torch.Tensor:
    """q (B, Lq, D) vs d (N, Ld, D) -> (B, N) late-interaction scores."""
    with ieee_f32_matmul():
        s = torch.einsum("bqd,ntd->bnqt", q_emb, d_emb)
    if d_mask is not None:
        s = torch.where(d_mask[None, :, None, :] > 0, s, -1e4)
    return s.amax(dim=-1).sum(dim=-1)  # max over doc tokens, sum over q


@torch.no_grad()
def params_from_numpy(
    tree: Mapping, cfg: ColBERTConfig, device: str | torch.device = "cuda"
) -> ColBERT:
    """A :class:`ColBERT` holding the reference's ``colbert.init_params``
    tree (converted to numpy) value for value; ``backbone/lm_head`` is
    dropped (``encode`` does not use it)."""
    model = ColBERT(cfg, T.params_from_numpy(tree["backbone"], cfg.backbone, device))
    T._fill(model.proj, np.asarray(tree["proj"]), "proj")
    return model


@torch.no_grad()
def init_params(
    cfg: ColBERTConfig, generator: torch.Generator, device: str | torch.device = "cuda"
) -> ColBERT:
    """Random weights with the reference's shapes and scales, drawn from
    ``generator`` (not ``jax.random``'s numbers)."""
    model = ColBERT(cfg, T.init_params(cfg.backbone, generator, device))
    scale = (2.0 / (cfg.backbone.d_model + cfg.out_dim)) ** 0.5
    model.proj.copy_(T._normal(tuple(model.proj.shape), scale, generator))
    return model
