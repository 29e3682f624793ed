"""plaid-colbertv2: the paper's own encoder, a BERT-base-class
late-interaction model (~110M parameters), with torch dtypes (the
counterpart of ``repro/configs/colbertv2.py``; its dry-run cells and the
training-only ``nway`` stay in the reference)."""
import torch

from repro_torch.models.colbert import ColBERTConfig
from repro_torch.models.transformer import TransformerConfig


def full_config() -> ColBERTConfig:
    backbone = TransformerConfig(
        name="colbert-backbone",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=30528,  # bert-base vocab padded to /16
        causal=False,
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=256,
        k_chunk=256,
    )
    return ColBERTConfig(backbone=backbone, out_dim=128)


def reduced_config() -> ColBERTConfig:
    backbone = TransformerConfig(
        name="colbert-backbone-reduced",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=128,
        causal=False,
        dtype=torch.float32,
        q_chunk=8,
        k_chunk=8,
    )
    return ColBERTConfig(backbone=backbone, out_dim=16)
