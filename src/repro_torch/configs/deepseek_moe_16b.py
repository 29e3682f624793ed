"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 64 routed experts
top-6 plus 2 shared, the first layer dense (d_ff 10944), with torch dtypes
(the counterpart of ``repro/configs/deepseek_moe_16b.py``)."""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=102400,
        n_experts=64,
        top_k=6,
        n_shared=2,
        first_dense=1,
        d_ff_dense=10944,
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=1024,
        k_chunk=1024,
        moe_group=256,
    )


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b-reduced",
        n_layers=3,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=24,
        vocab=256,
        n_experts=8,
        top_k=3,
        n_shared=1,
        first_dense=1,
        d_ff_dense=96,
        dtype=torch.float32,
        q_chunk=16,
        k_chunk=16,
        moe_group=8,
    )


CELLS = common.lm_cells(long_skip=common.FULL_ATTENTION_LONG_SKIP)
