"""granite-34b [arXiv:2405.04324]: 88-layer MQA (one KV head) code model,
with torch dtypes (the counterpart of ``repro/configs/granite_34b.py``)."""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-34b",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=1024,
        k_chunk=1024,
    )


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-34b-reduced",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=1,  # exercise MQA
        d_ff=160,
        vocab=256,
        dtype=torch.float32,
        q_chunk=16,
        k_chunk=16,
    )


CELLS = common.lm_cells(long_skip=common.FULL_ATTENTION_LONG_SKIP)
