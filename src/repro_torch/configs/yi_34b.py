"""yi-34b [arXiv:2403.04652]: llama-arch GQA, with torch dtypes (the
counterpart of ``repro/configs/yi_34b.py``).  56 heads are padded to 64
(kv-group-major) so the flat head count divides a 16-way model axis; the
padded heads are inert."""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=1024,
        k_chunk=1024,
    )


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="yi-34b-reduced",
        n_layers=2,
        d_model=56,  # 7 heads * 8 -> exercises head padding with tp_multiple
        n_heads=7,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        tp_multiple=4,
        dtype=torch.float32,
        q_chunk=16,
        k_chunk=16,
    )


CELLS = common.lm_cells(long_skip=common.FULL_ATTENTION_LONG_SKIP)
