"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 32
experts, top-8, fine-grained d_ff 512, with torch dtypes (the counterpart
of ``repro/configs/granite_moe_1b.py``).  Vocab 49155 is padded to 49168
(masked in the logits)."""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,  # padded_vocab -> 49168
        n_experts=32,
        top_k=8,
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=1024,
        k_chunk=1024,
        moe_group=256,
    )


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-reduced",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        d_ff=16,
        vocab=131,  # non-multiple -> exercises vocab padding
        n_experts=4,
        top_k=2,
        tp_multiple=4,
        dtype=torch.float32,
        q_chunk=16,
        k_chunk=16,
        moe_group=8,
    )


CELLS = common.lm_cells(long_skip=common.FULL_ATTENTION_LONG_SKIP)
