"""h2o-danube-3-4b [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention, the only LM arch that runs ``long_500k`` (a window-bounded KV
cache), with torch dtypes (the counterpart of
``repro/configs/h2o_danube3_4b.py``)."""
import torch

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab=32000,
        window=4096,  # Mistral-style sliding window
        tp_multiple=16,
        dtype=torch.bfloat16,
        q_chunk=1024,
        k_chunk=1024,
    )


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="h2o-danube-3-4b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        window=16,
        dtype=torch.float32,
        q_chunk=16,
        k_chunk=16,
    )


CELLS = common.lm_cells(long_skip=None)  # sliding window -> long_500k runs
