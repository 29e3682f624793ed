"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (the counterpart
of ``repro/configs/bst.py``): one transformer block over the 20-item
behavior sequence and the target item, then a 1024-512-256 MLP."""
from repro_torch.configs import common
from repro_torch.models.recsys import RecSysConfig

FAMILY = "recsys"


def full_config() -> RecSysConfig:
    return RecSysConfig(
        name="bst",
        interaction="transformer-seq",
        n_sparse=0,
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp=(1024, 512, 256),
        n_dense=13,
        item_vocab=4_000_000,  # Taobao-scale item catalog
    )


def reduced_config() -> RecSysConfig:
    return RecSysConfig(
        name="bst-reduced",
        interaction="transformer-seq",
        n_sparse=0,
        embed_dim=8,
        seq_len=6,
        n_blocks=1,
        n_heads=2,
        mlp=(16, 8),
        n_dense=3,
        item_vocab=256,
    )


CELLS = common.recsys_cells()
