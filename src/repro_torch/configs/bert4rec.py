"""bert4rec [arXiv:1904.06690]: bidirectional masked-item model (the
counterpart of ``repro/configs/bert4rec.py``); its catalog softmax is a
retrieval step: ``retrieval_cand`` scores 1M items by a dot product against
the item table, and ``core.item_retrieval`` serves the same table through
the PLAID pipeline."""
from repro_torch.configs import common
from repro_torch.models.recsys import RecSysConfig

FAMILY = "recsys"


def full_config() -> RecSysConfig:
    return RecSysConfig(
        name="bert4rec",
        interaction="bidir-seq",
        n_sparse=0,
        embed_dim=64,
        seq_len=200,
        n_blocks=2,
        n_heads=2,
        mlp=(),
        n_dense=0,
        item_vocab=1_000_000,
    )


def reduced_config() -> RecSysConfig:
    return RecSysConfig(
        name="bert4rec-reduced",
        interaction="bidir-seq",
        n_sparse=0,
        embed_dim=16,
        seq_len=12,
        n_blocks=2,
        n_heads=2,
        mlp=(),
        n_dense=0,
        item_vocab=200,
    )


CELLS = common.recsys_cells()
