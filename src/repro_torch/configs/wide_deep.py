"""wide-deep [arXiv:1606.07792]: a linear wide part over hashed crosses
and a deep MLP over 40 embedded sparse fields (the counterpart of
``repro/configs/wide_deep.py``)."""
from repro_torch.configs import common
from repro_torch.models.recsys import RecSysConfig

FAMILY = "recsys"


def full_config() -> RecSysConfig:
    return RecSysConfig(
        name="wide-deep",
        interaction="concat",
        n_sparse=40,
        embed_dim=32,
        hash_size=1 << 20,
        mlp=(1024, 512, 256),
        n_dense=13,
    )


def reduced_config() -> RecSysConfig:
    return RecSysConfig(
        name="wide-deep-reduced",
        interaction="concat",
        n_sparse=6,
        embed_dim=8,
        hash_size=64,
        mlp=(32, 16),
        n_dense=3,
    )


CELLS = common.recsys_cells()
