"""xdeepfm [arXiv:1803.05170]: CIN + DNN + linear over 39 sparse fields
(the counterpart of ``repro/configs/xdeepfm.py``)."""
from repro_torch.configs import common
from repro_torch.models.recsys import RecSysConfig

FAMILY = "recsys"


def full_config() -> RecSysConfig:
    return RecSysConfig(
        name="xdeepfm",
        interaction="cin",
        n_sparse=39,
        embed_dim=10,
        hash_size=1 << 20,  # criteo-scale: 39 x 1M rows
        cin_layers=(200, 200, 200),
        mlp=(400, 400),
        n_dense=13,
    )


def reduced_config() -> RecSysConfig:
    return RecSysConfig(
        name="xdeepfm-reduced",
        interaction="cin",
        n_sparse=5,
        embed_dim=4,
        hash_size=64,
        cin_layers=(8, 8),
        mlp=(16, 16),
        n_dense=3,
    )


CELLS = common.recsys_cells()
