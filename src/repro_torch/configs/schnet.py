"""schnet [arXiv:1706.08566]: continuous-filter message passing (the
counterpart of ``repro/configs/schnet.py``).  PLAID's technique does not
apply to a molecular-energy model; the graph-regime cells (cora / reddit
/ products shapes) project node features into the hidden space, and
``molecule`` is the faithful SchNet."""
from repro_torch.configs import common
from repro_torch.models.schnet import SchNetConfig

FAMILY = "gnn"


def full_config() -> SchNetConfig:
    return SchNetConfig(
        name="schnet",
        n_interactions=3,
        d_hidden=64,
        n_rbf=300,
        cutoff=10.0,
    )


def reduced_config() -> SchNetConfig:
    return SchNetConfig(
        name="schnet-reduced",
        n_interactions=2,
        d_hidden=16,
        n_rbf=20,
        cutoff=10.0,
    )


CELLS = common.gnn_cells()
