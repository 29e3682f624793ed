"""Model configurations of the port (torch dtypes) and the arch registry:
``--arch <id>`` resolves here (the counterpart of ``repro.configs``).

Every id of the reference resolves, with the reference's cells
(``cells_of``): ``plaid-colbertv2`` (the paper's own encoder and PLAID
search); the five LM archs (dense and MoE), which train (``lm_loss``)
and serve (``prefill`` and ``decode_step`` with a KV cache) on one device,
a data mesh or a mesh with a ``"model"`` axis (tensor and expert
parallelism; the FSDP weight split is ROADMAP Queue 1 item 8.5.2); the
four recsys archs (``models.recsys``) and SchNet (``models.schnet``), on
one device.  ``launch.dryrun`` plans every cell on the reference's
production meshes.
"""
from __future__ import annotations

import importlib

_MODULES = {
    # LM family
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    # GNN
    "schnet": "repro_torch.configs.schnet",
    # RecSys
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "bst": "repro_torch.configs.bst",
    "bert4rec": "repro_torch.configs.bert4rec",
    "wide-deep": "repro_torch.configs.wide_deep",
    # the paper's own architecture
    "plaid-colbertv2": "repro_torch.configs.colbertv2",
}

#: the reference's ids, in its order
ARCH_IDS = list(_MODULES)


def get(arch_id: str):
    """Return the arch config module for ``--arch <id>``."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch_id])


def cells_of(arch_id: str):
    return {c.name: c for c in get(arch_id).CELLS}
