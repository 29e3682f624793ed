"""Model configurations of the port (torch dtypes) and the arch registry:
``--arch <id>`` resolves here (the counterpart of ``repro.configs``).

Only ``plaid-colbertv2``, the paper's own encoder, is ported.  Every other
id of the reference's registry raises and names the ROADMAP item that
ports it: the LM family (dense and MoE) with LM training and decode, Queue 1
item 8; the recsys and GNN scaffolding, Queue 1 item 9.
"""
from __future__ import annotations

import importlib

_MODULES = {"plaid-colbertv2": "repro_torch.configs.colbertv2"}
#: the reference's other arch ids -> the ROADMAP item that ports them
_NOT_PORTED = {
    "h2o-danube-3-4b": "Queue 1 item 8 (LM training and decode)",
    "yi-34b": "Queue 1 item 8 (LM training and decode)",
    "granite-34b": "Queue 1 item 8 (LM training and decode)",
    "granite-moe-1b-a400m": "Queue 1 item 8 (MoE layers)",
    "deepseek-moe-16b": "Queue 1 item 8 (MoE layers)",
    "schnet": "Queue 1 item 9 (GNN scaffolding)",
    "xdeepfm": "Queue 1 item 9 (recsys scaffolding)",
    "bst": "Queue 1 item 9 (recsys scaffolding)",
    "bert4rec": "Queue 1 item 9 (recsys scaffolding)",
    "wide-deep": "Queue 1 item 9 (recsys scaffolding)",
}

#: the reference's ids, in its order
ARCH_IDS = list(_NOT_PORTED) + list(_MODULES)


def get(arch_id: str):
    """Return the arch config module for ``--arch <id>``."""
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch (ROADMAP {_NOT_PORTED[arch_id]})"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch_id])
