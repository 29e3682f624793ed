"""Shared config machinery of the port (the counterpart of
``repro/configs/common.py``): the shape cell and the LM family's cells.

Every arch module exposes ``FAMILY``, ``full_config()`` (the published
architecture), ``reduced_config()`` (a tiny config of the same family for
CPU tests) and ``CELLS`` (its input shapes: the full parameters, the
reduced ones and a skip reason).  The recsys, GNN and retrieval cell lists
come with their families (ROADMAP Queue 1 item 9; the retrieval cells with
the dry-run, item 8.5).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode (the LM family's kinds)
    full: dict
    reduced: dict
    skip: str | None = None


def lm_cells(long_skip: str | None) -> list[ShapeCell]:
    """The LM family's four cells, the reference's values."""
    return [
        ShapeCell(
            "train_4k",
            "train",
            full=dict(seq_len=4096, global_batch=256, n_micro=8),
            reduced=dict(seq_len=32, global_batch=4, n_micro=2),
        ),
        ShapeCell(
            "prefill_32k",
            "prefill",
            full=dict(seq_len=32768, global_batch=32),
            reduced=dict(seq_len=64, global_batch=2),
        ),
        ShapeCell(
            "decode_32k",
            "decode",
            full=dict(seq_len=32768, global_batch=128),
            reduced=dict(seq_len=64, global_batch=4),
        ),
        ShapeCell(
            "long_500k",
            "decode",
            full=dict(seq_len=524288, global_batch=1),
            reduced=dict(seq_len=128, global_batch=1),
            skip=long_skip,
        ),
    ]


#: the reason the full-attention LM archs skip ``long_500k``
FULL_ATTENTION_LONG_SKIP = (
    "pure full attention: 524k-token decode has no sub-quadratic "
    "mechanism in the published arch (DESIGN §Arch-applicability)"
)
