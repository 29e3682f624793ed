"""Index persistence: ``save_index`` / ``load_index``.

Directories use the reference's v2 segment-manifest layout
(``repro_torch.live.manifest``), so an index saved by ``repro`` loads here
array-identically and the reverse holds too.  An index is built from raw
embeddings by ``core.index.build_index`` (monolithic); the streaming
builder is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import PlaidIndex
from repro_torch.live import manifest as manifest_mod


def save_index(path: str, index: PlaidIndex) -> None:
    """Write ``index`` as a v2 (segment manifest) directory, one base segment."""
    manifest_mod.save_single_segment(path, index, generation=0)


def load_index(path: str, device: str | torch.device = "cuda") -> PlaidIndex:
    """Load a single-segment index directory (v1 or v2) onto ``device``."""
    return manifest_mod.load_single_segment(path, device)
