"""Index persistence (``save_index`` / ``load_index``) and the offline
encode + build adapter ``build_from_encoder``.

Directories use the reference's v2 segment-manifest layout
(``repro_torch.live.manifest``), so an index saved by ``repro`` loads here
array-identically and the reverse holds too.  An index is built from raw
embeddings by ``core.index.build_index`` (monolithic) or by the streaming
builder (``repro_torch.build``), and from token ids by
:func:`build_from_encoder`.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import PlaidIndex
from repro_torch.live import manifest as manifest_mod


def save_index(path: str, index: PlaidIndex) -> None:
    """Write ``index`` as a v2 (segment manifest) directory, one base segment."""
    manifest_mod.save_segmented(path, [index], [0], None, generation=0)


def load_index(path: str, device: str | torch.device = "cuda") -> PlaidIndex:
    """Load a single-segment index directory (v1 or v2) onto ``device``."""
    return manifest_mod.load_single_segment(path, device)


def build_from_encoder(
    encode_fn,  # (tokens (B, L) int tensor on device) -> (B, L, dim) f32
    corpus_tokens,  # (N, L) int, numpy or a tensor
    *,
    chunk: int = 256,
    doc_lens=None,
    return_stats: bool = False,
    device: str | torch.device = "cuda",
    **build_kwargs,
):
    """Offline encode + build, streaming, on ``device``: a thin adapter
    over ``repro_torch.build``.  Each chunk of ``chunk`` documents runs
    encode → assign → residual → compress on the device, so the corpus
    never exists as one float32 array and, without pruning, no float32
    chunk reaches the host (``return_stats=True`` returns the
    ``BuildStats``).  ``build_kwargs`` take the ``build_index_streaming``
    keyword surface."""
    from repro_torch import build as build_mod

    stream = build_mod.encoder_stream(
        encode_fn, corpus_tokens, chunk_docs=chunk, doc_lens=doc_lens
    )
    return build_mod.build_index_streaming(
        stream, return_stats=return_stats, device=device, **build_kwargs
    )
