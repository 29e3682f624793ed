"""Re-iterable corpus chunk streams for the two-pass streaming build (the
counterpart of ``repro.build.chunks``).

The builder streams the corpus TWICE (pass 1 samples + trains tables,
pass 2 quantizes), so its input is a *stream factory*: something that can
produce a fresh iterator of ``(payload, doc_lens)`` chunks on demand.
Chunk boundaries always fall on document boundaries — a passage never
spans chunks, which keeps per-chunk CSR assembly local.

Three concrete sources cover every call site:

* :func:`array_stream` — an in-memory corpus (list of per-doc arrays, or
  packed ``(Nt, d)`` + ``doc_lens``), re-chunked at ``chunk_docs``;
* :func:`encoder_stream` — token ids + an ``encode_fn``; chunks carry the
  raw TOKENS and the builder runs encode→assign→compress per chunk on its
  device, so float32 embeddings never reach the host;
* :func:`iterator_stream` — a zero-arg callable returning a fresh iterator
  of ``(embeddings, doc_lens)`` chunks (corpora that never exist as one
  array: database cursors, file shards, chunks made on the card, ...).

Payloads may be numpy arrays or tensors on any device; ``doc_lens`` are
host numpy int32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ChunkStream:
    """A re-iterable chunk source.

    ``chunks()`` yields ``(payload, doc_lens)``; ``payload`` is a packed
    ``(nt, d)`` float32 embedding chunk unless ``encode_fn`` is set, in
    which case it is whatever ``encode_fn`` consumes (token ids) and maps
    to ``(..., d)`` embeddings inside the builder.
    """

    factory: Callable[[], Iterator[tuple[Any, np.ndarray]]]
    encode_fn: Callable | None = None

    def chunks(self) -> Iterator[tuple[Any, np.ndarray]]:
        return self.factory()


def host_lens(doc_lens) -> np.ndarray:
    """Per-document token counts as host int32 (from numpy, a list or a
    tensor on any device)."""
    if isinstance(doc_lens, torch.Tensor):
        doc_lens = doc_lens.cpu().numpy()
    return np.asarray(doc_lens, np.int32)


def _doc_list(corpus, doc_lens):
    """Normalize (list | packed + doc_lens) -> (packed (Nt, d), doc_lens).

    Tensors stay tensors on their device; numpy stays numpy."""
    if isinstance(corpus, (list, tuple)):
        doc_lens = np.asarray([len(d) for d in corpus], np.int32)
        if any(isinstance(d, torch.Tensor) for d in corpus):
            packed = torch.cat([torch.as_tensor(d).float() for d in corpus])
        else:
            packed = np.concatenate([np.asarray(d, np.float32) for d in corpus], 0)
    else:
        if doc_lens is None:
            raise ValueError("packed corpus input requires doc_lens")
        doc_lens = host_lens(doc_lens)
        packed = (
            corpus.float() if isinstance(corpus, torch.Tensor)
            else np.asarray(corpus, np.float32)
        )
    if int(doc_lens.sum()) != packed.shape[0]:
        raise ValueError(
            f"doc_lens sum {int(doc_lens.sum())} != corpus tokens {packed.shape[0]}"
        )
    return packed, doc_lens


def array_stream(corpus, doc_lens=None, *, chunk_docs: int = 256) -> ChunkStream:
    """Chunk an in-memory corpus at document boundaries.

    The packed array is held by the CALLER either way; the builder's
    bounded-memory guarantee is about what *it* materializes on top
    (sample + one chunk's worth of quantization output).
    """
    packed, lens = _doc_list(corpus, doc_lens)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    chunk_docs = max(1, int(chunk_docs))

    def factory():
        for lo in range(0, len(lens), chunk_docs):
            hi = min(lo + chunk_docs, len(lens))
            yield packed[offsets[lo] : offsets[hi]], lens[lo:hi]

    return ChunkStream(factory=factory)


def encoder_stream(
    encode_fn,  # (tokens (B, L) int tensor) -> (B, L, d) f32
    corpus_tokens,  # (N, L) int, numpy or a tensor
    *,
    chunk_docs: int = 256,
    doc_lens=None,
) -> ChunkStream:
    """Stream token-id chunks through ``encode_fn`` inside the builder.

    ``doc_lens`` defaults to the full padded length ``L`` per document and
    must sum to ``N * L`` (every encoder output row is a stored token, the
    reference's ``build_from_encoder`` contract).
    """
    if not isinstance(corpus_tokens, torch.Tensor):
        corpus_tokens = np.asarray(corpus_tokens)
    N, L = corpus_tokens.shape
    doc_lens = np.full(N, L, np.int32) if doc_lens is None else host_lens(doc_lens)
    if len(doc_lens) != N or int(doc_lens.sum()) != N * L:
        raise ValueError(
            "encoder_stream doc_lens must cover every encoder output row "
            f"(need sum {N * L}, got {int(doc_lens.sum())})"
        )
    chunk_docs = max(1, int(chunk_docs))

    def factory():
        for lo in range(0, N, chunk_docs):
            hi = min(lo + chunk_docs, N)
            yield corpus_tokens[lo:hi], doc_lens[lo:hi]

    return ChunkStream(factory=factory, encode_fn=encode_fn)


def iterator_stream(factory: Callable[[], Iterator]) -> ChunkStream:
    """Wrap a zero-arg callable yielding ``(embeddings, doc_lens)`` chunks."""
    return ChunkStream(factory=factory)


def as_stream(corpus, doc_lens=None, *, chunk_docs: int = 256) -> ChunkStream:
    """Coerce any supported corpus input into a ChunkStream."""
    if isinstance(corpus, ChunkStream):
        return corpus
    if callable(corpus):
        return iterator_stream(corpus)
    return array_stream(corpus, doc_lens, chunk_docs=chunk_docs)
