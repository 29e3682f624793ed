"""Index persistence (``save_index`` / ``load_index``) and the offline
encode + build adapter ``build_from_encoder``.

Directories use the reference's v2 segment-manifest layout
(``repro_torch.live.manifest``), so an index saved by ``repro`` loads here
array-identically and the reverse holds too.  An index is built from raw
embeddings by ``core.index.build_index`` (monolithic) or by the streaming
builder (``repro_torch.build``), and from token ids by
:func:`build_from_encoder`.

Sharded layouts (:func:`save_sharded`) keep the reference's per-shard
format: ``manifest.json`` with the static meta, ``n_shards`` and
``docs_per_shard``, and one ``shard_%04d/arrays.npz`` a shard, so each
serving process reads only its own shards.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import PlaidIndex
from repro_torch.live import manifest as manifest_mod

#: centroid-space arrays, stored whole in every shard of a sharded layout
_REPLICATED = ("centroids", "centroids_q", "centroids_scale", "cutoffs", "weights")


def save_index(path: str, index: PlaidIndex) -> None:
    """Write ``index`` as a v2 (segment manifest) directory, one base segment."""
    manifest_mod.save_segmented(path, [index], [0], None, generation=0)


def load_index(path: str, device: str | torch.device = "cuda") -> PlaidIndex:
    """Load a single-segment index directory (v1 or v2) onto ``device``."""
    return manifest_mod.load_single_segment(path, device)


def save_sharded(path: str, index: PlaidIndex, n_shards: int) -> None:
    """Partition a global index into the per-shard directory layout."""
    from repro_torch.core import engine_sharded

    idx_dict, meta, per = engine_sharded.shard_index(index, n_shards)
    save_sharded_arrays(path, idx_dict, meta, n_shards=n_shards, docs_per_shard=per)


def save_sharded_arrays(
    path: str,
    idx_dict: dict,
    meta: dict,
    *,
    n_shards: int,
    docs_per_shard: int,
    shard_ids=None,
) -> None:
    """Write an already-sharded index (``engine_sharded.shard_index``
    layout: doc-partitioned arrays stacked along axis 0 in shard order) as
    the per-shard directory layout :func:`load_sharded` reassembles.

    ``shard_ids`` names the shards ``idx_dict`` holds (default: all
    ``n_shards``): a process of a sharded deployment writes its own, and
    the one holding shard 0 writes the manifest.
    """
    shard_ids = list(range(n_shards) if shard_ids is None else shard_ids)
    os.makedirs(path, exist_ok=True)
    if 0 in shard_ids:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(dict(meta, n_shards=n_shards, docs_per_shard=docs_per_shard), f)
    host = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in idx_dict.items()}
    for j, s in enumerate(shard_ids):
        sd = os.path.join(path, f"shard_{s:04d}")
        os.makedirs(sd, exist_ok=True)
        arrays = {}
        for k, v in host.items():
            if k in _REPLICATED:
                arrays[k] = v
            else:
                n = v.shape[0] // len(shard_ids)
                arrays[k] = v[j * n : (j + 1) * n]
        np.savez(os.path.join(sd, "arrays.npz"), **arrays)


def read_sharded_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_sharded(path: str, device: str | torch.device = "cuda", *, shard_ids=None):
    """Reassemble ``(index_dict, meta, docs_per_shard)`` from a shard
    layout onto ``device``: the shards ``shard_ids`` (default all), stacked
    in that order.  Layouts that predate the int8 centroid tables get them
    synthesized, as the reference's loader does."""
    from repro_torch.core.index import FIELD_DTYPES, quantize_centroids

    dev = resolve_device(device)
    manifest = read_sharded_manifest(path)
    ids = range(manifest["n_shards"]) if shard_ids is None else shard_ids
    parts = []
    for s in ids:
        with np.load(os.path.join(path, f"shard_{s:04d}", "arrays.npz")) as d:
            parts.append({k: d[k] for k in d.files})
    out = {}
    for k in parts[0]:
        v = parts[0][k] if k in _REPLICATED else np.concatenate([p[k] for p in parts])
        out[k] = torch.from_numpy(v).to(dev, FIELD_DTYPES[k])
    if "centroids_q" not in out:
        out["centroids_q"], out["centroids_scale"] = quantize_centroids(out["centroids"])
    meta = {k: manifest[k] for k in ("dim", "nbits", "doc_maxlen", "ivf_list_cap", "eivf_list_cap")}
    # layouts that predate build-time token pruning
    meta["prune_fraction"] = manifest.get("prune_fraction", 0.0)
    return out, meta, manifest["docs_per_shard"]


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
