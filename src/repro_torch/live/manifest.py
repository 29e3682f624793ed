"""On-disk index format: the single-segment side of ``format_version: 2``.

A v2 index directory is a *segment manifest*::

    <path>/
      manifest.json            # format_version, generation, segment list
      seg_000000/arrays.npz    # base segment (PlaidIndex array fields)

The bytes are the reference's (``repro.live.manifest``): a directory
written by either package loads in the other array-identically.  Writers
put every payload on disk (temp file + fsync + ``os.replace``) before the
manifest that names it, and swap the manifest in atomically.  v1
directories (flat ``arrays.npz`` next to the manifest) remain readable.

The multi-segment side (delta segments, tombstones, tiered payloads) is
the live index's and is not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.core.index import (
    ARRAY_FIELDS,
    STATIC_DEFAULTS,
    STATIC_FIELDS,
    PlaidIndex,
    index_from_numpy,
)

FORMAT_VERSION = 2


class PayloadMissingError(FileNotFoundError):
    """A file the manifest references does not exist on disk."""


class PayloadCorruptError(ValueError):
    """A referenced array file exists but cannot be parsed (truncated
    write, bad magic, wrong dtype header) — never load garbage."""


def _static_from_meta(static_meta: dict) -> dict:
    return {k: static_meta.get(k, STATIC_DEFAULTS[k]) for k in STATIC_FIELDS}


def segment_name(seg_id: int) -> str:
    return f"seg_{seg_id:06d}"


def _write_durable(path_tmp: str, path_final: str, write_fn) -> None:
    """write to temp -> flush + fsync -> rename."""
    with open(path_tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path_tmp, path_final)


def write_segment(seg_dir: str, seg: PlaidIndex) -> None:
    """Write one segment's arrays as ``arrays.npz``; atomic for readers."""
    os.makedirs(seg_dir, exist_ok=True)
    arrays = seg.numpy_arrays()
    _write_durable(
        os.path.join(seg_dir, "arrays.tmp.npz"),
        os.path.join(seg_dir, "arrays.npz"),
        lambda f: np.savez(f, **arrays),
    )


def _load_npz_arrays(seg_dir: str) -> dict:
    """``arrays.npz`` -> host dict, with typed read failures."""
    npz_path = os.path.join(seg_dir, "arrays.npz")
    try:
        with np.load(npz_path) as data:
            return {f: np.asarray(data[f]) for f in ARRAY_FIELDS if f in data.files}
    except FileNotFoundError as e:
        raise PayloadMissingError(
            f"segment payload missing: {npz_path} (referenced by the "
            "manifest but absent on disk)"
        ) from e
    except (zipfile.BadZipFile, ValueError, OSError, KeyError, EOFError) as e:
        raise PayloadCorruptError(
            f"segment payload unreadable: {npz_path}: {e} (truncated or "
            "torn write — refusing to load garbage)"
        ) from e


def read_segment(
    seg_dir: str, static_meta: dict, device: str | torch.device = "cuda"
) -> PlaidIndex:
    """One segment directory -> ``PlaidIndex`` on ``device``.

    Segments written before the quantized-centroid fields existed get their
    int8 tables synthesized here (``index_from_numpy``), bitwise identical
    to what a fresh build stores.
    """
    return index_from_numpy(
        _load_npz_arrays(seg_dir), _static_from_meta(static_meta), device
    )


def read_manifest(path: str) -> dict:
    """Load + version-check ``<path>/manifest.json``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version", 1)
    if version not in (1, FORMAT_VERSION):
        raise ValueError(
            f"index at {path!r} has format_version={version!r}; this build "
            f"reads versions 1 and {FORMAT_VERSION} — refusing to guess"
        )
    return manifest


def write_manifest_atomic(path: str, manifest: dict) -> None:
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "manifest.json"))


def save_single_segment(path: str, seg: PlaidIndex, generation: int = 0) -> None:
    """Write a v2 directory holding one base segment and no tombstones
    (payload first, manifest swap last, unreferenced ``seg_*`` removed)."""
    os.makedirs(path, exist_ok=True)
    name = segment_name(0)
    write_segment(os.path.join(path, name), seg)
    manifest = dict(
        format_version=FORMAT_VERSION,
        generation=generation,
        index_uuid=None,
        segments=[
            dict(
                name=name,
                num_passages=int(seg.num_passages),
                num_tokens=int(seg.num_tokens),
                **seg.static_dict(),
            )
        ],
        tombstones=None,
        num_passages=int(seg.num_passages),
        num_centroids=int(seg.num_centroids),
        dim=seg.dim,
        nbits=seg.nbits,
    )
    write_manifest_atomic(path, manifest)
    for entry in os.listdir(path):
        full = os.path.join(path, entry)
        if entry.startswith("seg_") and entry != name and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        elif entry.startswith("tombstones_") and entry.endswith(".npy"):
            os.unlink(full)


def load_single_segment(path: str, device: str | torch.device = "cuda") -> PlaidIndex:
    """Read a v1 directory, or a v2 directory holding exactly one segment
    and no tombstones; anything else is a live index and is refused."""
    manifest = read_manifest(path)
    storage = manifest.get("storage", "resident")
    if storage != "resident":
        raise ValueError(
            f"index at {path!r} stamps storage={storage!r}; only resident "
            "directories load here (the tiered index is not ported yet)"
        )
    if manifest.get("format_version", 1) == 1:
        return read_segment(path, manifest, device)
    segments = manifest["segments"]
    if len(segments) != 1 or manifest.get("tombstones"):
        raise ValueError(
            f"index at {path!r} holds {len(segments)} segments"
            f"{' + tombstones' if manifest.get('tombstones') else ''}; "
            "that is a live index, which this package does not load yet"
        )
    return read_segment(os.path.join(path, segments[0]["name"]), segments[0], device)
