"""On-disk format for segmented PLAID indexes — ``format_version: 2`` (the
counterpart of ``repro.live.manifest``).

A v2 index directory is a *segment manifest*::

    <path>/
      manifest.json            # format_version, generation, segment list
      seg_000000/arrays.npz    # base segment (PlaidIndex array fields)
      seg_000001/arrays.npz    # delta segments, same layout
      tombstones_000007.npy    # bool bitmap over global pids (if any dead)

The bytes and file names are the reference's: a directory written by
either package loads in the other array-identically.  Writer protocol
(single writer, many readers): every payload is on disk (temp file +
fsync + ``os.replace``) before the manifest that names it; the manifest
is swapped in atomically with a monotonic ``generation``; only then are
``seg_*`` / ``tombstones_*`` entries no manifest references collected.
A reader that races a save (its generation's files collected mid-read)
gets a clean ``FileNotFoundError``; :func:`load_segmented` re-reads the
fresh manifest and retries.  v1 directories (flat ``arrays.npz`` next to
the manifest) load as one base segment; unknown versions fail loudly.

The tiered layout (``storage: "tiered"`` stamped in the manifest): the
O(num_tokens) payload fields (:data:`TIERED_PAYLOAD_FIELDS`) move out of
``arrays.npz`` into raw per-field ``.npy`` files in the segment directory
(``codes.npy``, ``residuals.npy``, ...), each durable before the manifest
names it, so ``core.tiered.load_tiered`` memory-maps them with no
load-time copy.  The resident loaders refuse tiered directories (a silent
cross-load would densify the payload or read a placeholder), and
``load_tiered`` refuses resident ones.
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

#: O(num_tokens) payload fields a tiered segment stores as raw mmap-able
#: ``.npy`` files instead of ``arrays.npz`` members.  ``codes`` and
#: ``residuals`` are what a search reads; ``tok_pid`` / ``eivf_eids`` ride
#: along so a tiered directory still holds a full index.
TIERED_PAYLOAD_FIELDS = ("codes", "residuals", "tok_pid", "eivf_eids")


class PayloadMissingError(FileNotFoundError):
    """A file the manifest references does not exist on disk."""


class PayloadCorruptError(ValueError):
    """A referenced array file exists but cannot be parsed (truncated
    write, bad magic, wrong dtype header) — never load garbage."""


class StaleGenerationError(RuntimeError):
    """The on-disk manifest's generation is older than the caller's
    required minimum (e.g. a reader re-opening after a known flush)."""


def _static_from_meta(static_meta: dict) -> dict:
    return {k: static_meta.get(k, STATIC_DEFAULTS[k]) for k in STATIC_FIELDS}


def segment_name(seg_id: int) -> str:
    return f"seg_{seg_id:06d}"


def segment_static_meta(seg: PlaidIndex) -> dict:
    return seg.static_dict()


def _refuse_tiered(path: str, storage: str) -> None:
    """The resident loaders' refusal of a tiered (or unknown) layout."""
    if storage != "resident":
        raise ValueError(
            f"index at {path!r} stamps storage={storage!r}; the resident "
            "loader would densify (or garble) the payload — open tiered "
            "directories via repro_torch.core.tiered.load_tiered / the "
            "'plaid-tiered' backends"
        )


def _write_durable(path_tmp: str, path_final: str, write_fn) -> None:
    """write to temp -> flush + fsync -> rename."""
    with open(path_tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path_tmp, path_final)


def _host(x) -> np.ndarray:
    """An array field as host numpy: a tensor's copy, an array (or mmap)
    as it is."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_segment(seg_dir: str, seg: PlaidIndex, *, storage: str = "resident") -> None:
    """Write one segment's arrays as ``arrays.npz``; atomic for readers.

    ``storage="tiered"`` writes the payload fields as raw ``.npy`` files
    instead (one a field), each durable before the ``arrays.npz`` the
    manifest names beside it.  A field may be a tensor on any device or a
    host array (a tiered index's payloads are numpy, often mmaps).
    """
    os.makedirs(seg_dir, exist_ok=True)
    arrays = {f: _host(getattr(seg, f)) for f in ARRAY_FIELDS}
    if storage == "tiered":
        for field in TIERED_PAYLOAD_FIELDS:
            payload = arrays.pop(field)
            _write_durable(
                os.path.join(seg_dir, f"{field}.tmp.npy"),
                os.path.join(seg_dir, f"{field}.npy"),
                lambda f, payload=payload: np.save(f, payload),
            )
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


def read_tiered_payload(seg_dir: str, field: str) -> np.ndarray:
    """Open one tiered payload ``.npy``, memory-mapped read-only (no copy)."""
    path = os.path.join(seg_dir, f"{field}.npy")
    try:
        return np.load(path, mmap_mode="r")
    except FileNotFoundError as e:
        raise PayloadMissingError(
            f"tiered payload missing: {path} (manifest stamps storage="
            "'tiered' but the payload file is absent)"
        ) from e
    except (ValueError, OSError, EOFError) as e:
        raise PayloadCorruptError(f"tiered payload unreadable: {path}: {e}") from e


def read_tiered_segment(seg_dir: str, static_meta: dict):
    """One tiered segment -> ``(arrays, static, payloads)`` on the host.

    ``arrays`` holds the device tier's (non-payload) fields as numpy;
    ``payloads`` maps ``codes`` and ``residuals`` (what a search reads) to
    read-only mmaps.  ``tok_pid`` / ``eivf_eids`` are not opened.
    """
    arrays = _load_npz_arrays(seg_dir)
    payloads = {f: read_tiered_payload(seg_dir, f) for f in ("codes", "residuals")}
    return arrays, _static_from_meta(static_meta), payloads


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


def save_segmented(
    path: str,
    segments: list[PlaidIndex],
    seg_ids: list[int],
    tombstones: np.ndarray | None,
    generation: int,
    index_uuid: str | None = None,
    storage: str = "resident",
    extra_manifest: dict | None = None,
) -> None:
    """Write a v2 index directory (payloads first, manifest swap last).

    ``index_uuid`` identifies one LiveIndex lineage: within a lineage a
    segment name always maps to the same immutable content, so segments
    the CURRENT on-disk manifest (same uuid) already references are
    skipped — a save after a delta flush writes the delta, not the base.
    ``storage="tiered"`` stamps the manifest and writes the payloads as
    mmap-able ``.npy`` files (:func:`write_segment`).  ``extra_manifest``
    entries merge into the manifest; they may not override a layout key.
    """
    if storage not in ("resident", "tiered"):
        raise ValueError(f"unknown storage layout: {storage!r}")
    os.makedirs(path, exist_ok=True)
    names = [segment_name(i) for i in seg_ids]
    already_on_disk: set[str] = set()
    if index_uuid is not None:
        try:
            existing = read_manifest(path)
            if existing.get("index_uuid") == index_uuid:
                already_on_disk = {s["name"] for s in existing["segments"]}
        except (FileNotFoundError, ValueError, KeyError):
            pass
    for name, seg in zip(names, segments):
        if name not in already_on_disk:
            write_segment(os.path.join(path, name), seg, storage=storage)
    ts_name = None
    if tombstones is not None and tombstones.any():
        ts_name = f"tombstones_{generation:06d}.npy"
        _write_durable(
            os.path.join(path, f"tombstones_{generation:06d}.tmp.npy"),
            os.path.join(path, ts_name),
            lambda f: np.save(f, np.asarray(tombstones, bool)),
        )
    base = segments[0]
    stamp = dict(extra_manifest or {})
    clash = set(stamp) & {"format_version", "generation", "index_uuid", "segments",
                          "tombstones", "num_passages", "num_centroids", "dim", "nbits",
                          "storage"}
    if clash:
        raise ValueError(f"extra_manifest may not override {sorted(clash)}")
    if storage != "resident":
        stamp["storage"] = storage
    manifest = dict(
        stamp,
        format_version=FORMAT_VERSION,
        generation=generation,
        index_uuid=index_uuid,
        segments=[
            dict(
                name=name,
                num_passages=int(seg.num_passages),
                num_tokens=int(seg.num_tokens),
                **segment_static_meta(seg),
            )
            for name, seg in zip(names, segments)
        ],
        tombstones=ts_name,
        num_passages=int(sum(s.num_passages for s in segments)),
        num_centroids=int(base.num_centroids),
        dim=base.dim,
        nbits=base.nbits,
    )
    write_manifest_atomic(path, manifest)
    _collect_garbage(path, keep=set(names) | ({ts_name} if ts_name else set()))


def _collect_garbage(path: str, keep: set[str]) -> None:
    """Drop segment dirs / tombstone bitmaps no manifest references."""
    for entry in os.listdir(path):
        if entry in keep or entry.endswith(".tmp") or entry.endswith(".tmp.npy"):
            continue
        full = os.path.join(path, entry)
        if entry.startswith("seg_") and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        elif entry.startswith("tombstones_") and entry.endswith(".npy"):
            os.unlink(full)


def load_segmented(
    path: str,
    _retries: int = 2,
    min_generation: int = 0,
    device: str | torch.device = "cuda",
):
    """Read a v1 or v2 index directory onto ``device``.

    Returns ``(segments, seg_ids, tombstones, generation, index_uuid)``;
    v1 directories come back as one base segment with an all-alive bitmap
    (and no uuid).  If a concurrent save collects this reader's generation
    mid-read, the fresh manifest is re-read and the load retried.
    ``min_generation`` rejects manifests older than a generation the caller
    knows was written (:class:`StaleGenerationError`).
    """
    try:
        return _load_segmented_once(path, min_generation, device)
    except FileNotFoundError:
        # PayloadMissingError lands here too: only a file missing under a
        # manifest that stays put across the retries is real data loss
        if _retries <= 0:
            raise
        return load_segmented(
            path, _retries=_retries - 1, min_generation=min_generation, device=device
        )


def _load_segmented_once(path: str, min_generation: int, device):
    manifest = read_manifest(path)
    _refuse_tiered(path, manifest.get("storage", "resident"))
    if int(manifest.get("generation", 0)) < min_generation:
        raise StaleGenerationError(
            f"index at {path!r} is at generation {manifest.get('generation', 0)}, "
            f"caller requires >= {min_generation}"
        )
    if manifest.get("format_version", 1) == 1:
        seg = read_segment(path, manifest, device)  # flat arrays.npz
        return [seg], [0], np.zeros(seg.num_passages, bool), 0, None
    segments, seg_ids = [], []
    for entry in manifest["segments"]:
        segments.append(read_segment(os.path.join(path, entry["name"]), entry, device))
        seg_ids.append(int(entry["name"].split("_")[-1]))
    total = sum(s.num_passages for s in segments)
    if manifest.get("tombstones"):
        tombstones = np.asarray(np.load(os.path.join(path, manifest["tombstones"])), bool)
        assert tombstones.shape[0] == total
    else:
        tombstones = np.zeros(total, bool)
    return (
        segments,
        seg_ids,
        tombstones,
        int(manifest["generation"]),
        manifest.get("index_uuid"),
    )


def load_single_segment(path: str, device: str | torch.device = "cuda") -> PlaidIndex:
    """Read a v1 directory, or a v2 directory holding exactly one segment
    and no tombstones; anything else is a live index and is refused."""
    manifest = read_manifest(path)
    _refuse_tiered(path, manifest.get("storage", "resident"))
    if manifest.get("format_version", 1) == 1:
        return read_segment(path, manifest, device)
    segments = manifest["segments"]
    if len(segments) != 1 or manifest.get("tombstones"):
        raise ValueError(
            f"index at {path!r} holds {len(segments)} segments"
            f"{' + tombstones' if manifest.get('tombstones') else ''}; "
            "that is a live index: load it with repro_torch.live.LiveIndex.load "
            "or retrieval.load (the 'live' backends), or compact it first"
        )
    return read_segment(os.path.join(path, segments[0]["name"]), segments[0], device)
