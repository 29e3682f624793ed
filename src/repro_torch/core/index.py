"""PLAID index: packed token arrays + centroid->passage inverted file (CSR).

The layout is the reference's (``repro.core.index``) field for field, with
the same dtypes, so an index crosses between the two packages as a dict of
numpy arrays (:func:`index_from_numpy` / :meth:`PlaidIndex.numpy_arrays`):

  * the IVF maps centroids to *unique passage ids* (int32);
  * token payloads (codes, packed residuals) are stored packed, ordered by
    passage, with a CSR ``doc_offsets`` array;
  * static caps (``ivf_list_cap``, ``doc_maxlen``) are recorded at build
    time.

:func:`build_index` builds an index from token embeddings (k-means,
assignment, residual codec, compression); :func:`assemble_index` runs on
whatever device its inputs live on.  On the card it replaces the
reference's host ``np.unique(axis=0)`` over ``(code, pid)`` rows with a
sorted unique int64 key ``code * Nd + pid`` — the same order — so a
corpus of 1e8 tokens assembles in seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import residual_codec as rc

_STATIC = dict(static=True)


@dataclasses.dataclass(frozen=True)
class PlaidIndex:
    # --- centroid space ---
    centroids: torch.Tensor  # (K, d) f32
    centroids_q: torch.Tensor  # (K, d) i8   per-row int8 quantization
    centroids_scale: torch.Tensor  # (K,) f32  per-row dequant scale
    # --- packed token payload (ordered by passage) ---
    codes: torch.Tensor  # (Nt,) i32  centroid id per token
    residuals: torch.Tensor  # (Nt, d*b/8) u8
    tok_pid: torch.Tensor  # (Nt,) i32  owning passage per token
    # --- passage table ---
    doc_offsets: torch.Tensor  # (Nd+1,) i32
    doc_lens: torch.Tensor  # (Nd,) i32
    # --- inverted file: centroid -> passage ids (CSR) ---
    ivf_pids: torch.Tensor  # (nnz,) i32
    ivf_offsets: torch.Tensor  # (K+1,) i32
    ivf_lens: torch.Tensor  # (K,) i32
    # --- vanilla-ColBERTv2 inverted file: centroid -> embedding ids (CSR) ---
    eivf_eids: torch.Tensor  # (Nt,) i32
    eivf_offsets: torch.Tensor  # (K+1,) i32
    eivf_lens: torch.Tensor  # (K,) i32
    # --- codec tables ---
    cutoffs: torch.Tensor  # (2^b - 1,) f32
    weights: torch.Tensor  # (2^b,) f32
    # --- static metadata ---
    dim: int = dataclasses.field(metadata=_STATIC, default=128)
    nbits: int = dataclasses.field(metadata=_STATIC, default=2)
    doc_maxlen: int = dataclasses.field(metadata=_STATIC, default=128)
    ivf_list_cap: int = dataclasses.field(metadata=_STATIC, default=256)
    eivf_list_cap: int = dataclasses.field(metadata=_STATIC, default=512)
    #: build-time token-pruning fraction (recorded; search never reads it)
    prune_fraction: float = dataclasses.field(metadata=_STATIC, default=0.0)

    @property
    def num_passages(self) -> int:
        return self.doc_lens.shape[0]

    @property
    def num_tokens(self) -> int:
        return self.codes.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def codec(self) -> rc.ResidualCodec:
        return rc.ResidualCodec(self.cutoffs, self.weights, self.nbits)

    def to(self, device) -> "PlaidIndex":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in ARRAY_FIELDS}
        )

    def numpy_arrays(self) -> dict[str, np.ndarray]:
        """Every array field as host numpy (the on-disk / cross-package form)."""
        return {f: getattr(self, f).cpu().numpy() for f in ARRAY_FIELDS}

    def static_dict(self) -> dict:
        return {f: getattr(self, f) for f in STATIC_FIELDS}

    def nbytes(self) -> dict[str, int]:
        return {
            f: getattr(self, f).numel() * getattr(self, f).element_size()
            for f in ARRAY_FIELDS
        }

    def reconstruct_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Decompress a set of token embeddings (reference path)."""
        tid = token_ids.long()
        return rc.decompress(
            self.codec, self.codes[tid], self.residuals[tid], self.centroids
        )


#: Array fields and static fields, derived from the dataclass.
ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(PlaidIndex) if not f.metadata.get("static")
)
STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(PlaidIndex) if f.metadata.get("static")
)
STATIC_DEFAULTS = {
    f.name: f.default for f in dataclasses.fields(PlaidIndex) if f.metadata.get("static")
}

#: dtype of every array field (the reference's).
FIELD_DTYPES = dict(
    centroids=torch.float32,
    centroids_q=torch.int8,
    centroids_scale=torch.float32,
    codes=torch.int32,
    residuals=torch.uint8,
    tok_pid=torch.int32,
    doc_offsets=torch.int32,
    doc_lens=torch.int32,
    ivf_pids=torch.int32,
    ivf_offsets=torch.int32,
    ivf_lens=torch.int32,
    eivf_eids=torch.int32,
    eivf_offsets=torch.int32,
    eivf_lens=torch.int32,
    cutoffs=torch.float32,
    weights=torch.float32,
)


def quantize_centroids(centroids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of the centroid matrix.

    ``scale[k] = max(|centroids[k]|) / 127`` (floored so all-zero rows stay
    finite); ``q = round(centroids / scale)`` clipped to [-127, 127], rounded
    half to even like ``jnp.round``.  Dequantize as ``q.float() * scale[:, None]``.
    """
    c = centroids.float()
    scale = torch.clamp(c.abs().amax(dim=1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(c / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def index_from_numpy(
    arrays: Mapping[str, np.ndarray],
    static: Mapping,
    device: str | torch.device = "cuda",
) -> PlaidIndex:
    """Build the port's ``PlaidIndex`` from arrays taken out as numpy.

    ``arrays`` holds the array fields (for example ``{f: np.asarray(getattr(
    ref_index, f))}`` of a reference index); the int8 centroid tables are
    synthesized when absent (indexes that predate them), exactly as the
    reference's loader does.  ``static`` holds the static fields; missing
    ones take their dataclass defaults.
    """
    dev = resolve_device(device)
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    if set(missing) - {"centroids_q", "centroids_scale"}:
        raise KeyError(f"index arrays missing fields: {missing}")
    tensors = {}
    for f in ARRAY_FIELDS:
        if f not in arrays:
            continue
        t = torch.from_numpy(_writable(arrays[f]))
        if t.dtype != FIELD_DTYPES[f]:
            raise TypeError(f"field {f!r} has dtype {t.dtype}, expected {FIELD_DTYPES[f]}")
        tensors[f] = t.to(dev)
    if "centroids_q" not in tensors:
        tensors["centroids_q"], tensors["centroids_scale"] = quantize_centroids(
            tensors["centroids"]
        )
    st = {k: static.get(k, STATIC_DEFAULTS[k]) for k in STATIC_FIELDS}
    st = {k: (float(v) if k == "prune_fraction" else int(v)) for k, v in st.items()}
    return PlaidIndex(**tensors, **st)


def _writable(a: np.ndarray) -> np.ndarray:
    """A contiguous, writable view or copy (torch refuses read-only memory)."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(_writable(x))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _csr_offsets(lens: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(lens.long(), dim=0, out=off[1:])
    return off.to(torch.int32)


def unique_code_pid_keys(
    codes: torch.Tensor, tok_pid: torch.Tensor, num_passages: int
) -> torch.Tensor:
    """Sorted unique ``code * num_passages + pid`` int64 keys — the IVF's
    nonzero pattern, in ``np.unique(axis=0)`` order over ``(code, pid)``."""
    keys = codes.long() * num_passages + tok_pid.long()
    return torch.unique(keys, sorted=True)


def assemble_index(
    centroids,
    codes,
    packed_residuals,
    doc_lens,
    *,
    cutoffs,
    weights,
    nbits: int,
    ivf_list_cap: int | None = None,
    pairs: torch.Tensor | None = None,
    prune_fraction: float = 0.0,
    device: str | torch.device | None = None,
) -> PlaidIndex:
    """Assemble a PlaidIndex from already-quantized token payloads.

    Array-identical to ``repro.core.index.assemble_index`` on the same
    inputs.  Runs on ``device`` (default: the device of ``centroids`` when
    it is a tensor, else the card).  ``pairs`` lets incremental producers
    pass pre-merged sorted unique ``(code, pid)`` rows as an ``(n, 2)``
    int64 tensor instead of re-deriving them.
    """
    if device is None:
        device = centroids.device if isinstance(centroids, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    centroids = _as_tensor(centroids, torch.float32, dev)
    codes = _as_tensor(codes, torch.int32, dev)
    packed = _as_tensor(packed_residuals, torch.uint8, dev)
    doc_lens = _as_tensor(doc_lens, torch.int32, dev)
    num_centroids = int(centroids.shape[0])
    num_passages = int(doc_lens.shape[0])
    if int(doc_lens.long().sum()) != codes.shape[0]:
        raise ValueError(
            f"doc_lens sum {int(doc_lens.long().sum())} != tokens {codes.shape[0]}"
        )

    doc_offsets = _csr_offsets(doc_lens)
    tok_pid = torch.repeat_interleave(
        torch.arange(num_passages, dtype=torch.int32, device=dev), doc_lens.long()
    )

    # IVF: centroid -> sorted unique passage ids
    if pairs is None:
        keys = unique_code_pid_keys(codes, tok_pid, num_passages)
        pair_codes = keys // num_passages
        pair_pids = keys % num_passages
        del keys
    else:
        pairs = _as_tensor(pairs, torch.int64, dev)
        pair_codes, pair_pids = pairs[:, 0], pairs[:, 1]
    ivf_lens = torch.bincount(pair_codes, minlength=num_centroids).to(torch.int32)
    ivf_offsets = _csr_offsets(ivf_lens)
    ivf_pids = pair_pids.to(torch.int32)
    if ivf_list_cap is None:
        ivf_list_cap = max(int(ivf_lens.max()) if num_centroids else 1, 1)

    # vanilla-ColBERTv2 IVF: centroid -> embedding ids (stable argsort by code)
    eivf_eids = torch.sort(codes, stable=True).indices.to(torch.int32)
    eivf_lens = torch.bincount(codes.long(), minlength=num_centroids).to(torch.int32)
    eivf_offsets = _csr_offsets(eivf_lens)
    eivf_list_cap = max(int(eivf_lens.max()) if num_centroids else 1, 1)

    centroids_q, centroids_scale = quantize_centroids(centroids)
    return PlaidIndex(
        centroids=centroids,
        centroids_q=centroids_q,
        centroids_scale=centroids_scale,
        codes=codes,
        residuals=packed,
        tok_pid=tok_pid,
        doc_offsets=doc_offsets,
        doc_lens=doc_lens,
        ivf_pids=ivf_pids,
        ivf_offsets=ivf_offsets,
        ivf_lens=ivf_lens,
        eivf_eids=eivf_eids,
        eivf_offsets=eivf_offsets,
        eivf_lens=eivf_lens,
        cutoffs=_as_tensor(cutoffs, torch.float32, dev),
        weights=_as_tensor(weights, torch.float32, dev),
        dim=int(centroids.shape[1]),
        nbits=int(nbits),
        doc_maxlen=max(int(doc_lens.max()) if num_passages else 1, 1),
        ivf_list_cap=int(ivf_list_cap),
        eivf_list_cap=eivf_list_cap,
        prune_fraction=float(prune_fraction),
    )


class IndexAssembler:
    """Incremental CSR assembly: feed per-chunk quantized payloads, finish
    into a :class:`PlaidIndex` array-identical to a one-shot
    :func:`assemble_index` over the concatenated payloads.

    Chunks must cover disjoint, consecutive pid ranges (chunk boundaries on
    document boundaries), which makes per-chunk unique ``(code, pid)`` sets
    globally unique; the final merge is one sort.
    """

    def __init__(
        self,
        centroids,
        *,
        cutoffs,
        weights,
        nbits: int,
        ivf_list_cap: int | None = None,
        prune_fraction: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        self._device = resolve_device(device)
        self._centroids = _as_tensor(centroids, torch.float32, self._device)
        self._cutoffs = cutoffs
        self._weights = weights
        self._nbits = nbits
        self._ivf_list_cap = ivf_list_cap
        self._prune_fraction = float(prune_fraction)
        self._codes: list[torch.Tensor] = []
        self._packed: list[torch.Tensor] = []
        self._doc_lens: list[torch.Tensor] = []
        self._pairs: list[torch.Tensor] = []
        self._n_docs = 0
        self._finished = False

    @property
    def num_docs(self) -> int:
        return self._n_docs

    @property
    def num_tokens(self) -> int:
        return sum(c.shape[0] for c in self._codes)

    def add_chunk(self, codes, packed_residuals, doc_lens) -> None:
        """One quantized chunk: codes (nt,), packed (nt, d*b/8), doc_lens (nd,)."""
        dev = self._device
        codes = _as_tensor(codes, torch.int32, dev)
        packed = _as_tensor(packed_residuals, torch.uint8, dev)
        doc_lens = _as_tensor(doc_lens, torch.int32, dev)
        if int(doc_lens.long().sum()) != codes.shape[0]:
            raise ValueError(
                f"chunk doc_lens sum {int(doc_lens.long().sum())} != chunk tokens "
                f"{codes.shape[0]}"
            )
        nd = doc_lens.shape[0]
        local_pid = torch.repeat_interleave(
            torch.arange(nd, dtype=torch.int64, device=dev), doc_lens.long()
        )
        keys = unique_code_pid_keys(codes, local_pid, max(nd, 1))
        self._pairs.append(
            torch.stack([keys // max(nd, 1), self._n_docs + keys % max(nd, 1)], 1)
        )
        self._codes.append(codes)
        self._packed.append(packed)
        self._doc_lens.append(doc_lens)
        self._n_docs += nd

    def finish(self) -> PlaidIndex:
        if self._finished:
            raise RuntimeError("IndexAssembler.finish() called twice")
        self._finished = True
        if self._n_docs == 0:
            raise ValueError("no chunks were added")
        pairs = torch.cat(self._pairs)
        # rows are globally unique (disjoint pid ranges): one sort by the
        # combined key reproduces np.unique's (code, pid) row order
        order = torch.argsort(pairs[:, 0] * self._n_docs + pairs[:, 1])
        return assemble_index(
            self._centroids,
            torch.cat(self._codes),
            torch.cat(self._packed),
            torch.cat(self._doc_lens),
            cutoffs=self._cutoffs,
            weights=self._weights,
            nbits=self._nbits,
            ivf_list_cap=self._ivf_list_cap,
            pairs=pairs[order],
            prune_fraction=self._prune_fraction,
            device=self._device,
        )


def build_index(
    doc_embeddings,
    doc_lens=None,
    *,
    num_centroids: int | None = None,
    nbits: int = 2,
    seed: int = 0,
    kmeans_iters: int = 8,
    ivf_list_cap: int | None = None,
    centroids=None,
    codec: rc.ResidualCodec | None = None,
    prune_fraction: float = 0.0,
    device: str | torch.device = "cuda",
) -> PlaidIndex:
    """Build a PLAID index from per-document token embeddings on ``device``
    (the counterpart of the reference's monolithic ``build_index``).

    ``doc_embeddings`` is a list of (len_i, d) arrays or tensors, or a
    packed (Nt, d) array or tensor with ``doc_lens``.  The steps are the
    reference's: k-means centroids (``16 sqrt(Nt)`` unless
    ``num_centroids``) unless ``centroids=`` is given, nearest-centroid
    assignment, the residual codec fitted unless ``codec=`` is given, b-bit
    compression, then :func:`assemble_index`.  Under frozen ``centroids``
    and ``codec`` the result is array-identical to the reference's on the
    same embeddings.  The whole corpus is one float32 array; the streaming
    builder and token pruning are not ported (ROADMAP Queue 1 item 5).
    """
    if prune_fraction > 0.0:
        raise NotImplementedError(
            "build_index(prune_fraction > 0): build-time token pruning is not "
            "ported yet (ROADMAP Queue 1 item 5)"
        )
    dev = resolve_device(device)
    if isinstance(doc_embeddings, (list, tuple)):
        doc_lens = [len(d) for d in doc_embeddings]
        packed = torch.cat([_as_tensor(d, torch.float32, dev) for d in doc_embeddings])
    else:
        if doc_lens is None:
            raise ValueError("packed doc_embeddings need doc_lens")
        packed = _as_tensor(doc_embeddings, torch.float32, dev)
    doc_lens = _as_tensor(doc_lens, torch.int32, dev)
    if int(doc_lens.long().sum()) != packed.shape[0]:
        raise ValueError(f"doc_lens sum {int(doc_lens.long().sum())} != tokens {packed.shape[0]}")

    if centroids is None:
        centroids = _kmeans.train_centroids(
            packed, num_centroids or _kmeans.num_centroids_for(packed.shape[0]),
            seed=seed, iters=kmeans_iters,
        )
    else:
        centroids = _as_tensor(centroids, torch.float32, dev)

    codes, _ = _kmeans._assign_chunked(packed, centroids)
    residuals = packed - centroids[codes.long()]
    if codec is None:
        codec = rc.fit_codec(residuals, nbits)
    else:
        codec = rc.ResidualCodec(
            _as_tensor(codec.cutoffs, torch.float32, dev),
            _as_tensor(codec.weights, torch.float32, dev),
            codec.nbits,
        )
    packed_res = rc.compress_residuals(codec, residuals)
    del residuals
    return assemble_index(
        centroids, codes, packed_res, doc_lens,
        cutoffs=codec.cutoffs, weights=codec.weights, nbits=codec.nbits,
        ivf_list_cap=ivf_list_cap, device=dev,
    )
