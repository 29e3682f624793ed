"""Two-pass, bounded-memory, mesh-parallel PLAID index construction (the
counterpart of ``repro.build.streaming``).

The monolithic ``core.index.build_index`` holds every token embedding in
one float32 array on its device; at a corpus of 1.4e8 tokens at d=128 that
array alone is 72.7 GB.  This builder streams the corpus twice and never
holds more than ``sample_size + chunk`` float32 rows:

* **pass 1** — stream chunks (through the encoder, if the stream has
  one), reservoir-sample tokens by order-invariant priorities
  (``build.sampling``), train centroids with block-ordered Lloyd
  iterations over the build mesh's devices (``build.kmeans_mesh``) and
  fit the residual codec on the sample's residuals.  Skipped entirely
  when both ``centroids`` and ``codec`` are frozen (the online-ingest
  path).
* **pass 2** — re-stream chunks; each runs encode → assign → residual →
  compress, its rows split evenly over the build mesh's devices, and only
  the compact payloads (codes i32 + packed residuals u8) are kept,
  reassembled in row order and folded into the CSR by
  ``core.index.IndexAssembler``.

The build mesh (``n_devices=``, default the most visible cards whose count
divides ``stat_blocks``; or an explicit ``launch.mesh.Mesh`` as ``mesh=``,
whose devices may repeat) only spreads the work: every step is row-wise or
block-ordered, so the index is the same bits for 1, 2 and 4 devices.
Everything else stays on the build device: the sample, each chunk, the
payloads.  The host holds the sample's priorities (8 bytes a token) and,
when pruning, one chunk's copy for scoring (``build.prune``).

The contract: given the same training sample and frozen codec tables,
pass 2 is ARRAY-IDENTICAL to the monolithic ``build_index``: assignment is
row-wise and runs in fixed-height windows (``core.kmeans._assign_chunked``),
so a row's code does not depend on the chunk it came in.  Under frozen
centroids the build is array-identical to the reference's streaming build
(pruned or not).  Trained builds are bit-identical across chunkings and
runs; they differ from the reference's because ``torch.Generator`` draws
replace ``jax.random`` keys.

Spans (``obs.trace``, the reference's names and attributes): one
``build.sample_chunk`` a chunk of pass 1, ``build.kmeans`` around the
centroid fit, one ``build.quantize_chunk`` a chunk of pass 2.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.build import chunks as chunks_mod
from repro_torch.build import kmeans_mesh
from repro_torch.build import prune as prune_mod
from repro_torch.build.sampling import ReservoirSampler
from repro_torch.core import index as index_mod
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import residual_codec as rc
from repro_torch.core.index import PlaidIndex
from repro_torch.launch.mesh import Mesh
from repro_torch.obs.trace import get_tracer

DEFAULT_SAMPLE_SIZE = 1 << 18  # matches core.kmeans.train_centroids
DEFAULT_CHUNK_DOCS = 256


@dataclasses.dataclass
class BuildStats:
    """What the build did and what it cost.  ``peak_host_f32_bytes`` counts
    the builder's own float32 materializations in host memory: on the card
    only a chunk copied for pruning's scores, on ``device="cpu"`` also the
    sample and the chunk (the bounded-memory tests assert they stay
    O(sample + chunk) while the corpus grows)."""

    n_docs: int = 0
    n_tokens: int = 0
    n_chunks: int = 0
    num_centroids: int = 0
    sample_tokens: int = 0
    peak_chunk_tokens: int = 0
    peak_host_f32_bytes: int = 0
    n_devices: int = 1
    pass1_s: float = 0.0
    pass2_s: float = 0.0
    kmeans_s: float = 0.0  # the k-means step of pass 1
    trained: bool = False  # False = frozen centroids+codec (single pass)

    def note_f32(self, n_values: int) -> None:
        self.peak_host_f32_bytes = max(self.peak_host_f32_bytes, 4 * n_values)


def quantize_rows(emb: torch.Tensor, centroids: torch.Tensor, codec: rc.ResidualCodec):
    """assign → residual → compress; row-wise, so chunk invariant.  The
    same ``_assign_chunked`` as the monolithic ``build_index``."""
    emb = emb.float()
    codes, _ = _kmeans._assign_chunked(emb, centroids)
    return codes, rc.compress_residuals(codec, emb - centroids[codes.long()])


def quantize_rows_mesh(emb: torch.Tensor, mesh: Mesh, tables: list):
    """:func:`quantize_rows` with the rows split over the mesh's devices
    (``ceil(rows / devices)`` each, so the last slices may be shorter) and
    the results reassembled in row order on ``emb``'s device;
    ``tables[i]`` is ``(centroids, codec)`` on device ``i``.  The math is
    row-wise, so the result is the one-device result."""
    n_dev = len(mesh.devices)
    if n_dev == 1 and mesh.devices[0] == emb.device:
        return quantize_rows(emb, *tables[0])
    per = -(-emb.shape[0] // n_dev)
    parts = [quantize_rows(emb[i * per : (i + 1) * per].to(dev), *tables[i])
             for i, dev in enumerate(mesh.devices)]
    return (torch.cat([c.to(emb.device) for c, _ in parts]),
            torch.cat([p.to(emb.device) for _, p in parts]))


def default_n_devices(device: torch.device, stat_blocks: int) -> int:
    """The most visible cards whose count divides ``stat_blocks`` (an odd
    card count must not make a build fail); one on the host."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    return max(d for d in range(1, visible + 1) if stat_blocks % d == 0)


class StreamingIndexBuilder:
    """Two-pass streaming builder on ``device``; see module docstring.

    One-shot use::

        builder = StreamingIndexBuilder(num_centroids=4096)
        index = builder.build(corpus)          # or a ChunkStream / callable
        builder.save(path, layout="sharded", n_shards=4)

    or drive the passes yourself: ``train(stream)`` then ``quantize(stream)``.
    """

    def __init__(
        self,
        *,
        num_centroids: int | None = None,
        nbits: int = 2,
        seed: int = 0,
        kmeans_iters: int = 8,
        sample_size: int = DEFAULT_SAMPLE_SIZE,
        ivf_list_cap: int | None = None,
        chunk_docs: int = DEFAULT_CHUNK_DOCS,
        n_devices: int | None = None,
        stat_blocks: int = kmeans_mesh.DEFAULT_STAT_BLOCKS,
        centroids=None,
        codec: rc.ResidualCodec | None = None,
        prune_fraction: float = 0.0,
        prune_method: str = "attention",
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        self.device = resolve_device(device)
        if mesh is None:
            if n_devices is None:
                n_devices = default_n_devices(self.device, stat_blocks)
            mesh = kmeans_mesh.build_mesh(n_devices, self.device)
        elif n_devices is not None and n_devices != mesh.n_shards:
            raise ValueError(f"n_devices={n_devices} but the mesh has {mesh.n_shards}")
        self.mesh = mesh
        self.num_centroids = num_centroids
        self.nbits = nbits if codec is None else codec.nbits
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.sample_size = int(sample_size)
        self.ivf_list_cap = ivf_list_cap
        self.chunk_docs = chunk_docs
        self.stat_blocks = stat_blocks
        self.centroids = (
            None if centroids is None
            else index_mod._as_tensor(centroids, torch.float32, self.device)
        )
        self.codec = None if codec is None else index_mod.codec_to(codec, self.device)
        if not 0.0 <= prune_fraction < 1.0:
            raise ValueError(f"prune_fraction must be in [0, 1), got {prune_fraction}")
        self.prune_fraction = float(prune_fraction)
        if prune_method not in prune_mod.METHODS:
            raise ValueError(
                f"unknown prune method {prune_method!r}; use {prune_mod.METHODS}"
            )
        self.prune_method = prune_method
        self.stats = BuildStats(n_devices=mesh.n_shards)
        self.index: PlaidIndex | None = None

    # ---- pass 1: sample + train --------------------------------------
    def train(self, stream) -> tuple[torch.Tensor, rc.ResidualCodec]:
        """Stream once; train centroids (unless frozen) and fit the codec
        (unless frozen).  Returns the (centroids, codec) tables pass 2
        quantizes against."""
        stream = chunks_mod.as_stream(stream, chunk_docs=self.chunk_docs)
        t0 = time.perf_counter()
        need_centroids = self.centroids is None
        need_codec = self.codec is None
        if not (need_centroids or need_codec):
            return self.centroids, self.codec

        tracer = get_tracer()
        reservoir = ReservoirSampler(self.sample_size, seed=self.seed)
        n_tokens = n_docs = n_chunks = 0
        for payload, doc_lens in stream.chunks():
            with tracer.span("build.sample_chunk", chunk=n_chunks):
                emb, doc_lens = self._chunk(stream, payload, doc_lens)
                reservoir.offer(emb, n_tokens)
                if self.device.type == "cpu":
                    self.stats.note_f32((reservoir.n_kept + emb.shape[0]) * emb.shape[1])
                n_tokens += emb.shape[0]
                n_docs += len(doc_lens)
                n_chunks += 1
        if n_tokens == 0:
            raise ValueError("corpus stream yielded no tokens")
        self.stats.n_docs, self.stats.n_tokens = n_docs, n_tokens
        self.stats.n_chunks = n_chunks
        self.stats.sample_tokens = reservoir.n_kept
        sample = reservoir.sample()

        if need_centroids:
            k = self.num_centroids or _kmeans.num_centroids_for(n_tokens)
            # core.kmeans.train_centroids' generators: the sample-draw one
            # is unused (the reservoir is priority-based)
            _, g_fit = _kmeans.fit_generators(self.seed, self.device)
            t1 = time.perf_counter()
            with tracer.span("build.kmeans", k=int(k), sample_tokens=reservoir.n_kept):
                self.centroids = kmeans_mesh.kmeans_fit_mesh(
                    sample, k, generator=g_fit, iters=self.kmeans_iters,
                    mesh=self.mesh, stat_blocks=self.stat_blocks,
                )
                self._sync()
            self.stats.kmeans_s = time.perf_counter() - t1
        self.stats.num_centroids = int(self.centroids.shape[0])
        if need_codec:
            codes, _ = _kmeans._assign_chunked(sample, self.centroids)
            self.codec = rc.fit_codec(sample - self.centroids[codes.long()], self.nbits)
        self.stats.trained = True
        self._sync()
        self.stats.pass1_s = time.perf_counter() - t0
        return self.centroids, self.codec

    # ---- pass 2: quantize + incremental CSR --------------------------
    def quantize(self, stream) -> PlaidIndex:
        """Re-stream; encode → assign → residual → compress per chunk on
        the build device, assembled incrementally.  Requires tables
        (``train`` first, or frozen ``centroids=``/``codec=``)."""
        if self.centroids is None or self.codec is None:
            raise RuntimeError(
                "no centroid/codec tables: call train() first or construct "
                "with frozen centroids= and codec="
            )
        stream = chunks_mod.as_stream(stream, chunk_docs=self.chunk_docs)
        t0 = time.perf_counter()
        assembler = index_mod.IndexAssembler(
            self.centroids,
            cutoffs=self.codec.cutoffs,
            weights=self.codec.weights,
            nbits=self.codec.nbits,
            ivf_list_cap=self.ivf_list_cap,
            prune_fraction=self.prune_fraction,
            device=self.device,
        )
        tracer = get_tracer()
        tables = [(self.centroids.to(d), index_mod.codec_to(self.codec, d))
                  for d in self.mesh.devices]
        n_chunks = 0
        for payload, doc_lens in stream.chunks():
            with tracer.span("build.quantize_chunk", chunk=n_chunks):
                emb, doc_lens = self._chunk(stream, payload, doc_lens)
                codes, packed = quantize_rows_mesh(emb, self.mesh, tables)
                del emb  # freed before the stream makes the next chunk
                assembler.add_chunk(codes, packed, doc_lens)
                n_chunks += 1
        self.index = assembler.finish()
        self.stats.n_chunks = max(self.stats.n_chunks, n_chunks)
        if not self.stats.n_tokens:  # frozen-tables single-pass build
            self.stats.n_tokens = self.index.num_tokens
            self.stats.n_docs = self.index.num_passages
            self.stats.num_centroids = self.index.num_centroids
        self._sync()
        self.stats.pass2_s = time.perf_counter() - t0
        return self.index

    def build(self, corpus, doc_lens=None) -> PlaidIndex:
        """Both passes over any supported corpus input (see
        ``build.chunks.as_stream``)."""
        stream = chunks_mod.as_stream(corpus, doc_lens, chunk_docs=self.chunk_docs)
        self.train(stream)
        return self.quantize(stream)

    # ---- emit ----------------------------------------------------------
    def save(self, path: str, *, layout: str = "v2", n_shards: int | None = None):
        """Write the built index in a serving layout (see ``build.emit``)."""
        from repro_torch.build.emit import emit

        if self.index is None:
            raise RuntimeError("build() / quantize() before save()")
        return emit(self.index, path, layout=layout, n_shards=n_shards)

    # ---- internals -----------------------------------------------------
    def _chunk(self, stream, payload, doc_lens):
        """One chunk as ``(emb (nt, d) f32 on the build device, host
        doc_lens)``: encoded if the stream has an encoder, then pruned.

        Pruning is doc-local and deterministic (``build.prune``), so pass 1
        (sampling) and pass 2 (quantization) prune identically and chunk
        boundaries never change the result.
        """
        doc_lens = chunks_mod.host_lens(doc_lens)
        if stream.encode_fn is None:
            emb = index_mod._as_tensor(payload, torch.float32, self.device)
        else:
            tokens = payload if isinstance(payload, torch.Tensor) else torch.from_numpy(payload)
            emb = stream.encode_fn(tokens.to(self.device))
            emb = emb.reshape(-1, emb.shape[-1]).float()
        if self.device.type == "cpu" or self.prune_fraction > 0.0:
            self.stats.note_f32(emb.numel())  # a host chunk, or its host copy
        if self.prune_fraction > 0.0:
            emb, doc_lens = prune_mod.prune_chunk(
                emb, doc_lens, fraction=self.prune_fraction, method=self.prune_method
            )
        self.stats.peak_chunk_tokens = max(self.stats.peak_chunk_tokens, emb.shape[0])
        return emb, doc_lens

    def _sync(self) -> None:
        """Wait for the device, so a pass's seconds are its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def build_index_streaming(
    corpus,
    doc_lens=None,
    *,
    num_centroids: int | None = None,
    nbits: int = 2,
    seed: int = 0,
    kmeans_iters: int = 8,
    ivf_list_cap: int | None = None,
    centroids=None,
    codec: rc.ResidualCodec | None = None,
    chunk_docs: int = DEFAULT_CHUNK_DOCS,
    sample_size: int = DEFAULT_SAMPLE_SIZE,
    n_devices: int | None = None,
    stat_blocks: int = kmeans_mesh.DEFAULT_STAT_BLOCKS,
    prune_fraction: float = 0.0,
    prune_method: str = "attention",
    return_stats: bool = False,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
):
    """Build a PLAID index with the streaming two-pass pipeline on
    ``device``.

    The reference's keyword surface (a superset of ``core.index.
    build_index``'s; the ``retrieval.build`` factory routes here).
    ``corpus`` may be a list of per-doc arrays or tensors, a packed
    ``(Nt, d)`` array or tensor with ``doc_lens``, a ``ChunkStream``, or a
    zero-arg callable yielding ``(embeddings, doc_lens)`` chunks.
    """
    builder = StreamingIndexBuilder(
        num_centroids=num_centroids,
        nbits=nbits,
        seed=seed,
        kmeans_iters=kmeans_iters,
        sample_size=sample_size,
        ivf_list_cap=ivf_list_cap,
        chunk_docs=chunk_docs,
        n_devices=n_devices,
        stat_blocks=stat_blocks,
        centroids=centroids,
        codec=codec,
        prune_fraction=prune_fraction,
        prune_method=prune_method,
        device=device,
        mesh=mesh,
    )
    index = builder.build(corpus, doc_lens)
    return (index, builder.stats) if return_stats else index
