"""``repro_torch.build`` — streaming, mesh-parallel index construction (the
counterpart of ``repro.build``).

The bounded-memory replacement for one-shot ``core.index.build_index`` at
corpus scale (see ``build.streaming`` for the two-pass design and the
array-identity contract).  ``retrieval.build`` and
``core.indexer.build_from_encoder`` route through here; the monolithic
builder remains as the small-corpus oracle the tests compare against.
``build_mesh`` spreads pass 1's Lloyd statistics and pass 2's rows over
several devices with bit-identical output (``build.kmeans_mesh``).
"""
from repro_torch.build.chunks import (
    ChunkStream,
    array_stream,
    as_stream,
    encoder_stream,
    iterator_stream,
)
from repro_torch.build.emit import LAYOUTS, emit, save_live, save_sharded, save_v2, to_live_index
from repro_torch.build.kmeans_mesh import (
    BUILD_AXIS,
    DEFAULT_STAT_BLOCKS,
    build_mesh,
    kmeans_fit_mesh,
)
from repro_torch.build.prune import prune_chunk, prune_mask, token_importance
from repro_torch.build.sampling import ReservoirSampler, token_priorities
from repro_torch.build.streaming import (
    BuildStats,
    DEFAULT_CHUNK_DOCS,
    DEFAULT_SAMPLE_SIZE,
    StreamingIndexBuilder,
    build_index_streaming,
)

__all__ = [
    "BUILD_AXIS",
    "BuildStats",
    "ChunkStream",
    "DEFAULT_CHUNK_DOCS",
    "DEFAULT_SAMPLE_SIZE",
    "DEFAULT_STAT_BLOCKS",
    "LAYOUTS",
    "ReservoirSampler",
    "StreamingIndexBuilder",
    "array_stream",
    "as_stream",
    "build_index_streaming",
    "build_mesh",
    "emit",
    "encoder_stream",
    "iterator_stream",
    "kmeans_fit_mesh",
    "prune_chunk",
    "prune_mask",
    "save_live",
    "save_sharded",
    "save_v2",
    "to_live_index",
    "token_importance",
    "token_priorities",
]
