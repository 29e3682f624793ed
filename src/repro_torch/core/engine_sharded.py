"""Document-sharded PLAID: the index partitioner (the counterpart of
``repro.core.engine_sharded``).

The corpus is split into ``n_shards`` equal document ranges, one per mesh
device; the centroids replicate (they are K x 128).  Execution lives in
``repro_torch.exec.sharded`` (the pipeline per shard, then the one shared
merge in ``repro_torch.distributed.topk``); this module holds the
partitioner :func:`shard_index` and re-exports the execution entry point.

:func:`shard_index` runs with torch on the index's device.  The
reference's numpy version calls ``np.unique(axis=0)`` over every shard's
``(code, pid)`` pairs (142M of them at 2M passages), and the live backend
re-shards after every compaction; here the pairs are one int64 key
``code * per + local_pid``, whose sorted unique values are the
lexicographic order ``np.unique`` gives, and the embedding IVF is a stable
``torch.sort`` of the codes.  The output is the reference's array for
array.
"""
from __future__ import annotations

import torch

from repro_torch.core.index import STATIC_FIELDS, PlaidIndex
from repro_torch.exec.sharded import (  # noqa: F401  (re-exports)
    DOC_AXES,
    index_as_dict,
    make_sharded_search,
)

#: doc-partitioned arrays, stacked in shard order by :func:`shard_index`
_TOKEN_FIELDS = ("codes", "residuals", "tok_pid", "eivf_eids")
_PER_SHARD_FIELDS = ("doc_offsets", "doc_lens", "ivf_offsets", "ivf_lens",
                     "eivf_offsets", "eivf_lens")


def static_meta_of(index: PlaidIndex) -> dict:
    return {f: getattr(index, f) for f in STATIC_FIELDS}


def _offsets(lens: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int32, device=lens.device)
    out[1:] = torch.cumsum(lens, 0)
    return out


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, [0, 0] * (a.ndim - 1) + [0, n - a.shape[0]])


def shard_index(index: PlaidIndex, n_shards: int):
    """Partition a globally built index into equal document-range shards.

    Returns ``(index_dict, static_meta, docs_per_shard)`` for
    ``make_sharded_search``, on the index's device.  Shard ``i`` owns
    global pids ``[i * per, min((i + 1) * per, Nd))`` with ``per =
    ceil(Nd / n_shards)``, so a sharded pid (``shard * per + local``) IS
    the global pid; padded tail slots have zero length and appear in no
    IVF, so they never surface.  Per-shard IVFs are rebuilt over the
    shared centroids with LOCAL pids; token arrays are zero-padded to the
    largest shard's token count and the IVF pids to the largest pair
    count; ``ivf_list_cap`` / ``eivf_list_cap`` are the maxima over shards.
    """
    Nd = index.num_passages
    per = -(-Nd // n_shards)  # ceil
    K = index.num_centroids
    dev = index.device
    doc_off = index.doc_offsets.cpu()
    sh = {f: [] for f in (*_TOKEN_FIELDS, *_PER_SHARD_FIELDS, "ivf_pids")}
    max_nt = max_nnz = 1
    ivf_cap = eivf_cap = 1
    for i in range(n_shards):
        lo, hi = min(i * per, Nd), min((i + 1) * per, Nd)
        t0, t1 = int(doc_off[lo]), int(doc_off[hi])
        lens = torch.zeros(per, dtype=torch.int32, device=dev)
        lens[: hi - lo] = index.doc_lens[lo:hi]
        c = index.codes[t0:t1]
        tok_pid = torch.repeat_interleave(
            torch.arange(per, dtype=torch.int32, device=dev), lens.long(), output_size=t1 - t0
        )
        pairs = torch.unique(c.long() * per + tok_pid.long())  # sorted (code, pid)
        ivf_lens = torch.bincount(pairs // per, minlength=K).to(torch.int32)
        eivf_lens = torch.bincount(c.long(), minlength=K).to(torch.int32)
        sh["codes"].append(c)
        sh["residuals"].append(index.residuals[t0:t1])
        sh["tok_pid"].append(tok_pid)
        sh["doc_offsets"].append(_offsets(lens))
        sh["doc_lens"].append(lens)
        sh["ivf_pids"].append((pairs % per).to(torch.int32))
        sh["ivf_offsets"].append(_offsets(ivf_lens))
        sh["ivf_lens"].append(ivf_lens)
        sh["eivf_eids"].append(torch.sort(c, stable=True).indices.to(torch.int32))
        sh["eivf_offsets"].append(_offsets(eivf_lens))
        sh["eivf_lens"].append(eivf_lens)
        max_nt = max(max_nt, t1 - t0)
        max_nnz = max(max_nnz, pairs.shape[0])
        ivf_cap = max(ivf_cap, int(ivf_lens.max()) if K else 1)
        eivf_cap = max(eivf_cap, int(eivf_lens.max()) if K else 1)

    out = {f: getattr(index, f) for f in ("centroids", "centroids_q", "centroids_scale",
                                         "cutoffs", "weights")}
    for f in _TOKEN_FIELDS:
        out[f] = torch.cat([_pad_rows(a, max_nt) for a in sh.pop(f)])
    out["ivf_pids"] = torch.cat([_pad_rows(a, max_nnz) for a in sh.pop("ivf_pids")])
    for f in _PER_SHARD_FIELDS:
        out[f] = torch.cat(sh.pop(f))
    meta = dict(
        dim=index.dim,
        nbits=index.nbits,
        doc_maxlen=index.doc_maxlen,
        ivf_list_cap=ivf_cap,
        eivf_list_cap=eivf_cap,
        prune_fraction=index.prune_fraction,
    )
    return out, meta, per
