"""Replica load-balancing: one submit stream fanned over N retrievers (the
counterpart of ``repro.serving.replicas``).

A single dispatcher thread serializes device compute per retriever — the
right shape for one accelerator, but a host with several devices (or a
deliberately oversubscribed CPU) wants N independent dispatch streams.
:class:`ReplicaPool` owns one :class:`~repro_torch.serving.server.BatchingServer`
per retriever and routes each submit to the replica with the least
outstanding work (backlog + in-flight), the classic
join-shortest-queue policy — near-optimal for this shape because every
replica answers every query (replicas serve the same corpus, whether they
share one index object or hold per-device copies).

Corpus mutations fan out to every *distinct* underlying index exactly
once: replicas wrapping the same ``LiveIndex`` (the shared-index
deployment) mutate it a single time, while per-replica index copies each
receive the mutation — either way every replica serves the new corpus,
and each server's result cache invalidates through its own retriever's
generation counter.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.server import BatchingServer, RetrievalResult, ResultFuture


class ReplicaPool:
    """Least-outstanding-work router over N BatchingServers.

    ``server_kw`` is forwarded to every replica's ``BatchingServer``
    (batch size, admission bounds, cache size, ...).
    """

    def __init__(self, retrievers, **server_kw):
        retrievers = list(retrievers)
        if not retrievers:
            raise ValueError("ReplicaPool needs at least one retriever")
        self.servers = [BatchingServer(r, **server_kw) for r in retrievers]

    @property
    def n_replicas(self) -> int:
        return len(self.servers)

    # ---- routing ---------------------------------------------------------
    def _pick(self) -> BatchingServer:
        return min(self.servers, key=lambda s: s.outstanding)

    def submit(self, q_emb, **kw) -> ResultFuture:
        """Admit on the least-loaded replica (same knobs as
        ``BatchingServer.submit``)."""
        return self._pick().submit(q_emb, **kw)

    def search(self, q_emb, timeout: float = 30.0, **kw) -> RetrievalResult:
        return self.submit(q_emb, **kw).get(timeout=timeout)

    # ---- corpus mutation --------------------------------------------------
    def _unique_servers(self):
        """One server per distinct underlying index object: replicas
        sharing a LiveIndex mutate it once."""
        seen, out = set(), []
        for s in self.servers:
            index = getattr(s.retriever, "index", s.retriever)
            if id(index) not in seen:
                seen.add(id(index))
                out.append(s)
        return out

    def add_passages(self, doc_embeddings, doc_lens=None) -> np.ndarray:
        pids = None
        for s in self._unique_servers():
            pids = s.add_passages(doc_embeddings, doc_lens=doc_lens)
        return pids

    def delete_passages(self, pids) -> int:
        n = 0
        for s in self._unique_servers():
            n = s.delete_passages(pids)
        return n

    def compact(self):
        out = None
        for s in self._unique_servers():
            out = s.compact()
        return out

    # ---- introspection / lifecycle ----------------------------------------
    def stats(self) -> dict:
        """Pool aggregate + per-replica breakdown."""
        per = [s.stats() for s in self.servers]
        hits = sum(p.get("cache", {}).get("hits", 0) for p in per)
        misses = sum(p.get("cache", {}).get("misses", 0) for p in per)
        agg = dict(
            n_replicas=len(self.servers),
            submitted=sum(p.get("submitted", 0) for p in per),
            completed=sum(p.get("completed", 0) for p in per),
            expired=sum(p.get("expired", 0) for p in per),
            shed=sum(p.get("shed", 0) for p in per),
            cache_hits=hits,
            cache_hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            outstanding=[s.outstanding for s in self.servers],
            queue_depth=sum(p.get("queue_depth", 0) for p in per),
            replicas=per,
        )
        return agg

    def assert_zero_retrace(self) -> None:
        for s in self.servers:
            s.assert_zero_retrace()

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        for s in self.servers:
            s.shutdown(drain=drain, timeout=timeout)
