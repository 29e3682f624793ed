"""Continuous-batching retrieval front-end (the counterpart of
``repro.serving.server``).

The serving tier's entry point: requests arrive one at a time and the
server coalesces them into *bucketed* batches: dispatch rounds the
coalesced count up to the smallest pow2 bucket (``repro_torch.serving.
buckets``, the ``repro_torch.exec.segments`` padding discipline applied to
the query axis), so a burst of 3 runs at B=4 and a lone arrival at B=1.

Per-request knobs (the PLAID latency/quality operating point is a
per-request tunable):

* ``t_cs`` rides through the batch as a ``(B,)`` f32 per-lane vector, so
  one coalesced batch serves requests at different pruning
  aggressiveness;
* ``k`` is served by max-``k`` dispatch: the batch runs at the
  retriever's ``params.k`` and each result is truncated to the request's
  ``k`` (<= ``params.k``) on completion;
* ``priority`` and ``timeout_ms`` feed admission control
  (``repro_torch.serving.admission``): a bounded queue with load
  shedding, interactive-over-batch dispatch order, and expiry before
  dispatch.

An exact-match result cache (``repro_torch.serving.cache``) fronts the
queue, invalidated atomically by the mutable backends' ``generation``
counter — ingest/delete/compaction through this server (or directly on
the index) make every stale entry unreachable with one integer bump.

The server takes any ``repro_torch.retrieval.Retriever`` (facade backends
return ``SearchResult``) and also accepts the raw core engines (plain
``(scores, pids)`` tuples).  The padded numpy batch and the lane vector go
straight to ``search_batch``, whose engine moves them to the index's
device; each dispatched batch runs the batch-first stage pipeline — one
stage-1 ``C·Qᵀ`` and one shared candidate-token gather for the whole
coalesced batch — and the copy of its ``scores`` and ``pids`` to host
numpy, inside the ``serve.dispatch`` span, is the batch's one
device-to-host synchronization (the raw engines do not synchronize on
their own).  A device error reaches every waiter of the batch; nothing
falls back to the CPU.

With a mutable backend, ``add_passages`` / ``delete_passages`` /
``compact`` update the corpus while queries are in flight: LiveIndex
mutations swap immutable references under a lock and searches run on
snapshots, so a batch dispatched before an ingest completes against the
old snapshot and the next batch sees the new segment.  The dispatcher
thread and the client threads share the default CUDA stream, so a search
and a mutation reach the device in the order they were issued.

``retraces`` / :meth:`BatchingServer.assert_zero_retrace` keep the
reference's names and place in ``stats()``.  They read
``core.pipeline.trace_count()``, which stays 0 in eager PyTorch (nothing
is traced), so here they check only that convention.
"""
from __future__ import annotations

import dataclasses
import inspect
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.serving import buckets as buckets_mod
from repro_torch.serving.admission import (
    AdmissionQueue,
    DeadlineExceeded,
    ServerClosed,
)
from repro_torch.serving.cache import ResultCache, query_key
from repro_torch.serving.stats import Counters, LatencyWindow


@dataclasses.dataclass
class RetrievalResult:
    pids: np.ndarray  # (k,)
    scores: np.ndarray  # (k,)
    latency_ms: float
    t_cs: float | None = None  # the effective threshold this lane ran with
    k: int | None = None  # the per-request k the result was truncated to
    cached: bool = False  # served from the generation-stamped result cache


class ResultFuture:
    """Single-result handle: ``get(timeout)`` returns the
    :class:`RetrievalResult` or raises the request's typed error.

    Drop-in for the single-slot ``queue.Queue`` the server used to return
    (same ``get`` signature; ``queue.Empty`` on timeout).
    """

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None

    # ---- producer side (server internals) --------------------------------
    def set(self, result) -> None:
        self._result = result
        self._done.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    # ---- consumer side ----------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def get(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise queue_mod.Empty(
                f"no result within {timeout}s (request still queued or "
                "in flight)"
            )
        if self._exc is not None:
            raise self._exc
        return self._result


@dataclasses.dataclass
class _Pending:
    """One admitted request, queued for dispatch."""

    q: np.ndarray
    t_cs: float  # effective (default-resolved) threshold
    k: int  # effective (default-resolved) result size
    t0: float  # submit time (perf_counter)
    deadline: float | None  # absolute perf_counter expiry, or None
    future: ResultFuture
    cache_key: tuple | None  # None = don't cache this request

    def fail(self, exc: BaseException) -> None:
        self.future.set_exception(exc)


class BatchingServer:
    """Coalesces single-query requests into bucketed search batches."""

    def __init__(
        self,
        retriever,  # repro_torch.retrieval.Retriever (or a raw core engine)
        batch_size: int = 16,
        max_wait_ms: float = 2.0,
        *,
        bucketed: bool = True,  # False = legacy fixed-batch padding
        max_pending: int = 1024,
        cache_size: int | None = 1024,  # None/0 disables the result cache
        latency_window: int = 2048,
        tracer: trace_mod.Tracer | None = None,
        registry: metrics_mod.MetricsRegistry | None = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.retriever = retriever
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.bucketed = bucketed
        self._q = AdmissionQueue(max_pending)
        self._stop = threading.Event()
        self._drain = True
        self._closed = False
        self._lock = threading.Lock()  # guards _expected_shape + warm sets
        self._latencies = LatencyWindow(latency_window)
        self._counters = Counters(
            "submitted", "completed", "cache_hits", "expired", "errors",
            "dispatches", "retraces",
        )
        self._bucket_dispatches: dict[int, int] = {}
        self._warm: set = set()  # (bucket, generation) pairs already traced
        self._inflight = 0
        # observability: span tracer + gauge registry.  Defaults are the
        # process-wide singletons (zero plumbing); tests inject their own
        # for isolation/determinism.
        self.tracer = tracer if tracer is not None else trace_mod.get_tracer()
        self.registry = (
            registry if registry is not None else metrics_mod.get_registry()
        )
        self._g_queue_depth = self.registry.gauge("serving_queue_depth")
        self._g_outstanding = self.registry.gauge("serving_outstanding")
        self.cache = (
            ResultCache(cache_size) if cache_size else None
        )

        # per-request knob support is sniffed once: raw core engines differ
        # (PlaidEngine takes t_cs, VanillaEngine does not)
        params = getattr(retriever, "params", None)
        self._default_t_cs = float(getattr(params, "t_cs", 0.0) or 0.0)
        self._k_serve = getattr(params, "k", None)
        try:
            sig = inspect.signature(retriever.search_batch)
            self._accepts_t_cs = "t_cs" in sig.parameters
        except (TypeError, ValueError):  # builtins / C callables
            self._accepts_t_cs = False

        # query contract: (nq, dim) float.  dim comes from the retriever's
        # describe() when available; nq is fixed by the first request (the
        # batch stacks queries, so every request must match).
        self._dim = None
        describe = getattr(retriever, "describe", None)
        if callable(describe):
            try:
                self._dim = describe().get("index", {}).get("dim")
            except Exception:
                self._dim = None
        self._expected_shape: tuple | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- client API ------------------------------------------------------
    def _generation(self) -> int:
        """The retriever's corpus generation; 0 for immutable backends."""
        return int(getattr(self.retriever, "generation", 0))

    def _validate(self, q_emb: np.ndarray) -> np.ndarray:
        q = _to_host(q_emb)
        if q.ndim != 2:
            raise ValueError(
                f"q_emb must be a (nq, dim) query matrix, got shape {q.shape}"
            )
        if not np.issubdtype(q.dtype, np.floating):
            raise ValueError(f"q_emb must be floating point, got {q.dtype}")
        if self._dim is not None and q.shape[1] != self._dim:
            raise ValueError(
                f"q_emb dim {q.shape[1]} != index dim {self._dim}"
            )
        with self._lock:
            if self._expected_shape is None:
                self._expected_shape = q.shape
            elif q.shape != self._expected_shape:
                raise ValueError(
                    f"q_emb shape {q.shape} != the server's request shape "
                    f"{self._expected_shape} (the batcher stacks requests; "
                    "pad or truncate queries to a fixed nq)"
                )
        return q

    def _resolve_knobs(self, t_cs, k) -> tuple[float, int]:
        if t_cs is None:
            t = self._default_t_cs
        else:
            if not self._accepts_t_cs:
                raise ValueError(
                    "per-request t_cs is not supported by this retriever "
                    "(its search_batch has no t_cs parameter)"
                )
            t = float(t_cs)
        if k is None:
            kk = self._k_serve
            if kk is None:
                raise ValueError(
                    "retriever exposes no params.k; pass k= explicitly"
                )
        else:
            kk = int(k)
            if kk < 1:
                raise ValueError(f"k must be >= 1, got {kk}")
            if self._k_serve is not None and kk > self._k_serve:
                raise ValueError(
                    f"per-request k={kk} exceeds the serving "
                    f"k={self._k_serve} (max-k dispatch truncates, it "
                    "cannot extend; raise SearchParams.k)"
                )
        return t, int(kk)

    def submit(
        self,
        q_emb,
        *,
        t_cs: float | None = None,
        k: int | None = None,
        priority: str = "interactive",
        timeout_ms: float | None = None,
    ) -> ResultFuture:
        """Non-blocking admit: returns a :class:`ResultFuture`.

        Raises ``ValueError`` immediately on malformed queries/knobs,
        ``QueueFull`` when the bounded queue sheds the request, and
        ``ServerClosed`` after shutdown.  Also accepts a
        ``retrieval.SearchRequest`` carrying the same per-request knobs.
        """
        req = q_emb
        if hasattr(req, "q") and hasattr(req, "t_cs"):  # SearchRequest
            q_emb = req.q
            t_cs = req.t_cs if t_cs is None else t_cs
            k = getattr(req, "k", None) if k is None else k
            priority = getattr(req, "priority", priority)
            if timeout_ms is None:
                timeout_ms = getattr(req, "deadline_ms", None)
        if self._closed:  # checked before the cache: a closed server
            # serves nothing, not even hits
            raise ServerClosed("server is shut down; submit refused")
        q = self._validate(q_emb)
        t, kk = self._resolve_knobs(t_cs, k)
        self._counters.inc("submitted")
        t0 = time.perf_counter()

        key = None
        if self.cache is not None:
            with self.tracer.span("serve.cache_lookup"):
                key = query_key(q, t)
                hit = self.cache.get(key, self._generation())
            if hit is not None:
                scores, pids = hit
                fut = ResultFuture()
                lat = time.perf_counter() - t0
                fut.set(
                    RetrievalResult(
                        pids=pids[:kk],
                        scores=scores[:kk],
                        latency_ms=lat * 1e3,
                        t_cs=t,
                        k=kk,
                        cached=True,
                    )
                )
                self._counters.inc("cache_hits")
                self._counters.inc("completed")
                self._latencies.add(lat)
                return fut

        deadline = (
            None if timeout_ms is None else t0 + float(timeout_ms) / 1e3
        )
        pending = _Pending(
            q=q, t_cs=t, k=kk, t0=t0, deadline=deadline,
            future=ResultFuture(), cache_key=key,
        )
        self._q.put(pending, priority)  # QueueFull / ServerClosed
        self._g_queue_depth.set(len(self._q))
        self._g_outstanding.set(self.outstanding)
        return pending.future

    def search(self, q_emb, timeout: float = 30.0, **kw) -> RetrievalResult:
        return self.submit(q_emb, **kw).get(timeout=timeout)

    # ---- corpus mutation (live backends) ---------------------------------
    def _mutable(self, op: str):
        fn = getattr(self.retriever, op, None)
        if fn is None:
            raise TypeError(
                f"retriever backend "
                f"{getattr(self.retriever, 'backend_name', type(self.retriever).__name__)!r} "
                f"does not support {op}; serve a mutable backend "
                "(retrieval.build(..., backend='live'))"
            )
        return fn

    def add_passages(self, doc_embeddings, doc_lens=None) -> np.ndarray:
        """Ingest passages into a live backend while serving; returns the
        new global pids.  Safe to call concurrently with ``submit``: the
        underlying LiveIndex swaps snapshots, so in-flight batches finish
        against the old corpus and later batches see the new passages.
        The generation bump atomically invalidates the result cache."""
        return self._mutable("add_passages")(doc_embeddings, doc_lens=doc_lens)

    def delete_passages(self, pids) -> int:
        """Tombstone passages in a live backend while serving; returns the
        number newly deleted.  Batches dispatched after this call no longer
        return the deleted pids, and cached results from earlier
        generations become unreachable."""
        return self._mutable("delete_passages")(pids)

    def compact(self):
        """Run a live backend's compaction now; returns the old->new pid
        map.  The compaction swap bumps the generation, invalidating the
        result cache atomically."""
        return self._mutable("compact")()

    # ---- introspection ---------------------------------------------------
    @property
    def outstanding(self) -> int:
        """Backlog + in-flight: the load metric ReplicaPool routes on."""
        return len(self._q) + self._inflight

    def stats(self) -> dict:
        """Latency percentiles over the bounded window plus serving
        counters.  ``{}`` until the first request completes (legacy
        contract)."""
        base = self._latencies.summary()
        if not base:
            return {}
        base.update(self._counters.snapshot())
        base["shed"] = self._q.shed
        base["rejected"] = self._q.rejected
        base["pending"] = len(self._q)
        base["queue_depth"] = len(self._q)
        base["outstanding"] = self.outstanding
        self._g_queue_depth.set(base["queue_depth"])
        self._g_outstanding.set(base["outstanding"])
        with self._lock:
            base["buckets"] = dict(sorted(self._bucket_dispatches.items()))
        if self.cache is not None:
            c = self.cache.stats()
            looked = c["hits"] + c["misses"]
            c["hit_rate"] = c["hits"] / looked if looked else 0.0
            base["cache"] = c
        # tiered backends account every host->device candidate-slice pull;
        # surface the running totals so operators see PCIe traffic next to
        # latency (slice_bytes = exact CSR payload, staged_bytes = padded
        # staging transfer)
        transfer = getattr(self.retriever, "transfer_totals", None)
        if transfer:
            base["transfer"] = dict(transfer)
        return base

    def assert_zero_retrace(self) -> None:
        """Raise if any warmed (bucket, generation) pair retraced the
        pipeline — the reference's compile-discipline guard.  The port
        runs eagerly and ``pipeline.trace_count()`` stays 0, so this
        holds by construction here (see the module docstring)."""
        n = self._counters["retraces"]
        if n:
            raise RuntimeError(
                f"{n} dispatch(es) retraced an already-warm batch bucket; "
                "per-request knobs or bucket reuse retraced (see "
                "stats()['buckets'])"
            )

    # ---- shutdown --------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop serving.  ``drain=True`` (default) dispatches every queued
        request before the dispatcher exits; ``drain=False`` fails queued
        waiters with ``ServerClosed``.  Either way, subsequent submits
        raise ``ServerClosed`` and the dispatcher thread is joined."""
        self._drain = drain
        self._closed = True
        self._q.close()  # future puts raise ServerClosed
        self._stop.set()
        self._thread.join(timeout=timeout)

    # ---- dispatcher ------------------------------------------------------
    def _expire(self, batch: list) -> list:
        """Fail already-expired requests; return the live remainder."""
        now = time.perf_counter()
        live = []
        for p in batch:
            if p.deadline is not None and now > p.deadline:
                p.fail(
                    DeadlineExceeded(
                        f"deadline expired {1e3 * (now - p.deadline):.1f}ms "
                        "before dispatch"
                    )
                )
                self._counters.inc("expired")
            else:
                live.append(p)
        return live

    def _loop(self):
        while not self._stop.is_set():
            first = self._q.get(timeout=0.05)
            if first is None:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = (
                    0.0
                    if self._stop.is_set()
                    else deadline - time.perf_counter()
                )
                nxt = self._q.get(timeout=max(remaining, 0.0))
                if nxt is None:
                    break
                batch.append(nxt)
            batch = self._expire(batch)
            if not batch:
                continue
            self._inflight = len(batch)
            try:
                self._dispatch(batch)
            except Exception as exc:
                # propagate into every waiter instead of hanging them, and
                # keep the dispatcher alive for subsequent batches
                self._counters.inc("errors")
                for p in batch:
                    p.fail(exc)
            finally:
                self._inflight = 0
        # stopped: drain or fail whatever is still queued
        leftovers = self._q.drain()
        if self._drain:
            while leftovers:
                chunk = self._expire(leftovers[: self.batch_size])
                leftovers = leftovers[self.batch_size:]
                if not chunk:
                    continue
                try:
                    self._dispatch(chunk)
                except Exception as exc:
                    self._counters.inc("errors")
                    for p in chunk:
                        p.fail(exc)
        else:
            for p in leftovers:
                p.fail(ServerClosed("server shut down without drain"))

    def _dispatch(self, batch: list) -> None:
        from repro_torch.core import pipeline as pipeline_mod

        n = len(batch)
        dispatch_t0 = time.perf_counter()
        for p in batch:
            # the wait is only measurable once it ends: record retroactively
            self.tracer.record(
                "serve.queue_wait", p.t0, dispatch_t0 - p.t0
            )
        bucket = (
            buckets_mod.bucket_batch_size(n, self.batch_size)
            if self.bucketed
            else self.batch_size
        )
        with self.tracer.span("serve.pad", bucket=bucket, n=n):
            qs, ts = buckets_mod.pad_batch(
                [p.q for p in batch], [p.t_cs for p in batch], bucket
            )
        gen0 = self._generation()
        warm_key = (bucket, gen0)
        traces_before = pipeline_mod.trace_count()

        kwargs = {}
        if self._accepts_t_cs:
            # per-lane thresholds: one batch serves every per-request t_cs
            kwargs["t_cs"] = ts
        with self.tracer.span(
            "serve.dispatch", bucket=bucket, n=n, generation=gen0
        ):
            out = self.retriever.search_batch(qs, **kwargs)
            scores, pids = out  # SearchResult iterates as (scores, pids)
            # the batch's one device-to-host sync
            pids, scores = _to_host(pids), _to_host(scores)

        with self._lock:
            if warm_key in self._warm:
                if pipeline_mod.trace_count() != traces_before:
                    self._counters.inc("retraces")
            else:
                self._warm.add(warm_key)
            self._bucket_dispatches[bucket] = (
                self._bucket_dispatches.get(bucket, 0) + 1
            )
        self._counters.inc("dispatches")

        now = time.perf_counter()
        # cache only if no mutation raced the batch: the snapshot the
        # search actually ran against is then unambiguously gen0
        gen_ok = self.cache is not None and self._generation() == gen0
        with self.tracer.span("serve.truncate", n=n):
            for i, p in enumerate(batch):
                if gen_ok and p.cache_key is not None:
                    self.cache.put(p.cache_key, gen0, scores[i], pids[i])
                lat = now - p.t0
                self._latencies.add(lat)
                self._counters.inc("completed")
                p.future.set(
                    RetrievalResult(
                        pids=pids[i][: p.k],
                        scores=scores[i][: p.k],
                        latency_ms=lat * 1e3,
                        t_cs=p.t_cs,
                        k=p.k,
                        cached=False,
                    )
                )
        self._g_queue_depth.set(len(self._q))
        self._g_outstanding.set(len(self._q))  # this batch is done


def _to_host(x) -> np.ndarray:
    """``x`` as host numpy: a tensor on the card is copied (and waited
    for), a CPU tensor or an array-like is viewed."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)
