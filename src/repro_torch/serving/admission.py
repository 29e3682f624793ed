"""Admission control for the serving tier: typed errors, bounded two-level
priority queues, load shedding, and per-request deadlines (the counterpart
of ``repro.serving.admission``).

A production front-end must fail *fast and typed* instead of building an
unbounded backlog: under overload, queueing delay grows without bound and
every request eventually misses its SLO anyway (the classic open-loop
collapse).  This module gives the :class:`repro_torch.serving.server.
BatchingServer` the three standard controls:

* **bounded queue** — ``max_pending`` caps the backlog; a submit beyond it
  is rejected *immediately* with :class:`QueueFull` (load shedding), so
  clients can retry/degrade instead of timing out;
* **two-level priority** — ``"interactive"`` requests dispatch ahead of
  ``"batch"`` requests, and when the queue is full an interactive arrival
  sheds the *youngest queued batch request* (its waiter gets
  :class:`QueueFull`) rather than being rejected itself;
* **deadlines** — each request may carry an absolute expiry; the
  dispatcher drops already-expired requests (failing their waiters with
  :class:`DeadlineExceeded`) instead of wasting a batch lane on an answer
  nobody is waiting for.

The queue is a condition-variable pair of deques, not ``queue.Queue``:
priority pop, shed-from-tail, and atomic drain need access to both ends.
"""
from __future__ import annotations

import collections
import threading
import time

#: Admission classes, in dispatch order.
PRIORITIES = ("interactive", "batch")


class ServingError(Exception):
    """Base class for every typed serving-tier failure."""


class AdmissionError(ServingError):
    """The request was refused at (or after) admission."""


class QueueFull(AdmissionError):
    """Load shed: the bounded queue had no room for this request."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before it could be dispatched."""


class ServerClosed(ServingError):
    """The server is shut down (or shutting down without drain)."""


class AdmissionQueue:
    """Bounded two-level priority queue with shedding and deadline skips.

    Items are ``(priority, payload)``; ``payload`` must expose
    ``fail(exc)`` (the server's pending-request object) so a shed or
    drained request can be completed with a typed error from inside the
    queue.  Thread-safe; ``len()`` is the total backlog.
    """

    def __init__(self, max_pending: int):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._cond = threading.Condition()
        self._queues = {p: collections.deque() for p in PRIORITIES}
        self._closed = False
        self.shed = 0  # batch requests evicted by interactive arrivals
        self.rejected = 0  # submits refused outright with QueueFull

    def __len__(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    # ---- producer --------------------------------------------------------
    def put(self, payload, priority: str = "interactive") -> None:
        """Admit ``payload`` or raise a typed error (never blocks).

        When full, an interactive arrival sheds the youngest queued batch
        request (completing its waiter with ``QueueFull``); a batch
        arrival — or an interactive one with no batch victim — is rejected
        with ``QueueFull`` itself.
        """
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}"
            )
        victim = None
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down; submit refused")
            total = sum(len(q) for q in self._queues.values())
            if total >= self.max_pending:
                if priority == "interactive" and self._queues["batch"]:
                    victim = self._queues["batch"].pop()  # youngest batch
                    self.shed += 1
                else:
                    self.rejected += 1
                    raise QueueFull(
                        f"queue full ({total}/{self.max_pending} pending); "
                        "request shed"
                    )
            self._queues[priority].append(payload)
            self._cond.notify()
        if victim is not None:
            victim.fail(
                QueueFull(
                    "shed from the queue by an interactive arrival "
                    f"(backlog at max_pending={self.max_pending})"
                )
            )

    # ---- consumer (the dispatcher thread) --------------------------------
    def get(self, timeout: float | None = None):
        """Pop the highest-priority pending payload, or ``None`` on
        timeout.  Interactive requests always pop before batch ones."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while True:
                for p in PRIORITIES:
                    if self._queues[p]:
                        return self._queues[p].popleft()
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return None

    def get_nowait(self):
        return self.get(timeout=0)

    # ---- shutdown --------------------------------------------------------
    def close(self) -> None:
        """Refuse all future ``put``s (``ServerClosed``); queued items stay
        for the dispatcher to drain or fail."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list:
        """Atomically remove and return every queued payload, in dispatch
        order (interactive first)."""
        with self._cond:
            out = []
            for p in PRIORITIES:
                out.extend(self._queues[p])
                self._queues[p].clear()
            return out
