"""Deadline-driven micro-batching for the async serving pipeline.

The port's copy of the reference's ``service/scheduler.py`` (pure Python).
The scheduler is the pure data-structure half of
:class:`~repro_torch.service.async_engine.AsyncInfluenceEngine`: it owns no
threads, no locks, and no device state. Requests arrive one at a time and
are coalesced into *buckets* keyed by ``(store key, query class)`` — the
unit :meth:`InfluenceEngine.execute_chunk` executes as one padded batch.
A bucket flushes when it is **full** (``max_batch`` requests — batching
gain has saturated) or when its earliest member's **flush deadline**
arrives (latency bound — a lone request never waits longer than the flush
window for company). Between those two events the engine sleeps; the
scheduler tells it exactly how long via :meth:`next_flush_t`.

Buckets can be *held*: a hold token ``(key, qclass)`` parks that bucket
(``qclass=None`` parks every class for the key) so ``take_due`` skips it —
the engine holds ``(key, "TopKSeeds")`` while a background rebuild of a
stale entry is in flight, then releases and the parked requests flush
against the fresh version. Holds exclude a bucket from ``next_flush_t`` as
well, so a parked bucket costs no wakeups.

All methods assume the caller serializes access (the async engine calls
everything under one condition variable).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

from repro_torch.service.store import StoreKey


@dataclasses.dataclass
class AsyncRequest:
    """One admitted query waiting for (or riding in) a flush.

    enqueue_t:  monotonic admission time (queue-wait accounting).
    flush_t:    when the request's bucket must flush even if not full —
                ``enqueue_t + flush window``.
    deadline_t: absolute end-to-end SLO deadline (None = best effort);
                resolution after it counts as a deadline miss.
    future:     resolves to the :class:`~repro_torch.service.engine.QueryResult`.
    """

    seq: int
    key: StoreKey
    query: object
    future: object
    enqueue_t: float
    flush_t: float
    deadline_t: Optional[float] = None

    @property
    def qclass(self) -> str:
        return type(self.query).__name__


class MicroBatchScheduler:
    """Coalesce compatible requests; flush on batch-full or deadline."""

    def __init__(self, max_batch: int = 256, flush_window_s: float = 0.005):
        self.max_batch = int(max_batch)
        self.flush_window_s = float(flush_window_s)
        self._buckets: dict[tuple, list[AsyncRequest]] = {}
        self._holds: set[tuple] = set()
        self._seq = itertools.count()

    # -- admission ---------------------------------------------------------

    def make_request(self, key: StoreKey, query, future, now: float,
                     deadline_t: Optional[float] = None) -> AsyncRequest:
        return AsyncRequest(seq=next(self._seq), key=key, query=query,
                            future=future, enqueue_t=now,
                            flush_t=now + self.flush_window_s,
                            deadline_t=deadline_t)

    def offer(self, req: AsyncRequest) -> bool:
        """Enqueue into the request's bucket; True if the bucket is now
        full (the engine should flush without waiting for the window)."""
        b = self._buckets.setdefault((req.key, req.qclass), [])
        b.append(req)
        return len(b) >= self.max_batch

    def requeue(self, reqs: Sequence[AsyncRequest]) -> None:
        """Put deferred requests back (front of their buckets, original
        admission order) — their ``flush_t`` is unchanged, so once any hold
        clears they are immediately due."""
        by_bucket: dict[tuple, list[AsyncRequest]] = {}
        for r in reqs:
            by_bucket.setdefault((r.key, r.qclass), []).append(r)
        for bk, rs in by_bucket.items():
            self._buckets[bk] = sorted(rs + self._buckets.get(bk, []),
                                       key=lambda r: r.seq)

    # -- holds -------------------------------------------------------------

    def hold(self, key: StoreKey, qclass: Optional[str] = None) -> None:
        self._holds.add((key, qclass))

    def release(self, key: StoreKey, qclass: Optional[str] = None) -> None:
        self._holds.discard((key, qclass))

    def is_held(self, key: StoreKey, qclass: str) -> bool:
        return (key, qclass) in self._holds or (key, None) in self._holds

    # -- flush selection ---------------------------------------------------

    def take_due(self, now: float) -> list[list[AsyncRequest]]:
        """Remove and return every unheld bucket that is full or whose
        earliest member's flush window has expired."""
        due = []
        for bk, b in list(self._buckets.items()):
            key, qclass = bk
            if not b or self.is_held(key, qclass):
                continue
            if len(b) >= self.max_batch or min(r.flush_t for r in b) <= now:
                due.append(b)
                del self._buckets[bk]
        return due

    def take_all(self) -> list[list[AsyncRequest]]:
        """Remove and return every bucket, holds ignored (shutdown drain)."""
        out = [b for b in self._buckets.values() if b]
        self._buckets.clear()
        return out

    def next_flush_t(self) -> Optional[float]:
        """Earliest flush deadline among unheld buckets (None = nothing
        pending — sleep until a new arrival)."""
        ts = [min(r.flush_t for r in b)
              for (key, qclass), b in self._buckets.items()
              if b and not self.is_held(key, qclass)]
        return min(ts) if ts else None

    def depth(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def oldest_wait_s(self, now: float) -> float:
        """Age of the oldest queued request (0.0 when empty) — the
        admission-stall signal the engine watches."""
        ts = [r.enqueue_t for b in self._buckets.values() for r in b]
        return (now - min(ts)) if ts else 0.0
