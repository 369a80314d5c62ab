"""Async influence serving: admission queue, overlapped mutation, tenancy.

Counterpart of the reference's ``service/async_engine.py``. The synchronous
:class:`~repro_torch.service.engine.InfluenceEngine` batches, then blocks:
a cold build or a delta stalls every query behind it, and the store grows
without bound. This module is the admission path in front of it:

* **Deadline-driven micro-batching.** ``submit`` returns a ``Future`` at
  once; a :class:`~repro_torch.service.scheduler.MicroBatchScheduler`
  coalesces requests per ``(store key, query class)``, and the serve thread
  flushes a bucket when it fills or when its flush window (a quarter of the
  end-to-end deadline by default) runs out.
* **Overlapped builds and repairs.** ``register_async``,
  ``apply_delta_async`` and ``rebuild_async`` run on a mutation thread
  against a :meth:`SketchStore.shadow` double buffer: queries keep being
  answered from version N while N+1 is built in the shadow, and
  :meth:`SketchStore.swap_entry` installs it. A batch that took entry N
  before the swap finishes against N.
* **Cost-aware eviction.** With a budget (``max_resident_mb``), a
  :class:`~repro_torch.service.eviction.CostAwareEvictor` keeps the store's
  resident bytes and the cross-entry stack under it (the stack goes
  first); an evicted entry is rebuilt on its next touch.
* **Cross-entry dispatch.** SpreadEstimate buckets against *different*
  host-resident entries of the same register geometry are stacked (rows
  offset) into one matrix and answered in one batch, through
  ``queries._spread_batch`` and so through the cardinality kernel. A
  device-resident entry's buckets run on its mesh, one by one.
* **Device residency.** The serve thread's query batches and the mutation
  thread's repairs, rebuilds and placements of a device entry are
  operations of one serving mesh; the controller's lock
  (``launch.mesh.Controller.call``) makes each atomic, its record and all
  its collectives, so the two threads never interleave collectives.

The async layer reorders work but never changes it: every answer is
byte-equal to the synchronous engine's for the same query against the same
entry version (``tests/test_torch_async_service.py``). Observability: the
queue-depth gauge and timeline, deadline-miss counters, an SLO watchdog on
end-to-end latency, and a flight-recorder dump on admission stalls.

**Streams.** The kernels launch on PyTorch's current stream of the calling
thread (``kernels.common.stream``). The serve thread stays on the default
stream; the mutation thread runs every mutation inside
``torch.cuda.stream(s)`` on a ``torch.cuda.Stream`` of its own, so a
delta's sweeps and a query batch's kernels are in flight together. Before
``swap_entry`` installs a mutated entry, the mutation thread
**synchronizes its stream** (chosen over an event that the serving side
would wait on: the swap is a host-side dict write, so the host is where the
serving side learns of the new entry anyway, and a sync costs nothing the
swap would not wait for). Every tensor of the new entry is therefore
complete before a serving-stream kernel can read it. Stores sync only the
current stream (``device.synchronize``), so neither thread waits for the
other's kernels.

**The caching allocator.** No tensor needs ``record_stream``, because every
read across streams ends before its reader lets go of the tensor:

* the serve thread reads an entry's tensors (banks, the concatenated
  matrix, edge operands) through a snapshot of the entry it holds for the
  whole batch, and every batch ends in a host copy (``.cpu().numpy()``, or
  the changed flags and seeds of a warm top-k), which synchronizes the
  serving stream before the snapshot is dropped. A tensor the mutation
  stream allocated is thus freed, by whichever thread drops the last
  reference, only after the serving stream's reads of it are done;
* the mutation thread reads version N's banks (allocated on either stream)
  only through its shadow, which it holds until its stream is synchronized:
  before the swap, or in a ``finally`` when the mutation fails;
* the evictor runs on both threads, but an eviction only drops the store's
  reference: a batch in flight keeps its own until its host copy.

**The GIL.** Most of a large delta is host work: numpy sorts and dedup, a
hash of the edge list. numpy's sorts and ``hashlib`` release the GIL on
large arrays, Python loops do not, so how much of a delta overlaps serving
is measured on the card (``chip_smoke.py`` phase 7), not assumed.

A kernel error is never swallowed: a failed bucket fails its requests'
futures, a failed mutation its own future. Only observers (the evictor's
budget pass, the hold release after a stale rebuild) are guarded, and
their failures are counted in ``async.observer_errors``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.graphs.structs import Graph, GraphDelta
from repro_torch.obs import flight, metrics, trace
from repro_torch.obs.slo import SLOConfig, SLOWatchdog
from repro_torch.service.delta import apply_delta
from repro_torch.service.engine import InfluenceEngine, QueryResult, Request, _pow2
from repro_torch.service.eviction import CostAwareEvictor
from repro_torch.service.queries import _spread_batch
from repro_torch.service.scheduler import AsyncRequest, MicroBatchScheduler
from repro_torch.service.store import SketchStore, StoreEntry, StoreKey


@dataclasses.dataclass
class _Mutation:
    kind: str            # "build" | "repair" | "rebuild"
    label: str           # span attribute (graph key or "")
    fn: object
    future: Future
    on_done: object = None   # called under the engine lock after fn


class AsyncInfluenceEngine:
    """Future-returning admission front for an :class:`InfluenceEngine`.

    Without ``engine`` it makes one from ``store``, ``backend``, ``spec``,
    ``slo`` and ``device`` (CUDA unless ``device="cpu"``). ``deadline_ms`` and
    ``max_resident_mb`` default to ``spec``'s (then 50 ms and no budget).
    The budget covers the store's resident bytes and the cross-entry
    stack."""

    def __init__(self, engine: Optional[InfluenceEngine] = None, *,
                 store: Optional[SketchStore] = None, max_batch: int = 256,
                 deadline_ms: Optional[float] = None,
                 flush_window_s: Optional[float] = None,
                 max_resident_mb: Optional[float] = None,
                 backend=None, spec=None, slo=None, device=None):
        if engine is None:
            engine = InfluenceEngine(store=store, max_batch=max_batch, backend=backend,
                                     spec=spec, slo=slo, device=device)
        self.engine = engine
        self.store = engine.store
        if deadline_ms is None:
            deadline_ms = float(getattr(spec, "deadline_ms", 0.0) or 0.0) or 50.0
        if max_resident_mb is None:
            max_resident_mb = float(getattr(spec, "max_resident_mb", 0.0) or 0.0)
        self.deadline_ms = float(deadline_ms)
        if flush_window_s is None:
            flush_window_s = self.deadline_ms / 4.0 / 1e3
        self._sched = MicroBatchScheduler(max_batch=max_batch,
                                          flush_window_s=flush_window_s)
        self.evictor = (CostAwareEvictor(int(max_resident_mb * 2**20))
                        if max_resident_mb and max_resident_mb > 0 else None)
        self._watchdog = SLOWatchdog(SLOConfig.coerce({"e2e": self.deadline_ms}),
                                     on_breach=self._on_e2e_breach)
        # the mutation thread's own stream (None on the CPU: a no-op context)
        self._mut_stream = (torch.cuda.Stream(self.store.device)
                            if self.store.device.type == "cuda" else None)

        self._cv = threading.Condition()
        self._mut_q: collections.deque = collections.deque()
        self._rebuilding: set = set()
        self._outstanding = 0          # unresolved futures (queries and mutations)
        self._closed = False
        self._stalled = False
        self._concat_cache: Optional[tuple] = None  # (signature, stacked matrix)

        # admission telemetry (admission_summary)
        self._t0 = time.monotonic()
        self._depth_timeline: collections.deque = collections.deque(maxlen=4096)
        self._e2e_s: collections.deque = collections.deque(maxlen=200_000)
        self._completed = 0
        self._misses = 0
        self._flushes = 0
        self._cross_batches = 0
        self._stall_dumps = 0

        self._serve_thread = threading.Thread(
            target=self._serve_loop, name="im-serve", daemon=True)
        self._mut_thread = threading.Thread(
            target=self._mutate_loop, name="im-mutate", daemon=True)
        self._serve_thread.start()
        self._mut_thread.start()

    # -- admission ----------------------------------------------------------

    def submit(self, key: StoreKey, query, *,
               deadline_ms: Optional[float] = None) -> Future:
        """Queue a query; the future resolves to the ``QueryResult`` the sync
        engine would return. An unknown key is refused here (an evicted key
        is known: it is rebuilt when its bucket flushes)."""
        if key not in self.store:
            raise KeyError(f"store key not registered with this engine: {key}")
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        fut: Future = Future()
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncInfluenceEngine is closed")
            req = self._sched.make_request(
                key, query, fut, now, deadline_t=(now + dl / 1e3) if dl > 0 else None)
            self._outstanding += 1
            full = self._sched.offer(req)
            depth = self._sched.depth()
            self._record_depth(depth)
            # wake the serve thread only when it could act sooner than its
            # timeout: the bucket just filled, or the queue was empty
            if full or depth == 1:
                self._cv.notify_all()
        if self.evictor is not None:
            self.evictor.touch(key)
        return fut

    def register_async(self, g: Graph, config: Optional[DiFuserConfig] = None) -> Future:
        """Admit a graph: its build runs on the mutation thread (serving goes
        on) and the future resolves to its StoreKey."""
        def fn():
            entry = self.store.get_or_build(g, config)
            if self.evictor is not None:
                self.evictor.touch(entry.key)
            return entry.key
        return self._submit_mutation(_Mutation("build", g.content_key()[:12], fn, Future()))

    def apply_delta_async(self, key: StoreKey, delta: GraphDelta, **kwargs) -> Future:
        """Double-buffered delta repair: repair a shadow clone of the entry,
        then swap it in. The future resolves to the DeltaReport."""
        def fn():
            shadow = self.store.shadow(key)
            rep = apply_delta(shadow, key, delta, **kwargs)
            self._install(key, shadow.entry(key))
            return rep
        return self._submit_mutation(_Mutation("repair", key.graph_key[:12], fn, Future()))

    def rebuild_async(self, key: StoreKey, *, _on_done=None) -> Future:
        """Double-buffered pristine rebuild (shadow build, then swap)."""
        def fn():
            shadow = self.store.shadow(key)
            entry = shadow.rebuild(key)
            self._install(key, entry)
            return entry
        return self._submit_mutation(_Mutation("rebuild", key.graph_key[:12], fn, Future(),
                                               on_done=_on_done))

    def _install(self, key: StoreKey, entry: StoreEntry) -> None:
        """Swap a mutated entry in, its device work complete (the mutation
        stream synchronized; see the module docstring)."""
        self._settle()
        self._before_swap(key)
        self.store.swap_entry(key, entry)

    def _settle(self) -> None:
        if self._mut_stream is not None:
            self._mut_stream.synchronize()

    def _before_swap(self, key: StoreKey) -> None:
        """Test hook: runs on the mutation thread once the shadow is ready,
        just before the swap; tests override it to submit (and resolve)
        queries while the mutation is in flight."""

    # -- lifecycle ------------------------------------------------------------

    def drain(self, timeout_s: float = 300.0) -> None:
        """Block until every submitted future (queries and mutations) has
        resolved; raises ``TimeoutError`` after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"{self._outstanding} requests still outstanding")
                self._cv.wait(timeout=min(remaining, 0.05))

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop both threads; queued work is flushed on the way out."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._serve_thread.join(timeout=timeout_s)
        self._mut_thread.join(timeout=timeout_s)

    def __enter__(self) -> "AsyncInfluenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- serve thread -----------------------------------------------------------

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                batches = self._sched.take_due(time.monotonic())
                while not batches and not self._closed:
                    nxt = self._sched.next_flush_t()
                    now = time.monotonic()
                    self._cv.wait(timeout=None if nxt is None else max(nxt - now, 1e-4))
                    batches = self._sched.take_due(time.monotonic())
                if not batches and self._closed:
                    batches = self._sched.take_all()
                    if not batches and not self._mut_q:
                        return
                self._record_depth(self._sched.depth())
                stall_s = self._sched.oldest_wait_s(time.monotonic())
            self._check_stall(stall_s)
            if batches:
                self._execute_flush(batches)

    def _execute_flush(self, batches: list) -> None:
        runnable: list = []
        for bucket in batches:
            key, qclass = bucket[0].key, bucket[0].qclass
            try:
                entry = self.store.entry(key)  # an evicted entry is rebuilt here
            except Exception as e:  # noqa: BLE001 (fails this bucket's futures)
                self._fail_bucket(bucket, e)
                continue
            if self.evictor is not None:
                self.evictor.touch(key)
            if qclass == "TopKSeeds" and entry.stale and not self._closed:
                # a full rebuild must not block the serve thread: hand it to
                # the mutation thread and park the bucket until the swap
                self._rebuild_and_hold(key, bucket)
                continue
            runnable.append((entry, bucket))

        runnable = self._dispatch_cross_entry(runnable)
        for entry, bucket in runnable:
            try:
                self._run_bucket(entry, bucket)
            except Exception as e:  # noqa: BLE001 (fails this bucket's futures)
                self._fail_bucket(bucket, e)
        if self.evictor is not None:
            protect = {r.key for _, b in runnable for r in b}
            self._enforce_budget(protect)

    def _run_bucket(self, entry: StoreEntry, bucket: Sequence[AsyncRequest]) -> None:
        reqs = [Request(key=r.key, query=r.query) for r in bucket]
        results: list = [None] * len(bucket)
        for lo in range(0, len(bucket), self.engine.max_batch):
            idxs = list(range(lo, min(lo + self.engine.max_batch, len(bucket))))
            self.engine.execute_chunk(entry, reqs, idxs, results)
        now = time.monotonic()
        metrics.counter("async.flushes", query=bucket[0].qclass).inc()
        self._flushes += 1
        for r, res in zip(bucket, results):
            self._finish(r, res, now)
        self._done(len(bucket))

    def _rebuild_and_hold(self, key: StoreKey, bucket: Sequence[AsyncRequest]) -> None:
        with self._cv:
            self._sched.hold(key, "TopKSeeds")
            self._sched.requeue(bucket)
            already = key in self._rebuilding
            if not already:
                self._rebuilding.add(key)
        if already:
            return
        metrics.counter("async.stale_rebuilds").inc()

        def on_done():   # under the engine lock, when the mutation has ended
            self._rebuilding.discard(key)
            self._sched.release(key, "TopKSeeds")
        self.rebuild_async(key, _on_done=on_done)

    # -- cross-entry dispatch -----------------------------------------------------

    def _dispatch_cross_entry(self, runnable: list) -> list:
        """Answer SpreadEstimate buckets against different host-resident
        entries of one register geometry (same J, same estimator) in one
        stacked batch. Returns the buckets left for per-entry execution."""
        by_sig: dict = {}
        rest: list = []
        for entry, bucket in runnable:
            if bucket[0].qclass == "SpreadEstimate" and entry.residency == "host":
                sig = (int(entry.x.shape[0]), entry.cfg.estimator, entry.device)
                by_sig.setdefault(sig, []).append((entry, bucket))
            else:
                rest.append((entry, bucket))
        for groups in by_sig.values():
            if len(groups) < 2:       # one entry: the plain path is one batch too
                rest.extend(groups)
                continue
            try:
                self._run_cross_spread(groups)
            except Exception as e:  # noqa: BLE001 (fails these buckets' futures)
                for _, bucket in groups:
                    self._fail_bucket(bucket, e)
        return rest

    def _run_cross_spread(self, groups: list) -> None:
        total_regs = int(groups[0][0].x.shape[0])
        estimator = groups[0][0].cfg.estimator
        # a stable order, so the stacked matrix's cache key is deterministic
        groups = sorted(groups, key=lambda g: dataclasses.astuple(g[0].key))
        sig = tuple((dataclasses.astuple(e.key), e.version) for e, _ in groups)
        # one read of the cache: a budget pass on the mutation thread may drop it
        cache = self._concat_cache
        if cache is None or cache[0] != sig:
            self._concat_cache = cache = None    # free the old stack before the new one
            cache = (sig, torch.cat([e.matrix for e, _ in groups], dim=0))
            self._concat_cache = cache
        mat = cache[1]

        rows: list = []
        sentinels: list = []
        flat: list = []
        off = 0
        for entry, bucket in groups:
            sent = entry.graph.n_pad - 1 + off
            for r in bucket:
                rows.append(tuple(v + off for v in r.query.candidates))
                sentinels.append(sent)
                flat.append(r)
            off += int(entry.graph.n_pad)

        b = _pow2(len(rows))
        length = _pow2(max((len(c) for c in rows), default=1))
        # each row pads with its own entry's sentinel row (VISITED throughout
        # its block), so its merged registers are the single-entry batch's
        arr = np.empty((b, length), dtype=np.int64)
        for i in range(b):
            arr[i, :] = sentinels[i] if i < len(rows) else sentinels[0]
            if i < len(rows) and rows[i]:
                arr[i, : len(rows[i])] = rows[i]
        with trace.span("async.cross_spread", phase="query", timed=True,
                        batch=len(rows), entries=len(groups)) as sp:
            vals = _spread_batch(mat, torch.from_numpy(arr).to(mat.device),
                                 total_regs=total_regs, estimator=estimator).cpu().numpy()
        dt = sp.duration_s
        metrics.counter("engine.cross_entry_batches").inc()
        self._cross_batches += 1
        self.engine._account("SpreadEstimate", dt, len(flat))
        now = time.monotonic()
        for i, r in enumerate(flat):
            self._finish(r, QueryResult(r.query, float(vals[i]), dt, dt / len(flat),
                                        len(flat), backend="cross:host"), now)
        self._done(len(flat))

    # -- mutation thread ----------------------------------------------------------

    def _submit_mutation(self, mut: _Mutation) -> Future:
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncInfluenceEngine is closed")
            self._outstanding += 1
            self._mut_q.append(mut)
            self._cv.notify_all()
        return mut.future

    def _mutate_loop(self) -> None:
        while True:
            with self._cv:
                while not self._mut_q and not self._closed:
                    self._cv.wait()
                if not self._mut_q:
                    return
                mut = self._mut_q.popleft()
            try:
                with torch.cuda.stream(self._mut_stream), \
                        trace.span(f"async.{mut.kind}", phase="service", timed=True,
                                   key=mut.label):
                    try:
                        res = mut.fn()
                    finally:
                        self._settle()   # a failed mutation's reads end here too
                mut.future.set_result(res)
            except Exception as e:  # noqa: BLE001 (fails this mutation's future)
                metrics.counter("async.mutation_errors", kind=mut.kind).inc()
                mut.future.set_exception(e)
            if self.evictor is not None:
                self._enforce_budget(())
            with self._cv:
                if mut.on_done is not None:
                    try:
                        mut.on_done()
                    except Exception:  # noqa: BLE001 (an observer)
                        metrics.counter("async.observer_errors", what="on_done").inc()
                self._outstanding -= 1
                self._cv.notify_all()

    def held_bytes(self) -> int:
        """What the budget covers: the store's resident bytes and the
        cross-entry stack."""
        cache = self._concat_cache
        stack = cache[1].numel() * cache[1].element_size() if cache is not None else 0
        return self.store.resident_bytes() + stack

    def _enforce_budget(self, protect) -> None:
        """The evictor's budget pass. The cross-entry stack is a copy of
        resident rows: over the budget, it goes first (the next cross batch
        stacks again), then the evictor takes entries. Budget pressure must
        not fail serving, so an error here is counted, not raised (an
        eviction launches no kernel; a rebuild happens on a touch, where
        errors reach futures)."""
        if self.held_bytes() > self.evictor.budget_bytes:
            self._concat_cache = None
        try:
            self.evictor.enforce(self.store, protect=protect)
        except Exception:  # noqa: BLE001 (an observer)
            metrics.counter("async.observer_errors", what="evictor").inc()

    # -- accounting -----------------------------------------------------------------

    def _finish(self, req: AsyncRequest, result: QueryResult, now: float) -> None:
        e2e = now - req.enqueue_t
        self._e2e_s.append(e2e)
        self._completed += 1
        metrics.histogram("async.e2e_s", unit="s", query=req.qclass).observe(e2e)
        if req.deadline_t is not None and now > req.deadline_t:
            self._misses += 1
            metrics.counter("async.deadline_misses", query=req.qclass).inc()
        self._watchdog.observe("e2e", e2e)
        req.future.set_result(result)

    def _fail_bucket(self, bucket: Sequence[AsyncRequest], exc) -> None:
        for r in bucket:
            r.future.set_exception(exc)
        self._done(len(bucket))

    def _done(self, n: int) -> None:
        with self._cv:
            self._outstanding -= n
            self._cv.notify_all()

    def _record_depth(self, depth: int) -> None:
        metrics.gauge("async.queue_depth").set(float(depth))
        self._depth_timeline.append((time.monotonic() - self._t0, depth))

    def _check_stall(self, oldest_wait_s: float) -> None:
        """Rising-edge admission-stall detector: the oldest queued request
        waiting far past the deadline means flushes stopped keeping up; dump
        the flight ring once per episode."""
        thresh = max(10.0 * self.deadline_ms / 1e3, 1.0)
        if oldest_wait_s > thresh:
            if not self._stalled:
                self._stalled = True
                self._stall_dumps += 1
                metrics.counter("async.admission_stalls").inc()
                flight.dump(f"admission-stall-{oldest_wait_s * 1e3:.0f}ms")
        else:
            self._stalled = False

    @staticmethod
    def _on_e2e_breach(qclass, p99_ms, budget_ms, watchdog) -> None:
        flight.dump(f"async-e2e-p99-{p99_ms:.1f}ms-budget-{budget_ms:.1f}ms")

    def admission_summary(self) -> dict:
        """Queue, deadline and tenancy state: completions, deadline misses,
        end-to-end p50/p95/p99, flushes, cross-entry batches, stalls, the
        queue-depth timeline, resident bytes against the budget, the SLO."""
        e2e = np.asarray(self._e2e_s, dtype=np.float64)

        def pct(q):
            return float(np.percentile(e2e, q) * 1e3) if len(e2e) else 0.0

        return {
            "completed": self._completed,
            "deadline_ms": self.deadline_ms,
            "deadline_misses": self._misses,
            "deadline_miss_rate": self._misses / self._completed if self._completed else 0.0,
            "e2e_p50_ms": pct(50),
            "e2e_p95_ms": pct(95),
            "e2e_p99_ms": pct(99),
            "flushes": self._flushes,
            "cross_entry_batches": self._cross_batches,
            "admission_stalls": self._stall_dumps,
            "queue_depth_timeline": [(round(t, 4), d) for t, d in self._depth_timeline],
            "resident_bytes": self.store.resident_bytes(),
            "budget_bytes": self.evictor.budget_bytes if self.evictor is not None else None,
            "slo": self._watchdog.summary(),
        }
