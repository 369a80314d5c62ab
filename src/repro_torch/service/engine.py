"""Batched influence query engine, synchronous.

Counterpart of the reference's ``service/engine.py``. A stream of mixed
queries is grouped by (store key, query class), cut into chunks of at most
``max_batch`` requests, padded (the batch size and the candidate-set length
rounded up to powers of two, as the reference pads for its compiler; the
padding rows are the sentinel's, which change no result), run, and
scattered back to per-request results with the batch's latency.

``TopKSeeds`` requests are deduplicated: identical (store key, k) requests
of a chunk share one run, and results are memoized against the entry's
``(version, stale)`` token, which every delta and rebuild moves, so repeated
top-k traffic against an unchanged index is a dictionary hit; a swap of the
entry (``SketchStore.swap_entry``) drops the key's memos at once.

A batch against a device-resident entry (``StoreEntry.place_on_mesh``)
runs as one operation of its serving mesh, shard-locally, and is recorded
with ``backend="mesh:device"``; its answers are the host lowering's.

Every batch runs in a timed span (``engine.*_batch``, the ``query`` lane)
and lands in the ``engine.*`` metrics; with latency budgets configured
(``slo``, or ``RunSpec.slo``) an SLO watchdog reads each batch's latency
and dumps the flight ring on a breach, as an exception during ``run`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.graphs.structs import Graph
from repro_torch.obs import flight, metrics, trace
from repro_torch.obs.slo import SLOConfig, SLOWatchdog
from repro_torch.service import queries as Q
from repro_torch.service.store import SketchStore, StoreEntry, StoreKey


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class Request:
    """One query bound to a store key."""

    key: StoreKey
    query: Q.Query


@dataclasses.dataclass
class QueryResult:
    """Per-request result with serving metadata.

    value: float (SpreadEstimate, MarginalGain), ``{"est", "max_register"}``
           arrays (CoverageProbe) or an InfluenceResult (TopKSeeds).
    latency_s: wall time of the batch this request rode in, device work
           included.
    amortized_s: latency_s / batch_size.
    batch_size: real requests in the executed batch.
    backend: ``"single:host"`` (a reduction over the canonical matrix),
           ``"mesh:device"`` (shard-local reductions on the placed blocks of
           a device entry) or ``"memo"`` (a top-k memo hit, nothing executed).
    cache_hit: the result came from the top-k memo.
    deduped: this request shared an identical request's run in its batch.
    """

    query: Q.Query
    value: object
    latency_s: float
    amortized_s: float
    batch_size: int
    backend: str = "single:host"
    cache_hit: bool = False
    deduped: bool = False


class InfluenceEngine:
    """Runs a stream of mixed queries in padded batches against ``store``'s
    entries.

    Without ``store`` the engine makes its own from ``backend``, ``spec``
    and ``device`` (CUDA unless ``device="cpu"``); with one, those belong to
    the store and passing them raises. ``slo``: per-class p99 budgets in ms (an
    ``SLOConfig``, a mapping or ``(class, ms)`` pairs), else ``spec.slo``."""

    def __init__(self, store: Optional[SketchStore] = None, max_batch: int = 256, *,
                 backend=None, spec=None, slo=None, device=None):
        # an empty store is falsy (len 0): compare with None
        if store is None:
            store = SketchStore(backend=backend, spec=spec, device=device)
        elif backend is not None or spec is not None or device is not None:
            raise ValueError("pass backend, spec and device to the SketchStore itself "
                             "when sharing an explicit store")
        self.store = store
        self.max_batch = max_batch
        self._pending: list = []
        # (store key, k) -> ((version, stale), InfluenceResult): a delta
        # overwrites the value instead of stranding old versions
        self._topk_memo: dict = {}
        if slo is None and spec is not None:
            slo = spec.slo
        cfg = SLOConfig.coerce(slo)
        self.slo = (SLOWatchdog(cfg, on_breach=self._on_slo_breach) if cfg is not None
                    else None)
        self.store.add_swap_hook(self._on_store_swap)

    def _on_store_swap(self, key, old, new) -> None:
        """A swap retires the key's memoized top-k results at once (the
        version token would reject them anyway). Runs on the mutating
        thread: ``list`` copies the keys in one step under the GIL."""
        for mk in list(self._topk_memo):
            if mk[0] == key:
                self._topk_memo.pop(mk, None)

    @staticmethod
    def _on_slo_breach(qclass, p99_ms, budget_ms, watchdog) -> None:
        flight.dump(f"slo-breach-{qclass}-p99-{p99_ms:.1f}ms-budget-{budget_ms:.1f}ms")

    def slo_summary(self) -> dict:
        """Per-class SLO state; empty without budgets."""
        return self.slo.summary() if self.slo is not None else {}

    # -- admission ----------------------------------------------------------

    def register(self, g: Graph, config: Optional[DiFuserConfig] = None) -> StoreKey:
        """Build the store's entry for a graph (the one cold build) and
        return its key."""
        return self.store.get_or_build(g, config).key

    def submit(self, key: StoreKey, query: Q.Query) -> int:
        """Queue a query; returns its index in the next ``run``. An unknown
        key is refused here, before it could fail a whole ``run``."""
        if key not in self.store:
            raise KeyError(f"store key not registered with this engine: {key}")
        self._pending.append(Request(key=key, query=query))
        return len(self._pending) - 1

    def clear_topk_memo(self) -> None:
        """Drop every memoized top-k result (they run again on demand)."""
        self._topk_memo.clear()

    # -- execution ----------------------------------------------------------

    def run(self, requests: Optional[Sequence[Request]] = None) -> list:
        """Run the queued (or the given) requests; results in request order."""
        if requests is None:
            requests, self._pending = self._pending, []
        else:
            for req in requests:
                if req.key not in self.store:
                    raise KeyError(f"store key not registered with this engine: {req.key}")
        results: list = [None] * len(requests)
        groups: dict = {}
        for i, req in enumerate(requests):
            groups.setdefault((req.key, type(req.query).__name__), []).append(i)
        try:
            for (key, _), idxs in groups.items():
                entry = self.store.entry(key)
                for lo in range(0, len(idxs), self.max_batch):
                    self.execute_chunk(entry, requests, idxs[lo: lo + self.max_batch],
                                       results)
        except Exception as e:
            # the flight ring holds the spans that led up to the fault; the
            # dump never raises, and the fault propagates
            metrics.counter("engine.exceptions", error=type(e).__name__).inc()
            flight.dump(f"engine-exception-{type(e).__name__}")
            raise
        return results

    def __call__(self, key: StoreKey, query: Q.Query) -> QueryResult:
        """One query, a batch of one."""
        return self.run([Request(key=key, query=query)])[0]

    def execute_chunk(self, entry: StoreEntry, requests: Sequence[Request],
                      chunk: Sequence[int], results: list) -> None:
        """Run one chunk of requests of one class against ``entry``, writing
        their ``QueryResult``s into ``results`` at the chunk's indices. The
        async engine's unit of work: it takes the entry, not the key, so a
        batch finishes against the version it started with even if a swap
        lands meanwhile."""
        qname = type(requests[chunk[0]].query).__name__
        run = {"TopKSeeds": self._run_topk, "SpreadEstimate": self._run_spread,
               "MarginalGain": self._run_marginal,
               "CoverageProbe": self._run_probe}.get(qname)
        if run is None:
            raise TypeError(f"unknown query type: {qname}")
        run(entry, requests, chunk, results)

    # -- per-class executors --------------------------------------------------

    def _account(self, qclass: str, dt: float, batch: int) -> None:
        """Per-class serving metrics (requests, batch latency, amortized
        cost) and the SLO watchdog's window."""
        metrics.counter("engine.requests", query=qclass).inc(batch)
        metrics.histogram("engine.batch_latency_s", unit="s", query=qclass).observe(dt)
        metrics.histogram("engine.amortized_s", unit="s",
                          query=qclass).observe(dt / max(batch, 1))
        if self.slo is not None:
            self.slo.observe(qclass, dt)

    @staticmethod
    def _pad_sets(sets: list) -> list:
        """Pad the batch to a power of two with empty (sentinel-only) sets."""
        return sets + [()] * (_pow2(len(sets)) - len(sets))

    def _scatter(self, qclass, entry, requests, chunk, results, values, dt) -> None:
        self._account(qclass, dt, len(chunk))
        for j, i in enumerate(chunk):
            results[i] = QueryResult(requests[i].query, values[j], dt, dt / len(chunk),
                                     len(chunk), backend=entry.serving_backend)

    def _run_spread(self, entry, requests, chunk, results):
        sets = self._pad_sets([requests[i].query.candidates for i in chunk])
        length = _pow2(max((len(s) for s in sets), default=1))
        # the lowerings return numpy, so the span's clock covers the device
        with trace.span("engine.spread_batch", phase="query", timed=True,
                        batch=len(chunk)) as sp:
            est = Q.spread_estimates(entry, sets, length)
        self._scatter("SpreadEstimate", entry, requests, chunk, results,
                      [float(v) for v in est], sp.duration_s)

    def _run_marginal(self, entry, requests, chunk, results):
        sentinel = entry.graph.n_pad - 1
        cands = [requests[i].query.candidate for i in chunk]
        comm = self._pad_sets([requests[i].query.committed for i in chunk])
        length = _pow2(max((len(s) for s in comm), default=1))
        cands = cands + [sentinel] * (len(comm) - len(chunk))
        with trace.span("engine.marginal_batch", phase="query", timed=True,
                        batch=len(chunk)) as sp:
            gains = Q.marginal_gains(entry, cands, comm, length)
        self._scatter("MarginalGain", entry, requests, chunk, results,
                      [float(v) for v in gains], sp.duration_s)

    def _run_probe(self, entry, requests, chunk, results):
        sentinel = entry.graph.n_pad - 1
        flat: list = []
        spans = []
        for i in chunk:
            vs = requests[i].query.vertices
            spans.append((len(flat), len(vs)))
            flat.extend(vs)
        flat = flat + [sentinel] * (_pow2(max(len(flat), 1)) - len(flat))
        with trace.span("engine.probe_batch", phase="query", timed=True,
                        batch=len(chunk)) as sp:
            est, max_reg = Q.coverage_probes(entry, flat)
        values = [{"est": est[off: off + ln].copy(),
                   "max_register": max_reg[off: off + ln].copy()} for off, ln in spans]
        self._scatter("CoverageProbe", entry, requests, chunk, results, values,
                      sp.duration_s)

    def _run_topk(self, entry, requests, chunk, results):
        by_k: dict = {}
        for i in chunk:
            by_k.setdefault(requests[i].query.k, []).append(i)
        for k, idxs in by_k.items():
            memo_key = (entry.key, k)
            cached = self._topk_memo.get(memo_key)
            if cached is not None and cached[0] == (entry.version, entry.stale):
                metrics.counter("engine.topk_memo_hits").inc(len(idxs))
                for i in idxs:
                    results[i] = QueryResult(requests[i].query, cached[1], 0.0, 0.0,
                                             len(idxs), backend="memo", cache_hit=True)
                continue
            metrics.counter("engine.topk_memo_misses").inc()
            with trace.span("engine.topk_batch", phase="query", timed=True, k=k,
                            batch=len(idxs)) as sp:
                res = Q.top_k_seeds(self.store, entry, k)
            dt = sp.duration_s
            self._account("TopKSeeds", dt, len(idxs))
            # a stale entry was rebuilt in place: memoize under the executed
            # entry's new token, not a fresh lookup's (a swap to N+1 meanwhile
            # must not file version N's result under N+1)
            self._topk_memo[memo_key] = ((entry.version, entry.stale), res)
            for j, i in enumerate(idxs):
                results[i] = QueryResult(requests[i].query, res, dt, dt / len(idxs),
                                         len(idxs), backend=entry.serving_backend,
                                         deduped=j > 0)


def summarize_latencies(results: Sequence[QueryResult]) -> dict:
    """p50/p99 of the per-request latency, the amortized cost, and the
    requests each serving path answered (``by_backend``)."""
    lat = np.asarray([r.latency_s for r in results], dtype=np.float64)
    amort = np.asarray([r.amortized_s for r in results], dtype=np.float64)
    total = float(amort.sum())
    by_backend: dict = {}
    for r in results:
        by_backend[r.backend] = by_backend.get(r.backend, 0) + 1
    return {
        "num_queries": len(results),
        "total_s": total,
        "qps": len(results) / total if total > 0 else 0.0,
        "p50_ms": float(np.percentile(lat, 50) * 1e3) if len(results) else 0.0,
        "p99_ms": float(np.percentile(lat, 99) * 1e3) if len(results) else 0.0,
        "amortized_ms": total / len(results) * 1e3 if len(results) else 0.0,
        "cache_hits": sum(1 for r in results if r.cache_hit),
        "deduped": sum(1 for r in results if r.deduped),
        "by_backend": by_backend,
    }
