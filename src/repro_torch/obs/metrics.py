"""Counters, gauges and streaming histograms behind a named registry.

The port's copy of the reference's ``obs/metrics.py``: the same classes,
the same geometric histogram grid and the same JSONL snapshot schema, so a
snapshot written by either package merges into the other's registry
(``MetricsRegistry.merge`` / ``from_jsonl``).

The numbers the serving story argues from land here, in one process-wide
:class:`MetricsRegistry`: bank build time and evictions from the store,
repair sweeps from delta repair, per-query-class latency from the engine,
queue depth and deadline misses from the async engine.

Histograms are streaming: geometric buckets (growth factor 1.04, about 2%
relative resolution) hold counts only, so p50/p95/p99 come out of a few
hundred integers whatever the sample count.

Standard library only, like :mod:`repro_torch.obs.trace`.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, Optional, Tuple

_GROWTH = 1.04               # bucket growth factor: <= ~2% relative error
_LOG_GROWTH = math.log(_GROWTH)
_V0 = 1e-9                   # smallest resolvable magnitude (1 ns in seconds)
#: Nudge on the (log-space) bucket index so a value sitting exactly on a
#: bucket boundary ``_V0 * G^i`` always lands in bucket ``i``. Without it,
#: ``log(v / _V0) / log(G)`` comes out as ``i - 1e-16`` for ~5% of indices
#: (libm rounding) and the value mis-buckets one slot low — the bucket-
#: alignment bug that made two processes disagree about the same observation
#: when their snapshots were merged.
_IDX_EPS = 1e-9


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        """Fold another process's count in (counts are additive)."""
        self.value += other.value

    def summary(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-written value (residency, imbalance, bytes...)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def merge(self, other: "Gauge") -> None:
        """Gauges are last-writer-wins: the merged-in snapshot is treated as
        newer (merge order is the caller's timeline)."""
        self.value = other.value

    def summary(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming distribution: p50/p95/p99 without storing samples.

    Values are assigned to geometric buckets ``[_V0 * G^i, _V0 * G^(i+1))``;
    a percentile query walks the cumulative counts and returns the matched
    bucket's geometric midpoint, so the answer is within one bucket width
    (~2% relative) of the exact order statistic. Non-positive values share
    one underflow bucket reported as 0.0.
    """

    __slots__ = ("buckets", "count", "total", "min", "max", "unit")
    kind = "histogram"

    def __init__(self, unit: str = ""):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.unit = unit

    @staticmethod
    def _index(v: float) -> int:
        if v <= _V0:
            return -1          # underflow bucket (zeros, negatives)
        # _IDX_EPS keeps exact bucket-boundary values in their own bucket
        # (int() truncation + libm rounding shifted them one slot low)
        return int(math.log(v / _V0) / _LOG_GROWTH + _IDX_EPS)

    @staticmethod
    def _midpoint(idx: int) -> float:
        if idx < 0:
            return 0.0
        return _V0 * math.exp((idx + 0.5) * _LOG_GROWTH)

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self._index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100])."""
        if self.count == 0:
            return 0.0
        # nearest-rank on the cumulative bucket counts; exact min/max at the
        # extremes so p0/p100 round-trip the observed range
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        rank = q / 100.0 * self.count
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                mid = self._midpoint(idx)
                return min(max(mid, self.min), self.max)
        return self.max  # pragma: no cover - rank <= count always hits

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in without sample loss: bucket counts are
        added index-by-index (both sides use the identical geometric grid,
        so no re-binning — and no resolution loss — ever happens), and
        count/sum/min/max combine exactly. Percentiles of the merged
        histogram match a single histogram that observed both streams."""
        for idx, cnt in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + cnt
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        if not self.unit:
            self.unit = other.unit

    def summary(self) -> dict:
        # "buckets" carries the raw geometric-grid counts (keys are bucket
        # indices as strings — JSON object keys), which is what makes a
        # JSONL snapshot mergeable without sample loss
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "buckets": {str(i): c for i, c in sorted(self.buckets.items())}}

    @classmethod
    def from_summary(cls, rec: dict) -> "Histogram":
        """Reconstruct from a :meth:`summary`-shaped dict (a ``load_jsonl``
        row). Rows written before bucket serialization existed degrade to a
        single bucket at the mean (count/sum stay exact)."""
        h = cls(unit=rec.get("unit", ""))
        h.count = int(rec.get("count", 0))
        h.total = float(rec.get("sum", 0.0))
        if h.count:
            h.min = float(rec.get("min", 0.0))
            h.max = float(rec.get("max", 0.0))
        buckets = rec.get("buckets")
        if buckets is None and h.count:
            buckets = {str(cls._index(h.total / h.count)): h.count}
        for idx, cnt in (buckets or {}).items():
            h.buckets[int(idx)] = int(cnt)
        return h


_MetricKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class MetricsRegistry:
    """Named, tag-aware metric store. ``counter``/``gauge``/``histogram``
    are get-or-create (same name+tags -> same instance), so call sites
    don't thread metric objects around."""

    def __init__(self):
        self._metrics: Dict[_MetricKey, object] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, tags: dict) -> _MetricKey:
        return name, tuple(sorted((str(k), str(v)) for k, v in tags.items()))

    def _get(self, cls, name: str, tags: dict, **kw):
        key = self._key(name, tags)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(**kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, *, unit: str = "", **tags) -> Histogram:
        return self._get(Histogram, name, tags, unit=unit)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- merge (multi-process aggregation) ---------------------------------

    def merge(self, rows) -> int:
        """Fold a snapshot into this registry: ``rows`` is either another
        :class:`MetricsRegistry` or an iterable of ``load_jsonl`` rows.
        Counters add, gauges take the merged-in value, histograms combine
        bucket-exact (no sample loss) — this is how per-process metrics from
        separate processes or runs aggregate into one view. Returns
        the number of series merged."""
        if isinstance(rows, MetricsRegistry):
            rows = rows.snapshot()
        n = 0
        for rec in rows:
            name, tags = rec["name"], rec.get("tags", {})
            kind = rec.get("kind", "counter")
            if kind == "counter":
                other = Counter()
                other.value = rec.get("value", 0)
                self.counter(name, **tags).merge(other)
            elif kind == "gauge":
                other = Gauge()
                other.value = float(rec.get("value", 0.0))
                self.gauge(name, **tags).merge(other)
            elif kind == "histogram":
                other = Histogram.from_summary(rec)
                self.histogram(name, unit=other.unit, **tags).merge(other)
            else:
                raise ValueError(f"unknown metric kind in snapshot: {kind!r}")
            n += 1
        return n

    @classmethod
    def from_jsonl(cls, *paths: str) -> "MetricsRegistry":
        """Build a registry by merging one or more JSONL snapshots (the
        per-process files the launchers write with ``--metrics``)."""
        reg = cls()
        for path in paths:
            reg.merge(load_jsonl(path))
        return reg

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Iterable[dict]:
        """One JSON-ready dict per metric: ``{"name", "kind", "tags",
        **summary}`` (histograms add ``unit`` and the percentile fields)."""
        with self._lock:
            items = list(self._metrics.items())
        out = []
        for (name, tags), m in sorted(items, key=lambda kv: kv[0]):
            rec = {"name": name, "kind": m.kind, "tags": dict(tags)}
            if isinstance(m, Histogram) and m.unit:
                rec["unit"] = m.unit
            rec.update(m.summary())
            out.append(rec)
        return out

    def write_jsonl(self, path: str) -> int:
        """Append-free JSONL snapshot (one metric per line); returns the
        metric count written. The schema is the reference's, which its
        ``benchmarks/trend.py`` diffs across runs."""
        snap = list(self.snapshot())
        with open(path, "w") as f:
            for rec in snap:
                f.write(json.dumps(rec) + "\n")
        return len(snap)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global default registry all repo call sites use."""
    return _REGISTRY


def counter(name: str, **tags) -> Counter:
    return _REGISTRY.counter(name, **tags)


def gauge(name: str, **tags) -> Gauge:
    return _REGISTRY.gauge(name, **tags)


def histogram(name: str, *, unit: str = "", **tags) -> Histogram:
    return _REGISTRY.histogram(name, unit=unit, **tags)


def load_jsonl(path: str) -> list:
    """Read a snapshot written by :meth:`MetricsRegistry.write_jsonl`."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
