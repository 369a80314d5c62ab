"""Measured per-shard profiles of the serial ring: the planner's reality check.

Counterpart of the reference's ``obs/shardprof.py``. The partition planner
predicts at plan time how the work spreads over the ``(mu_v, mu_s)`` shard
grid (``PlanStats`` in ``partition.cost``); the busiest shard bounds every
sweep, so DiFuseR's scaling claim rests on that prediction. This module
keeps what happened instead: per shard and ring step, the seconds and the
bucket bytes of a build's or a fixpoint's merges, folded into a
``MeasuredProfile`` comparable with the predicted stats.

The serial ring (``partition/serial.py``) runs shard by shard, so each
``(shard, ring step)`` bucket merge is timed on its own
(``per_step_timed=True``): on the card by a pair of CUDA events around the
merge's launch, read after the sweep's flag sync; on the CPU by the host
clock. The mesh (``core/distributed.py``) runs its shards at once, one per
rank, so its profile holds each bucket's bytes (``add_partition_bytes``,
off the partition's counts) and the wall time alone
(``per_step_timed=False``), as the reference's does.

``publish`` keeps a profile in a bounded process ring (``profiles``) and,
where the plan carries predicted stats, sets the
``partition.predicted_vs_measured_edge_imb`` and ``_bucket_imb`` gauges:
measured over predicted imbalance, tagged by strategy and backend. A ratio
well above 1.0 is a misprediction, visible as soon as the plan runs.

numpy only; no torch at import, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from time import perf_counter
from typing import Optional

import numpy as np

from repro_torch.obs import metrics

#: Bytes a bucket edge costs per sweep: 20 B of operands (h, w, r, t, l,
#: 4 B each) plus one int8 register read and one int8 write per register.
_EDGE_OPERAND_BYTES = 20


def bucket_bytes(edge_count: int, j_loc: int) -> int:
    """Bytes one bucket of ``edge_count`` real edges moves in one sweep."""
    return int(edge_count) * (_EDGE_OPERAND_BYTES + 2 * int(j_loc))


def _imbalance(loads: np.ndarray) -> float:
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    mean = loads.mean() if loads.size else 0.0
    return float(loads.max(initial=0.0) / mean) if mean > 0 else 1.0


@dataclasses.dataclass
class MeasuredProfile:
    """What one build or fixpoint cost, per shard and ring step.

    ``step_seconds[v, k]`` and ``step_bytes[v, k]`` sum vertex shard ``v``'s
    ring-step-``k`` merges over all sim shards and all sweeps.
    ``per_step_timed`` is False when no merge was timed (bytes alone).
    """

    backend: str                   # "serial" | ...
    phase: str                     # "build" | "fixpoint" | ...
    strategy: str
    mu_v: int
    mu_s: int
    sweeps: int
    step_seconds: np.ndarray       # float64[mu_v, mu_v]
    step_bytes: np.ndarray         # int64[mu_v, mu_v]
    wall_s: float
    per_step_timed: bool

    def shard_seconds(self) -> np.ndarray:
        return self.step_seconds.sum(axis=1)

    def shard_bytes(self) -> np.ndarray:
        return self.step_bytes.sum(axis=1)

    def time_imbalance(self) -> float:
        """max/mean of the per-shard seconds (1.0 = even); the bytes
        imbalance when the steps were not timed."""
        if not self.per_step_timed:
            return self.bytes_imbalance()
        return _imbalance(self.shard_seconds())

    def bytes_imbalance(self) -> float:
        """max/mean of the per-shard bucket bytes: the measured twin of the
        planner's predicted edge imbalance."""
        return _imbalance(self.shard_bytes())

    def step_imbalance(self) -> float:
        """max/mean over the (shard, ring step) grid: the measured twin of
        the predicted bucket imbalance."""
        grid = self.step_seconds if self.per_step_timed else self.step_bytes
        return _imbalance(grid)

    def achieved_gbps(self) -> float:
        """Bucket bytes over wall seconds (compare ``utils.roofline.HBM_BW``)."""
        total = float(self.step_bytes.sum())
        return total / self.wall_s / 1e9 if self.wall_s > 0 else 0.0

    def skew_table(self) -> str:
        """Per-shard seconds, bytes and load relative to the mean."""
        secs, byts = self.shard_seconds(), self.shard_bytes()
        mean_b = byts.mean() if byts.size else 0.0
        lines = [f"[{self.backend}:{self.strategy}] {self.phase} "
                 f"mu_v={self.mu_v} mu_s={self.mu_s} sweeps={self.sweeps} "
                 f"wall={self.wall_s:.3f}s "
                 f"time_imb={self.time_imbalance():.2f} "
                 f"bytes_imb={self.bytes_imbalance():.2f}",
                 "shard      seconds         bytes   rel_load"]
        for v in range(self.mu_v):
            rel = byts[v] / mean_b if mean_b > 0 else 1.0
            sec = f"{secs[v]:.4f}" if self.per_step_timed else "   n/a"
            lines.append(f"{v:5d}  {sec:>10s}  {int(byts[v]):12d}   {rel:7.2f}x")
        return "\n".join(lines)

    def summary(self) -> dict:
        """A JSON-ready summary."""
        return {
            "backend": self.backend, "phase": self.phase,
            "strategy": self.strategy, "mu_v": self.mu_v, "mu_s": self.mu_s,
            "sweeps": self.sweeps, "wall_s": self.wall_s,
            "per_step_timed": self.per_step_timed,
            "time_imbalance": self.time_imbalance(),
            "bytes_imbalance": self.bytes_imbalance(),
            "step_imbalance": self.step_imbalance(),
            "achieved_gbps": self.achieved_gbps(),
            "shard_seconds": [float(s) for s in self.shard_seconds()],
            "shard_bytes": [int(b) for b in self.shard_bytes()],
        }


class ShardProfiler:
    """Sums the per-(shard, ring step) measurements of one build or
    fixpoint; the serial ring calls ``record`` for every timed merge and
    ``count_sweep`` after each sweep, the mesh ``add_partition_bytes`` once."""

    def __init__(self, mu_v: int, mu_s: int, *, backend: str, phase: str,
                 strategy: str = "block"):
        self.mu_v, self.mu_s = mu_v, mu_s
        self.backend, self.phase, self.strategy = backend, phase, strategy
        self.step_seconds = np.zeros((mu_v, mu_v), dtype=np.float64)
        self.step_bytes = np.zeros((mu_v, mu_v), dtype=np.int64)
        self.sweeps = 0
        self.per_step_timed = False
        self._t0 = perf_counter()

    def record(self, v: int, kk: int, seconds: float, nbytes: int) -> None:
        """One measured merge of shard ``v`` at ring step ``kk``."""
        self.step_seconds[v, kk] += seconds
        self.step_bytes[v, kk] += nbytes
        self.per_step_timed = True

    def count_sweep(self) -> None:
        self.sweeps += 1

    def add_partition_bytes(self, counts: np.ndarray, j_loc: int, sweeps: int) -> None:
        """Fold the buckets' real-edge ``counts`` (``int64[mu_v, mu_s, mu_v]``,
        a partition's ``p_counts``) in as bytes, times the sweeps the
        fixpoint ran; no time is recorded."""
        per_edge = _EDGE_OPERAND_BYTES + 2 * int(j_loc)
        self.step_bytes += counts.sum(axis=1).astype(np.int64) * per_edge * max(sweeps, 1)
        self.sweeps += sweeps

    def finish(self, wall_s: Optional[float] = None) -> MeasuredProfile:
        return MeasuredProfile(
            backend=self.backend, phase=self.phase, strategy=self.strategy,
            mu_v=self.mu_v, mu_s=self.mu_s, sweeps=self.sweeps,
            step_seconds=self.step_seconds, step_bytes=self.step_bytes,
            wall_s=wall_s if wall_s is not None else perf_counter() - self._t0,
            per_step_timed=self.per_step_timed)


# process-level publication: a bounded ring and the predicted-vs-measured gauges

_PROFILES: deque = deque(maxlen=64)
_LOCK = threading.Lock()
_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Turn profile capture on or off (on by default: on the card a timed
    merge costs two CUDA event records, read after the sweep's sync)."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def profiles() -> list:
    """Recent ``MeasuredProfile``\\ s, oldest first (bounded ring)."""
    with _LOCK:
        return list(_PROFILES)


def last_profile() -> Optional[MeasuredProfile]:
    with _LOCK:
        return _PROFILES[-1] if _PROFILES else None


def clear() -> None:
    with _LOCK:
        _PROFILES.clear()


def publish(profile: MeasuredProfile, predicted=None) -> MeasuredProfile:
    """Keep a finished profile in the ring and set its gauges, tagged
    ``strategy=… backend=…``:

      * ``partition.measured_edge_imb``, ``partition.measured_time_imb`` and
        ``partition.achieved_gbps``: the profile's own numbers;
      * with the plan's predicted ``PlanStats``:
        ``partition.predicted_vs_measured_edge_imb`` (measured bytes
        imbalance over predicted edge imbalance; 1.0 = the cost model was
        right about shard skew) and
        ``partition.predicted_vs_measured_bucket_imb`` (measured (shard,
        step) imbalance over predicted bucket imbalance)."""
    if not _ENABLED:
        return profile
    with _LOCK:
        _PROFILES.append(profile)
    tags = {"strategy": profile.strategy, "backend": profile.backend}
    metrics.gauge("partition.measured_edge_imb", **tags).set(profile.bytes_imbalance())
    metrics.gauge("partition.measured_time_imb", **tags).set(profile.time_imbalance())
    metrics.gauge("partition.achieved_gbps", **tags).set(profile.achieved_gbps())
    if predicted is not None:
        if predicted.edge_imbalance > 0:
            metrics.gauge("partition.predicted_vs_measured_edge_imb", **tags).set(
                profile.bytes_imbalance() / predicted.edge_imbalance)
        if predicted.bucket_imbalance > 0:
            metrics.gauge("partition.predicted_vs_measured_bucket_imb", **tags).set(
                profile.step_imbalance() / predicted.bucket_imbalance)
    return profile


def profile_for_partition(part, *, backend: str, phase: str) -> ShardProfiler:
    """A profiler shaped for a built ``Partition2D`` (its plan's strategy,
    ``block`` without a plan)."""
    strategy = part.plan.strategy if part.plan is not None else "block"
    return ShardProfiler(part.mu_v, part.mu_s, backend=backend, phase=phase,
                         strategy=strategy)
