"""Partition cost model: the numbers a planner is judged by.

Counterpart of the reference's ``partition/cost.py`` (without its metrics
gauges): edge imbalance (max/mean of per-shard sampled edges, the straggler
bound), bucket imbalance (max/mean of per-(write shard, ring step) bucket
loads) and pad waste (dead padded slots over all slots). ``predicted_stats``
runs at plan time from the relabeling alone; ``measure_partition`` reads the
same numbers off a built ``Partition2D``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Cost-model summary for one partition (predicted or measured)."""

    source: str                  # "predicted" | "measured"
    strategy: str
    mu_v: int
    mu_s: int
    edges_per_shard: np.ndarray  # int64[mu_v] sampled edges written per vertex shard
    edge_imbalance: float        # max/mean of per-device edge counts
    bucket_imbalance: float      # max/mean of per-(shard, step) bucket loads
    pad_waste_frac: float        # dead padded slots / total padded slots
    ring_bytes_per_sweep: int    # int8 register-block ring traffic per device

    def describe(self) -> str:
        return (f"[{self.source}:{self.strategy}] "
                f"edge_imb={self.edge_imbalance:.2f} "
                f"bucket_imb={self.bucket_imbalance:.2f} "
                f"pad_waste={self.pad_waste_frac * 100:.1f}% "
                f"ring_B={self.ring_bytes_per_sweep}")


def _imbalance(loads: np.ndarray) -> float:
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    mean = loads.mean() if loads.size else 0.0
    return float(loads.max(initial=0.0) / mean) if mean > 0 else 1.0


def predicted_stats(g, strategy: str, perm: np.ndarray, c_e: np.ndarray,
                    mu_v: int, mu_s: int, n_loc: int, j_loc: int) -> PlanStats:
    """Plan-time stats from the relabeling permutation and per-edge sample
    multiplicities (edge e counted once per sim shard sampling it)."""
    src = g.src[: g.m_real].astype(np.int64)
    dst = g.dst[: g.m_real].astype(np.int64)
    own_src = perm[src].astype(np.int64) // n_loc
    own_dst = perm[dst].astype(np.int64) // n_loc
    edges = np.bincount(own_src, weights=c_e, minlength=mu_v).astype(np.int64)
    kp = (own_dst - own_src) % mu_v
    kc = (own_src - own_dst) % mu_v
    bp = np.bincount(own_src * mu_v + kp, weights=c_e, minlength=mu_v * mu_v)
    bc = np.bincount(own_dst * mu_v + kc, weights=c_e, minlength=mu_v * mu_v)
    return PlanStats(
        source="predicted", strategy=strategy, mu_v=mu_v, mu_s=mu_s,
        edges_per_shard=edges, edge_imbalance=_imbalance(edges),
        bucket_imbalance=_imbalance(np.concatenate([bp, bc])),
        pad_waste_frac=0.0,
        ring_bytes_per_sweep=(mu_v - 1) * n_loc * j_loc)


def measure_partition(part) -> PlanStats:
    """Measured stats off a built ``partition.builder.Partition2D``."""
    counts_p = part.p_counts.astype(np.int64)   # (mu_v, mu_s, mu_v)
    counts_c = part.c_counts.astype(np.int64)
    real = int(counts_p.sum() + counts_c.sum())
    padded = sum(step.numel() for arrs in (part.p_h, part.c_h) for step in arrs)
    strategy = part.plan.strategy if part.plan is not None else "block"
    return PlanStats(
        source="measured", strategy=strategy, mu_v=part.mu_v, mu_s=part.mu_s,
        edges_per_shard=counts_p.sum(axis=(1, 2)),
        edge_imbalance=_imbalance(part.edge_counts),
        bucket_imbalance=_imbalance(
            np.concatenate([counts_p.reshape(-1), counts_c.reshape(-1)])),
        pad_waste_frac=float(1.0 - real / padded) if padded else 0.0,
        ring_bytes_per_sweep=part.comm_bytes_per_sweep)
