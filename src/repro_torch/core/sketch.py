"""Flajolet-Martin sketch state and estimators (paper §2.3, §3.1).

State: one ``int8[n_pad, J]`` matrix. ``M[u, j]`` in [0, 32] is the max clz
over u's sampled-reachable set in simulation j; ``M[u, j] == VISITED (-1)``
marks u as activated by the committed seeds in simulation j. VISITED is the
bottom of the max-merge lattice and stays sticky.

``estimate_from_sums`` and ``count_visited`` repeat the reference package's
``core/sketch.py`` in float32 with the same order of operations.
"""
from __future__ import annotations

import torch

VISITED = -1
PHI_FM = 0.77351                 # FM correction (paper eq. (6))
C_HARMONIC = 1.4426950408889634  # 1 / ln 2, full-stream harmonic estimator


def estimate_from_sums(sums: torch.Tensor, total_regs: int, *,
                       estimator: str = "hll") -> torch.Tensor:
    """Finish the per-vertex estimate from ``float32[2, n_pad]`` statistics
    (sum statistic, valid count).

    The statistic is always the HLL sum of 2^-M (see ``select.local_sums``);
    ``fm_mean`` reads it as a sum of M, as the reference does."""
    f32 = dict(dtype=torch.float32, device=sums.device)
    stat, j_valid = sums[0], sums[1]
    frac_valid = j_valid / torch.tensor(float(total_regs), **f32)
    if estimator == "hll":
        est = torch.tensor(C_HARMONIC, **f32) * j_valid / torch.clamp_min(
            stat, torch.tensor(1e-30, **f32))
    elif estimator == "fm_mean":
        mean = stat / torch.clamp_min(j_valid, torch.tensor(1.0, **f32))
        est = torch.exp2(mean) / torch.tensor(PHI_FM, **f32)
    else:
        raise ValueError(f"unknown estimator: {estimator}")
    return torch.where(j_valid > 0, est * frac_valid, torch.zeros((), **f32))


def count_visited(m: torch.Tensor, n_real: int) -> torch.Tensor:
    """Number of (vertex, simulation) pairs activated (real rows only).

    Counted one block of rows at a time: PyTorch reduces a bool tensor by
    first copying it to int64, 8 bytes per register, which for the whole
    matrix would be eight times the matrix itself."""
    rows = max(1, (1 << 23) // max(m.shape[1], 1))
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    for blk in m[:n_real].split(rows):
        total += (blk == VISITED).sum()
    return total
