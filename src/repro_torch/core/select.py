"""Seed selection (paper Alg. 4 lines 8-14).

Counterpart of the reference's ``core/select.py`` ``local_sums``,
``finish_select`` and ``topk_candidates``: per-row statistics from the
cardinality kernel, the float32 estimate, padding rows masked to -1, and the
argmax, which returns the first index of the maximum on the CPU and on CUDA
alike; or the top C, ties in index order as ``jax.lax.top_k`` gives them.
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch
from repro_torch.kernels import ops


def local_sums(m: torch.Tensor) -> torch.Tensor:
    """``float32[2, n_pad]``: (sum of 2^-M over valid registers, valid count)."""
    return ops.cardinality_stats(m)


def finish_select(sums: torch.Tensor, total_regs: int, n_real: int, *,
                  estimator: str = "hll"):
    """Returns (seed vertex, its estimated marginal gain) as 0-dim tensors."""
    est = sketch.estimate_from_sums(sums, total_regs, estimator=estimator)
    valid_row = torch.arange(est.shape[0], device=est.device) < n_real
    est = torch.where(valid_row, est, torch.full_like(est, -1.0))
    s = torch.argmax(est)
    return s, est[s]


def topk_candidates(sums: torch.Tensor, total_regs: int, n_real: int, c: int, *,
                    estimator: str = "hll"):
    """A shard's top-C pre-filter (the compressed selection of paper §6):
    ``(vertex ids int32[c], estimates float32[c])``, best first, equal
    estimates in index order (a stable descending sort: ``torch.topk``
    promises no order among ties)."""
    est = sketch.estimate_from_sums(sums, total_regs, estimator=estimator)
    valid_row = torch.arange(est.shape[0], device=est.device) < n_real
    est = torch.where(valid_row, est, torch.full_like(est, -1.0))
    vals, idx = torch.sort(est, descending=True, stable=True)
    return idx[:c].to(torch.int32), vals[:c]
