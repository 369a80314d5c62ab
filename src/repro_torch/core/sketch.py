"""Flajolet-Martin sketch state and estimators (paper §2.3, §3.1).

State: one ``int8[n_pad, J]`` matrix. ``M[u, j]`` in [0, 32] is the max clz
over u's sampled-reachable set in simulation j; ``M[u, j] == VISITED (-1)``
marks u as activated by the committed seeds in simulation j. VISITED is the
bottom of the max-merge lattice and stays sticky.

``estimate_from_sums`` and ``count_visited`` repeat the reference package's
``core/sketch.py`` in float32 with the same order of operations.

The CUDA kernels move registers four at a time, so the drivers widen the
register axis of every matrix they hand to a kernel to ``padded_regs(J)``
columns, once per build or ring state, on every device. The padding columns
are VISITED and inert: the fill skips VISITED, propagate keeps it, the
cascade only sets it, and the cardinality statistics (sum and valid count)
and the ring's row sums of M skip it. Only the counts of VISITED registers
read them, and those read the first J columns (``count_visited``). x is
widened too; a padding register's x is never read by a sweep, since its
column is VISITED everywhere.
"""
from __future__ import annotations

import torch

VISITED = -1
PHI_FM = 0.77351                 # FM correction (paper eq. (6))
C_HARMONIC = 1.4426950408889634  # 1 / ln 2, full-stream harmonic estimator


def estimate_from_sums(sums: torch.Tensor, total_regs: int, *,
                       estimator: str = "hll") -> torch.Tensor:
    """Finish the per-row estimate from ``float32[2, n]`` statistics (sum
    statistic, valid count).

    ``hll`` reads the statistic as the sum of 2^-M, ``fm_mean`` as the sum
    of M. The single path's ``select.local_sums`` always passes the former,
    which ``fm_mean`` then reads as the latter, as the reference does there;
    the query path (``service.queries``) passes each its own statistic."""
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


#: the kernels' register counts are multiples of this (32-bit words of int8)
REG_ALIGN = 4


def padded_regs(num_regs: int) -> int:
    """The register count the kernels take for ``num_regs`` registers: the
    next multiple of ``REG_ALIGN``."""
    return -(-int(num_regs) // REG_ALIGN) * REG_ALIGN


def blank_matrix(n_rows: int, num_regs: int, device) -> torch.Tensor:
    """Zeros of ``padded_regs(num_regs)`` columns, the padding columns VISITED."""
    m = torch.zeros((n_rows, padded_regs(num_regs)), dtype=torch.int8, device=device)
    m[:, num_regs:] = VISITED
    return m


def pad_columns(m: torch.Tensor, num_regs: int) -> torch.Tensor:
    """A ``num_regs``-wide matrix widened to ``padded_regs(num_regs)`` with
    VISITED columns; ``m`` itself when no padding is needed."""
    width = padded_regs(num_regs)
    if m.shape[1] == width:
        return m
    if m.shape[1] != num_regs:
        raise ValueError(f"expected a matrix of {num_regs} registers, got {m.shape[1]}")
    out = torch.full((m.shape[0], width), VISITED, dtype=m.dtype, device=m.device)
    out[:, :num_regs] = m
    return out


def real_columns(m: torch.Tensor, num_regs: int) -> torch.Tensor:
    """The first ``num_regs`` registers of a padded matrix, contiguous."""
    return m if m.shape[1] == num_regs else m[:, :num_regs].contiguous()


def pad_x(x: torch.Tensor, num_regs: int) -> torch.Tensor:
    """``x`` (int32[num_regs]) widened to ``padded_regs(num_regs)`` with zeros."""
    width = padded_regs(num_regs)
    if x.shape[-1] == width:
        return x
    out = torch.zeros((*x.shape[:-1], width), dtype=x.dtype, device=x.device)
    out[..., :num_regs] = x
    return out


def count_visited(m: torch.Tensor, n_real: int, num_regs: int) -> torch.Tensor:
    """Number of (vertex, simulation) pairs activated (real rows, the first
    ``num_regs`` registers only).

    Counted one block of rows at a time: PyTorch reduces a bool tensor by
    first copying it to int64, 8 bytes per register, which for the whole
    matrix would be eight times the matrix itself."""
    rows = max(1, (1 << 23) // max(m.shape[1], 1))
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    for blk in m[:n_real, :num_regs].split(rows):
        total += (blk == VISITED).sum()
    return total
