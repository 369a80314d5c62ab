"""Flajolet-Martin sketch state and estimators (paper §2.3, §3.1).

State: one ``int8[n_pad, J]`` matrix. ``M[u, j]`` in [0, 32] is the max clz
over u's sampled-reachable set in simulation j; ``M[u, j] == VISITED (-1)``
marks u as activated by the committed seeds in simulation j. VISITED is the
bottom of the max-merge lattice and stays sticky.

``estimate_cardinality``, ``partial_sums``, ``estimate_from_sums`` and
``count_visited`` repeat the reference package's ``core/sketch.py`` in
float32 with the same order of operations; ``fill_registers`` is its fill
through ``kernels.ops.sketch_fill`` (any row ids), ``merge`` its sketch
union, ``hll_alpha`` and ``exact_distinct_reference`` its host helpers.

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

import numpy as np
import torch

from repro_torch.core.sampling import clz32, register_hash

VISITED = -1
REG_DTYPE = torch.int8
PHI_FM = 0.77351                 # FM correction (paper eq. (6))
C_HARMONIC = 1.4426950408889634  # 1 / ln 2, full-stream harmonic estimator


def hll_alpha(j: int) -> float:
    """HyperLogLog's alpha_m, kept for tests of classic HLL behaviour (the
    estimators use ``C_HARMONIC``: every FM register sees every item)."""
    if j >= 128:
        return 0.7213 / (1.0 + 1.079 / j)
    if j >= 64:
        return 0.709
    if j >= 32:
        return 0.697
    return 0.673


def fill_registers(n_pad: int, num_regs: int, *, reg_offset: int = 0, seed: int = 0,
                   visited=None, ids=None, device=None) -> torch.Tensor:
    """FILL-SKETCHES (paper Alg. 1): ``int8[n_pad, num_regs]``, ``M[r, j] =
    clz(h_{reg_offset + j}(u))`` with u = r, or ``ids[r]`` where row ids
    (``n_pad`` of them) are given, through ``kernels.ops.sketch_fill`` on
    ``device`` (CUDA unless ``"cpu"`` is passed). ``visited``: an optional
    ``(n_pad, num_regs)`` bool mask whose entries stay VISITED (Alg. 1's
    early exit)."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    m = blank_matrix(n_pad, num_regs, dev)
    if visited is not None:
        m[:, :num_regs][torch.as_tensor(visited, dtype=torch.bool, device=dev)] = VISITED
    if ids is not None:
        ids = torch.as_tensor(ids, device=dev)
        if ids.dtype not in (torch.int32, torch.int64):
            ids = ids.to(torch.int64)
        ids = ids.contiguous()
    out = ops.sketch_fill(m, ids=ids, reg_offset=reg_offset, seed=seed)
    return real_columns(out, num_regs)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sketch union (paper eq. (5)) with sticky VISITED."""
    return torch.where(a == VISITED, a, torch.maximum(a, b))


def _stat(m: torch.Tensor, valid: torch.Tensor, estimator: str) -> torch.Tensor:
    """The per-row sum statistic: of 2^-M (``hll``) or of M (``fm_mean``)
    over the valid registers, float32."""
    mf = m.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    if estimator == "hll":
        return torch.where(valid, torch.exp2(-mf), zero).sum(dim=-1)
    if estimator == "fm_mean":
        return torch.where(valid, mf, zero).sum(dim=-1)
    raise ValueError(f"unknown estimator: {estimator}")


def estimate_cardinality(m: torch.Tensor, *, estimator: str = "hll") -> torch.Tensor:
    """``float32[n]``: each row's expected marginal influence from its
    registers (paper eqs. 6/7). VISITED registers add nothing; the estimate
    is scaled by the fraction of simulations where the vertex is still free.
    ``hll``: the harmonic mean; ``fm_mean``: ``2^mean / phi``."""
    f32 = dict(dtype=torch.float32, device=m.device)
    valid = m != VISITED
    j_valid = valid.sum(dim=-1).to(torch.float32)
    frac_valid = j_valid / torch.tensor(float(m.shape[-1]), **f32)
    stat = _stat(m, valid, estimator)
    if estimator == "hll":
        est = torch.tensor(C_HARMONIC, **f32) * j_valid / torch.clamp_min(
            stat, torch.tensor(1e-30, **f32))
    else:
        mean = stat / torch.clamp_min(j_valid, torch.tensor(1.0, **f32))
        est = torch.exp2(mean) / torch.tensor(PHI_FM, **f32)
    return torch.where(j_valid > 0, est * frac_valid, torch.zeros((), **f32))


def partial_sums(m: torch.Tensor, *, estimator: str = "hll") -> torch.Tensor:
    """``float32[2, n]``: each row's (sum statistic, valid count), the
    additive statistics shards sum before ``estimate_from_sums``."""
    valid = m != VISITED
    return torch.stack([_stat(m, valid, estimator), valid.sum(dim=-1).to(torch.float32)])


def exact_distinct_reference(items: np.ndarray, num_regs: int, seed: int = 0) -> float:
    """Host FM estimate of ``|set(items)|`` from ``num_regs`` registers (the
    estimator-accuracy tests' reference)."""
    u = np.asarray(items, dtype=np.uint32)[:, None]
    j = np.arange(num_regs, dtype=np.uint32)[None, :]
    regs = clz32(register_hash(u, j, seed=seed)).max(axis=0)
    denom = np.sum(np.exp2(-regs.astype(np.float64)))
    return float(C_HARMONIC * num_regs / denom)


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
    m = torch.zeros((n_rows, padded_regs(num_regs)), dtype=REG_DTYPE, device=device)
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
