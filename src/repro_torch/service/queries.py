"""Influence queries and their lowerings to register reductions.

Counterpart of the reference's ``service/queries.py``, host residency only.
Every query but ``TopKSeeds`` is a reduction over the store's propagated
matrix, with the statistics of the reference's ``sketch.partial_sums`` and
the float32 finish of ``sketch.estimate_from_sums`` (paper eqs. 6-7):

* ``SpreadEstimate(S)``: the max-merge of S's rows (eq. 5), then the
  estimate: the expected spread of S;
* ``MarginalGain(c, S)``: spread(S + {c}) - spread(S);
* ``CoverageProbe(V)``: each probed vertex's singleton estimate and its
  largest register;
* ``TopKSeeds(k)``: Alg. 4's K rounds warm-started from the cached matrix
  (fill and propagate skipped). A stale entry (removals since its build) is
  rebuilt first and the fresh matrix kept in the store.

The statistic of a merged row is, for ``hll``, the sum of 2^-M over its
valid (not VISITED) registers, from the cardinality kernel
(``kernels.ops.cardinality_stats``, exact integer sums rounded once to
float32); a register count off multiples of 4 is widened with VISITED
columns first (``sketch.pad_columns``), which the kernel does not count.
For ``fm_mean`` it is the sum of M over valid registers, an integer sum.
Both come with the valid count.

Candidate sets are padded with the sentinel vertex ``n_pad - 1``, whose row
is VISITED everywhere, the bottom of the max lattice: padding changes no
merged row. Each lowering returns numpy, so its caller's clock includes the
device's work.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.difuser import InfluenceResult, find_seeds_warm
from repro_torch.core.sketch import VISITED, estimate_from_sums, pad_columns
from repro_torch.kernels import ops


def _as_tuple(v) -> tuple:
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(u) for u in np.asarray(v).reshape(-1))


@dataclasses.dataclass(frozen=True)
class TopKSeeds:
    """Greedy top-k seed set (Alg. 4 rounds, warm-started)."""

    k: int


@dataclasses.dataclass(frozen=True)
class SpreadEstimate:
    """Expected spread of a fixed candidate seed set."""

    candidates: tuple

    def __init__(self, candidates):
        object.__setattr__(self, "candidates", _as_tuple(candidates))


@dataclasses.dataclass(frozen=True)
class MarginalGain:
    """Expected gain of adding ``candidate`` to ``committed``."""

    candidate: int
    committed: tuple

    def __init__(self, candidate, committed=()):
        object.__setattr__(self, "candidate", int(candidate))
        object.__setattr__(self, "committed", _as_tuple(committed))


@dataclasses.dataclass(frozen=True)
class CoverageProbe:
    """Singleton influence estimates of the probed vertices."""

    vertices: tuple

    def __init__(self, vertices):
        object.__setattr__(self, "vertices", _as_tuple(vertices))


Query = Union[TopKSeeds, SpreadEstimate, MarginalGain, CoverageProbe]


# -- batch reductions (torch, on the matrix's device) -------------------------

def row_statistics(rows: torch.Tensor, estimator: str) -> torch.Tensor:
    """``float32[2, B]``: the estimator's sum statistic and the valid count
    of each row of ``rows`` (int8[B, J])."""
    if estimator == "hll":
        return ops.cardinality_stats(pad_columns(rows.contiguous(), rows.shape[1]))
    if estimator == "fm_mean":
        valid = rows != VISITED
        stat = torch.where(valid, rows.to(torch.int32), 0).sum(1).to(torch.float32)
        return torch.stack([stat, valid.sum(1).to(torch.float32)])
    raise ValueError(f"unknown estimator: {estimator}")


def _estimate(rows: torch.Tensor, total_regs: int, estimator: str) -> torch.Tensor:
    return estimate_from_sums(row_statistics(rows, estimator), total_regs,
                              estimator=estimator)


def _spread_batch(m: torch.Tensor, cands: torch.Tensor, *, total_regs: int,
                  estimator: str) -> torch.Tensor:
    """cands int64[B, L] (sentinel-padded) -> float32[B]."""
    merged = m[cands].amax(dim=1)        # eq. (5) union; sentinel rows are VISITED
    return _estimate(merged, total_regs, estimator)


def _marginal_batch(m, cand, committed, *, total_regs: int, estimator: str):
    """cand int64[B], committed int64[B, L] -> (gain, with, without)."""
    with_c = torch.cat([committed, cand[:, None]], dim=1)
    est_with = _spread_batch(m, with_c, total_regs=total_regs, estimator=estimator)
    est_without = _spread_batch(m, committed, total_regs=total_regs, estimator=estimator)
    return est_with - est_without, est_with, est_without


def _probe_batch(m, verts, *, total_regs: int, estimator: str):
    """verts int64[B] -> (estimate float32[B], largest register int32[B])."""
    rows = m[verts]
    return (_estimate(rows, total_regs, estimator),
            rows.amax(dim=-1).to(torch.int32))


# -- lowerings (host side) ----------------------------------------------------

def pad_candidate_sets(sets: Sequence[tuple], sentinel: int, length: int) -> np.ndarray:
    """Stack ragged candidate tuples into int32[B, length], sentinel-padded."""
    out = np.full((len(sets), max(length, 1)), sentinel, dtype=np.int32)
    for i, s in enumerate(sets):
        if len(s):
            out[i, : len(s)] = np.asarray(s, dtype=np.int32)
    return out


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def spread_estimates(entry, sets: Sequence[tuple], length: int | None = None) -> np.ndarray:
    """A batch of SpreadEstimate queries against one store entry. ``length``
    overrides the padded set length."""
    if length is None:
        length = max((len(s) for s in sets), default=1)
    cands = pad_candidate_sets(sets, entry.graph.n_pad - 1, length)
    est = _spread_batch(entry.matrix, _ids(cands, entry.device),
                        total_regs=entry.x.shape[0], estimator=entry.cfg.estimator)
    return est.cpu().numpy()


def marginal_gains(entry, cands: Sequence[int], committed: Sequence[tuple],
                   length: int | None = None) -> np.ndarray:
    if length is None:
        length = max((len(s) for s in committed), default=1)
    comm = pad_candidate_sets(committed, entry.graph.n_pad - 1, length)
    gain, _, _ = _marginal_batch(entry.matrix, _ids(cands, entry.device),
                                 _ids(comm, entry.device), total_regs=entry.x.shape[0],
                                 estimator=entry.cfg.estimator)
    return gain.cpu().numpy()


def coverage_probes(entry, verts: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    est, max_reg = _probe_batch(entry.matrix, _ids(verts, entry.device),
                                total_regs=entry.x.shape[0], estimator=entry.cfg.estimator)
    return est.cpu().numpy(), max_reg.cpu().numpy()


def top_k_seeds(store, entry, k: int) -> InfluenceResult:
    """Alg. 4's K rounds from the cached matrix. A stale entry is rebuilt
    first (the lazy rebuild), and the store keeps the fresh matrix."""
    if entry.stale:
        entry = store.rebuild(entry.key)
    return find_seeds_warm(entry.graph, k, entry.cfg, matrix=entry.matrix, x=entry.x,
                           edges=entry.device_edges(), device=entry.device)
