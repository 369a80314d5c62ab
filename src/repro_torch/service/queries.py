"""Influence queries and their lowerings to register reductions.

Counterpart of the reference's ``service/queries.py``. Every query but
``TopKSeeds`` is a reduction over the store's propagated matrix, with the
statistics of the reference's ``sketch.partial_sums`` and the float32 finish
of ``sketch.estimate_from_sums`` (paper eqs. 6-7):

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

Two lowerings per query class, chosen by ``StoreEntry.residency``:

* **host**: the reductions over the canonical matrix on the store's device;
* **device**: shard-local reductions on the row blocks ``place_on_mesh``
  placed, as one operation of the serving world (``launch.mesh``): each
  rank merges the requested plan-order rows it owns (``shard_partial_rows``:
  the rows it does not own are VISITED, inert under the merge), one
  all-reduce MAX over the vertex group combines the partial registers, and
  the controller runs the estimator on the merged rows, the very rows the
  host lowering merges, so the answers are byte-equal. ``TopKSeeds`` runs
  the mesh's warm rounds off the placed blocks
  (``core.distributed.find_seeds_warm_distributed``); a stale device entry
  is rebuilt and placed again first.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.difuser import InfluenceResult, find_seeds_warm
from repro_torch.core.sketch import VISITED, estimate_from_sums, pad_columns
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh


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


# -- shard-local reductions (device residency) ---------------------------------

def shard_partial_rows(m_loc: torch.Tensor, rows: torch.Tensor, row0: int,
                       n_loc: int) -> torch.Tensor:
    """One shard's half of a row gather from the plan-order matrix: of the
    requested plan-order ``rows`` (any shape), the ones this shard owns
    (``[row0, row0 + n_loc)``) from its block ``m_loc``, VISITED (the
    bottom of the max lattice) for the others. ``rows.shape + (J,)``."""
    local = rows - row0
    owned = (local >= 0) & (local < n_loc)
    got = m_loc[local.clamp(0, n_loc - 1)]
    return torch.where(owned[..., None], got, torch.full((), VISITED, dtype=m_loc.dtype,
                                                         device=m_loc.device))


def _merged(state, p, *row_sets) -> list:
    """The rank's partial max-merge of each row set (``[B, L]`` merges over
    L, ``[B]`` is taken as it is), combined over the vertex group by one
    all-reduce MAX; the merged ``[B, J]`` rows of each set, on every rank."""
    mesh = launch_mesh.ProcessMesh.by_key(p["mesh"])
    blk = state.blocks[p["hid"]]
    row0 = mesh.coord[0] * blk.shape[0]
    parts = []
    for rows in row_sets:
        got = shard_partial_rows(blk, torch.from_numpy(rows.astype(np.int64)).to(blk.device),
                                 row0, blk.shape[0])
        parts.append(got.amax(dim=1) if rows.ndim == 2 else got)
    merged = mesh.exchange.all_reduce_max(torch.stack(parts), mesh.vertex_group)
    return list(merged.unbind(0))


def _op_spread(state, p, local):
    (rows,) = _merged(state, p, p["cands"])
    if local is None:
        return None
    return _estimate(rows, p["total_regs"], p["estimator"]).cpu().numpy()


def _op_marginal(state, p, local):
    with_c = np.concatenate([p["committed"], p["cand"][:, None]], axis=1)
    rows_with, rows_without = _merged(state, p, with_c, p["committed"])
    if local is None:
        return None
    est_with = _estimate(rows_with, p["total_regs"], p["estimator"])
    est_without = _estimate(rows_without, p["total_regs"], p["estimator"])
    return (est_with - est_without).cpu().numpy()


def _op_probe(state, p, local):
    (rows,) = _merged(state, p, p["verts"])
    if local is None:
        return None
    return (_estimate(rows, p["total_regs"], p["estimator"]).cpu().numpy(),
            rows.amax(dim=-1).to(torch.int32).cpu().numpy())


def _plan_rows(entry, ids) -> np.ndarray:
    """Original vertex ids -> plan-order rows (host side, O(batch)). The
    sentinel's row is VISITED everywhere in the plan order too."""
    return entry.plan.perm[np.asarray(ids, dtype=np.int64)].astype(np.int32)


def _on_mesh(entry, op, **rows):
    """Run the query operation body ``op`` on the entry's placed blocks."""
    placement = entry.planned_matrix()
    ctl = placement.ctl
    payload = dict(mesh=placement.mesh.key, hid=placement.hid,
                   total_regs=int(entry.x.shape[0]), estimator=entry.cfg.estimator,
                   **{name: _plan_rows(entry, ids) for name, ids in rows.items()})
    return ctl.call(op, payload, local=True)


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
    overrides the padded set length. A device entry is answered shard-locally
    on its mesh, byte-equal to the host lowering."""
    if length is None:
        length = max((len(s) for s in sets), default=1)
    cands = pad_candidate_sets(sets, entry.graph.n_pad - 1, length)
    if entry.residency == "device":
        return _on_mesh(entry, _op_spread, cands=cands)
    est = _spread_batch(entry.matrix, _ids(cands, entry.device),
                        total_regs=entry.x.shape[0], estimator=entry.cfg.estimator)
    return est.cpu().numpy()


def marginal_gains(entry, cands: Sequence[int], committed: Sequence[tuple],
                   length: int | None = None) -> np.ndarray:
    if length is None:
        length = max((len(s) for s in committed), default=1)
    comm = pad_candidate_sets(committed, entry.graph.n_pad - 1, length)
    if entry.residency == "device":
        return _on_mesh(entry, _op_marginal, cand=np.asarray(cands, dtype=np.int64),
                        committed=comm)
    gain, _, _ = _marginal_batch(entry.matrix, _ids(cands, entry.device),
                                 _ids(comm, entry.device), total_regs=entry.x.shape[0],
                                 estimator=entry.cfg.estimator)
    return gain.cpu().numpy()


def coverage_probes(entry, verts: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    if entry.residency == "device":
        return _on_mesh(entry, _op_probe, verts=np.asarray(verts, dtype=np.int64))
    est, max_reg = _probe_batch(entry.matrix, _ids(verts, entry.device),
                                total_regs=entry.x.shape[0], estimator=entry.cfg.estimator)
    return est.cpu().numpy(), max_reg.cpu().numpy()


def top_k_seeds(store, entry, k: int) -> InfluenceResult:
    """Alg. 4's K rounds from the cached matrix. A stale entry is rebuilt
    first (the lazy rebuild; a device entry is placed again), and the store
    keeps the fresh matrix. A device entry runs the mesh's warm rounds off
    its placed blocks; ``result.stats`` then holds the controller's
    exchange summary and the partition's host seconds (0 when cached)."""
    if entry.stale:
        entry = store.rebuild(entry.key)
    if entry.residency == "device":
        from repro_torch.core.distributed import _op_warm_rounds
        from repro_torch.runtime.spec import RunSpec

        placement = entry.planned_matrix()
        mesh, ctl = placement.mesh, placement.ctl
        sim_axes = tuple(ax for ax in mesh.axis_names if ax != entry.vertex_axis)
        cfg = RunSpec.from_config(entry.cfg, vertex_axis=entry.vertex_axis,
                                  sim_axes=sim_axes).distributed_config()
        return ctl.call(_op_warm_rounds, dict(
            mesh=mesh.key, hid=placement.hid, graph=ctl.share_graph(entry.graph),
            plan=ctl.share_plan(entry.plan), x=entry.x, cfg=cfg, k=int(k)))
    return find_seeds_warm(entry.graph, k, entry.cfg, matrix=entry.matrix, x=entry.x,
                           edges=entry.device_edges(), device=entry.device)
