"""DiFuseR driver (paper Alg. 4), single device, in PyTorch.

Counterpart of the reference's ``core/difuser.py``: the build (fill, then
propagate to a fixpoint) and K seed rounds of {select, cascade, score, lazy
rebuild}, as Python loops over the kernels of ``kernels.ops``. The score and
rebuild arithmetic is float32, in the reference's order of operations, so
seeds, rebuilds and sweep counts come out the same. Any register count J
runs: the matrix and x the kernels see are ``sketch.padded_regs(J)`` wide
(inert VISITED columns, see ``core.sketch``), and what the entry points
return is J wide.

Entry points (``build_sketch_matrix``, ``find_seeds``, ``find_seeds_warm``)
run on CUDA unless ``device="cpu"`` is passed; see ``repro_torch.device``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import select as _select
from repro_torch.core.cascade import cascade_from_seed
from repro_torch.core.sampling import make_x_vector
from repro_torch.core.simulate import propagate_to_fixpoint
from repro_torch.core.sketch import (VISITED, blank_matrix, count_visited, pad_columns,
                                     pad_x, real_columns)
from repro_torch.device import resolve_device, synchronize
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.diffusion.constants import DEFAULT_MODEL
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.edges import EdgeOperands


@dataclasses.dataclass(frozen=True)
class DiFuserConfig:
    """The knobs of Alg. 4 that decide its result."""

    num_registers: int = 1024          # J == R (one register per simulation)
    seed: int = 0                      # global hash seed
    estimator: str = "hll"             # "hll" (eq. 7) | "fm_mean" (eq. 6)
    rebuild_threshold: float = 0.01    # e in Alg. 4 line 22
    max_propagate_iters: int = 64
    max_cascade_iters: int = 64
    sort_x: bool = True                # FASST ordering (§4.1)
    model: str = DEFAULT_MODEL         # diffusion model spec


@dataclasses.dataclass
class InfluenceResult:
    seeds: np.ndarray          # int32[K]
    est_gains: np.ndarray      # float32[K] sketch-estimated marginal gains
    scores: np.ndarray         # float32[K] influence after committing seed i
    rebuilds: np.ndarray       # bool[K] whether round i rebuilt the sketches
    propagate_iters: int       # sweeps of the initial build's fixpoint
    x: np.ndarray              # the random vector used (uint32[J])
    # where the time went (host clock, each phase ends in a device sync):
    # prep_s (edge sort, model lowering, upload), build_s, rounds_s,
    # cascade_sweeps, rebuild_sweeps
    stats: dict = dataclasses.field(default_factory=dict)


def normalize_x(cfg: DiFuserConfig, x: Optional[np.ndarray]) -> np.ndarray:
    """Default x from the config seed, as uint32, FASST-sorted."""
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
    x = np.asarray(x, dtype=np.uint32)
    return np.sort(x) if cfg.sort_x else x


def normalize_inputs(g: Graph, config: Optional[DiFuserConfig] = None,
                     x: Optional[np.ndarray] = None):
    """Edges by destination, x normalized (idempotent)."""
    cfg = config or DiFuserConfig()
    return g.sorted_by_dst(), normalize_x(cfg, x)


def edge_operands(g: Graph, cfg: DiFuserConfig, device) -> EdgeOperands:
    """Lower ``cfg.model`` against ``g`` (already in serving order) to the
    device operands of the sweeps."""
    ep = resolve_model(cfg.model).edge_params(g, seed=cfg.seed)
    return EdgeOperands.from_numpy(g.src, g.dst, ep.h, ep.lo, ep.thr, g.n_pad,
                                   resolve_device(device))


def x_tensor(x: np.ndarray, device) -> torch.Tensor:
    """x on the device, as int32 holding the uint32 bits, padded to the
    kernels' register count."""
    t = torch.from_numpy(np.require(x, np.uint32, ["C", "W"]).view(np.int32)).to(device)
    return pad_x(t, t.shape[0])


def _init_registers(n_pad: int, n_real: int, num_regs: int, device) -> torch.Tensor:
    """Zeros, padding rows and padding columns VISITED."""
    m = blank_matrix(n_pad, num_regs, device)
    m[n_real:] = VISITED
    return m


def _as_matrix(matrix, num_regs: int, device) -> torch.Tensor:
    """A J-wide matrix (tensor or numpy) on ``device``, padded for the kernels."""
    if isinstance(matrix, np.ndarray):
        matrix = torch.from_numpy(np.require(matrix, np.int8, ["C", "W"]))
    return pad_columns(matrix.to(device), num_regs)


def _build(edges, x_t, n_real, *, num_regs, cfg, variant, reg_offset=0):
    """Alg. 4 lines 3-6: init + fill + propagate to fixpoint."""
    m = _init_registers(edges.n_pad, n_real, num_regs, edges.device)
    m = ops.sketch_fill(m, reg_offset=reg_offset, seed=cfg.seed)
    return propagate_to_fixpoint(m, edges, x_t, variant=variant,
                                 max_iters=cfg.max_propagate_iters)


def _seed_rounds(m, edges, x_t, *, k, n_real, num_regs, cfg, variant, stats):
    """Alg. 4 lines 7-23: K rounds of {select, cascade, score, lazy rebuild}
    from a propagated matrix ``m`` (left as it was). Returns numpy
    (seeds, gains, scores, rebuilds)."""
    f32 = np.float32
    threshold, floor, regs = f32(cfg.rebuild_threshold), f32(1e-9), f32(num_regs)
    oldscore = f32(0.0)
    seeds, gains, scores, rebuilds = [], [], [], []
    stats.update(cascade_sweeps=0, rebuild_sweeps=0)
    for _ in range(k):
        sums = _select.local_sums(m)
        s, gain = _select.finish_select(sums, num_regs, n_real, estimator=cfg.estimator)
        s = int(s.item())
        m, it = cascade_from_seed(m, s, edges, x_t, variant=variant,
                                  max_iters=cfg.max_cascade_iters)
        stats["cascade_sweeps"] += it
        new_score = f32(count_visited(m, n_real, num_regs).item()) / regs
        rel = (new_score - oldscore) / np.maximum(new_score, floor)
        do_rebuild = bool(rel > threshold)
        if do_rebuild:
            m = ops.sketch_fill(m, reg_offset=0, seed=cfg.seed)
            m, it = propagate_to_fixpoint(m, edges, x_t, variant=variant,
                                          max_iters=cfg.max_propagate_iters)
            stats["rebuild_sweeps"] += it
            oldscore = new_score
        seeds.append(s)
        gains.append(gain.item())
        scores.append(new_score)
        rebuilds.append(do_rebuild)
    return (np.asarray(seeds, np.int32), np.asarray(gains, np.float32),
            np.asarray(scores, np.float32), np.asarray(rebuilds, bool))


def build_sketch_matrix(g: Graph, config: Optional[DiFuserConfig] = None,
                        x: Optional[np.ndarray] = None, *, reg_offset: int = 0,
                        init_matrix=None, normalized: bool = False,
                        edges: Optional[EdgeOperands] = None, device=None):
    """Alg. 4 lines 3-6 once. Returns ``(matrix int8[n_pad, J] on the
    device, build_iters, x_used)``, J = len(x).

    ``reg_offset`` offsets the register hash slots (bank b of a split sample
    space fills slots from b * J). ``init_matrix`` (tensor or numpy) starts
    the fixpoint from an existing matrix instead of a fresh fill.
    ``normalized=True`` skips sorting when ``g`` and ``x`` already are.
    ``edges``: operands from ``edge_operands`` for the normalized graph."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    if not normalized:
        g, x = normalize_inputs(g, cfg, x)
    if edges is None:
        edges = edge_operands(g, cfg, dev)
    variant = resolve_model(cfg.model).variant
    x_t = x_tensor(x, dev)
    if init_matrix is None:
        m, iters = _build(edges, x_t, g.n, num_regs=x.shape[0], cfg=cfg,
                          variant=variant, reg_offset=reg_offset)
    else:
        m, iters = propagate_to_fixpoint(_as_matrix(init_matrix, x.shape[0], dev), edges,
                                         x_t, variant=variant,
                                         max_iters=cfg.max_propagate_iters)
    return real_columns(m, x.shape[0]), iters, x


def find_seeds(g: Graph, k: int, config: Optional[DiFuserConfig] = None,
               x: Optional[np.ndarray] = None, *, device=None) -> InfluenceResult:
    """Single-device Alg. 4: build, then K seed rounds. ``x`` overrides the
    random vector."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    t_prep = time.perf_counter()
    g, x = normalize_inputs(g, cfg, x)
    edges = edge_operands(g, cfg, dev)
    variant = resolve_model(cfg.model).variant
    x_t = x_tensor(x, dev)
    synchronize(dev)
    t0 = time.perf_counter()
    stats = {"prep_s": t0 - t_prep}
    m, build_iters = _build(edges, x_t, g.n, num_regs=cfg.num_registers, cfg=cfg,
                            variant=variant)
    synchronize(dev)
    t1 = time.perf_counter()
    seeds, gains, scores, rebuilds = _seed_rounds(
        m, edges, x_t, k=k, n_real=g.n, num_regs=cfg.num_registers, cfg=cfg,
        variant=variant, stats=stats)
    synchronize(dev)
    stats.update(build_s=t1 - t0, rounds_s=time.perf_counter() - t1)
    return InfluenceResult(seeds=seeds, est_gains=gains, scores=scores,
                           rebuilds=rebuilds, propagate_iters=build_iters, x=x,
                           stats=stats)


def find_seeds_warm(g: Graph, k: int, config: Optional[DiFuserConfig] = None, *,
                    matrix, x: np.ndarray, edges: Optional[EdgeOperands] = None,
                    device=None) -> InfluenceResult:
    """The K seed rounds from an already-propagated ``matrix`` (tensor or
    numpy, e.g. from ``build_sketch_matrix`` or ``core.state``). The round
    loop is the one ``find_seeds`` runs, so the seeds equal a cold run's.
    With ``edges`` given, ``g`` and ``x`` must already be normalized."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    if edges is None:
        g, x = normalize_inputs(g, cfg, x)
        edges = edge_operands(g, cfg, dev)
    x = np.asarray(x, dtype=np.uint32)
    stats = {}
    t0 = time.perf_counter()
    seeds, gains, scores, rebuilds = _seed_rounds(
        _as_matrix(matrix, x.shape[0], dev), edges, x_tensor(x, dev), k=k, n_real=g.n,
        num_regs=x.shape[0], cfg=cfg, variant=resolve_model(cfg.model).variant,
        stats=stats)
    synchronize(dev)
    stats.update(build_s=0.0, rounds_s=time.perf_counter() - t0)
    return InfluenceResult(seeds=seeds, est_gains=gains, scores=scores,
                           rebuilds=rebuilds, propagate_iters=0, x=x, stats=stats)
