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
Where they lower the edges themselves, ``propagate`` and ``cascade`` are the
two sweeps' work-list geometry (``kernels.edges.ItemGeometry``: edges an
item, warps a block), which moves time and never a result.

Spans (``obs.trace``): the reference's ``single.find_seeds`` (build and
rounds), ``single.build_matrix`` (with its bandwidth, ``utils.roofline``)
and ``single.warm_rounds``, and the port's own split of a run, which
the reference's one-program jit has no room for: ``single.prep`` with
``single.sort_by_dst`` (the sort on the job's device, ``on=`` its type
and ``bytes=`` what it copied), ``single.lower``, ``single.upload`` and
``single.work_lists`` inside, ``single.seed_rounds``, and per round
``single.round`` with ``single.select``, ``single.cascade_fixpoint``,
``single.count_visited`` and ``single.rebuild`` inside, named as the serial
ring's are; the two fixpoints carry their ``sweeps=``, the cascade its
``seed=`` and the rebuild ``fill=1``. Each syncs what it produced (a
fixpoint by its last sweep's flag read). The spans whose time goes into
``InfluenceResult.stats`` are ``timed``, so they measure with the recorder
off too; the others are null and free then.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.kernels import cost, ops
from repro_torch.kernels.edges import DEFAULT_GEOMETRY, EdgeOperands, ItemGeometry, upload
from repro_torch.obs import trace
from repro_torch.utils import roofline


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
    # where the time went (each its span's duration, ending in a device
    # sync): prep_s (sort_s + lower_s + upload_s + worklists_s), build_s,
    # rounds_s, and of the rounds visited_s (the visited counts), cascade_s
    # (the cascade fixpoints) and rebuild_s (the lazy rebuilds' fills and
    # fixpoints); cascade_sweeps, rebuild_sweeps
    stats: dict = dataclasses.field(default_factory=dict)


def normalize_x(cfg: DiFuserConfig, x: Optional[np.ndarray]) -> np.ndarray:
    """Default x from the config seed, as uint32, FASST-sorted."""
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
    x = np.asarray(x, dtype=np.uint32)
    return np.sort(x) if cfg.sort_x else x


def normalize_inputs(g: Graph, config: Optional[DiFuserConfig] = None,
                     x: Optional[np.ndarray] = None, *, device=None):
    """Edges by destination, x normalized (idempotent). The edges are sorted
    on ``device`` where one is given, else on the host
    (``Graph.sorted_by_dst``); the result is the same."""
    cfg = config or DiFuserConfig()
    return g.sorted_by_dst(device), normalize_x(cfg, x)


def edge_operands(g: Graph, cfg: DiFuserConfig, device, *,
                  propagate: ItemGeometry = DEFAULT_GEOMETRY,
                  cascade: ItemGeometry = DEFAULT_GEOMETRY) -> EdgeOperands:
    """Lower ``cfg.model`` against ``g`` (already in serving order) to the
    device operands of the sweeps, their work lists cut at the ``propagate``
    and ``cascade`` geometry."""
    ep = resolve_model(cfg.model).edge_params(g, seed=cfg.seed)
    return EdgeOperands.from_numpy(g.src, g.dst, ep.h, ep.lo, ep.thr, g.n_pad,
                                   resolve_device(device), propagate=propagate,
                                   cascade=cascade)


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
    stats.update(cascade_sweeps=0, rebuild_sweeps=0, visited_s=0.0, cascade_s=0.0,
                 rebuild_s=0.0)
    for i in range(k):
        with trace.span("single.round", phase="select", round=i) as rsp:
            with trace.span("single.select", round=i):
                sums = _select.local_sums(m)
                s, gain = _select.finish_select(sums, num_regs, n_real,
                                                estimator=cfg.estimator)
                s = int(s.item())
            # the two fixpoints end in their last sweep's flag read, which
            # is their sync: timing them adds none
            with trace.span("single.cascade_fixpoint", phase="ring", round=i,
                            timed=True) as csp:
                m, it = cascade_from_seed(m, s, edges, x_t, variant=variant,
                                          max_iters=cfg.max_cascade_iters)
                csp.annotate(seed=s, sweeps=it)
            stats["cascade_sweeps"] += it
            stats["cascade_s"] += csp.duration_s
            with trace.span("single.count_visited", round=i, timed=True) as vsp:
                visited = count_visited(m, n_real, num_regs).item()
            stats["visited_s"] += vsp.duration_s
            new_score = f32(visited) / regs
            rel = (new_score - oldscore) / np.maximum(new_score, floor)
            do_rebuild = bool(rel > threshold)
            if do_rebuild:
                with trace.span("single.rebuild", phase="build", round=i,
                                timed=True) as bsp:
                    m = ops.sketch_fill(m, reg_offset=0, seed=cfg.seed)
                    m, it = propagate_to_fixpoint(m, edges, x_t, variant=variant,
                                                  max_iters=cfg.max_propagate_iters)
                    bsp.annotate(fill=1, sweeps=it)
                stats["rebuild_sweeps"] += it
                stats["rebuild_s"] += bsp.duration_s
                oldscore = new_score
            rsp.annotate(seed=s, rebuild=do_rebuild)
        seeds.append(s)
        gains.append(gain.item())
        scores.append(new_score)
        rebuilds.append(do_rebuild)
    return (np.asarray(seeds, np.int32), np.asarray(gains, np.float32),
            np.asarray(scores, np.float32), np.asarray(rebuilds, bool))


def _annotate_build(sp, iters: int, n: int, num_edges: int, num_regs: int, variant: int,
                    *, fill: bool = True) -> None:
    """The build span's bandwidth: the compulsory bytes of its fill (when
    ``fill``) and ``iters`` propagate sweeps (``kernels.cost``, at the real
    n, J and edges, as the benchmark's ``kernel_roofline_pct`` counts them)
    over the span's time."""
    nbytes = iters * cost.sketch_propagate(n, num_regs, num_edges, variant)[1]
    if fill:
        nbytes += cost.sketch_fill(n, num_regs)[1]
    roofline.annotate_bandwidth(sp, nbytes, sp.duration_s)


def build_sketch_matrix(g: Graph, config: Optional[DiFuserConfig] = None,
                        x: Optional[np.ndarray] = None, *, reg_offset: int = 0,
                        init_matrix=None, normalized: bool = False,
                        edges: Optional[EdgeOperands] = None, device=None,
                        propagate: ItemGeometry = DEFAULT_GEOMETRY,
                        cascade: ItemGeometry = DEFAULT_GEOMETRY):
    """Alg. 4 lines 3-6 once. Returns ``(matrix int8[n_pad, J] on the
    device, build_iters, x_used)``, J = len(x).

    ``reg_offset`` offsets the register hash slots (bank b of a split sample
    space fills slots from b * J). ``init_matrix`` (tensor or numpy) starts
    the fixpoint from an existing matrix instead of a fresh fill.
    ``normalized=True`` skips sorting when ``g`` and ``x`` already are.
    ``edges``: operands from ``edge_operands`` for the normalized graph
    (else they are lowered here at the ``propagate``/``cascade`` geometry)."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    if not normalized:
        g, x = normalize_inputs(g, cfg, x, device=dev)
    if edges is None:
        edges = edge_operands(g, cfg, dev, propagate=propagate, cascade=cascade)
    variant = resolve_model(cfg.model).variant
    x_t = x_tensor(x, dev)
    with trace.span("single.build_matrix", phase="build", n=g.n, registers=int(x.shape[0]),
                    reg_offset=reg_offset, warm=init_matrix is not None) as sp:
        if init_matrix is None:
            m, iters = _build(edges, x_t, g.n, num_regs=x.shape[0], cfg=cfg,
                              variant=variant, reg_offset=reg_offset)
        else:
            m, iters = propagate_to_fixpoint(_as_matrix(init_matrix, x.shape[0], dev),
                                             edges, x_t, variant=variant,
                                             max_iters=cfg.max_propagate_iters)
        sp.sync(m)
        sp.annotate(iters=iters)
    _annotate_build(sp, iters, g.n, g.m_real, x.shape[0], variant,
                    fill=init_matrix is None)
    return real_columns(m, x.shape[0]), iters, x


def find_seeds(g: Graph, k: int, config: Optional[DiFuserConfig] = None,
               x: Optional[np.ndarray] = None, *, device=None,
               propagate: ItemGeometry = DEFAULT_GEOMETRY,
               cascade: ItemGeometry = DEFAULT_GEOMETRY) -> InfluenceResult:
    """Single-device Alg. 4: build, then K seed rounds. ``x`` overrides the
    random vector."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    with trace.span("single.prep", phase="plan", n=g.n, registers=cfg.num_registers,
                    timed=True) as prep:
        with trace.span("single.sort_by_dst", n=g.n, timed=True) as sort:
            sort.annotate(on=dev.type, bytes=g.dst_sort_bytes(dev))
            g, x = normalize_inputs(g, cfg, x, device=dev)
        with trace.span("single.lower", model=cfg.model, edges=g.m, timed=True) as lower:
            ep = resolve_model(cfg.model).edge_params(g, seed=cfg.seed)
            lower.annotate(bytes=ep.h.nbytes + ep.lo.nbytes + ep.thr.nbytes)
        with trace.span("single.upload", edges=g.m, timed=True) as up:
            operands = up.sync(upload(g.src, g.dst, ep.h, ep.lo, ep.thr, dev))
            x_t = up.sync(x_tensor(x, dev))
            up.annotate(bytes=sum(t.nbytes for t in operands) + x_t.nbytes)
        with trace.span("single.work_lists", timed=True) as work:
            edges = work.sync(EdgeOperands.from_device(*operands, g.n_pad,
                                                       propagate=propagate,
                                                       cascade=cascade))
        variant = resolve_model(cfg.model).variant
    stats = {"prep_s": prep.duration_s, "sort_s": sort.duration_s,
             "lower_s": lower.duration_s, "upload_s": up.duration_s,
             "worklists_s": work.duration_s}
    with trace.span("single.find_seeds", phase="select", k=k, n=g.n,
                    registers=cfg.num_registers, model=cfg.model):
        with trace.span("single.build_matrix", phase="build", n=g.n,
                        registers=cfg.num_registers, reg_offset=0, warm=False,
                        timed=True) as build:
            m, build_iters = _build(edges, x_t, g.n, num_regs=cfg.num_registers, cfg=cfg,
                                    variant=variant)
            build.sync(m)
            build.annotate(iters=build_iters)
        _annotate_build(build, build_iters, g.n, g.m_real, cfg.num_registers, variant)
        with trace.span("single.seed_rounds", phase="select", k=k, timed=True) as rounds:
            seeds, gains, scores, rebuilds = _seed_rounds(
                m, edges, x_t, k=k, n_real=g.n, num_regs=cfg.num_registers, cfg=cfg,
                variant=variant, stats=stats)
            synchronize(dev)
    stats.update(build_s=build.duration_s, rounds_s=rounds.duration_s)
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
        g, x = normalize_inputs(g, cfg, x, device=dev)
        edges = edge_operands(g, cfg, dev)
    x = np.asarray(x, dtype=np.uint32)
    stats = {}
    with trace.span("single.warm_rounds", phase="select", k=k, n=g.n,
                    registers=int(x.shape[0]), timed=True) as rounds:
        seeds, gains, scores, rebuilds = _seed_rounds(
            _as_matrix(matrix, x.shape[0], dev), edges, x_tensor(x, dev), k=k, n_real=g.n,
            num_regs=x.shape[0], cfg=cfg, variant=resolve_model(cfg.model).variant,
            stats=stats)
        synchronize(dev)
    stats.update(build_s=0.0, rounds_s=rounds.duration_s)
    return InfluenceResult(seeds=seeds, est_gains=gains, scores=scores,
                           rebuilds=rebuilds, propagate_iters=0, x=x, stats=stats)
