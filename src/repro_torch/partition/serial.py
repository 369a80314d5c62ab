"""Serial-ring executor: the paper's 2-D distributed schedule on one device.

Counterpart of the reference's ``partition/serial.py``: fill, ring propagate
to a fixpoint, then K rounds of {select, cascade, score, lazy rebuild}, run
serially over the ``(mu_v, mu_s)`` shard grid. The state is one ``int8[mu_v,
mu_s, n_loc, j_loc]`` tensor on the device; every bucket merge is a kernel
of ``kernels.ops``:

* the fresh fill is ``sketch_fill`` of the canonical matrix (rows in
  original-id order, all J registers) at ``reg_offset``, whose rows are then
  gathered by ``owned_ids`` and whose columns split into sim shards;
* a ring sweep merges, for each (vertex shard v, sim shard s), the buckets
  of every ring step kk against the block of shard ``(v + kk) % mu_v``
  (``bucket_propagate`` or its cascade twin ``bucket_cascade``), Jacobi:
  every merge reads the sweep's input grid;
* the comm-free prologue (``local_sweeps``) merges only the kk = 0 buckets,
  sweep by sweep or fused into one ``fused_sweep`` call per shard;
* ``select`` takes each block's ``cardinality_stats`` (hll) or integer row
  sums of M (fm_mean, as the reference sums M there), adds the sim shards
  in shard order in float32 and breaks near-ties by the minimum original id.

Each bucket's live slots (the padding dropped) are grouped by write row once
per partition, on the device (``kernels.edges.group_rows``), and cut into
the work list of the merges' kernels (``kernels.edges.with_work``: items of
at most ``CHUNK`` slots; an empty row is an item too, which the in-place
merges skip at once and the fused prologue copies). One partial scratch, at
the largest ``num_partials`` of the state's buckets, serves every propagate
and cascade merge: the launches are ordered on one stream. Seeds are
original vertex ids whatever the plan's relabeling.

Any ``j_loc`` runs: each sim shard's block and x are ``sketch.padded_regs(j_loc)``
wide, the padding columns VISITED and inert (``core.sketch``), and
``canonical_matrix`` and ``visited_count`` read the real columns only. The
partition and its plan keep the real ``j_loc``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sketch
from repro_torch.core.difuser import DiFuserConfig, InfluenceResult
from repro_torch.core.sampling import make_x_vector
from repro_torch.core.sketch import VISITED, blank_matrix, pad_x, padded_regs
from repro_torch.device import resolve_device
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.edges import group_rows, with_work
from repro_torch.partition.builder import Partition2D, build_partition_2d
from repro_torch.partition.plan import PartitionPlan, plan_partition, sample_edge_sets


def _bucket_rows(part: Partition2D, arrays, counts: np.ndarray):
    """``rows[kk][v][s]``: the live slots of bucket (v, s, kk), grouped by
    write row, with their work list."""
    bh, bw, br, bt, bl = arrays
    return [[[with_work(group_rows(bw[kk][v, s, :n], br[kk][v, s, :n], bh[kk][v, s, :n],
                                   bl[kk][v, s, :n], bt[kk][v, s, :n], part.n_loc))
              for s, n in enumerate(counts[v, :, kk].tolist())]
             for v in range(part.mu_v)]
            for kk in range(part.mu_v)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _RingState:
    """Shard-grid register state and the bucket sweeps over it.

    ``reg_offset`` offsets the register hash slots (bank b of a split sample
    space). ``local_sweeps`` comm-free sweeps run before each ring sweep,
    fused into one ``fused_sweep`` call per shard when ``fuse_sweeps``;
    ``lane_fill`` is passed on to ``fused_sweep``, whose result does not
    depend on it. ``partial`` is the split rows' scratch of every bucket
    merge. ``m``, ``fresh``, ``x`` and ``partial`` are ``padded_regs(j_loc)``
    wide.
    """

    def __init__(self, part: Partition2D, g: Graph, cfg: DiFuserConfig, *,
                 reg_offset: int = 0, local_sweeps: int = 0, fuse_sweeps: bool = False,
                 lane_fill: int = 0):
        self.part, self.cfg = part, cfg
        self.local_sweeps = int(local_sweeps)
        self.fuse_sweeps = bool(fuse_sweeps)
        self.lane_fill = int(lane_fill)
        self.variant = resolve_model(cfg.model).variant
        dev = self.device = part.p_h[0].device
        mu_v, mu_s, n_loc, j_loc = part.mu_v, part.mu_s, part.n_loc, part.j_loc
        self.owned = torch.from_numpy(part.owned_ids.astype(np.int64)).to(dev)
        self.valid = self.owned < g.n                             # (mu_v, n_loc)
        j_pad = padded_regs(j_loc)
        self.x = pad_x(torch.from_numpy(
            np.ascontiguousarray(part.x_shards, dtype=np.uint32).view(np.int32)).to(dev),
            j_loc)
        self.p_rows = _bucket_rows(part, (part.p_h, part.p_w, part.p_r, part.p_t,
                                          part.p_l), part.p_counts)
        self.c_rows = _bucket_rows(part, (part.c_h, part.c_w, part.c_r, part.c_t,
                                          part.c_l), part.c_counts)
        buckets = [r for grid in (self.p_rows, self.c_rows)
                   for step in grid for by_v in step for r in by_v]
        self.partial = torch.empty((max(r.work.num_partials for r in buckets), j_pad),
                                   dtype=torch.int8, device=dev)
        self.p_width = [int(a.shape[-1]) for a in part.p_h]
        self.c_width = [int(a.shape[-1]) for a in part.c_h]
        canon = ops.sketch_fill(blank_matrix(part.n_pad, mu_s * j_loc, dev),
                                reg_offset=reg_offset, seed=cfg.seed)
        self.fresh = torch.full((mu_v, mu_s, n_loc, j_pad), VISITED, dtype=torch.int8,
                                device=dev)
        for v in range(mu_v):
            rows = canon.index_select(0, self.owned[v])
            for s in range(mu_s):
                self.fresh[v, s, :, :j_loc] = rows[:, s * j_loc:(s + 1) * j_loc]
        del canon
        self.m = torch.where(self.valid[:, None, :, None], self.fresh,
                             torch.full((), VISITED, dtype=torch.int8, device=dev))

    def canonical_matrix(self, n_pad: int) -> torch.Tensor:
        """The grid in the single-device layout: ``int8[n_pad, mu_s * j_loc]``,
        rows in original-id order, columns in sorted-x order."""
        p = self.part
        planned = self.m[..., :p.j_loc].permute(0, 2, 1, 3).reshape(p.mu_v * p.n_loc,
                                                                    p.mu_s * p.j_loc)
        perm = torch.from_numpy(p.plan.perm[:n_pad].astype(np.int64)).to(self.device)
        return planned.index_select(0, perm)

    def _ring(self, merge, rows, widths, steps, **kw) -> bool:
        """One Jacobi sweep of ``merge`` over the buckets of ``steps``; the
        merges write a copy of the grid and read the grid. ``kw`` goes to
        every merge."""
        p = self.part
        out = self.m.clone()
        flags = []
        for v in range(p.mu_v):
            for s in range(p.mu_s):
                for kk in steps:
                    if widths[kk]:
                        flags.append(merge(out[v, s], self.m[(v + kk) % p.mu_v, s],
                                           rows[kk][v][s], self.x[s],
                                           variant=self.variant, **kw))
        self.m = out
        return bool(torch.cat(flags).any().item()) if flags else False

    def sweep_local(self) -> bool:
        """One comm-free propagate sweep: the kk = 0 buckets only."""
        return self._ring(ops.bucket_propagate, self.p_rows, self.p_width, (0,),
                          partial=self.partial)

    def sweep_local_fused(self, num_sweeps: int) -> None:
        """``num_sweeps`` x ``sweep_local`` as one ``fused_sweep`` call per
        (vertex, sim) shard."""
        p = self.part
        if num_sweeps <= 0 or not self.p_width[0]:
            return
        for v in range(p.mu_v):
            for s in range(p.mu_s):
                self.m[v, s] = ops.fused_sweep(self.m[v, s], self.p_rows[0][v][s],
                                               self.x[s], variant=self.variant,
                                               num_sweeps=num_sweeps,
                                               lane_fill=self.lane_fill)

    def sweep_propagate(self) -> bool:
        if self.fuse_sweeps and self.local_sweeps:
            self.sweep_local_fused(self.local_sweeps)
        else:
            for _ in range(self.local_sweeps):
                if not self.sweep_local():
                    break
        return self._ring(ops.bucket_propagate, self.p_rows, self.p_width,
                          range(self.part.mu_v), partial=self.partial)

    def sweep_cascade(self) -> bool:
        return self._ring(ops.bucket_cascade, self.c_rows, self.c_width,
                          range(self.part.mu_v), partial=self.partial)

    @staticmethod
    def fixpoint(sweep, max_iters: int) -> int:
        it, changed = 0, True
        while changed and it < max_iters:
            changed = sweep()
            it += 1
        return it

    def select(self, total_regs: int, n_big: int):
        """The minimum-original-id argmax of the finished estimates. Returns
        ``(seed vertex, gain)``."""
        p = self.part
        f32 = dict(dtype=torch.float32, device=self.device)
        stat = torch.zeros((p.mu_v, p.n_loc), **f32)
        cnt = torch.zeros((p.mu_v, p.n_loc), **f32)
        for s in range(p.mu_s):   # the psum over sim shards, in shard order
            for v in range(p.mu_v):
                blk = self.m[v, s]
                sums = ops.cardinality_stats(blk)
                if self.cfg.estimator == "hll":
                    stat[v] += sums[0]
                else:   # fm_mean: the reference sums M over valid registers
                    stat[v] += _valid_row_sums(blk).to(torch.float32)
                cnt[v] += sums[1]
        est = sketch.estimate_from_sums(torch.stack([stat, cnt]), total_regs,
                                        estimator=self.cfg.estimator)
        est = torch.where(self.valid, est, torch.full((), -1.0, **f32))
        best = est.max()
        seed_v = torch.where(est == best, self.owned, n_big).min()
        return int(seed_v.item()), np.float32(best.item())

    def commit(self, seed_v: int) -> None:
        row = int(self.part.plan.perm[seed_v])
        self.m[row // self.part.n_loc, :, row % self.part.n_loc] = VISITED

    def visited_count(self) -> int:
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for v in range(self.part.mu_v):
            for s in range(self.part.mu_s):
                blk = self.m[v, s, :, :self.part.j_loc]
                total += _visited_per_row(blk)[self.valid[v]].sum()
        return int(total.item())

    def refill(self) -> None:
        self.m = torch.where(self.m == VISITED, self.m, self.fresh)


_ROW_BLOCK = 1 << 23   # registers per step of the row reductions below


def _valid_row_sums(blk: torch.Tensor) -> torch.Tensor:
    """int64 per row: the sum of M over the registers that are not VISITED."""
    rows = max(1, _ROW_BLOCK // max(blk.shape[1], 1))
    return torch.cat([torch.where(b == VISITED, 0, b.to(torch.int64)).sum(1)
                      for b in blk.split(rows)])


def _visited_per_row(blk: torch.Tensor) -> torch.Tensor:
    """int64 per row: the VISITED registers, counted a block of rows at a
    time (a reduced bool tensor is copied to int64 first)."""
    rows = max(1, _ROW_BLOCK // max(blk.shape[1], 1))
    return torch.cat([(b == VISITED).sum(1) for b in blk.split(rows)])


def _prepare(g: Graph, x: np.ndarray, cfg: DiFuserConfig, *, mu_v: int, mu_s: int,
             strategy: str, pad_mode: str, device, stats: dict,
             plan: Optional[PartitionPlan] = None) -> Partition2D:
    """Sample sets, plan (unless given) and buckets on ``device``, timed into
    ``stats``."""
    t0 = time.perf_counter()
    sampled = sample_edge_sets(g, x, mu_s, seed=cfg.seed, model=cfg.model, device=device)
    _sync(device)
    t1 = time.perf_counter()
    if plan is None:
        plan = plan_partition(g, mu_v, mu_s=mu_s, strategy=strategy, seed=cfg.seed,
                              model=cfg.model, sampled=sampled)
    t2 = time.perf_counter()
    part = build_partition_2d(g, x, mu_v, mu_s, seed=cfg.seed, model=cfg.model,
                              plan=plan, pad_mode=pad_mode, sampled=sampled)
    _sync(device)
    stats.update(sample_s=t1 - t0, plan_s=t2 - t1, buckets_s=time.perf_counter() - t2)
    return part


def find_seeds_ring_serial(g: Graph, k: int, config: Optional[DiFuserConfig] = None,
                           *, mu_v: int = 2, mu_s: int = 2, strategy: str = "block",
                           plan: Optional[PartitionPlan] = None,
                           x: Optional[np.ndarray] = None, pad_mode: str = "step",
                           local_sweeps: int = 0, fuse_sweeps: bool = False,
                           lane_fill: int = 0, device=None):
    """Serial-ring Alg. 4 (the ``serial`` backend's body), on CUDA unless
    ``device="cpu"`` is passed. Returns ``(InfluenceResult, Partition2D)``;
    seeds are original vertex ids. ``result.stats`` holds the host clock of
    each phase (sort_s, sample_s, plan_s, buckets_s, state_s, build_s,
    rounds_s, each ending in a device sync) and the sweep counts. ``plan``
    replaces the ``strategy``'s planning with a precomputed plan."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    t_sort = time.perf_counter()
    g = g.sorted_by_dst()
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
    x = np.asarray(x, dtype=np.uint32)
    stats: dict = {"sort_s": time.perf_counter() - t_sort}
    part = _prepare(g, x, cfg, mu_v=mu_v, mu_s=mu_s, strategy=strategy, plan=plan,
                    pad_mode=pad_mode, device=dev, stats=stats)
    t0 = time.perf_counter()
    st = _RingState(part, g, cfg, local_sweeps=local_sweeps, fuse_sweeps=fuse_sweeps,
                    lane_fill=lane_fill)
    _sync(dev)
    t1 = time.perf_counter()
    total_regs = part.mu_s * part.j_loc
    build_iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
    _sync(dev)
    t2 = time.perf_counter()

    f32 = np.float32
    seeds = np.zeros(k, dtype=np.int32)
    gains = np.zeros(k, dtype=f32)
    scores = np.zeros(k, dtype=f32)
    rebuilds = np.zeros(k, dtype=bool)
    oldscore = f32(0.0)
    stats.update(cascade_sweeps=0, rebuild_sweeps=0)
    for i in range(k):
        s_v, gain = st.select(total_regs, part.n_pad)
        st.commit(s_v)
        stats["cascade_sweeps"] += st.fixpoint(st.sweep_cascade, cfg.max_cascade_iters)
        new_score = f32(st.visited_count()) / f32(total_regs)
        rel = (new_score - oldscore) / np.maximum(new_score, f32(1e-9))
        do_rebuild = bool(rel > f32(cfg.rebuild_threshold))
        if do_rebuild:
            st.refill()
            stats["rebuild_sweeps"] += st.fixpoint(st.sweep_propagate,
                                                   cfg.max_propagate_iters)
            oldscore = new_score
        seeds[i], gains[i], scores[i], rebuilds[i] = s_v, gain, new_score, do_rebuild
    _sync(dev)
    stats.update(state_s=t1 - t0, build_s=t2 - t1, rounds_s=time.perf_counter() - t2)
    res = InfluenceResult(seeds=seeds, est_gains=gains, scores=scores, rebuilds=rebuilds,
                          propagate_iters=build_iters, x=np.sort(x), stats=stats)
    return res, part


def build_matrix_ring_serial(g: Graph, config: Optional[DiFuserConfig] = None,
                             x: Optional[np.ndarray] = None, *, mu_v: int = 2,
                             mu_s: int = 1, strategy: str = "block",
                             plan: Optional[PartitionPlan] = None, pad_mode: str = "step",
                             reg_offset: int = 0, local_sweeps: int = 0,
                             fuse_sweeps: bool = False, lane_fill: int = 0, device=None):
    """Alg. 4 lines 3-6 on the serial ring: fill + propagate to a fixpoint.
    Expects ``g`` sorted by destination and ``x`` sorted. Returns ``(matrix
    int8[g.n_pad, len(x)], iters, Partition2D)`` with the matrix in the
    single-device layout, equal to ``core.difuser.build_sketch_matrix``'s
    with the same ``reg_offset``."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    if x is None:
        x = np.sort(make_x_vector(cfg.num_registers, seed=cfg.seed))
    x = np.asarray(x, dtype=np.uint32)
    part = _prepare(g, x, cfg, mu_v=mu_v, mu_s=mu_s, strategy=strategy, plan=plan,
                    pad_mode=pad_mode, device=dev, stats={})
    st = _RingState(part, g, cfg, reg_offset=reg_offset, local_sweeps=local_sweeps,
                    fuse_sweeps=fuse_sweeps, lane_fill=lane_fill)
    iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
    return st.canonical_matrix(g.n_pad), iters, part
