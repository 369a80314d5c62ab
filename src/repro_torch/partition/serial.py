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

``repair_plan_shards`` is the shard-restricted insertion repair: the ring
state starts from a plan-order matrix (a sound lower bound of the new
fixpoint) instead of a fill, and each sweep merges only the buckets that
read from a shard the previous sweep changed (``sweep_propagate_restricted``),
starting from the shards a delta touched.

Observability: the drivers run in the reference's spans (``serial.*``), each
synchronizing the grid it produced; ``find_seeds_ring_serial``'s phase
timings in ``InfluenceResult.stats`` are the durations of its ``timed``
spans. With a ``ShardProfiler`` set
(``obs.shardprof``, on by default for the builds) every (shard, ring step)
merge of a full sweep is timed, by a pair of CUDA events on the card, read
after the sweep's flag sync, and by the host clock on the CPU. Without a
profiler no event is recorded.

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
from repro_torch.device import resolve_device, synchronize
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.edges import group_rows, with_work
from repro_torch.obs import shardprof, trace
from repro_torch.partition.builder import Partition2D, build_partition_2d
from repro_torch.partition.plan import PartitionPlan, plan_partition, sample_edge_sets
from repro_torch.utils import roofline


def _shard_rows(part: Partition2D, arrays, counts: np.ndarray, v: int, s: int):
    """``rows[kk]``: the live slots of bucket (v, s, kk) for each ring step,
    grouped by write row, with their work list."""
    bh, bw, br, bt, bl = arrays
    out = []
    for kk in range(part.mu_v):
        n = int(counts[v, s, kk])
        out.append(with_work(group_rows(bw[kk][v, s, :n], br[kk][v, s, :n],
                                        bh[kk][v, s, :n], bl[kk][v, s, :n],
                                        bt[kk][v, s, :n], part.n_loc)))
    return out


def _bucket_rows(part: Partition2D, arrays, counts: np.ndarray):
    """``rows[kk][v][s]``: ``_shard_rows`` of every shard."""
    grid = [[_shard_rows(part, arrays, counts, v, s) for s in range(part.mu_s)]
            for v in range(part.mu_v)]
    return [[[grid[v][s][kk] for s in range(part.mu_s)] for v in range(part.mu_v)]
            for kk in range(part.mu_v)]


def _partial_scratch(buckets, j_pad: int, device) -> torch.Tensor:
    """The split rows' scratch of every merge of ``buckets`` (``EdgeRows``
    with work lists): one, at the largest ``num_partials``, since the
    merges run in order on one stream."""
    return torch.empty((max(r.work.num_partials for r in buckets), j_pad),
                       dtype=torch.int8, device=device)


class _MergeTimer:
    """Times each merge of one sweep for a ``ShardProfiler``: a pair of CUDA
    events around each launch on the card, read by ``finish`` after the
    sweep's flag sync; the host clock on the CPU, where a merge runs
    synchronously."""

    def __init__(self, profiler, device: torch.device):
        self.profiler = profiler
        self.cuda = device.type == "cuda"
        self.pending: list = []
        self._start = None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self, v: int, kk: int, nbytes: int) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.pending.append((v, kk, nbytes, self._start, end))
        else:
            self.profiler.record(v, kk, time.perf_counter() - self._start, nbytes)

    def finish(self) -> None:
        """Fold the sweep's timings into the profiler (after its sync)."""
        for v, kk, nbytes, start, end in self.pending:
            self.profiler.record(v, kk, start.elapsed_time(end) * 1e-3, nbytes)
        self.pending.clear()
        self.profiler.count_sweep()


class _RingState:
    """Shard-grid register state and the bucket sweeps over it.

    ``reg_offset`` offsets the register hash slots (bank b of a split sample
    space). ``local_sweeps`` comm-free sweeps run before each ring sweep,
    fused into one ``fused_sweep`` call per shard when ``fuse_sweeps``;
    ``lane_fill`` is passed on to ``fused_sweep``, whose result does not
    depend on it. ``partial`` is the split rows' scratch of every bucket
    merge. ``m``, ``fresh``, ``x`` and ``partial`` are ``padded_regs(j_loc)``
    wide.

    ``matrix`` (a ``(mu_v, mu_s, n_loc, j_loc)`` grid) starts the state from
    that grid, copied, instead of the fill; ``fresh`` is then None and
    ``refill`` refuses (the repair path never calls it). ``profiler``: an
    ``obs.shardprof.ShardProfiler`` that times the merges of
    ``sweep_propagate`` and ``sweep_cascade`` when set.
    """

    def __init__(self, part: Partition2D, g: Graph, cfg: DiFuserConfig, *,
                 reg_offset: int = 0, local_sweeps: int = 0, fuse_sweeps: bool = False,
                 lane_fill: int = 0, matrix: Optional[torch.Tensor] = None):
        self.part, self.cfg = part, cfg
        self.local_sweeps = int(local_sweeps)
        self.fuse_sweeps = bool(fuse_sweeps)
        self.lane_fill = int(lane_fill)
        self.profiler = None
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
        self.partial = _partial_scratch([r for grid in (self.p_rows, self.c_rows)
                                         for step in grid for by_v in step for r in by_v],
                                        j_pad, dev)
        self.p_width = [int(a.shape[-1]) for a in part.p_h]
        self.c_width = [int(a.shape[-1]) for a in part.c_h]
        if matrix is not None:
            if tuple(matrix.shape) != (mu_v, mu_s, n_loc, j_loc):
                raise ValueError(f"matrix grid {tuple(matrix.shape)} is not "
                                 f"{(mu_v, mu_s, n_loc, j_loc)}")
            self.fresh = None
            self.m = torch.full((mu_v, mu_s, n_loc, j_pad), VISITED, dtype=torch.int8,
                                device=dev)
            self.m[..., :j_loc] = matrix   # a copy: the caller's tensor is never written
            return
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

    def _sweep(self, merge, rows, widths, steps, *, read_dirty=None, counts=None):
        """One Jacobi sweep of ``merge`` over the buckets of ``steps``, only
        those whose read shard ``(v + kk) % mu_v`` is in ``read_dirty`` when
        it is given; the merges write a copy of the grid and read the grid.
        With ``counts`` (the buckets' real edges) and a profiler set, each
        merge is timed. Returns the merges' changed flags, the vertex shard
        of each, and the timer (None when nothing is timed)."""
        p = self.part
        timer = (_MergeTimer(self.profiler, self.device)
                 if counts is not None and self.profiler is not None else None)
        out = self.m.clone()
        flags, owners = [], []
        for v in range(p.mu_v):
            for s in range(p.mu_s):
                for kk in steps:
                    r = (v + kk) % p.mu_v
                    if not widths[kk] or (read_dirty is not None and r not in read_dirty):
                        continue
                    if timer is not None:
                        timer.start()
                    flags.append(merge(out[v, s], self.m[r, s], rows[kk][v][s], self.x[s],
                                       variant=self.variant, partial=self.partial))
                    if timer is not None:
                        timer.stop(v, kk, shardprof.bucket_bytes(counts[v, s, kk], p.j_loc))
                    owners.append(v)
        self.m = out
        return flags, owners, timer

    def _ring(self, merge, rows, widths, steps, counts=None) -> bool:
        """One sweep (``_sweep``); True when a register changed. One host
        read of the flags, after which the merges' timings are folded in."""
        flags, _, timer = self._sweep(merge, rows, widths, steps, counts=counts)
        changed = bool(torch.cat(flags).any().item()) if flags else False
        if timer is not None:
            timer.finish()
        return changed

    def sweep_local(self) -> bool:
        """One comm-free propagate sweep: the kk = 0 buckets only."""
        return self._ring(ops.bucket_propagate, self.p_rows, self.p_width, (0,))

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
                          range(self.part.mu_v), counts=self.part.p_counts)

    def sweep_propagate_restricted(self, read_dirty) -> set:
        """One propagate sweep over only the buckets whose read shard is in
        ``read_dirty``; returns the vertex shards whose rows changed (the
        next sweep's dirty set), from the merges' flags summed per shard
        and read once. From a sound lower bound of the fixpoint, changes
        start only at rows a dirty shard feeds, so the buckets that read
        clean shards would change nothing. No comm-free prologue runs."""
        read_dirty = {int(v) for v in read_dirty}
        flags, owners, _ = self._sweep(ops.bucket_propagate, self.p_rows, self.p_width,
                                       range(self.part.mu_v), read_dirty=read_dirty)
        if not flags:
            return set()
        per_v = torch.zeros(self.part.mu_v, dtype=torch.int32, device=self.device)
        per_v.index_add_(0, torch.tensor(owners, device=self.device), torch.cat(flags))
        return {v for v, c in enumerate(per_v.tolist()) if c}

    def sweep_cascade(self) -> bool:
        return self._ring(ops.bucket_cascade, self.c_rows, self.c_width,
                          range(self.part.mu_v), counts=self.part.c_counts)

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
        if self.fresh is None:
            raise RuntimeError("refill() needs a state started from the fill")
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
             plan: Optional[PartitionPlan] = None, method: str = "fasst") -> Partition2D:
    """Sample sets (``method``: the sample partition, ``fasst`` or
    ``naive``), plan (unless given) and buckets on ``device``, in the spans
    ``serial.sample_sets``, ``serial.plan`` and ``serial.buckets``, whose
    durations go into ``stats`` (``sample_s``, ``plan_s``, ``buckets_s``)."""
    with trace.span("serial.sample_sets", phase="plan", mu_s=mu_s, timed=True) as sample:
        sampled = sample_edge_sets(g, x, mu_s, seed=cfg.seed, model=cfg.model,
                                   method=method, device=device)
        synchronize(device)
    with trace.span("serial.plan", phase="plan", strategy=strategy, timed=True) as planned:
        if plan is None:
            plan = plan_partition(g, mu_v, mu_s=mu_s, strategy=strategy, seed=cfg.seed,
                                  model=cfg.model, sampled=sampled)
    with trace.span("serial.buckets", phase="plan", mu_v=mu_v, mu_s=mu_s,
                    timed=True) as buckets:
        part = build_partition_2d(g, x, mu_v, mu_s, seed=cfg.seed, model=cfg.model,
                                  plan=plan, pad_mode=pad_mode, sampled=sampled)
        synchronize(device)
    stats.update(sample_s=sample.duration_s, plan_s=planned.duration_s,
                 buckets_s=buckets.duration_s)
    return part


def _build_profiler(st: _RingState, part: Partition2D, phase: str) -> None:
    """Give a build's ring state its shard profiler, when capture is on."""
    if shardprof.enabled():
        st.profiler = shardprof.profile_for_partition(part, backend="serial", phase=phase)


def _publish_profile(st: _RingState, part: Partition2D, sp) -> None:
    """Publish the build's measured profile against the plan's prediction
    and attribute its bandwidth to the span ``sp``, whose duration is the
    profile's wall time; the null span (tracing off and not ``timed``)
    reports 0.0 seconds, and the profiler's own clock is used then."""
    if st.profiler is None:
        return
    prof = shardprof.publish(st.profiler.finish(sp.duration_s or None),
                             predicted=part.plan.predicted if part.plan else None)
    roofline.annotate_bandwidth(sp, int(prof.step_bytes.sum()), prof.wall_s)
    st.profiler = None   # the rounds reuse the state; the profile is the build's


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
    rounds_s, each its span's duration, ending in a device sync), of the
    rounds visited_s, cascade_s and rebuild_s (the visited counts, the
    cascade fixpoints, the lazy rebuilds), and the sweep counts. ``plan``
    replaces the ``strategy``'s planning with a precomputed plan. The sort runs on
    the job's device in ``serial.sort_by_dst`` (``on=``, ``bytes=``), the
    partition in ``serial.sample_sets``,
    ``serial.plan`` and ``serial.buckets``, the ring state (work lists,
    fill) is made in ``serial.ring_state`` (the port's spans), the build
    runs in ``serial.build_fixpoint``, the rounds in ``serial.seed_rounds``
    and each round in ``serial.round`` (with ``serial.select``,
    ``serial.cascade_fixpoint`` (``seed=``, ``sweeps=``),
    ``serial.visited_count`` and ``serial.rebuild`` (``fill=1``,
    ``sweeps=``) inside)."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    with trace.span("serial.sort_by_dst", phase="plan", n=g.n, timed=True) as sort:
        sort.annotate(on=dev.type, bytes=g.dst_sort_bytes(dev))
        g = g.sorted_by_dst(dev)
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
    x = np.asarray(x, dtype=np.uint32)
    stats: dict = {"sort_s": sort.duration_s}
    part = _prepare(g, x, cfg, mu_v=mu_v, mu_s=mu_s, strategy=strategy, plan=plan,
                    pad_mode=pad_mode, device=dev, stats=stats)
    with trace.span("serial.ring_state", phase="build", mu_v=mu_v, mu_s=mu_s,
                    timed=True) as state:
        st = _RingState(part, g, cfg, local_sweeps=local_sweeps, fuse_sweeps=fuse_sweeps,
                        lane_fill=lane_fill)
        state.sync(st.m)
    _build_profiler(st, part, "fixpoint")
    total_regs = part.mu_s * part.j_loc
    with trace.span("serial.build_fixpoint", phase="fixpoint", mu_v=mu_v,
                    mu_s=mu_s, timed=True) as build:
        build_iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
        build.sync(st.m)
        build.annotate(iters=build_iters)
    _publish_profile(st, part, build)

    f32 = np.float32
    seeds = np.zeros(k, dtype=np.int32)
    gains = np.zeros(k, dtype=f32)
    scores = np.zeros(k, dtype=f32)
    rebuilds = np.zeros(k, dtype=bool)
    oldscore = f32(0.0)
    stats.update(cascade_sweeps=0, rebuild_sweeps=0, visited_s=0.0, cascade_s=0.0,
                 rebuild_s=0.0)
    with trace.span("serial.seed_rounds", phase="select", k=k, timed=True) as rounds:
        for i in range(k):
            with trace.span("serial.round", phase="select", round=i) as rsp:
                with trace.span("serial.select", round=i):
                    s_v, gain = st.select(total_regs, part.n_pad)
                    st.commit(s_v)
                # the two fixpoints end in their last sweep's flag read, which
                # is their sync: timing them adds none
                with trace.span("serial.cascade_fixpoint", phase="ring", round=i,
                                timed=True) as csp:
                    it = st.fixpoint(st.sweep_cascade, cfg.max_cascade_iters)
                    csp.annotate(seed=s_v, sweeps=it)
                stats["cascade_sweeps"] += it
                stats["cascade_s"] += csp.duration_s
                with trace.span("serial.visited_count", round=i, timed=True) as vsp:
                    visited = st.visited_count()
                stats["visited_s"] += vsp.duration_s
                new_score = f32(visited) / f32(total_regs)
                rel = (new_score - oldscore) / np.maximum(new_score, f32(1e-9))
                do_rebuild = bool(rel > f32(cfg.rebuild_threshold))
                if do_rebuild:
                    with trace.span("serial.rebuild", phase="build", round=i,
                                    timed=True) as bsp:
                        st.refill()
                        it = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
                        bsp.annotate(fill=1, sweeps=it)
                    stats["rebuild_sweeps"] += it
                    stats["rebuild_s"] += bsp.duration_s
                    oldscore = new_score
                rsp.annotate(seed=s_v, rebuild=do_rebuild)
            seeds[i], gains[i], scores[i], rebuilds[i] = s_v, gain, new_score, do_rebuild
        synchronize(dev)
    stats.update(state_s=state.duration_s, build_s=build.duration_s,
                 rounds_s=rounds.duration_s)
    res = InfluenceResult(seeds=seeds, est_gains=gains, scores=scores, rebuilds=rebuilds,
                          propagate_iters=build_iters, x=np.sort(x), stats=stats)
    return res, part


def build_matrix_ring_serial(g: Graph, config: Optional[DiFuserConfig] = None,
                             x: Optional[np.ndarray] = None, *, mu_v: int = 2,
                             mu_s: int = 1, strategy: str = "block",
                             plan: Optional[PartitionPlan] = None, pad_mode: str = "step",
                             reg_offset: int = 0, local_sweeps: int = 0,
                             fuse_sweeps: bool = False, lane_fill: int = 0, device=None):
    """Alg. 4 lines 3-6 on the serial ring: fill + propagate to a fixpoint,
    in a ``serial.build_matrix`` span. Expects ``g`` sorted by destination
    and ``x`` sorted. Returns ``(matrix int8[g.n_pad, len(x)], iters,
    Partition2D)`` with the matrix in the single-device layout, equal to
    ``core.difuser.build_sketch_matrix``'s with the same ``reg_offset``."""
    cfg = config or DiFuserConfig()
    dev = resolve_device(device)
    if x is None:
        x = np.sort(make_x_vector(cfg.num_registers, seed=cfg.seed))
    x = np.asarray(x, dtype=np.uint32)
    part = _prepare(g, x, cfg, mu_v=mu_v, mu_s=mu_s, strategy=strategy, plan=plan,
                    pad_mode=pad_mode, device=dev, stats={})
    with trace.span("serial.build_matrix", phase="build", mu_v=mu_v, mu_s=mu_s,
                    reg_offset=reg_offset) as sp:
        st = _RingState(part, g, cfg, reg_offset=reg_offset, local_sweeps=local_sweeps,
                        fuse_sweeps=fuse_sweeps, lane_fill=lane_fill)
        _build_profiler(st, part, "build")
        iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
        sp.sync(st.m)
        sp.annotate(iters=iters)
    _publish_profile(st, part, sp)
    return st.canonical_matrix(g.n_pad), iters, part


def repair_plan_shards(g: Graph, config: DiFuserConfig, x: np.ndarray,
                       planned_m: torch.Tensor, plan: PartitionPlan, touched, *,
                       pad_mode: str = "step"):
    """Shard-restricted monotone insertion repair on the serial ring, on the
    device of ``planned_m``.

    ``planned_m`` is the pre-delta matrix in the plan's row order
    (``StoreEntry.planned_matrix()``, all banks' columns), a sound lower
    bound of the post-delta fixpoint; ``g`` is the post-delta graph, sorted
    by destination; ``x`` the entry's sorted x; ``touched`` the vertex
    shards the delta's endpoints land in (``DeltaReport.plan_shards_touched``).

    The first sweep merges only the buckets that read a touched shard, and
    each later one only those that read a shard the sweep before changed,
    so a localized delta sweeps its own shards alone. Returns
    ``(planned_matrix, sweeps, shards_swept)``; the matrix is a new tensor,
    byte-equal to a full rebuild (a max-merge fixpoint above a sound lower
    bound is unique).
    """
    x = np.asarray(x, dtype=np.uint32)
    part = build_partition_2d(g, x, plan.mu_v, plan.mu_s, seed=config.seed,
                              model=config.model, plan=plan, pad_mode=pad_mode,
                              device=planned_m.device)
    grid = planned_m.reshape(plan.mu_v, plan.n_loc, part.mu_s, part.j_loc).permute(0, 2, 1, 3)
    with trace.span("serial.ring_state", phase="repair", mu_v=plan.mu_v,
                    mu_s=part.mu_s) as sp:
        st = _RingState(part, g, config, matrix=grid)
        sp.sync(st.m)
    dirty = {int(v) for v in touched}
    sweeps = 0
    swept: set = set()
    with trace.span("serial.repair", phase="repair", touched=len(dirty)) as sp:
        while dirty and sweeps < config.max_propagate_iters:
            swept |= dirty
            with trace.span("serial.repair_sweep", dirty=len(dirty), sweep=sweeps,
                            shards=tuple(sorted(dirty))) as ssp:
                dirty = st.sweep_propagate_restricted(dirty)
                ssp.sync(st.m)
            sweeps += 1
        sp.annotate(sweeps=sweeps, shards_swept=len(swept))
    planned = st.m[..., :part.j_loc].permute(0, 2, 1, 3).reshape(
        plan.mu_v * plan.n_loc, part.mu_s * part.j_loc)
    return planned, sweeps, tuple(sorted(swept))
