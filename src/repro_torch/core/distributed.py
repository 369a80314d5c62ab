"""Distributed DiFuseR (paper §4, the 2-D schedule) on a process mesh.

Counterpart of the reference's ``core/distributed.py``, whose one
``shard_map`` program becomes one process per ``(vertex, sim)`` shard of a
``launch.mesh.ProcessMesh``. Registers are split over the sim shards and
vertices over the vertex shards; each rank holds one ``(n_loc, j_loc)``
register block and the buckets of its own shard, and fills only the rows
it owns, hashed by their original vertex ids (``sketch_fill``'s row-id
operand). Propagation reads remote registers, so a sweep walks the vertex
ring: at step kk the rank merges the bucket whose reads live in the block it
holds, then passes that block on.

How the reference's collectives map onto ``torch.distributed`` (each is a
method of the mesh's ``Exchange``, timed and spanned there):

* ``ppermute`` of the ring block: a send to ``(v - 1) % mu_v`` and a receive
  from ``(v + 1) % mu_v`` (same s, ``batch_isend_irecv``), into the other of
  two ring buffers;
* the ``allgather`` schedule's ``all_gather`` of the blocks: ``all_gather``
  over the vertex group;
* the fixpoints' ``psum`` of the changed flags: one int ``all_reduce(MAX)``
  over the grid, read once a sweep on the host, as the serial ring reads
  its flags;
* the ``psum`` of the selection statistics over the sim axes: the
  exchange's ``ordered_sum`` of each rank's ``(2, n_loc)`` float32 sums in
  the sim group, a reduce-scatter and an all-gather that add in shard order
  ``s = 0..mu_s-1`` (the serial ring's order; float32 addition is not
  associative, and a near-tie follows the order), moving an all-reduce's
  bytes;
* the argmax's ``all_gather`` of each vertex shard's best and seed: one
  gather of (best, seed) pairs over the vertex group, then the minimum
  original id among the equal bests;
* the ``psum`` of the visited count: an int64 ``all_reduce(SUM)``;
* ``out_specs=P(vertex_axis, sim_spec)`` of the build: an ``all_gather`` of
  the blocks over the grid, reassembled and put through ``plan.perm`` as the
  serial ring's ``canonical_matrix`` does.

The merges are the serial ring's (``partition/serial.py``): ``bucket_propagate``
and ``bucket_cascade`` on work lists cut by ``_shard_rows``, ``fused_sweep``
for the fused prologue, ``sketch_fill`` and ``cardinality_stats``. Each rank
prepares only its own ``(v, s)`` shard (``partition.shard.build_shard_2d``):
the sample sets a chunk of edges at a time through ``fused_sample``, the
same deterministic counts and plan on every rank with no exchange, and the
work lists of its own buckets; the partition it returns keeps every
shard's counts and shape-only (``meta``) bucket tensors, so its stats stay
whole.

Device-resident serving runs two more mesh programs on a ``(mu_v, 1)``
serving mesh whose ranks hold their plan-order row block of a placed store
entry (``service.store.StoreEntry.place_on_mesh``):

* ``find_seeds_warm_distributed``: the K seed rounds straight off the
  placed block (no fill, no build fixpoint; a rebuild during the rounds
  still refills from the fill of the rank's rows), in a ``mesh.warm_rounds``
  span, ``propagate_iters=0``;
* ``repair_plan_shards_distributed``: the shard-restricted insertion
  repair, in a ``mesh.repair`` span. A sweep merges ring step kk's bucket
  only where the block's owner ``(v + kk) % mu_v`` is dirty; its changed
  flag is OR-ed over the sim group and all-gathered over the vertex group
  into the next sweep's dirty vector; it stops when nothing is dirty or at
  ``max_propagate_iters``. The new block stays on its rank.

Both take their rank's ``_rank_partition`` of the plan (the costly host
step); the serving world's operations (the ``_op_*`` bodies at the end of
this module) cache it on each rank against the content of the entry's
version (its graph's fingerprint, the plan, x and the setting), as the
reference caches it against the version.

Two behaviours follow the reference's mesh and not its serial ring:

* the selection sums ``2^-M`` (``cardinality_stats``) for both estimators,
  which ``fm_mean`` then reads as a sum of M, as the single path does;
* ``fasst=False`` takes the naive sample partition and returns x unsorted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import sketch
from repro_torch.core.difuser import DiFuserConfig, InfluenceResult
from repro_torch.core.sampling import make_x_vector
from repro_torch.core.sketch import VISITED, blank_matrix, pad_x, padded_regs
from repro_torch.device import synchronize
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.obs import shardprof, trace
from repro_torch.partition.builder import Partition2D
from repro_torch.partition.serial import _partial_scratch, _RingState, _visited_per_row
from repro_torch.partition.shard import build_shard_2d
from repro_torch.utils import roofline


@dataclasses.dataclass(frozen=True)
class DistributedConfig(DiFuserConfig):
    vertex_axis: str = "data"
    sim_axes: tuple = ("model",)
    schedule: str = "ring"          # "ring" | "allgather"
    fasst: bool = True              # False -> naive sample partition
    local_sweeps: int = 0           # extra comm-free sweeps per exchange
    fuse_sweeps: bool = False       # fused local-sweep prologue (fused_sweep)
    lane_fill: int = 0              # passed on to fused_sweep
    partition: str = "block"        # vertex-assignment strategy (partition.plan)
    pad_mode: str = "step"          # "step" | "global" bucket padding


def _publish_mesh_profile(part: Partition2D, *, phase: str, sweeps: int, wall_s: float,
                          span) -> None:
    """The mesh's measured profile: each (shard, ring step) bucket's bytes
    (off the partition's counts, times the sweeps the fixpoint ran) and the
    wall time, ``per_step_timed=False`` as in the reference; each rank
    publishes it to its own registry."""
    if not shardprof.enabled():
        return
    prof = shardprof.profile_for_partition(part, backend="mesh", phase=phase)
    prof.add_partition_bytes(np.asarray(part.p_counts), part.j_loc, sweeps)
    predicted = part.plan.predicted if part.plan is not None else None
    mp = shardprof.publish(prof.finish(wall_s), predicted=predicted)
    roofline.annotate_bandwidth(span, int(mp.step_bytes.sum()), wall_s)


class _RankState:
    """One rank's register block and the sweeps of the mesh program.

    ``m``, ``fresh``, ``x`` and ``partial`` are ``padded_regs(j_loc)`` wide,
    as in the serial ring. ``reg_offset`` offsets the register hash slots
    (bank b of a split sample space)."""

    def __init__(self, part: Partition2D, g: Graph, cfg: DistributedConfig, mesh, *,
                 rows: tuple, reg_offset: int = 0, block: Optional[torch.Tensor] = None,
                 fill: bool = True):
        """``rows``: this rank's ``(p_rows, c_rows)`` work lists
        (``_rank_partition``); ``part``'s buckets may be shape-only.
        ``block``: this rank's ``(n_loc, j_loc)`` registers to start from (a
        warm start or a repair), copied, so the caller's tensor is never
        written; else the fill. ``fill=False`` skips the fill (``refill``
        then refuses)."""
        self.part, self.cfg, self.mesh = part, cfg, mesh
        self.variant = resolve_model(cfg.model).variant
        v, s = mesh.coord
        dev = self.device = mesh.device
        j_loc = part.j_loc
        self.owned = torch.from_numpy(part.owned_ids[v].astype(np.int64)).to(dev)
        self.valid = self.owned < g.n
        self.x = pad_x(torch.from_numpy(np.ascontiguousarray(
            part.x_shards[s], dtype=np.uint32).view(np.int32)).to(dev), j_loc)
        self.p_rows, self.c_rows = rows
        self.partial = _partial_scratch(self.p_rows + self.c_rows, padded_regs(j_loc), dev)
        self.p_width = [int(a.shape[-1]) for a in part.p_h]
        self.c_width = [int(a.shape[-1]) for a in part.c_h]
        self.fresh = None
        if fill:
            # the rows this rank owns, hashed by their original ids at its sim
            # shard's register slots; no n_pad-row matrix exists on a rank
            self.fresh = ops.sketch_fill(blank_matrix(part.n_loc, j_loc, dev), ids=self.owned,
                                         reg_offset=reg_offset + s * j_loc, seed=cfg.seed)
        if block is not None:
            if tuple(block.shape) != (part.n_loc, j_loc):
                raise ValueError(f"block {tuple(block.shape)} is not "
                                 f"{(part.n_loc, j_loc)}")
            self.m = torch.full((part.n_loc, padded_regs(j_loc)), VISITED,
                                dtype=torch.int8, device=dev)
            self.m[:, :j_loc] = block
        else:
            self.m = torch.where(self.valid[:, None], self.fresh,
                                 torch.full((), VISITED, dtype=torch.int8, device=dev))
        self.ring = [torch.empty_like(self.m), torch.empty_like(self.m)]

    # -- sweeps ------------------------------------------------------------

    def _sweep(self, merge, rows, widths, steps) -> list:
        """One Jacobi sweep of ``merge`` over the ring steps ``steps`` (all of
        them, or only 0 for a comm-free sweep): merges write a copy of the
        block and read the block of step kk. Returns the merges' flags."""
        mesh, part = self.mesh, self.part
        mu_v, (v, s) = part.mu_v, mesh.coord
        out = self.m.clone()
        flags = []
        if self.cfg.schedule == "allgather" and mu_v > 1 and len(steps) > 1:
            blocks = mesh.exchange.all_gather(self.m, mesh.vertex_group, mu_v)
            for kk in steps:
                if widths[kk]:
                    flags.append(merge(out, blocks[(v + kk) % mu_v], rows[kk], self.x,
                                       variant=self.variant, partial=self.partial))
        else:
            block = self.m
            for i, kk in enumerate(steps):
                if widths[kk]:
                    flags.append(merge(out, block, rows[kk], self.x,
                                       variant=self.variant, partial=self.partial))
                if i + 1 < len(steps):
                    block = mesh.exchange.ring_shift(
                        block, self.ring[i % 2],
                        send_to=mesh.rank_of((v - 1) % mu_v, s),
                        recv_from=mesh.rank_of((v + 1) % mu_v, s))
        self.m = out
        return flags

    def _changed(self, flags) -> bool:
        """Whether any rank's sweep changed a register: one ``all_reduce``."""
        local = int(torch.cat(flags).any().item()) if flags else 0
        return self.mesh.exchange.all_reduce(local, dist.ReduceOp.MAX,
                                             self.mesh.grid_group) > 0

    def sweep_local(self) -> bool:
        """One comm-free propagate sweep (the kk = 0 bucket); True when this
        rank's block changed."""
        flags = self._sweep(ops.bucket_propagate, self.p_rows, self.p_width, (0,))
        return bool(torch.cat(flags).any().item()) if flags else False

    def sweep_propagate(self) -> bool:
        if self.cfg.fuse_sweeps and self.cfg.local_sweeps:
            if self.p_width[0]:
                self.m = ops.fused_sweep(self.m, self.p_rows[0], self.x,
                                         variant=self.variant,
                                         num_sweeps=self.cfg.local_sweeps,
                                         lane_fill=self.cfg.lane_fill)
        else:
            for _ in range(self.cfg.local_sweeps):
                if not self.sweep_local():
                    break
        return self._changed(self._sweep(ops.bucket_propagate, self.p_rows, self.p_width,
                                         range(self.part.mu_v)))

    def sweep_cascade(self) -> bool:
        return self._changed(self._sweep(ops.bucket_cascade, self.c_rows, self.c_width,
                                         range(self.part.mu_v)))

    def sweep_restricted(self, dirty) -> list:
        """One ring sweep of propagate merges, step kk's applied only where
        the block's owner ``(v + kk) % mu_v`` is dirty (the block moves on
        either way, as the reference's ``ppermute`` does). Returns the next
        sweep's dirty vector: each vertex shard's changed flag, OR-ed over
        its sim group and all-gathered over the vertex group."""
        mesh, part = self.mesh, self.part
        mu_v, (v, s) = part.mu_v, mesh.coord
        out = self.m.clone()
        flags = []
        block = self.m
        for kk in range(mu_v):
            if self.p_width[kk] and dirty[(v + kk) % mu_v]:
                flags.append(ops.bucket_propagate(out, block, self.p_rows[kk], self.x,
                                                  variant=self.variant,
                                                  partial=self.partial))
            if kk + 1 < mu_v:
                block = mesh.exchange.ring_shift(
                    block, self.ring[kk % 2], send_to=mesh.rank_of((v - 1) % mu_v, s),
                    recv_from=mesh.rank_of((v + 1) % mu_v, s))
        self.m = out
        changed = int(torch.cat(flags).any().item()) if flags else 0
        if part.mu_s > 1:
            changed = mesh.exchange.all_reduce(changed, dist.ReduceOp.MAX, mesh.sim_group)
        got = mesh.exchange.all_gather(torch.tensor([changed], dtype=torch.int8,
                                                    device=self.device),
                                       mesh.vertex_group, mu_v)
        return [bool(f) for f in got.reshape(-1).tolist()]

    fixpoint = staticmethod(_RingState.fixpoint)

    # -- the round's steps ---------------------------------------------------

    def _argmax_pairs(self, total_regs: int) -> torch.Tensor:
        """Every vertex shard's (best estimate, its minimum original id) as
        float64 pairs, ``(mu_v, 2)`` on this rank's device."""
        mesh, part = self.mesh, self.part
        # the psum over the sim shards, added in shard order
        stat = mesh.exchange.ordered_sum(ops.cardinality_stats(self.m), mesh.sim_group,
                                         part.mu_s)
        est = sketch.estimate_from_sums(stat, total_regs, estimator=self.cfg.estimator)
        est = torch.where(self.valid, est, torch.full((), -1.0, dtype=torch.float32,
                                                      device=self.device))
        best = est.max()
        seed = torch.where(est == best, self.owned, part.n_pad).min()
        # float64 holds a float32 and an int32 id exactly
        pair = torch.stack([best.to(torch.float64), seed.to(torch.float64)])
        return mesh.exchange.all_gather(pair, mesh.vertex_group, part.mu_v)

    def select(self, total_regs: int):
        """The grid's minimum-original-id argmax: ``(seed vertex, gain)``."""
        pairs = self._argmax_pairs(total_regs).cpu()
        bests = pairs[:, 0].to(torch.float32)
        gain = bests.max()
        s_global = int(torch.where(bests == gain, pairs[:, 1],
                                   float(self.part.n_pad)).min().item())
        return s_global, np.float32(gain.item())

    def commit(self, seed_v: int) -> None:
        self.m[self.owned == seed_v] = VISITED

    def visited_count(self) -> int:
        blk = self.m[:, :self.part.j_loc]
        local = int(_visited_per_row(blk)[self.valid].sum().item())
        return self.mesh.exchange.all_reduce(local, dist.ReduceOp.SUM,
                                             self.mesh.grid_group)

    def refill(self) -> None:
        if self.fresh is None:
            raise RuntimeError("refill() needs a state made with the fill")
        self.m = torch.where(self.m == VISITED, self.m, self.fresh)

    def gather_matrix(self, n_pad: int) -> torch.Tensor:
        """Every rank's block, in the single-device layout ``int8[n_pad,
        mu_s * j_loc]`` (rows in original-id order), on every rank."""
        mesh, p = self.mesh, self.part
        blk = self.m[:, :p.j_loc].contiguous()
        blocks = mesh.exchange.all_gather(blk, mesh.grid_group, mesh.size)
        planned = blocks.reshape(p.mu_v, p.mu_s, p.n_loc, p.j_loc).permute(0, 2, 1, 3)
        planned = planned.reshape(p.mu_v * p.n_loc, p.mu_s * p.j_loc)
        perm = torch.from_numpy(p.plan.perm[:n_pad].astype(np.int64)).to(self.device)
        return planned.index_select(0, perm)


def _grid(mesh, cfg: DistributedConfig):
    if mesh.axis_names[0] != cfg.vertex_axis or tuple(mesh.axis_names[1:]) != tuple(
            cfg.sim_axes):
        raise ValueError(f"mesh axes {mesh.axis_names} are not ({cfg.vertex_axis!r}, "
                         f"*{tuple(cfg.sim_axes)})")
    return mesh.mu_v, mesh.mu_s


def _rank_partition(g: Graph, mesh, cfg: DistributedConfig, x: np.ndarray, plan,
                    stats: Optional[dict] = None) -> tuple:
    """This rank's prep: ``(partition with shape-only buckets, its (p_rows,
    c_rows) work lists)`` of ``build_shard_2d`` at the mesh's coordinate,
    on its device; ``plan=None`` plans with ``cfg.partition``. ``stats``
    gets the prep's host seconds."""
    mu_v, mu_s = _grid(mesh, cfg)
    if plan is not None and plan.mu_v != mu_v:
        raise ValueError(f"plan has mu_v={plan.mu_v} but the mesh's {cfg.vertex_axis!r} "
                         f"axis is {mu_v}-way")
    v, s = mesh.coord
    return build_shard_2d(g, np.asarray(x, dtype=np.uint32), mu_v, mu_s, v, s,
                          seed=cfg.seed, model=cfg.model,
                          method="fasst" if cfg.fasst else "naive",
                          strategy=cfg.partition, plan=plan, pad_mode=cfg.pad_mode,
                          device=mesh.device, stats=stats)


def _rounds(st: _RankState, k: int, cfg: DistributedConfig, total_regs: int,
            stats: dict) -> tuple:
    """Alg. 4's K seed rounds on the rank state: ``(seeds, gains, scores,
    rebuilds)``, the same on every rank; adds the sweep counts to ``stats``."""
    f32 = np.float32
    seeds = np.zeros(k, dtype=np.int32)
    gains = np.zeros(k, dtype=f32)
    scores = np.zeros(k, dtype=f32)
    rebuilds = np.zeros(k, dtype=bool)
    stats.update(cascade_sweeps=0, rebuild_sweeps=0)
    oldscore = f32(0.0)
    for i in range(k):
        s_v, gain = st.select(total_regs)
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
    return seeds, gains, scores, rebuilds


def _find_seeds_distributed(g: Graph, k: int, mesh,
                            config: Optional[DistributedConfig] = None,
                            x: Optional[np.ndarray] = None, plan=None):
    """Alg. 4 on the mesh (the ``mesh`` backend's body), on every rank of it.
    Returns ``(InfluenceResult, Partition2D)``, the same on every rank;
    seeds are original vertex ids. ``result.stats`` holds this rank's host
    clock per phase (as the serial ring's), the sweep counts and its
    ``exchange`` summary. Runs in a ``mesh.find_seeds`` span."""
    cfg = config or DistributedConfig()
    dev = mesh.device
    exchanged = dict(mesh.exchange.stats)
    t_sort = time.perf_counter()
    g = g.sorted_by_dst()
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
    x = np.asarray(x, dtype=np.uint32)
    stats: dict = {"sort_s": time.perf_counter() - t_sort}
    part, rows = _rank_partition(g, mesh, cfg, x, plan, stats)
    t0 = time.perf_counter()
    st = _RankState(part, g, cfg, mesh, rows=rows)
    synchronize(dev)
    t1 = time.perf_counter()
    total_regs = part.mu_s * part.j_loc
    with trace.span("mesh.find_seeds", phase="select", k=k, mu_v=part.mu_v,
                    mu_s=part.mu_s, schedule=cfg.schedule) as sp:
        build_iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
        synchronize(dev)
        t2 = time.perf_counter()
        seeds, gains, scores, rebuilds = _rounds(st, k, cfg, total_regs, stats)
        sp.sync(st.m)
    _publish_mesh_profile(part, phase="select", sweeps=build_iters,
                          wall_s=time.perf_counter() - t1, span=sp)
    stats.update(state_s=t1 - t0, build_s=t2 - t1, rounds_s=time.perf_counter() - t2,
                 exchange=mesh.exchange.summary(since=exchanged))
    res = InfluenceResult(seeds=seeds, est_gains=gains, scores=scores, rebuilds=rebuilds,
                          propagate_iters=build_iters,
                          x=np.sort(x) if cfg.fasst else x, stats=stats)
    return res, part


def find_seeds_distributed(g: Graph, k: int, mesh,
                           config: Optional[DistributedConfig] = None,
                           x: Optional[np.ndarray] = None):
    """Deprecated entry point, kept as the reference keeps it: a shim
    through the ``mesh`` backend (prefer ``repro_torch.runtime.run`` with a
    ``RunSpec(backend="mesh")``). Returns ``(InfluenceResult,
    Partition2D)``."""
    import warnings

    from repro_torch.runtime import run
    from repro_torch.runtime.spec import _EXEC_FIELDS, RunSpec

    warnings.warn("repro_torch.core.distributed.find_seeds_distributed is deprecated; "
                  "use repro_torch.runtime.run with RunSpec(backend='mesh')",
                  DeprecationWarning, stacklevel=2)
    cfg = config or DistributedConfig()
    spec = RunSpec.from_config(cfg, backend="mesh", mu_v=mesh.mu_v, mu_s=mesh.mu_s,
                               **{f: getattr(cfg, f) for f in _EXEC_FIELDS})
    report = run(g, k, spec, x=x, mesh=mesh, device=mesh.device.type)
    return report.result, report.partition


def build_matrix_distributed(g: Graph, mesh, config: Optional[DistributedConfig] = None,
                             x: Optional[np.ndarray] = None, *, reg_offset: int = 0,
                             plan=None):
    """Alg. 4 lines 3-6 on the mesh: fill + propagate to a fixpoint, gathered
    back to the canonical layout on every rank, in a ``mesh.build_matrix``
    span. Expects ``g`` sorted by destination and ``x`` canonical (sorted
    when FASST). Returns ``(matrix int8[g.n_pad, len(x)], iters,
    Partition2D)``, equal to the single path's ``build_sketch_matrix`` at the
    same ``reg_offset``."""
    cfg = config or DistributedConfig()
    if x is None:
        x = make_x_vector(cfg.num_registers, seed=cfg.seed)
        if cfg.fasst:
            x = np.sort(x)
    x = np.asarray(x, dtype=np.uint32)
    part, rows = _rank_partition(g, mesh, cfg, x, plan)
    t0 = time.perf_counter()
    with trace.span("mesh.build_matrix", phase="build", mu_v=part.mu_v, mu_s=part.mu_s,
                    reg_offset=reg_offset) as sp:
        st = _RankState(part, g, cfg, mesh, rows=rows, reg_offset=reg_offset)
        iters = st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
        m = sp.sync(st.gather_matrix(g.n_pad))
    _publish_mesh_profile(part, phase="build", sweeps=iters,
                          wall_s=time.perf_counter() - t0, span=sp)
    return m, iters, part



# -- device-resident serving: warm rounds and the shard repair -------------------------

def find_seeds_warm_distributed(g: Graph, k: int, mesh, config: Optional[DistributedConfig],
                                planned_block: torch.Tensor, plan, x: np.ndarray, *,
                                part: Optional[tuple] = None) -> InfluenceResult:
    """Alg. 4's K seed rounds from this rank's block of an already-propagated
    plan-order matrix (``planned_block``: rows ``[v * n_loc, (v + 1) *
    n_loc)`` of ``StoreEntry.planned_matrix()``), on every rank of ``mesh``;
    fill and the build fixpoint are skipped. The round program is the cold
    one's, so the seeds equal ``find_seeds``'s on every backend. ``part``: a
    ``_rank_partition`` of the same (graph, plan, x) made earlier (it is the
    costly host step). ``result.stats`` holds the sweep counts, ``rounds_s``
    and this rank's ``exchange`` summary; ``propagate_iters`` is 0."""
    cfg = config or DistributedConfig()
    x = np.asarray(x, dtype=np.uint32)
    exchanged = dict(mesh.exchange.stats)
    if part is None:
        part = _rank_partition(g, mesh, cfg, x, plan)
    part_meta, rows = part
    stats: dict = {}
    t0 = time.perf_counter()
    with trace.span("mesh.warm_rounds", phase="select", k=k, mu_v=part_meta.mu_v,
                    mu_s=part_meta.mu_s) as sp:
        st = _RankState(part_meta, g, cfg, mesh, rows=rows, block=planned_block)
        seeds, gains, scores, rebuilds = _rounds(st, k, cfg,
                                                 part_meta.mu_s * part_meta.j_loc, stats)
        sp.sync(st.m)
    stats.update(rounds_s=time.perf_counter() - t0,
                 exchange=mesh.exchange.summary(since=exchanged))
    return InfluenceResult(seeds=seeds, est_gains=gains, scores=scores, rebuilds=rebuilds,
                           propagate_iters=0, x=np.sort(x) if cfg.fasst else x, stats=stats)


def repair_plan_shards_distributed(g: Graph, mesh, config: Optional[DistributedConfig],
                                   x: np.ndarray, planned_block: torch.Tensor, plan, touched,
                                   *, part: Optional[tuple] = None):
    """The shard-restricted monotone insertion repair on ``mesh`` (the
    ``mesh`` backend's twin of ``partition.serial.repair_plan_shards``), on
    every rank with its block of the pre-delta plan-order matrix, a sound
    lower bound of the fixpoint of ``g`` (the post-delta graph, sorted by
    destination). ``touched``: the plan shards the delta's endpoints land
    in. Returns ``(planned_block, sweeps, shards_swept)``, the new block a
    new tensor on this rank, byte-equal to the rows of a full rebuild and of
    the serial repair (a max-merge fixpoint above a sound lower bound is
    unique), in a ``mesh.repair`` span."""
    cfg = config or DistributedConfig()
    x = np.asarray(x, dtype=np.uint32)
    if part is None:
        part = _rank_partition(g, mesh, cfg, x, plan)
    part_meta, rows = part
    mu_v = part_meta.mu_v
    dirty = [False] * mu_v
    for v in touched:
        dirty[int(v)] = True
    swept = [False] * mu_v
    sweeps = 0
    with trace.span("mesh.repair", phase="repair", touched=sum(dirty)) as sp:
        st = _RankState(part_meta, g, cfg, mesh, rows=rows, block=planned_block, fill=False)
        while any(dirty) and sweeps < cfg.max_propagate_iters:
            swept = [a or b for a, b in zip(swept, dirty)]
            dirty = st.sweep_restricted(dirty)
            sweeps += 1
        block = sp.sync(st.m[:, :part_meta.j_loc].contiguous())
        sp.annotate(sweeps=sweeps, shards_swept=sum(swept))
    return block, sweeps, tuple(v for v in range(mu_v) if swept[v])


def _part_key(p: dict) -> tuple:
    cfg = p["cfg"]
    x_id = hashlib.blake2b(np.asarray(p["x"], dtype=np.uint32).tobytes(),
                           digest_size=16).hexdigest()
    return ("rank_partition", p["mesh"], p["graph"], p["plan"], x_id, cfg.seed, cfg.model,
            cfg.fasst, cfg.pad_mode)


def _cached_partition(state, p: dict, g: Graph, mesh, plan) -> tuple:
    """The rank partition of the operation's (graph, plan, x, setting),
    from the rank's cache; ``(part, host seconds, cache hit)``."""
    key = _part_key(p)
    hit = key in state.parts
    t0 = time.perf_counter()
    part = state.cached(key, lambda: _rank_partition(g, mesh, p["cfg"], p["x"], plan))
    return part, time.perf_counter() - t0, hit


def _op_warm_rounds(state, p, local):
    mesh = launch_mesh.ProcessMesh.by_key(p["mesh"])
    g, plan = state.graph(p["graph"]), state.plans[p["plan"]]
    part, part_s, hit = _cached_partition(state, p, g, mesh, plan)
    res = find_seeds_warm_distributed(g, p["k"], mesh, p["cfg"], state.blocks[p["hid"]],
                                      plan, p["x"], part=part)
    res.stats.update(partition_s=part_s, partition_cached=hit)
    return res


def _op_repair(state, p, local):
    mesh = launch_mesh.ProcessMesh.by_key(p["mesh"])
    g, plan = state.graph(p["graph"]), state.plans[p["plan"]]
    part, _, _ = _cached_partition(state, p, g, mesh, plan)
    block, sweeps, swept = repair_plan_shards_distributed(
        g, mesh, p["cfg"], p["x"], state.blocks[p["hid"]], plan, p["touched"], part=part)
    state.blocks[p["out"]] = block
    return sweeps, swept
