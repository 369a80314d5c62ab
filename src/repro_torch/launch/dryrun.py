"""Production-scale dry run: trace one rank's mesh program on the ``meta``
device and record what the compiled program would cost, per device, for the
roofline (``utils.roofline.Roofline``).

Counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles its ``shard_map`` program on fake host devices. The port has no
compiler to ask, so it runs the rank program of ``core/distributed.py`` on
``meta`` tensors, which have shapes and no data: ``kernels.ops`` takes each
kernel's shape function (a dry launch, its cost from ``kernels.cost``), the
mesh's ``DryExchange`` sends nothing and records each collective, and a
dispatch mode counts every other op and the live ``meta`` storage. Nothing is
computed, on any machine, so the dry run is not an entry point that defaults
to the card.

The program runs each loop body once, as XLA's cost analysis counts a
``while`` body: the fill; one build propagate sweep; one round (select,
commit, one cascade sweep, the visited count, the refill, one rebuild
propagate sweep). ``DryProgram.scaled`` multiplies each body by a real run's
counts instead. The shapes come from ``IM_CELLS`` and the grid alone; each
bucket has the duplication model's width and a work list at its least (one
item a row, no split row), since the cuts depend on the data.

Usage::

    PYTHONPATH=src python -m repro_torch dryrun           # six records
    PYTHONPATH=src python -m repro_torch dryrun --arch difuser-twitter \\
        --mesh single --schedule allgather

Each record keeps the reference's keys and names. ``compile_s`` is the dry
run's host seconds (nothing is compiled); ``flops`` counts integer
operations (the kernels' from ``kernels.cost``, one per result element of
every other op), ``bytes_accessed`` the kernels' compulsory bytes and every
other op's operand and result bytes; ``memory`` holds the rank's inputs
(``argument_bytes``: its work lists and what it uploads), the peak of the
live ``meta`` storage the program allocates beyond them (``temp_bytes``),
the K rounds' results (``output_bytes``), 0 aliased bytes and the size of
the built kernel libraries of the kernels it launches (``code_bytes``, 0
where none is built).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import Counter
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.distributed import DistributedConfig, _RankState
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import build, counters, ops
from repro_torch.kernels.edges import EdgeRows, WorkList
from repro_torch.launch.mesh import MeshShape, dry_mesh, make_production_mesh
from repro_torch.partition.builder import Partition2D
from repro_torch.partition.serial import _visited_per_row
from repro_torch.utils.collectives import collective_stats

# ---------------------------------------------------------------------------
# DiFuseR IM cells (paper workloads at production scale; shapes only)
# ---------------------------------------------------------------------------

IM_CELLS = {
    # name: (n vertices, edges, J registers, duplication factor estimate)
    "difuser-livejournal": (1 << 23, 1 << 27, 2048, 1.6),
    "difuser-twitter": (1 << 26, 1 << 31, 1024, 1.4),
    "difuser-friendster": (1 << 26, 1 << 31, 2048, 1.4),
}

#: the loop bodies of the rank program, in program order (the round's
#: select, commit and visited count are one body around the cascade's)
BODIES = ("fill", "build", "round", "cascade", "refill", "rebuild")


# ---------------------------------------------------------------------------
# the rank program on meta tensors
# ---------------------------------------------------------------------------

class _DryRankState(_RankState):
    """The rank state without its host reads: the sweeps run as they are,
    and each read of a device value the real program makes on the host (a
    changed flag, the argmax, the visited count) is made on the device and
    not read. The dry exchange's ``all_reduce`` returns 0, so a fixpoint
    stops after one sweep; the seed is vertex 0."""

    def _changed(self, flags) -> bool:
        if flags:
            torch.cat(flags).any()
        return self.mesh.exchange.all_reduce(0, dist.ReduceOp.MAX,
                                             self.mesh.grid_group) > 0

    def sweep_local(self) -> bool:
        flags = self._sweep(ops.bucket_propagate, self.p_rows, self.p_width, (0,))
        if flags:
            torch.cat(flags).any()
        return False

    def select(self, total_regs: int):
        self._argmax_pairs(total_regs)
        return 0, np.float32(0.0)

    def commit(self, seed_v: int) -> None:
        self.m.masked_fill_((self.owned == seed_v)[:, None], VISITED)

    def visited_count(self) -> int:
        per_row = _visited_per_row(self.m[:, :self.part.j_loc])
        torch.where(self.valid, per_row, 0).sum()
        return self.mesh.exchange.all_reduce(0, dist.ReduceOp.SUM, self.mesh.grid_group)


_ALLOCATIONS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _OpCounter(TorchDispatchMode):
    """Counts the rank program's ops on ``meta`` tensors.

    * ``flops``: one per result element of every op but views, allocations
      (``empty``) and uploads; ``op_bytes``: those ops' operand and result
      bytes. The kernels' shape functions allocate their outputs, so a dry
      launch adds nothing here (its cost is ``counters.DRY_*``).
    * ``upload_bytes``: copies from the host onto the device, the rank's
      inputs (``argument_bytes``), as are the storages of ``arguments``.
    * ``live`` and ``peak``: the bytes of every other ``meta`` storage, each
      counted once, from the op that allocates it until its last tensor is
      freed."""

    def __init__(self, arguments):
        super().__init__()
        self.flops = self.op_bytes = self.upload_bytes = 0
        self.live = self.peak = 0
        self._held = list(arguments)      # their storage keys must not be reused
        self._args = {_storage_key(t) for t in self._held}
        self._refs: dict = {}             # storage key -> [bytes, live tensors]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.device.type == "meta"]
        if not outs:
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        metas = [t for t in ins if t.device.type == "meta"]
        if ins and not metas:        # a copy from the host: an upload
            for t in outs:
                self.upload_bytes += t.nbytes
                self._held.append(t)
                self._args.add(_storage_key(t))
            return out
        if not func.is_view and func not in _ALLOCATIONS:
            self.flops += sum(t.numel() for t in outs)
            self.op_bytes += sum(t.nbytes for t in metas + outs)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._args:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ref[0]
            self.peak = max(self.peak, self.live)
        ref[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]


@dataclasses.dataclass
class DryBody:
    """What one run of a loop body does on the rank: dry kernel launches,
    their operations and bytes, the other ops' flops and bytes, and the
    exchange's calls and bytes sent per kind, with its collective records."""

    launches: Counter = dataclasses.field(default_factory=Counter)
    kernel_ops: int = 0
    kernel_bytes: int = 0
    op_flops: int = 0
    op_bytes: int = 0
    exchange: Counter = dataclasses.field(default_factory=Counter)   # kind -> calls
    sent: Counter = dataclasses.field(default_factory=Counter)       # kind -> bytes
    records: list = dataclasses.field(default_factory=list)

    def __add__(self, other: "DryBody") -> "DryBody":
        return DryBody(self.launches + other.launches, self.kernel_ops + other.kernel_ops,
                       self.kernel_bytes + other.kernel_bytes,
                       self.op_flops + other.op_flops, self.op_bytes + other.op_bytes,
                       self.exchange + other.exchange, self.sent + other.sent,
                       self.records + other.records)

    def times(self, n: int) -> "DryBody":
        def mul(c: Counter) -> Counter:
            return Counter({k: v * n for k, v in c.items() if v * n})
        return DryBody(mul(self.launches), self.kernel_ops * n, self.kernel_bytes * n,
                       self.op_flops * n, self.op_bytes * n, mul(self.exchange),
                       mul(self.sent), self.records * n)

    @property
    def flops(self) -> int:
        return self.kernel_ops + self.op_flops

    @property
    def bytes_accessed(self) -> int:
        return self.kernel_bytes + self.op_bytes

    def summary(self) -> dict:
        """``{kind: {"calls", "bytes_sent"}}``, as ``Exchange.summary()``
        without the seconds."""
        return {kind: dict(calls=c, bytes_sent=self.sent[kind])
                for kind, c in sorted(self.exchange.items())}


class _BodyRecorder:
    """Cuts the counts of a dry program into its loop bodies."""

    def __init__(self, mode: _OpCounter, exchange):
        self.mode, self.exchange = mode, exchange
        self.bodies = {name: DryBody() for name in BODIES}

    def _snapshot(self):
        return (Counter(counters.DRY_LAUNCHES), sum(counters.DRY_OPS.values()),
                sum(counters.DRY_BYTES.values()), self.mode.flops, self.mode.op_bytes,
                dict(self.exchange.stats), len(self.exchange.records))

    def run(self, name: str, fn):
        l0, k0, b0, f0, o0, x0, r0 = self._snapshot()
        out = fn()
        l1, k1, b1, f1, o1, x1, _ = self._snapshot()
        calls, sent = Counter(), Counter()
        for kind, (c, nb, _) in x1.items():
            c0, nb0, _ = x0.get(kind, (0, 0, 0.0))
            if c > c0:
                calls[kind], sent[kind] = c - c0, nb - nb0
        self.bodies[name] = self.bodies[name] + DryBody(
            l1 - l0, k1 - k0, b1 - b0, f1 - f0, o1 - o0, calls, sent,
            list(self.exchange.records[r0:]))
        return out


@dataclasses.dataclass
class DryProgram:
    """One rank's dry program: the counts of each loop body (``BODIES``)
    run once, and its memory."""

    bodies: dict
    argument_bytes: int
    temp_bytes: int
    output_bytes: int
    code_bytes: int
    host_s: float

    def total(self) -> DryBody:
        """Each body once: what the record counts."""
        out = DryBody()
        for body in self.bodies.values():
            out = out + body
        return out

    def scaled(self, *, build_sweeps: int, cascade_sweeps: int, rebuild_sweeps: int,
               k: int, rebuilds: int) -> DryBody:
        """The bodies times a real run's counts: its build, cascade and
        rebuild sweeps, K rounds and rebuilds; the fill once."""
        b = self.bodies
        return (b["fill"] + b["build"].times(build_sweeps) + b["round"].times(k)
                + b["cascade"].times(cascade_sweeps) + b["refill"].times(rebuilds)
                + b["rebuild"].times(rebuild_sweeps))

    def for_run(self, result) -> DryBody:
        """``scaled`` by the counts of a real run's ``InfluenceResult``."""
        return self.scaled(build_sweeps=int(result.propagate_iters),
                           cascade_sweeps=int(result.stats["cascade_sweeps"]),
                           rebuild_sweeps=int(result.stats["rebuild_sweeps"]),
                           k=len(result.seeds), rebuilds=int(np.sum(result.rebuilds)))


def _meta_rows(n_loc: int, slots: int) -> EdgeRows:
    """Shape-only rows of a bucket of ``slots`` slots, its work list at its
    least: one item a row, no split row, no partial."""
    def i32(n):
        return torch.empty(n, dtype=torch.int32, device="meta")

    work = WorkList(item_ptr=i32(n_loc + 1), item_row=i32(n_loc), item_slot=i32(n_loc),
                    split_row=i32(0), split_ptr=i32(1), num_partials=0)
    return EdgeRows(rowptr=i32(n_loc + 1), nbr=i32(slots), h=i32(slots), lo=i32(slots),
                    thr=i32(slots), work=work)


def _code_bytes(kernels) -> int:
    """The size of the built libraries (default block shape) of ``kernels``."""
    sources = {build.SIGNATURES[name][0] for name in kernels}
    paths = [build.library_path(src) for src in sorted(sources)]
    return sum(p.stat().st_size for p in paths if p.exists())


def dry_program(part: Partition2D, cfg: DistributedConfig, *, k: int,
                grid: Optional[MeshShape] = None, coord=(0, 0)) -> DryProgram:
    """Run rank ``coord``'s program of ``part`` once on ``meta`` tensors (the
    module doc): its buckets are ``part``'s counts of live slots (each
    bucket's width for a shape-only partition). ``grid`` defaults to ``(mu_v,
    mu_s)`` over ``("data", "model")``."""
    t0 = time.perf_counter()
    grid = grid or MeshShape((part.mu_v, part.mu_s), ("data", "model"))
    mesh = dry_mesh(grid, coord)
    v, s = coord
    rows = tuple([_meta_rows(part.n_loc, int(counts[v, s, kk])) for kk in range(part.mu_v)]
                 for counts in (part.p_counts, part.c_counts))
    arguments = {_storage_key(t): t for grid_rows in rows for r in grid_rows
                 for t in (r.rowptr, r.nbr, r.h, r.lo, r.thr, r.work.item_ptr,
                           r.work.item_row, r.work.item_slot, r.work.split_row,
                           r.work.split_ptr)}
    mode = _OpCounter(arguments.values())
    rec = _BodyRecorder(mode, mesh.exchange)
    total_regs = part.mu_s * part.j_loc
    g = SimpleNamespace(n=part.n)
    with mode:
        st = rec.run("fill", lambda: _DryRankState(part, g, cfg, mesh, rows=rows))
        rec.run("build", st.sweep_propagate)
        seed, _ = rec.run("round", lambda: st.select(total_regs))
        rec.run("round", lambda: st.commit(seed))
        rec.run("cascade", st.sweep_cascade)
        rec.run("round", st.visited_count)
        rec.run("refill", st.refill)
        rec.run("rebuild", st.sweep_propagate)
    launched = {name for body in rec.bodies.values() for name in body.launches}
    return DryProgram(
        bodies=rec.bodies,
        argument_bytes=sum(t.untyped_storage().nbytes() for t in arguments.values())
        + mode.upload_bytes,
        temp_bytes=mode.peak,
        # the K rounds' seeds, gains and scores (4 bytes each), rebuild flags
        output_bytes=k * (4 + 4 + 4 + 1),
        code_bytes=_code_bytes(launched), host_s=time.perf_counter() - t0)


def _shape_partition(name: str, grid: MeshShape) -> Partition2D:
    """The shapes of ``name``'s partition on ``grid``: every bucket of the
    duplication model's width, no data."""
    n, m, j, dup = IM_CELLS[name]
    mu_v, mu_s = grid.mu_v, grid.mu_s
    n_pad = n + ((-n) % mu_v)
    n_loc = n_pad // mu_v
    j_loc = j // mu_s
    bucket = int(np.ceil(m * dup / (mu_v * mu_s * mu_v) / 256) * 256)
    steps = tuple(torch.empty((mu_v, mu_s, bucket), dtype=torch.int32, device="meta")
                  for _ in range(mu_v))
    counts = np.full((mu_v, mu_s, mu_v), bucket, dtype=np.int64)
    return Partition2D(
        n=n, n_pad=n_pad, n_loc=n_loc, j_loc=j_loc, mu_v=mu_v, mu_s=mu_s,
        x_shards=np.zeros((mu_s, j_loc), dtype=np.uint32),
        owned_ids=np.broadcast_to(np.zeros(1, dtype=np.int32), (mu_v, n_loc)),
        p_h=steps, p_w=steps, p_r=steps, p_t=steps, p_l=steps,
        c_h=steps, c_w=steps, c_r=steps, c_t=steps, c_l=steps,
        edge_counts=counts.sum(axis=2), p_counts=counts, c_counts=counts,
        comm_bytes_per_sweep=(mu_v - 1) * n_loc * j_loc)


def _tuned_knobs(name: str, tuning: str) -> dict:
    """Cached winners for a cell's edge bucket, the knobs that survive a
    shapes-only run: the ``bucket_propagate`` winner's ``local_sweeps`` and
    the ``fused_sweep`` winner's ``fuse_sweeps``. The port's cache keys carry
    the device type; the dry run reads the ``"cuda"`` winners. ``"auto"``
    cannot measure here (there is no graph), so both non-off modes read the
    cache and keep the defaults (0, unfused) on a miss."""
    knobs = {"local_sweeps": 0, "fuse_sweeps": False}
    if tuning == "off":
        return knobs
    from repro_torch.tune import cache_key, default_cache

    _, m, _, _ = IM_CELLS[name]
    cache = default_cache()
    cfg = cache.lookup(cache_key("bucket_propagate", backend="mesh", impl="cuda",
                                 model="wc", num_edges=int(m)))
    if cfg is not None:
        knobs["local_sweeps"] = int(cfg.local_sweeps)
    fused = cache.lookup(cache_key("fused_sweep", backend="mesh", impl="cuda", model="wc",
                                   num_edges=int(m)))
    if fused is not None:
        knobs["fuse_sweeps"] = bool(fused.fuse_sweeps)
    return knobs


def lower_im_cell(name: str, grid: MeshShape, *, k: int = 4, schedule: str = "ring",
                  local_sweeps: int = 0, fuse_sweeps: bool = False):
    """Run the distributed Alg. 4 program of cell ``name`` on ``grid`` dry
    (shapes only; bucket widths from the duplication model). Returns
    ``(DryProgram, Partition2D)``; the partition is shape-only."""
    part = _shape_partition(name, grid)
    cfg = DistributedConfig(
        num_registers=IM_CELLS[name][2], estimator="hll", rebuild_threshold=0.01,
        max_propagate_iters=24, max_cascade_iters=24, seed=0,
        vertex_axis=grid.vertex_axis, sim_axes=grid.sim_axes, schedule=schedule,
        local_sweeps=local_sweeps, fuse_sweeps=fuse_sweeps)
    return dry_program(part, cfg, k=k, grid=grid), part


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cell_metrics(prog: DryProgram) -> dict:
    total = prog.total()
    coll = collective_stats(total.records)
    return {"flops": float(total.flops), "bytes_accessed": float(total.bytes_accessed),
            "wire_bytes": coll.wire_bytes, "coll": coll}


def run_cell(name, grid, mesh_name, *, out_dir=None, tag="", schedule="ring",
             local_sweeps=0, fuse_sweeps=False):
    """Run one IM cell dry, recording its cost, memory and collectives."""
    from repro_torch.obs import trace

    t0 = time.time()
    rec = {"arch": name, "shape": "im_step", "mesh": mesh_name, "ok": False}
    try:
        with trace.span("dryrun.cell", phase="plan", arch=name, mesh=mesh_name,
                        schedule=schedule):
            prog, _ = lower_im_cell(name, grid, schedule=schedule,
                                    local_sweeps=local_sweeps, fuse_sweeps=fuse_sweeps)
            m = _cell_metrics(prog)
        rec.update(
            ok=True,
            compile_s=round(time.time() - t0, 3),
            flops=m["flops"],
            bytes_accessed=m["bytes_accessed"],
            wire_bytes=m["wire_bytes"],
            memory={
                "argument_bytes": prog.argument_bytes,
                "output_bytes": prog.output_bytes,
                "temp_bytes": prog.temp_bytes,
                "alias_bytes": 0,
                "code_bytes": prog.code_bytes,
            },
            collectives=m["coll"].to_dict(),
            chips=grid.size,
        )
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = os.path.join(out_dir, f"{name}__im_step__{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    from repro_torch.launch.common import add_obs_args, add_tuning_arg, observe

    ap = argparse.ArgumentParser(description="dry run of the production IM cells "
                                             "(meta tensors; nothing is computed)")
    ap.add_argument("--arch", default="all", help="IM cell name (IM_CELLS)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--im", action="store_true",
                    help="no-op, kept from the reference: the IM cells are the only cells")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--schedule", default="ring", choices=["ring", "allgather"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    add_tuning_arg(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True)))

    failures = 0
    names = list(IM_CELLS) if args.arch == "all" else [args.arch]
    with observe(args):
        for mesh_name, grid in meshes:
            for name in names:
                rec = run_cell(name, grid, mesh_name, out_dir=args.out,
                               schedule=args.schedule, tag=args.tag,
                               **_tuned_knobs(name, args.tuning))
                status = "OK " if rec["ok"] else "FAIL"
                print(f"[{status}] {name:24s} im_step      {mesh_name:12s} "
                      f"{rec.get('compile_s', '-'):>6}s  {rec.get('error', '')}")
                failures += 0 if rec["ok"] else 1
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
