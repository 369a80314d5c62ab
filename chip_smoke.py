#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # all phases, as the check runs it
    python3 chip_smoke.py --phases 1,2    # build and kernel checks only
    python3 chip_smoke.py --phases 1,6,7  # the serving phases (7 needs 6)
    python3 chip_smoke.py --phases 1,6,8  # the shard repair and spans (8 needs 6)
    python3 chip_smoke.py --phases 1,4,4b,9  # tuning and the report (9 needs 4, 4b)
    python3 chip_smoke.py --phases 1,4,4b,10  # the mesh backend (10 needs 4, 4b)
    python3 chip_smoke.py --phases 1,6,11  # device-resident serving (11 needs 6)
    python3 chip_smoke.py --phases 1,4,4b,10,12  # the dry run (12 needs 10)
    python3 chip_smoke.py --phases 1,13   # FASST's partition and Table 5-7 metrics
    python3 chip_smoke.py --phases 1,14   # the port's scripts; the other models at full size

Phases (each raises on failure; none is caught):

1. device: the card's name and power limit (``nvidia-smi``); build the
   seven CUDA sources from ``src/repro_torch/kernels/csrc``, and the two
   single-path sweeps again at each other block shape of
   ``build.ITEM_WARPS`` (``-DREPRO_ITEM_WARPS``; one ``nvcc`` each, all in
   parallel), and print what ``ptxas`` reports for each kernel instance
   (registers, spills);
2. each kernel against its plain PyTorch version on the card, on several
   shapes (both predicate forms, ``reg_offset != 0``, VISITED rows, a prime
   edge count, register counts that are not multiples of 32; for the sweeps
   also rows of 40,000 and of about ``CHUNK`` edges, which they split; for the
   serial ring's kernels a prime and an empty bucket, hub buckets with write
   rows of 13,657, 257, 256 and 0 slots at ``j_loc`` 512 and 100 (the 16-
   and the 4-byte path), both in-place merges with a partial scratch passed
   in and with their own, ``num_sweeps`` 1-3 and several ``lane_fill``;
   ``fused_sample`` at 36, 100, 128 and 512 samples on a prime edge count):
   equal int8 and uint8 outputs, equal changed flags and bit-equal float32
   statistics; a bare kernel refuses a register or sample count off
   multiples of 4;
3. the kernel path against the plain path on the card at rmat:14, J=256,
   K=8, for wc, ic:0.1, lt and dic:1.0 (for the plain path this script puts
   the plain versions in place of ``kernels.ops``' functions): seeds,
   rebuilds and sweep counts equal, gains and scores to rtol 1e-6; the same
   for the ``serial`` backend (grid 2x2, ``degree`` plan, fused prologue of
   2 sweeps), whose seeds must also equal the single backend's; and, through
   the drivers' register padding, the single path at J=37 and the serial
   backend at J=100 (``j_loc`` 50);
4. the single-device slice at full size through the launcher's entry point
   (``repro_torch.launch.im``: rmat:20, setting 0.1, wc, J=1024, K=50), with
   the launch counters reset before and read after: every kernel of the path
   launched, no plain version called;
4b. the ``serial`` backend at the same size through ``repro_torch.runtime.run``
   (grid 2x2, ``degree``, fused prologue, ``lane_fill`` 256), counters as in
   phase 4; its seeds must equal phase 4's;
5. each kernel at phase 4's and 4b's shapes: time (CUDA events), its plain
   version's time, the largest difference between the two, and the bound
   (``kernels.cost``'s operations and bytes over ``utils.roofline``'s roofs);
   ``sketch_fill`` also with row ids at 4b's ``n_loc x j_loc`` (a mesh
   rank's owned-rows fill);
   for the sweeps and the serial ring's merges also their work lists
   (items, split rows, partials, longest item) and the bytes they gather;
   one ``bucket_propagate`` launch over each propagate bucket of a ring
   sweep, summed; the registers of the in-place merges' instances;
6. the influence query service at full width through the serve launcher's
   entry point (``repro_torch.launch.serve_im.run``: rmat:20, setting 0.1,
   wc, J=512, 1 bank, 1,000 queries of the default mix, top-k 10, batches
   of at most 256), counters reset before it and read after; then the query
   loop alone on the warm store (counters reset before it: the cardinality
   kernel launched, no plain call), its spread, marginal and probe answers
   held against the plain path's; then one insertion delta of 1,024 random
   edges through ``InfluenceSession.apply_delta`` and a warm top-k, whose
   seeds must equal a cold ``find_seeds`` on the post-delta graph; last the
   host steps of the launcher and of the delta, timed one by one;
7. async serving at phase 6's width: the serve launcher with ``--async
   --deadline-ms 50`` on phase 4's graph (answers byte-equal to the sync
   engine's for the same stream); phase 6's delta through
   ``apply_delta_async`` while a spread or probe query arrives every 2 ms
   (an answer before the swap is the old index's, after it the repaired
   one's, whose matrix equals phase 6's); then two rmat:18 graphs at J=512
   beside the rmat:20 index under a resident budget that holds two of the
   three: 6 waves over the key pairs must evict, rebuild on touch and stack
   both rmat:18 entries in one cross-entry batch, with answers equal to the
   sync engine's and the bytes the budget covers (resident entries and the
   cross-entry stack) under it after each budget pass; an rmat:18 index
   rebuilt after its eviction must equal a build of it on the plain path.
   The launch counters count the launcher and the async engines alone (the
   sync engine's reference answers run outside them): the engines' own
   calls launched every single-path kernel, no plain version ran, and no
   future holds an exception;
8. shard repair and spans, on phase 6's index of phase 4's graph (J=512):
   (a) an 8-shard ``block`` plan (``mu_s`` 1) attached, phase 6's
   1,024-edge random delta through ``apply_delta(…, backend="serial")``,
   byte-equal to phase 6's per-bank repair of the same delta, all 8 shards
   swept; the ``single`` and the ``serial`` backends' ``fixpoint`` hooks
   from the unrepaired matrix equal to it; (b) 1,024 insertions with both
   endpoints in plan shard 0 (``plan_shards_touched == (0,)``), byte-equal
   to the per-bank repair on a clone, the shards swept per sweep printed; a
   warm top-k after both equal to a cold ``find_seeds``, and the ``cascade``
   hook; (c) at rmat:18, the build, both kinds of repair and the cascade
   hook on the kernel path and replayed on the plain path, equal; (d)
   ``repro_torch.launch.im --trace --metrics`` at phase 4's size and the
   phase 4b grid traced (``observe``), seeds equal to phases 4 and 4b: span
   coverage, lanes, the top spans, the measured shard profile and its
   ``partition.predicted_vs_measured_edge_imb`` gauge (the launcher takes
   phase 4's graph instead of generating it again). Each repair runs with
   the span recorder on, its merges timed by CUDA events; its launches, with
   the hooks' and the warm top-k's, are ``launches_repair``;
9. tuning and the report, at phase 4's size (needs 4 and 4b; 6-8 feed the
   report): (a) ``tune.autotune`` of the single backend into a cache under
   a temporary directory: each ``sketch_propagate`` and ``cascade_step``
   work-item geometry (``item_edges`` x ``item_warps``) timed, printed with
   its GB/s and share of the roof, and its output held byte-equal to the
   default geometry's and the plain version's; (b) the ``serial`` families
   (``bucket_propagate``'s schedule, ``fused_sweep``) at phase 4b's spec;
   (c) phase 4's launcher with ``--tuning cached`` and phase 4b's spec with
   ``tuning="cached"`` from that cache: seeds, scores, rebuilds and cascade
   sweeps equal phases 4 and 4b's (the single path's build and rebuild
   sweeps too; the ring's equal an untuned run at the tuned schedule, since
   comm-free sweeps stand in for ring sweeps); (d) ``obs.report`` of this
   run's records (phases 4, 4b, 6 and 7, phase 8 (d)'s spans, the metrics,
   the shard profiles, the cache), every section present. Launches of
   (a)-(c) are ``launches_tune``;
10. the ``mesh`` backend (needs 4 and 4b): (a) a world of 4 spawned ranks
   sharing the card (gloo, every exchange staged through pinned host
   buffers), grid 2x2, at phase 4b's spec with the ring schedule: seeds,
   rebuilds and every sweep count equal phase 4b's, seeds equal phase 4's;
   the ranks' launch counters, summed, show the six ring kernels launched
   and no plain call (``launches_mesh``); each rank's prep/build/rounds
   split, exchanges (calls, bytes sent, seconds) and peak memory, and rank
   0's exchange spans; (b) the allgather schedule at K = 8, equal to the
   first 8 rounds of (a); (c) ``MeshBackend.build_matrix`` at J = 512,
   byte-equal to the single path's matrix; (d) a world of 1 on NCCL at
   rmat:14, J = 256, K = 8, seeds equal to the single path's; in (a)-(c)
   each rank prepares only its own shard (``partition.shard.build_shard_2d``
   once a run; no call of the whole partition's build or of its graph-wide
   sample sets, counted through every name that reaches them); in (a) each
   rank's state construction fills only its ``n_loc`` owned rows, by row
   ids, and its peak is split into the partition's prep, the state's
   construction and the rest: the prep at most 1.0 GiB, the whole peak at
   most 2.0 GiB (and within 1 % of ``MESH_WHOLE_FILL_PEAK_GIB``, the peak
   when a rank filled the whole ``n_pad x j_loc`` matrix), printed beside
   ``MESH_WHOLE_PARTITION_PEAK_GIB``, the peak when every rank built the
   whole partition; (e) ``python
   -m torch.distributed.run --nproc-per-node 4 -m repro_torch im --devices 4
   --backend mesh`` at rmat:14, seeds equal to the serial backend's. The
   shared-card world time-slices one card and exchanges through host
   memory: it is no multi-GPU speed figure;
11. device-resident serving (needs 6): phase 6's index (rmat:20, J = 512,
   one bank) built on the controller of a serving world of 4 spawned ranks
   sharing the card (``launch.mesh.serve_world``; gloo, host-staged), a
   4-shard ``block`` plan attached and the index placed as row blocks; (a)
   phase 6's 1,000-query stream through the sync engine, answers
   byte-equal to phase 6's host answers, qps, p50, p99 and the all-reduce
   MAX exchanges; (b) that stream's warm top-10 off the placed blocks: the
   partition's host seconds, ring shifts, bytes and seconds, sweeps; (d)
   the async engine on the placed entry, answers equal to (a)'s; (c) phase
   6's delta through ``apply_delta``: routed to ``mesh``, the gathered
   matrix byte-equal to phase 6's repaired matrix and to the ``serial``
   shard repair at the same plan, sweeps and shards swept equal to it; the
   delta's host seconds, rank 0's merges on the device (CUDA events) and
   the exchanges; each rank's peak memory (the followers' beside their
   prediction and ``MESH_SERVE_WHOLE_PARTITION_GIB``), and its launches
   from placement to (c)'s mesh repair, reset and read by operations of the
   world on every rank (the store builds, the plan and the serial twin's
   repair run before that window; every rank launched the path's five
   kernels, no other kernel, no plain call; ``launches_mesh_serve``,
   summed);
   (e) ``python -m torch.distributed.run --nproc-per-node 4 -m repro_torch
   serve --residency device --plan-shards 4`` at rmat:14, its answers equal
   to a host-resident run's. As in phase 10 the ranks time-slice one card
   and exchange through host memory: no multi-GPU figure;
12. the dry run held against the card (needs 10; (c) checks its seeds
   against 4's): (a) ``launch.dryrun.run_cell`` of the reference's six
   production records (three cells on the 16 x 16 and the 2 x 16 x 16 grid)
   and twitter on the 16 x 16 grid under the allgather schedule, each ``ok``,
   written to ``chiprun_out/chip_smoke/dryrun/``: per device, wire bytes by
   kind, flops, bytes accessed, the memory fields and ``Roofline``'s three
   times and bottleneck on the H100's roofs; a ring cell's
   collective-permute bytes equal 3 x (mu_v - 1) x n_loc x j_loc; (b) the
   dry program of each phase 10 (a) rank's partition (its real bucket
   widths), times that run's build, cascade and rebuild sweeps and K, equals
   the rank's exchanges (calls and bytes sent per kind) and kernel launches
   (the partition's ``fused_sample`` aside); each rank's predicted peak
   (arguments and temp) beside its ``max_memory_allocated`` and their
   ratio, not a gate;
   (c) phase 4's launcher once under ``torch.profiler`` with CUDA activity:
   the top 12 kernels by device time (``utils.opprof``), the port's
   kernels' share of it, and device-busy time over wall time. Gates: every
   record's temp at most a quarter of the whole-matrix fill's
   (``WHOLE_FILL_TEMP_GB``: a rank fills its owned rows only) and its
   selection bytes (the all-reduce kind) within 10 % of the reference's
   compiled program's (``REF_ALL_REDUCE``: an ordered sum, not an
   all-gather of every shard's sums);
13. FASST's partition and its Table 5-7 metrics at full width (rmat:20,
   R = 1024, ``mu`` 4 and 8, ``fasst`` and ``naive``): ``core.fasst``'s
   ``build_partition`` (edge counts, ``E_max``), ``max_shard_fraction``,
   ``duplication_histogram`` and ``lane_fill_rate`` (lanes of 32 and 128, x
   sorted and unsorted), each timed, on the kernel path and on the plain
   path: arrays byte-equal, floats equal, the counters showing which path
   ran; and ``core.sketch.fill_registers`` with row ids against
   ``sketch_fill_plain`` with the same ids;
14. the port's scripts and the model zoo at full size: (a)
   ``examples_torch/quickstart.py`` (rmat:10), ``influence_service.py``
   (rmat:12) and ``scripts_torch/check_models.py`` (ER n = 1,024) in this
   process with ``--device cuda``, each on the kernel path and on the plain
   path: exit 0, result lines equal (qps, p50/p99 and "amortized" lines
   dropped, wall seconds masked), the counters showing which path ran;
   ``examples_torch/distributed_im.py`` (rmat:12) as its own command, 8
   ranks under ``torch.distributed.run`` sharing the card (gloo,
   host-staged), started through ``DIST_RUNNER`` so that each rank writes
   its counts as it leaves the world: exit 0, ``auto`` on the mesh, its own
   check of mesh seeds against single-device seeds, every rank's mesh run
   launched ``DIST_KERNELS`` and no plain version, and its rank-0 single
   half run here on both paths, equal, its spread the script's; (b) ic:0.1, dic:1.0 and lt
   through ``repro_torch.launch.im`` at phase 4's size (rmat:20, setting
   0.1, J=1024, K=50, phase 4's graph), each checked as phase 4 is: prep,
   build, rounds and total seconds, sweeps, rebuilds, launches and peak
   memory printed; every main-path kernel launched, no plain call, seeds
   distinct and in range.

Phase 3 also drives the service at rmat:14, J=256 on both paths: a 2-bank
store built by the ``single`` and by the ``serial`` backend, 256 mixed
queries, an insertion delta of 256 edges, a removal delta below the
staleness threshold and a warm top-k (answers, repair sweeps, matrices and
seeds equal the plain path's, the warm seeds a cold ``find_seeds``'s); the
async engine on both paths (two rmat:14 graphs, the 256 queries byte-equal
to the sync engine's, an insertion delta through ``apply_delta_async``
while queries keep coming, one of them answered from inside the swap hook;
the new index equal to a cold build); and ``repro_torch.launch.im
--validate --ris`` at rmat:14, K=8.

It prints the ``kernels`` JSON line (``launches`` counts phase 4's or 4b's
run, ``launches_serve`` phase 6's, ``launches_async`` phase 7's
launcher and async engines, ``launches_repair`` phase 8's repairs,
``launches_tune`` phase 9's tuning and tuned runs, ``launches_mesh``
phase 10 (a)'s ranks, summed, ``launches_mesh_serve`` phase 11's ranks
from placement to the mesh repair, summed, ``launches_fasst`` phase 13's
kernel path, ``launches_scripts`` phase 14 (a)'s three in-process scripts'
kernel paths and ``distributed_im``'s 8 ranks' mesh runs, summed,
``launches_models`` phase 14 (b)'s three runs; the ``sketch_fill`` row also
carries phase 5's owned-rows fill, ``ids_*``), the
``nvidia-smi`` line, and last the contract line ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the repository around it, it
exits non-zero before printing any. Longer output goes to
``chiprun_out/chip_smoke/``, the flight recorder's dumps (SLO breaches of
the async engines) to its ``flight/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# The H100's roofs (device memory 3.35 TB/s, INT32 about 16.7 T operations a
# second) are ``repro_torch.utils.roofline``'s, and each kernel's operations
# and compulsory bytes ``repro_torch.kernels.cost``'s: the bound column and
# the dry run (phase 12) read the same counts.

FULL = dict(graph="rmat:20", setting="0.1", model="wc", registers=1024)
# phase 4b's spec: the reference launcher's serial grid, the degree planner
# and the tuner's fused prologue
SERIAL = dict(backend="serial", mu_v=2, mu_s=2, partition="degree", local_sweeps=2,
              fuse_sweeps=True, lane_fill=256)
# phase 6's serve configuration: the serve launcher's defaults (J = 512,
# one bank, 1,000 queries, top-k 10, batches of 256) on phase 4's graph
SERVE = dict(registers=512, banks=1, queries=1000, topk=10, max_batch=256, delta_edges=1024)
# phase 7's tenancy: two more graphs at phase 6's J beside its index, each
# about a quarter of it, under a resident budget that holds two of the three
TENANT_GRAPH = "rmat:18"
# phase 8's plan and localized delta: the serve launcher's --plan-shards 8
# block plan over one sim shard on phase 6's index, and 1,024 insertions
REPAIR = dict(plan_shards=8, strategy="block", delta_edges=1024)
SINGLE_KERNELS = ("sketch_fill", "sketch_cardinality", "sketch_propagate", "cascade_step")
SERIAL_KERNELS = ("fused_sample", "sketch_fill", "sketch_cardinality", "fused_sweep",
                  "bucket_propagate", "bucket_cascade")
# phase 8: the restricted and full ring repairs (their partitions sample with
# fused_sample), the single hooks, and the warm top-k after the repairs
REPAIR_KERNELS = ("bucket_propagate", "fused_sample", "sketch_propagate", "cascade_step",
                  "sketch_cardinality")


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """Fail the run (an explicit raise, kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------- phase 1 ----

_PTXAS: dict = {}   # source -> [(kernel instance, registers, spill bytes)]


def _instance(mangled: str) -> str:
    """A readable name for a kernel's mangled entry: the item walk's
    template arguments (operation, predicate, unit bytes, in place), else the
    function's name and its integer template arguments."""
    import re

    m = re.search(r"item_(sweep|combine)INS_\d+(\w+?)E(?:Li(\d)ELi(\d+)E)?Lb(\d)E", mangled)
    if m:
        kind, op, pred, vec, in_place = m.groups()
        args = f"PRED {pred}, VEC {vec}, " if pred else ""
        return f"item_{kind}<{op}, {args}{'in place' if in_place == '1' else 'out of place'}>"
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:Li\d+E)+E)?", mangled)
    if m:
        args = re.findall(r"Li(\d+)E", m.group(2) or "")
        return m.group(1) + (f"<{', '.join(args)}>" if args else "")
    return mangled


def _ptxas_table(report: str) -> list:
    """(instance, registers, spill store + load bytes) of each entry
    function in a ``ptxas -v`` report."""
    import re

    rows, entry, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((_instance(entry), int(m.group(1)), spill))
            entry = None
    return rows


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s -> {build.BUILD_DIR}")
    OUT.mkdir(parents=True, exist_ok=True)
    for name, rep in sorted(reports.items()):
        (OUT / f"ptxas_{name}.txt").write_text(rep)
        _PTXAS[name] = _ptxas_table(rep)
        for inst, regs, spill in _PTXAS[name]:
            log(f"    {name}: {inst}: {regs} registers, {spill} bytes spilled")
    for name in build.KERNELS:
        build.load(name)
    for name in build.VARIANT_KERNELS:
        for warps in build.ITEM_WARPS:
            build.load(name, warps)


def full_graph():
    """Phase 4's graph, generated once for the phases that share it."""
    if "g" not in _GRAPH:
        from repro_torch.launch.common import make_graph

        _GRAPH["g"] = make_graph(FULL["graph"], FULL["setting"], 0)
    return _GRAPH["g"]


_GRAPH: dict = {}


# --------------------------------------------------------------- phase 2 ----

def _random_case(n_pad, num_regs, num_edges, *, seed, device):
    import numpy as np
    import torch

    from repro_torch.kernels.edges import EdgeOperands

    rng = np.random.default_rng(seed)
    m = rng.integers(-1, 33, size=(n_pad, num_regs)).astype(np.int8)
    m[rng.random(n_pad) < 0.1] = -1              # whole VISITED rows
    src = rng.integers(0, n_pad, num_edges).astype(np.int32)
    dst = rng.integers(0, n_pad, num_edges).astype(np.int32)
    u32 = lambda size: rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    h, lo = u32(num_edges), u32(num_edges)
    thr = u32(num_edges) >> rng.integers(0, 8, num_edges).astype(np.uint32)
    thr[rng.random(num_edges) < 0.05] = 0         # dead edges, as padding
    order = np.lexsort((src, dst))
    edges = EdgeOperands.from_numpy(src[order], dst[order], h[order], lo[order],
                                    thr[order], n_pad, device)
    x = torch.from_numpy(u32(num_regs).view(np.int32)).to(device)
    return torch.from_numpy(m).to(device), edges, x


def _hub_case(num_regs, *, seed, device):
    """A graph whose sweeps split rows: sources 10-14 and destinations 20-24
    with 40,000, CHUNK - 1, CHUNK, CHUNK + 1 and 3 CHUNK + 1 edges, their
    other ends and 1000 random edges among rows 30-499, rows 500-519 empty;
    the matrix and edge operands drawn as in ``_random_case``."""
    import numpy as np
    import torch

    from repro_torch.kernels.edges import CHUNK, EdgeOperands

    n_pad = 520
    rng = np.random.default_rng(seed)
    m = rng.integers(-1, 33, size=(n_pad, num_regs)).astype(np.int8)
    m[rng.random(n_pad) < 0.1] = -1
    src, dst = [rng.integers(30, 500, 1000)], [rng.integers(30, 500, 1000)]
    for i, deg in enumerate((40_000, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 1)):
        src += [np.full(deg, 10 + i), rng.integers(30, 500, deg)]
        dst += [rng.integers(30, 500, deg), np.full(deg, 20 + i)]
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    num_edges = src.shape[0]
    u32 = lambda size: rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    h, lo = u32(num_edges), u32(num_edges)
    thr = u32(num_edges) >> rng.integers(0, 8, num_edges).astype(np.uint32)
    thr[rng.random(num_edges) < 0.05] = 0
    order = np.lexsort((src, dst))
    edges = EdgeOperands.from_numpy(src[order], dst[order], h[order], lo[order],
                                    thr[order], n_pad, device)
    x = torch.from_numpy(u32(num_regs).view(np.int32)).to(device)
    return torch.from_numpy(m).to(device), edges, x


def _check_sweeps(m, edges, x, what) -> None:
    """Both sweep kernels against their plain versions, both predicates."""
    import torch

    from repro_torch.kernels import cascade_step, sketch_propagate

    for variant in (0, 1):
        for cuda_fn, plain_fn in (
                (sketch_propagate.propagate_sweep_cuda, sketch_propagate.propagate_sweep_plain),
                (cascade_step.cascade_sweep_cuda, cascade_step.cascade_sweep_plain)):
            a, fa = cuda_fn(m, edges, x, variant=variant)
            b, fb = plain_fn(m, edges, x, variant=variant)
            check(torch.equal(a, b), (cuda_fn.__name__, what, variant))
            check(bool(fa.item()) == bool(fb.item()), (cuda_fn.__name__, what, "changed"))


# phase 2's work-list item sizes of the sweeps (one-edge items, the tuner's
# smallest and largest), each at every block shape the sweeps are built at
ITEM_SIZES = (1, 64, 1024)


def _regeometry(edges, item_edges, item_warps):
    """``edges`` with both work lists recut at ``(item_edges, item_warps)``."""
    import dataclasses

    from repro_torch.kernels.edges import with_work

    return dataclasses.replace(edges, by_src=with_work(edges.by_src, item_edges, item_warps),
                               by_dst=with_work(edges.by_dst, item_edges, item_warps))


def phase_kernels():
    import torch

    from repro_torch.kernels import build, sketch_cardinality, sketch_fill

    cases = [  # (n_pad, J, E): prime E, J off multiples of 32
        (1024, 256, 10007), (2048, 1024, 30011), (520, 100, 4099),
        (264, 36, 2003), (128, 2048, 1009), (4104, 1500, 65521)]
    for i, (n_pad, num_regs, num_edges) in enumerate(cases):
        m, edges, x = _random_case(n_pad, num_regs, num_edges, seed=i, device="cuda")
        for reg_offset, seed in ((0, 0), (12345, 7)):
            a = sketch_fill.sketch_fill_cuda(m, reg_offset=reg_offset, seed=seed)
            b = sketch_fill.sketch_fill_plain(m, reg_offset=reg_offset, seed=seed)
            check(torch.equal(a, b), ("sketch_fill", n_pad, num_regs, reg_offset))
        a = sketch_cardinality.cardinality_stats_cuda(m)
        b = sketch_cardinality.cardinality_stats_plain(m)
        check(torch.equal(a, b), ("cardinality_stats", n_pad, num_regs))
        _check_sweeps(m, edges, x, (n_pad, num_regs, num_edges))
        log(f"[2] n_pad={n_pad} J={num_regs} E={num_edges}: 4 kernels equal "
            f"their plain versions (both predicates, reg_offset 0 and 12345)")
    for num_regs in (256, 1024):
        m, edges, x = _hub_case(num_regs, seed=40 + num_regs, device="cuda")
        _check_sweeps(m, edges, x, ("hub", num_regs))
        work = [(r.work.num_items, r.work.num_split, r.work.num_partials)
                for r in (edges.by_src, edges.by_dst)]
        log(f"[2] hub rows J={num_regs} E={edges.num_edges} (work items, split rows, "
            f"partials: by source {work[0]}, by destination {work[1]}): both sweeps equal "
            f"their plain versions (both predicates)")
        geometries = [(e, w) for e in ITEM_SIZES for w in build.ITEM_WARPS]
        for geometry in geometries:
            _check_sweeps(m, _regeometry(edges, *geometry), x, ("hub", num_regs, geometry))
        log(f"[2] hub rows J={num_regs}: both sweeps equal their plain versions at every "
            f"(item_edges, item_warps) of {geometries}")
    m, _, _ = _random_case(64, 37, 101, seed=99, device="cuda")
    try:
        sketch_fill.sketch_fill_cuda(m)
    except ValueError as e:
        log(f"[2] J=37 refused: {e}")
    else:
        check(False, "sketch_fill_cuda took a register count off multiples of 4")
    phase_ring_kernels()
    phase_sample_kernel()
    torch.cuda.synchronize()


def _random_bucket(n_loc, j_loc, num_slots, *, seed, device, hubs=()):
    """acc and block (VISITED rows in both), the slots of one bucket grouped
    by write row with their work list, and x. ``hubs``: write rows 10, 11,
    ... get these many slots on top of ``num_slots`` random ones among rows
    30 to n_loc - 41, and the last 40 rows none."""
    import numpy as np
    import torch

    from repro_torch.kernels.edges import group_rows, with_work

    rng = np.random.default_rng(seed)

    def matrix():
        m = rng.integers(-1, 33, size=(n_loc, j_loc)).astype(np.int8)
        m[rng.random(n_loc) < 0.1] = -1
        return torch.from_numpy(m).to(device)

    u32 = lambda size: rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, n_loc, num_slots).astype(np.int32)
    if hubs:   # write rows 10, 11, ... with these many slots; rows from n_loc - 40 empty
        w = np.concatenate([rng.integers(30, n_loc - 40, num_slots)]
                           + [np.full(d, 10 + i) for i, d in enumerate(hubs)])
        num_slots = w.shape[0]
    w = w.astype(np.int32)
    r = rng.integers(0, n_loc, num_slots).astype(np.int32)
    thr = u32(num_slots) >> rng.integers(1, 8, num_slots).astype(np.uint32)
    operands = (w, r, u32(num_slots), u32(num_slots), thr)
    rows = with_work(group_rows(*(torch.from_numpy(a.view(np.int32)).to(device)
                                  for a in operands), n_loc))
    return matrix(), matrix(), rows, torch.from_numpy(u32(j_loc).view(np.int32)).to(device)


#: write rows of the hub buckets: the longest row of phase 4b's buckets at
#: rmat:20, rows just over and at CHUNK (256), and an empty row
BUCKET_HUBS = (13_657, 257, 256, 0)


def phase_ring_kernels():
    """The serial ring's kernels against their plain versions."""
    import torch

    from repro_torch.kernels import bucket_propagate as bp
    from repro_torch.kernels import fused_sample, fused_sweep

    cases = [(1000, 36, 4099, ()), (777, 100, 0, ()), (4096, 512, 30011, ()),
             (520, 512, 1, ()), (4096, 512, 30011, BUCKET_HUBS),
             (4096, 100, 30011, BUCKET_HUBS)]
    for i, (n_loc, j_loc, slots, hubs) in enumerate(cases):
        acc, block, rows, x = _random_bucket(n_loc, j_loc, slots, seed=10 + i,
                                             device="cuda", hubs=hubs)
        # one scratch for every merge, larger than the list needs, as the
        # ring state keeps one at its buckets' largest num_partials
        partial = torch.empty((rows.work.num_partials + 5, j_loc), dtype=torch.int8,
                              device="cuda")
        what = (n_loc, j_loc, rows.nbr.numel(), hubs)
        for variant in (0, 1):
            for name in ("bucket_propagate", "bucket_cascade"):
                a, b = acc.clone(), acc.clone()
                fa = getattr(bp, name + "_cuda")(a, block, rows, x, variant=variant,
                                                 partial=partial)
                fb = getattr(bp, name + "_plain")(b, block, rows, x, variant=variant)
                check(torch.equal(a, b), (name, what, variant))
                check(bool(fa.item()) == bool(fb.item()), (name, what, variant, "changed"))
                check(bool((a[acc == -1] == -1).all()), (name, "VISITED kept"))
                # with the scratch the wrapper allocates
                a = acc.clone()
                getattr(bp, name + "_cuda")(a, block, rows, x, variant=variant)
                check(torch.equal(a, b), (name, what, variant, "own scratch"))
            for num_sweeps in (1, 2, 3):
                for lane_fill in (0, 8, 24, 256):
                    a = fused_sweep.fused_sweep_cuda(acc, rows, x, variant=variant,
                                                     num_sweeps=num_sweeps,
                                                     lane_fill=lane_fill)
                    b = fused_sweep.fused_sweep_plain(acc, rows, x, variant=variant,
                                                      num_sweeps=num_sweeps,
                                                      lane_fill=lane_fill)
                    check(torch.equal(a, b), ("fused_sweep", what, variant, num_sweeps,
                                              lane_fill))
            h, lo, thr = rows.h, rows.lo, rows.thr
            a = fused_sample.fused_sample_cuda(h, lo, thr, x, variant=variant)
            b = fused_sample.fused_sample_plain(h, lo, thr, x, variant=variant)
            check(a.dtype == torch.uint8 and torch.equal(a, b),
                  ("fused_sample", what, variant))
        w = rows.work
        log(f"[2] n_loc={n_loc} j_loc={j_loc} slots={rows.nbr.numel()}"
            f"{f' hub rows {list(hubs)}' if hubs else ''} (work items {w.num_items}, split "
            f"rows {w.num_split}, partials {w.num_partials}): bucket_propagate and "
            f"bucket_cascade (in place, scratch passed in and their own), fused_sweep "
            f"(num_sweeps 1-3, lane_fill 0/8/24/256) and fused_sample equal their plain "
            f"versions (both predicates, changed flags equal)")


def phase_sample_kernel():
    """``fused_sample`` against its plain version at sample counts on the
    4-byte path (36, 100) and the 16-byte path (128, 512), a prime edge
    count; a sample count off multiples of 4 refused."""
    import numpy as np
    import torch

    from repro_torch.kernels import fused_sample

    rng = np.random.default_rng(77)
    num_edges = 65521
    u32 = lambda size: rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    thr = u32(num_edges) >> rng.integers(0, 8, num_edges).astype(np.uint32)
    thr[rng.random(num_edges) < 0.05] = 0
    h, lo, thr = (torch.from_numpy(a.view(np.int32)).cuda()
                  for a in (u32(num_edges), u32(num_edges), thr))
    for num_samples in (36, 100, 128, 512):
        x = torch.from_numpy(u32(num_samples).view(np.int32)).cuda()
        for variant in (0, 1):
            a = fused_sample.fused_sample_cuda(h, lo, thr, x, variant=variant)
            b = fused_sample.fused_sample_plain(h, lo, thr, x, variant=variant)
            check(a.dtype == torch.uint8 and torch.equal(a, b),
                  ("fused_sample", num_edges, num_samples, variant))
    log(f"[2] fused_sample E={num_edges} R=36/100/128/512: equal its plain version "
        f"(both predicates)")
    try:
        fused_sample.fused_sample_cuda(h, lo, thr, x[:50], variant=0)
    except ValueError as e:
        log(f"[2] R=50 refused: {e}")
    else:
        check(False, "fused_sample_cuda took a sample count off multiples of 4")


# --------------------------------------------------------------- phase 3 ----

@contextlib.contextmanager
def plain_ops():
    """Put the plain versions in place of ``kernels.ops``' functions,
    which the driver calls as module attributes, for the length of a block."""
    from repro_torch.kernels import (bucket_propagate, cascade_step, fused_sample,
                                     fused_sweep, ops, sketch_cardinality, sketch_fill,
                                     sketch_propagate)

    swap = dict(sketch_fill=sketch_fill.sketch_fill_plain,
                cardinality_stats=sketch_cardinality.cardinality_stats_plain,
                propagate_sweep=sketch_propagate.propagate_sweep_plain,
                cascade_sweep=cascade_step.cascade_sweep_plain,
                fused_sample=fused_sample.fused_sample_plain,
                fused_sweep=fused_sweep.fused_sweep_plain,
                bucket_propagate=bucket_propagate.bucket_propagate_plain,
                bucket_cascade=bucket_propagate.bucket_cascade_plain)
    saved = {name: getattr(ops, name) for name in swap}
    try:
        for name, fn in swap.items():
            setattr(ops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _same_run(kern, plain, what) -> None:
    """Seeds, rebuilds and sweep counts equal; gains and scores to rtol 1e-6."""
    import numpy as np

    np.testing.assert_array_equal(kern.seeds, plain.seeds)
    np.testing.assert_array_equal(kern.rebuilds, plain.rebuilds)
    check(kern.propagate_iters == plain.propagate_iters, (what, "build sweeps"))
    for key in ("cascade_sweeps", "rebuild_sweeps"):
        check(kern.stats[key] == plain.stats[key], (what, key))
    np.testing.assert_allclose(kern.est_gains, plain.est_gains, rtol=1e-6, atol=0)
    np.testing.assert_allclose(kern.scores, plain.scores, rtol=1e-6, atol=0)


def _kernel_and_plain(fn, kernels, what, same=_same_run):
    """Run ``fn`` on the kernel path, then on the plain path; check which
    path ran by the counters, and that the two agree (``same``)."""
    from repro_torch.kernels import counters

    counters.reset()
    t0 = time.perf_counter()
    kern = fn()
    t1 = time.perf_counter()
    check(not counters.PLAIN_CALLS and set(counters.LAUNCHES) == set(kernels),
          f"{what} kernel path: launches {dict(counters.LAUNCHES)}, plain "
          f"{dict(counters.PLAIN_CALLS)}")
    counters.reset()
    with plain_ops():
        plain = fn()
    t2 = time.perf_counter()
    check(not counters.LAUNCHES and set(counters.PLAIN_CALLS) == set(kernels),
          f"{what} plain path launched {dict(counters.LAUNCHES)}")
    same(kern, plain, what)
    return kern, t1 - t0, t2 - t1


def phase_parity():
    import numpy as np

    from repro_torch.graphs import rmat_graph
    from repro_torch.runtime import RunSpec, run

    g = rmat_graph(14, setting="0.1", seed=0)
    for model in ("wc", "ic:0.1", "lt", "dic:1.0"):
        single = RunSpec(num_registers=256, model=model)
        kern, t_k, t_p = _kernel_and_plain(
            lambda: run(g, 8, single, device="cuda").result, SINGLE_KERNELS,
            f"single {model}")
        log(f"[3] rmat:14 J=256 K=8 {model}: seeds {kern.seeds.tolist()} "
            f"sweeps={kern.propagate_iters} rebuilds={int(kern.rebuilds.sum())} "
            f"equal; kernel path {t_k:.2f}s, plain path {t_p:.2f}s")
        serial = RunSpec(num_registers=256, model=model, **SERIAL)
        ring, t_k, t_p = _kernel_and_plain(
            lambda: run(g, 8, serial, device="cuda").result, SERIAL_KERNELS,
            f"serial {model}")
        np.testing.assert_array_equal(ring.seeds, kern.seeds)
        log(f"[3] serial 2x2 degree fused prologue, {model}: seeds equal the single "
            f"backend's and the plain path's (sweeps={ring.propagate_iters}, cascade "
            f"sweeps={ring.stats['cascade_sweeps']}); kernel path {t_k:.2f}s, plain "
            f"path {t_p:.2f}s")
    # register counts off multiples of 4, through the drivers' padding
    kern, t_k, t_p = _kernel_and_plain(
        lambda: run(g, 8, RunSpec(num_registers=37), device="cuda").result, SINGLE_KERNELS,
        "single J=37")
    log(f"[3] rmat:14 J=37 (padded to 40) K=8 wc: seeds {kern.seeds.tolist()} "
        f"sweeps={kern.propagate_iters} equal the plain path's; kernel path {t_k:.2f}s, "
        f"plain path {t_p:.2f}s")
    single = run(g, 8, RunSpec(num_registers=100), device="cuda").result
    ring, t_k, t_p = _kernel_and_plain(
        lambda: run(g, 8, RunSpec(num_registers=100, **SERIAL), device="cuda").result,
        SERIAL_KERNELS, "serial J=100")
    np.testing.assert_array_equal(ring.seeds, single.seeds)
    log(f"[3] serial 2x2 degree fused prologue, J=100 (j_loc 50, padded to 52), wc: seeds "
        f"{ring.seeds.tolist()} equal the single backend's at J=100 and the plain path's "
        f"(sweeps={ring.propagate_iters}, cascade sweeps={ring.stats['cascade_sweeps']}); "
        f"kernel path {t_k:.2f}s, plain path {t_p:.2f}s")
    phase_service_parity(g)


def _answer(result):
    """A query result's value, comparable with ``==``."""
    v = result.value
    if isinstance(v, dict):
        return (v["est"].tolist(), v["max_register"].tolist())
    if hasattr(v, "seeds"):
        return v.seeds.tolist()
    return v


def _exact(result) -> bytes:
    """A query result's value as bytes: equal bytes, byte-equal answers."""
    import numpy as np

    v = result.value
    if isinstance(v, dict):
        return v["est"].tobytes() + v["max_register"].tobytes()
    if hasattr(v, "seeds"):
        return b"".join(np.asarray(a).tobytes() for a in (v.seeds, v.est_gains, v.scores))
    return np.float64(v).tobytes()


def _results(futures, what, timeout=600.0) -> list:
    """The results of ``futures``; fails the run if any holds an exception."""
    out = []
    for f in futures:
        exc = f.exception(timeout=timeout)
        check(exc is None, f"{what}: a future holds {exc!r}")
        out.append(f.result(0))
    return out


_TIMED: dict = {}


def _timed_engine(**kw):
    """An ``AsyncInfluenceEngine`` that records the host clock just before
    (``before_swap``) and just after (``swapped``) each swap, the keys of
    each cross-entry batch, and the bytes the budget covers after each
    budget pass (``held_bytes``: resident entries and the cross stack);
    with ``hook_query`` it also answers that query from inside
    ``_before_swap``, while the mutation thread waits for it."""
    if "cls" not in _TIMED:
        from repro_torch.service import AsyncInfluenceEngine

        class Timed(AsyncInfluenceEngine):
            def __init__(self, *a, hook_query=None, **kw):
                self.marks, self.cross_keys, self.after_enforce = {}, [], []
                self.hook_query, self.hook_answer = hook_query, None
                super().__init__(*a, **kw)
                self.store.add_swap_hook(self._mark_swap)

            def _before_swap(self, key):
                self.marks["before_swap"] = time.monotonic()
                if self.hook_query is not None:
                    self.hook_answer = _exact(self.submit(key, self.hook_query).result(120))

            def _mark_swap(self, key, old, new):
                self.marks["swapped"] = time.monotonic()

            def _run_cross_spread(self, groups):
                self.cross_keys.append([e.key for e, _ in groups])
                super()._run_cross_spread(groups)

            def _enforce_budget(self, protect):
                super()._enforce_budget(protect)
                self.after_enforce.append(self.held_bytes())

        _TIMED["cls"] = Timed
    return _TIMED["cls"](**kw)


def _delta_under_load(aeng, key, delta, pool, *, interval_s, timeout=900.0):
    """``delta`` through ``apply_delta_async`` while the queries of ``pool``
    are submitted round robin, one every ``interval_s``, until the delta's
    future resolves. Returns (report, the delta's wall seconds, [pool index,
    host clock before the submit, host clock at resolution, future])."""
    sent = []
    t0 = time.monotonic()
    fut = aeng.apply_delta_async(key, delta)
    i = 0
    while not fut.done() and time.monotonic() - t0 < timeout:
        t_sub = time.monotonic()
        f = aeng.submit(key, pool[i % len(pool)])
        rec = [i % len(pool), t_sub, None, f]
        f.add_done_callback(lambda _f, rec=rec: rec.__setitem__(2, time.monotonic()))
        sent.append(rec)
        i += 1
        time.sleep(interval_s)
    rep = _results([fut], "the async delta", timeout)[0]
    wall = time.monotonic() - t0
    aeng.drain(timeout)
    _results([rec[3] for rec in sent], "a query during the delta", timeout)
    return rep, wall, sent


def _check_swap_order(marks, sent, before, after, what) -> list:
    """A query resolved before the swap began answers version N
    (``before``), one submitted after the swap ended answers the new
    version (``after``), one in between either. Returns the latencies
    (seconds) of the queries resolved while the delta was in flight."""
    lat = []
    for idx, t_sub, t_res, f in sent:
        got = _exact(f.result(0))
        if t_res < marks["before_swap"]:
            check(got == before[idx], (what, "answer before the swap is not version N's", idx))
            lat.append(t_res - t_sub)
        elif t_sub > marks["swapped"]:
            check(got == after[idx], (what, "answer after the swap is not the new version's",
                                      idx))
        else:
            check(got in (before[idx], after[idx]), (what, "answer of neither version", idx))
    return lat


def _async_service_path(graphs, queries, which, add) -> dict:
    """Phase 3's async case on the card: the mixed stream over two graphs
    through the async engine (each answer byte-equal to the sync engine's),
    then an insertion delta through ``apply_delta_async`` while queries keep
    coming: answers of version N until the swap (one of them answered from
    inside the swap hook, while the mutation thread waits), of the new
    version after it, and the new index byte-equal to a cold build."""
    import numpy as np

    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.graphs import GraphDelta
    from repro_torch.service import (CoverageProbe, InfluenceEngine, Request, SketchStore,
                                     SpreadEstimate)

    cfg = DiFuserConfig(num_registers=256)
    sync = InfluenceEngine(SketchStore(device="cuda"))
    ks = [sync.register(g, cfg) for g in graphs]
    want = [_exact(r) for r in sync.run([Request(ks[w], q) for w, q in zip(which, queries)])]
    pool = [q for q in queries if isinstance(q, (SpreadEstimate, CoverageProbe))][:64]
    with _timed_engine(store=SketchStore(device="cuda"), deadline_ms=50.0,
                       hook_query=pool[0]) as aeng:
        keys = _results([aeng.register_async(g, cfg) for g in graphs], "async register")
        check(keys == ks, "async register keys")
        got = [_exact(r) for r in _results(
            [aeng.submit(keys[w], q) for w, q in zip(which, queries)], "async stream")]
        check(got == want, "async answers differ from the sync engine's")
        before = [_exact(r) for r in
                  InfluenceEngine(aeng.store).run([Request(keys[0], q) for q in pool])]
        rep, wall, sent = _delta_under_load(aeng, keys[0], GraphDelta.make(add=add), pool,
                                            interval_s=0.001)
        after = [_exact(r) for r in
                 InfluenceEngine(aeng.store).run([Request(keys[0], q) for q in pool])]
        lat = _check_swap_order(aeng.marks, sent, before, after, "phase 3 async delta")
        check(aeng.hook_answer == before[0], "the query answered during the swap hook")
        entry = aeng.store.entry(keys[0])
        repaired = entry.matrix.cpu().numpy()
        cold = SketchStore(device="cuda").get_or_build(entry.graph, cfg, entry.x)
        check(np.array_equal(repaired, cold.matrix.cpu().numpy()),
              "the swapped-in index differs from a cold build of the new graph")
    return dict(answers=got, insert=(rep.repair_sweeps, rep.banks_touched, rep.rebuilt),
                repaired=repaired, after=after, during=len(lat), sent=len(sent), wall=wall)


def _same_async(kern, plain, what) -> None:
    import numpy as np

    check(np.array_equal(kern["repaired"], plain["repaired"]), (what, "repaired matrix"))
    for key in ("answers", "insert", "after"):
        check(kern[key] == plain[key], (what, key))


def _service_path(g, spec, queries, add, num_removed):
    """One run of the serving path on the card: a 2-bank store built
    through ``spec``'s backend, ``queries`` through the engine, an insertion
    delta, a removal delta below the staleness threshold, a warm top-k (the
    lazy rebuild) and a cold ``find_seeds`` on the post-delta graph."""
    import numpy as np

    from repro_torch.graphs import GraphDelta
    from repro_torch.runtime import InfluenceSession
    from repro_torch.service import InfluenceEngine, Request

    sess = InfluenceSession(g, spec, num_banks=2, device="cuda")
    entry = sess.entry()
    built = entry.matrix.cpu().numpy()
    results = InfluenceEngine(sess.store).run([Request(entry.key, q) for q in queries])
    ins = sess.apply_delta(GraphDelta.make(add=add))
    repaired = entry.matrix.cpu().numpy()
    idx = np.random.default_rng(18).choice(entry.graph.m_real, num_removed, replace=False)
    rem = sess.apply_delta(GraphDelta.make(remove=(entry.graph.src[idx],
                                                   entry.graph.dst[idx])))
    check(rem.stale and not rem.rebuilt, ("removal below the threshold", rem))
    warm = sess.find_seeds_warm(8)
    check(not entry.stale and entry.rebuilds == 1, "the warm top-k did not rebuild")
    cold = sess.find_seeds(8)
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    return dict(built=built, answers=[_answer(r) for r in results],
                insert=(ins.repair_sweeps, ins.banks_touched, ins.rebuilt),
                remove=(rem.removed, rem.stale, rem.staleness_frac),
                repaired=repaired, rebuilt=entry.matrix.cpu().numpy(),
                warm=warm.seeds.tolist(), cold=cold.seeds.tolist())


def _same_service(kern, plain, what) -> None:
    import numpy as np

    for key in ("built", "repaired", "rebuilt"):
        check(np.array_equal(kern[key], plain[key]), (what, key, "matrix"))
    for key in ("answers", "insert", "remove", "warm", "cold"):
        check(kern[key] == plain[key], (what, key))


def phase_service_parity(g) -> None:
    """The service on the kernel path against the plain path at rmat:14,
    J = 256, built by the single and by the serial backend; the async engine
    on both paths; then the launcher's ``--validate --ris``."""
    import numpy as np

    from repro_torch.graphs import rmat_graph
    from repro_torch.launch import im
    from repro_torch.launch.serve_im import make_workload
    from repro_torch.runtime import RunSpec

    queries = make_workload(g.n, 256, k=8, seed=7)
    rng = np.random.default_rng(17)
    add = (rng.integers(0, g.n, 256), rng.integers(0, g.n, 256))
    matrices = {}
    for name, spec, kernels in (
            ("single", RunSpec(num_registers=256), SINGLE_KERNELS),
            ("serial", RunSpec(num_registers=256, **SERIAL),
             SERIAL_KERNELS + ("sketch_propagate", "cascade_step"))):
        kern, t_k, t_p = _kernel_and_plain(
            lambda: _service_path(g, spec, queries, add, 50), kernels,
            f"service, {name}-built store", same=_same_service)
        matrices[name] = kern
        log(f"[3] service, 2-bank store built by {name}: 256 queries, insertion delta of "
            f"256 edges (repair sweeps, banks touched, rebuilt: {kern['insert']}), removal "
            f"of 50 (removed, stale, staleness: {kern['remove']}), warm top-k 8 "
            f"{kern['warm']} equal the plain path's and a cold find_seeds; kernel path "
            f"{t_k:.2f}s, plain path {t_p:.2f}s")
    for key in ("built", "repaired", "rebuilt"):
        check(np.array_equal(matrices["single"][key], matrices["serial"][key]),
              ("serial-built store", key))
    check(matrices["single"]["answers"] == matrices["serial"]["answers"],
          "serial-built store answers")
    log("[3] the serial-built store's matrices and answers equal the single-built one's")
    g2 = rmat_graph(14, setting="0.1", seed=1)
    which = np.random.default_rng(19).integers(0, 2, size=len(queries)).tolist()
    kern, t_k, t_p = _kernel_and_plain(
        lambda: _async_service_path((g, g2), queries, which, add), SINGLE_KERNELS,
        "async service", same=_same_async)
    log(f"[3] async engine, two rmat:14 graphs at J=256: {len(queries)} mixed queries "
        f"byte-equal to the sync engine's; insertion delta of 256 edges through "
        f"apply_delta_async in {kern['wall']:.3f}s (repair sweeps, banks touched, rebuilt: "
        f"{kern['insert']}) with {kern['sent']} queries submitted meanwhile, "
        f"{kern['during']} of them answered from version N before the swap, one from inside "
        f"the swap hook; the new index equals a cold build; all equal on the plain path; "
        f"kernel path {t_k:.2f}s, plain path {t_p:.2f}s")
    t0 = time.perf_counter()
    out = im.run(["--graph", "rmat:14", "--setting", "0.1", "--registers", "256", "--k", "8",
                  "--validate", "--ris"])
    for key in ("oracle_score", "ris_oracle"):
        check(np.isfinite(out[key]) and out[key] >= 8, (key, out[key]))
    log(f"[3] im --validate --ris rmat:14 J=256 K=8: oracle(difuser seeds) "
        f"{out['oracle_score']}, RIS {out['ris_time_s']}s, oracle(RIS seeds) "
        f"{out['ris_oracle']}, quality ratio {out['oracle_score'] / out['ris_oracle']:.4f} "
        f"({time.perf_counter() - t0:.1f}s)")


# --------------------------------------------------------------- phase 4 ----

def phase_full(k: int, model: str = FULL["model"], tag: str = "4") -> dict:
    """Phase 4 (and, for the other models, phase 14 (b)): the launcher at
    full size on phase 4's graph, the counters reset before it and read
    after it."""
    import numpy as np
    import torch

    from repro_torch.kernels import counters
    from repro_torch.launch import im

    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model",
            model, "--registers", str(FULL["registers"]), "--k", str(k)]
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    with _reuse_full_graph(im):   # generated once, outside the launcher's clock
        out = im.run(argv)
    launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {FULL['graph']} {model} n={out['n']} m={out['m']} J={FULL['registers']} "
        f"K={k}: prep {out['prep_s']:.3f}s, build {out['build_s']:.3f}s "
        f"({out['propagate_iters']} sweeps), rounds {out['rounds_s']:.3f}s "
        f"({out['cascade_sweeps']} cascade sweeps, {out['rebuild_sweeps']} rebuild "
        f"sweeps), total {out['time_s']:.2f}s, rebuilds {out['rebuilds']}/{k}, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[{tag}] launches {launches}; plain calls {plain}")
    check(not plain, f"{model}: plain versions ran on the main path: {plain}")
    missing = [n for n in SINGLE_KERNELS if launches.get(n, 0) <= 0]
    check(not missing, f"{model}: kernels not launched on the main path: {missing}")
    seeds = np.asarray(out["seeds"])
    check(len(seeds) == k and len(set(seeds.tolist())) == k, f"{model}: seeds not distinct")
    check(((seeds >= 0) & (seeds < out["n"])).all(), f"{model}: seed outside [0, n)")
    check(np.isfinite(out["difuser_score"]) and out["difuser_score"] > 0,
          f"{model}: influence estimate {out['difuser_score']}")
    out.update(launches=launches, peak_bytes=peak)
    return out


def phase_full_serial(k: int, single_seeds) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import counters
    from repro_torch.obs import shardprof
    from repro_torch.runtime import RunSpec, run

    g = full_graph()
    spec = RunSpec(num_registers=FULL["registers"], model=FULL["model"], **SERIAL)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    report = run(g, k, spec, device="cuda")
    wall = time.perf_counter() - t0
    launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    res, st, part = report.result, report.result.stats, report.partition
    log(f"[4b] serial {FULL['graph']} J={FULL['registers']} K={k} grid "
        f"{part.mu_v}x{part.mu_s} {SERIAL['partition']}, local_sweeps "
        f"{SERIAL['local_sweeps']} fused, lane_fill {SERIAL['lane_fill']}: host prep "
        f"dst sort {st['sort_s']:.3f}s, sample sets {st['sample_s']:.3f}s, plan {st['plan_s']:.3f}s, buckets "
        f"{st['buckets_s']:.3f}s, ring state {st['state_s']:.3f}s; build "
        f"{st['build_s']:.3f}s ({res.propagate_iters} sweeps); rounds "
        f"{st['rounds_s']:.3f}s ({st['cascade_sweeps']} cascade sweeps, "
        f"{st['rebuild_sweeps']} rebuild sweeps); total {wall:.2f}s; rebuilds "
        f"{int(res.rebuilds.sum())}/{k}; max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[4b] partition: {part.stats().describe()}; planned "
        f"{part.plan.predicted.describe()}; bucket widths propagate "
        f"{[int(a.shape[-1]) for a in part.p_h]}, cascade "
        f"{[int(a.shape[-1]) for a in part.c_h]}; sampled edges per sim shard "
        f"{part.p_counts.sum(axis=(0, 2)).tolist()}")
    prof = shardprof.last_profile()
    check(prof is not None and prof.per_step_timed and prof.phase == "fixpoint",
          "4b: no timed shard profile of the build")
    log(f"[4b] measured shard profile of the build (CUDA events per merge): time imbalance "
        f"{prof.time_imbalance():.3f}, bytes imbalance {prof.bytes_imbalance():.3f}, "
        f"shard seconds {[round(float(v), 4) for v in prof.shard_seconds()]}, "
        f"{prof.achieved_gbps():.1f} GB/s of bucket bytes over {prof.wall_s:.3f}s")
    log(f"[4b] launches {launches}; plain calls {plain}")
    check(not plain, f"plain versions ran on the serial path: {plain}")
    missing = [n for n in SERIAL_KERNELS if launches.get(n, 0) <= 0]
    check(not missing, f"kernels not launched on the serial path: {missing}")
    seeds = res.seeds
    check(len(set(seeds.tolist())) == k and ((seeds >= 0) & (seeds < g.n)).all(),
          "serial seeds not k distinct vertices")
    check(np.isfinite(res.scores[-1]) and res.scores[-1] > 0,
          f"influence estimate {res.scores[-1]}")
    if single_seeds is not None:
        np.testing.assert_array_equal(seeds, np.asarray(single_seeds))
        log("[4b] serial seeds equal the single backend's (phase 4)")
    return dict(launches=launches, peak_bytes=peak, wall_s=wall, partition=part,
                seeds=seeds.tolist(), score=float(res.scores[-1]),
                rebuilds=int(res.rebuilds.sum()), propagate_iters=res.propagate_iters, **st)


# --------------------------------------------------------------- phase 5 ----

def phase_ring_timings(serial: dict) -> list:
    """The serial ring's kernels at phase 4b's shapes: the largest propagate
    and cascade buckets, the largest kk = 0 bucket fused over 2 sweeps, and
    one chunk of fused_sample. The state is 4b's partition after the build;
    the cascade times the first round's first sweep."""
    import numpy as np
    import torch

    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.core.fasst import SAMPLE_CHUNK
    from repro_torch.diffusion import resolve
    from repro_torch.kernels import bucket_propagate as bp
    from repro_torch.kernels import cost, fused_sample, fused_sweep
    from repro_torch.partition.serial import _RingState
    from repro_torch.utils.roofline import HBM_BW

    part = serial["partition"]
    launches = serial["launches"]
    cfg = DiFuserConfig(num_registers=FULL["registers"], model=FULL["model"])
    g = full_graph().sorted_by_dst()
    st = _RingState(part, g, cfg,
                    local_sweeps=SERIAL["local_sweeps"], fuse_sweeps=True,
                    lane_fill=SERIAL["lane_fill"])
    st.fixpoint(st.sweep_propagate, cfg.max_propagate_iters)
    built = st.m.clone()
    seed_v, _ = st.select(part.mu_s * part.j_loc, part.n_pad)
    st.commit(seed_v)
    variant, j = st.variant, part.j_loc
    longest = {name: max(int(torch.diff(r.rowptr).max().item())
                         for step in grid for by_v in step for r in by_v)
               for name, grid in (("propagate", st.p_rows), ("cascade", st.c_rows))}
    log(f"[5] longest row over all buckets: {longest}")
    buckets = [r for grid in (st.p_rows, st.c_rows) for step in grid for by_v in step
               for r in by_v]
    list_bytes = sum(t.numel() * t.element_size() for r in buckets
                     for t in (r.work.item_ptr, r.work.item_row, r.work.item_slot,
                               r.work.split_row, r.work.split_ptr))
    log(f"[5] ring state: {len(buckets)} bucket work lists, {list_bytes / 1e9:.4f} GB; one "
        f"partial scratch of {tuple(st.partial.shape)} ({st.partial.numel() / 1e6:.3f} MB) "
        f"for every propagate and cascade merge")
    for inst, regs, spill in _PTXAS.get("bucket_propagate", []):
        if "in place" in inst:
            log(f"[5] ptxas {inst}: {regs} registers, {spill} bytes spilled")

    def gathers(nbytes):
        return (f"gathers {nbytes / 1e9:.4f} GB, {nbytes / HBM_BW * 1e3:.4f} ms "
                f"at the device memory rate")

    def touched(rows):
        """The rows the bucket's slots write and read."""
        return dict(write_rows=int((torch.diff(rows.rowptr) > 0).sum().item()),
                    read_rows=int(torch.unique(rows.nbr).numel()))

    out = []
    for name, replaces, grid, counts, m in (
            ("bucket_propagate", "src/repro/kernels/bucket_propagate.py:85", st.p_rows,
             part.p_counts, built),
            # no Pallas kernel: the reference's jnp merge of the cascade buckets
            ("bucket_cascade", "src/repro/core/distributed.py:88", st.c_rows,
             part.c_counts, st.m)):
        v, s, kk = np.unravel_index(int(np.argmax(counts)), counts.shape)
        rows, x = grid[kk][v][s], st.x[s]
        block = m[(v + kk) % part.mu_v, s]
        acc = m[v, s]
        slots = rows.nbr.numel()
        if name == "bucket_propagate":
            launch_cost = cost.bucket_propagate(part.n_loc, j, slots, variant, **touched(rows))
        else:   # one VISITED test per (slot, word), the predicate on VISITED reads
            vis_pairs = int((block == -1).sum(1)[rows.nbr.long()].sum().item())
            launch_cost = cost.bucket_cascade(part.n_loc, j, slots, variant,
                                              vis_pairs=vis_pairs, **touched(rows))
        # the merges reuse the ring state's scratch, as its sweeps do
        kw = dict(partial=st.partial)
        kern = getattr(bp, name + "_cuda")
        plain = getattr(bp, name + "_plain")
        a, b = acc.clone(), acc.clone()
        kern(a, block, rows, x, variant=variant, **kw)
        plain(b, block, rows, x, variant=variant)
        err = _max_abs_err(a, b)
        call = lambda f, **k: (lambda t: f(t, block, rows, x, variant=variant, **k))
        ms = _time_in_place_ms(acc.clone, call(kern, **kw), reps=5)
        plain_ms = _time_in_place_ms(acc.clone, call(plain), reps=1)
        log(f"[5] {name}: bucket (v={v}, s={s}, kk={kk}) of {slots} slots, longest row "
            f"{int(torch.diff(rows.rowptr).max().item())} slots; {_work_line(rows)}")
        out.append(_row(name, "bucket_propagate.cu", replaces, launches.get(name, 0), err,
                        ms, plain_ms, cost.bound_ms(launch_cost), note=gathers(slots * j)))

    # one launch over each propagate bucket of a ring sweep, each on its
    # built block, summed
    total_ms, total_slots, merges = 0.0, 0, 0
    for kk in range(part.mu_v):
        for v in range(part.mu_v):
            for s in range(part.mu_s):
                if not st.p_width[kk]:
                    continue
                rows, block = st.p_rows[kk][v][s], built[(v + kk) % part.mu_v, s]
                total_ms += _time_in_place_ms(
                    built[v, s].clone,
                    lambda t: bp.bucket_propagate_cuda(t, block, rows, st.x[s],
                                                       variant=variant, partial=st.partial),
                    reps=3)
                total_slots += rows.nbr.numel()
                merges += 1
    log(f"[5] bucket_propagate over a ring sweep's {merges} propagate buckets ({total_slots} "
        f"slots): {total_ms:.4f} ms in all, one launch each (mean of 3 per bucket), "
        f"{total_slots / total_ms / 1e6:.3f} G slots/s")
    serial["ring_sweep_propagate_ms"] = total_ms

    v, s = np.unravel_index(int(np.argmax(part.p_counts[:, :, 0])), part.p_counts.shape[:2])
    rows, x, m = st.p_rows[0][v][s], st.x[s], built[v, s]
    slots = rows.nbr.numel()
    fuse = dict(variant=variant, num_sweeps=SERIAL["local_sweeps"],
                lane_fill=SERIAL["lane_fill"])
    err = _max_abs_err(fused_sweep.fused_sweep_cuda(m, rows, x, **fuse),
                       fused_sweep.fused_sweep_plain(m, rows, x, **fuse))
    log(f"[5] fused_sweep: kk=0 bucket (v={v}, s={s}) of {slots} slots, "
        f"{SERIAL['local_sweeps']} whole-card item sweeps (an item launch and a combine "
        f"launch each); {_work_line(rows)}")
    out.append(_row(
        "fused_sweep", "fused_sweep.cu", "src/repro/kernels/fused_sweep.py:103",
        launches.get("fused_sweep", 0), err,
        _time_ms(lambda: fused_sweep.fused_sweep_cuda(m, rows, x, **fuse), reps=5),
        _time_ms(lambda: fused_sweep.fused_sweep_plain(m, rows, x, **fuse), reps=1),
        cost.bound_ms(cost.fused_sweep(part.n_loc, j, slots, variant,
                                       SERIAL["local_sweeps"])),
        note=gathers(SERIAL["local_sweeps"] * slots * j)))

    ep = resolve(cfg.model).edge_params(g, seed=cfg.seed)
    sample = [torch.from_numpy(a[:SAMPLE_CHUNK].view(np.int32)).cuda()
              for a in (ep.h, ep.lo, ep.thr)]
    num_e = sample[0].numel()
    x = st.x[0]
    err = _max_abs_err(fused_sample.fused_sample_cuda(*sample, x, variant=variant),
                       fused_sample.fused_sample_plain(*sample, x, variant=variant))
    out.append(_row(
        "fused_sample", "fused_sample.cu", "src/repro/kernels/fused_sample.py:60",
        launches.get("fused_sample", 0), err,
        _time_ms(lambda: fused_sample.fused_sample_cuda(*sample, x, variant=variant), reps=5),
        _time_ms(lambda: fused_sample.fused_sample_plain(*sample, x, variant=variant), reps=1),
        cost.bound_ms(cost.fused_sample(num_e, j, variant))))

    # a mesh rank's fill: its owned rows (vertex shard 0's of 4b's plan, by
    # their original ids) at sim shard 1's register slots
    from repro_torch.core.sketch import blank_matrix
    from repro_torch.kernels import sketch_fill

    ids = torch.from_numpy(part.owned_ids[0].astype(np.int64)).cuda()
    m = blank_matrix(part.n_loc, j, "cuda")
    fill = dict(ids=ids, reg_offset=j, seed=cfg.seed)
    err = _max_abs_err(sketch_fill.sketch_fill_cuda(m, **fill),
                       sketch_fill.sketch_fill_plain(m, **fill))
    check(err == 0.0, "sketch_fill with row ids differs from its plain version")
    bound_ms, bound_by = cost.bound_ms(cost.sketch_fill(*m.shape, id_bytes=8))
    serial["fill_ids"] = dict(
        ids_max_abs_err=err, ids_ms=_time_ms(lambda: sketch_fill.sketch_fill_cuda(m, **fill),
                                             reps=5),
        ids_plain_ms=_time_ms(lambda: sketch_fill.sketch_fill_plain(m, **fill), reps=1),
        ids_bound_ms=bound_ms, ids_bound_by=bound_by, ids_shape=tuple(m.shape))
    f = serial["fill_ids"]
    log(f"[5] sketch_fill with row ids (a mesh rank's owned rows, n_loc x j_loc "
        f"{tuple(m.shape)}, int64 ids): {f['ids_ms']:.4f} ms (plain {f['ids_plain_ms']:.3f} "
        f"ms, bound {bound_ms:.4f} ms by {bound_by}), max_abs_err {err}")
    return out



def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_in_place_ms(setup, fn, reps: int) -> float:
    """Mean time of ``fn(setup())`` over ``reps`` launches, each on a fresh
    ``setup()`` (an in-place kernel must not see its own output), timed by
    events around the launch alone."""
    import torch

    fn(setup())
    total = 0.0
    for _ in range(reps):
        arg = setup()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _work_line(rows) -> str:
    """A bucket's work list: items (those with slots), split rows, partials
    and the longest item."""
    import torch

    w = rows.work
    sizes = torch.diff(w.item_ptr)
    return (f"work list: {w.num_items} items ({int((sizes > 0).sum().item())} with slots), "
            f"{w.num_split} split rows, {w.num_partials} partials, longest item "
            f"{int(sizes.max().item())} slots")


def _row(name, file, replaces, launches, err, ms, plain_ms, bound, note="") -> dict:
    bound_ms, bound_by = bound
    log(f"[5] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"by {bound_by}{'; ' + note if note else ''}), launches {launches}, "
        f"max_abs_err {err}")
    check(err == 0.0, f"{name} differs from its plain version at full size")
    return dict(name=name, route="cuda", source="src/repro_torch/kernels/csrc/" + file,
                replaces=replaces, launches=int(launches), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _max_abs_err(a, b) -> float:
    import torch

    a = a[0] if isinstance(a, tuple) else a
    b = b[0] if isinstance(b, tuple) else b
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item())


def phase_timings(full: dict) -> list:
    import torch

    from repro_torch.core.difuser import (DiFuserConfig, build_sketch_matrix,
                                          edge_operands, normalize_inputs, x_tensor)
    from repro_torch.core.select import finish_select
    from repro_torch.diffusion import resolve
    from repro_torch.kernels import (cascade_step, cost, sketch_cardinality, sketch_fill,
                                     sketch_propagate)
    from repro_torch.kernels.edges import work_list
    from repro_torch.utils.roofline import HBM_BW

    cfg = DiFuserConfig(num_registers=FULL["registers"], model=FULL["model"])
    g, x = normalize_inputs(full_graph(), cfg)
    edges = edge_operands(g, cfg, "cuda")
    x_t = x_tensor(x, "cuda")
    variant = resolve(cfg.model).variant
    m, _, _ = build_sketch_matrix(g, cfg, x, normalized=True, edges=edges, device="cuda")
    s, _ = finish_select(sketch_cardinality.cardinality_stats_cuda(m), m.shape[1], g.n)
    m_casc = m.clone()
    m_casc[int(s.item())] = -1                    # the first round's first sweep
    n_pad, num_regs = m.shape
    num_edges = edges.num_edges
    vis_rows = (m_casc == -1).sum(1)
    vis_pairs = int(vis_rows[edges.src.long()].sum().item())

    specs = [
        ("sketch_fill", "sketch_fill.cu", "src/repro/kernels/sketch_fill.py:47",
         lambda: sketch_fill.sketch_fill_cuda(m),
         lambda: sketch_fill.sketch_fill_plain(m),
         cost.bound_ms(cost.sketch_fill(n_pad, num_regs))),
        ("sketch_cardinality", "sketch_cardinality.cu",
         "src/repro/kernels/sketch_cardinality.py:40",
         lambda: sketch_cardinality.cardinality_stats_cuda(m),
         lambda: sketch_cardinality.cardinality_stats_plain(m),
         cost.bound_ms(cost.sketch_cardinality(n_pad, num_regs))),
        ("sketch_propagate", "sketch_propagate.cu",
         "src/repro/kernels/sketch_propagate.py:121",
         lambda: sketch_propagate.propagate_sweep_cuda(m, edges, x_t, variant=variant),
         lambda: sketch_propagate.propagate_sweep_plain(m, edges, x_t, variant=variant),
         cost.bound_ms(cost.sketch_propagate(n_pad, num_regs, num_edges, variant))),
        # the cascade needs the predicate only where the source register is
        # VISITED: one test per (edge, 4-register word), the predicate on
        # vis_pairs
        ("cascade_step", "cascade_step.cu", "src/repro/kernels/cascade_step.py:80",
         lambda: cascade_step.cascade_sweep_cuda(m_casc, edges, x_t, variant=variant),
         lambda: cascade_step.cascade_sweep_plain(m_casc, edges, x_t, variant=variant),
         cost.bound_ms(cost.cascade_step(n_pad, num_regs, num_edges, variant, vis_pairs))),
    ]
    rows = []
    for name, file, replaces, kern, plain, bnd in specs:
        err = _max_abs_err(kern(), plain())
        rows.append(_row(name, file, replaces, full["launches"].get(name, 0), err,
                         _time_ms(kern, reps=5), _time_ms(plain, reps=1), bnd))
    out_deg = torch.diff(edges.by_src.rowptr).max().item()
    in_deg = torch.diff(edges.by_dst.rowptr).max().item()
    log(f"[5] longest row: out-degree {out_deg} (propagate), in-degree {in_deg} "
        f"(cascade)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for grouped in (edges.by_src, edges.by_dst):
        work_list(grouped.rowptr)
    torch.cuda.synchronize()
    log(f"[5] both work lists built again in {(time.perf_counter() - t0) * 1e3:.3f} ms "
        f"(host clock, part of the host prep)")
    for name, grouped in (("propagate", edges.by_src), ("cascade", edges.by_dst)):
        w = grouped.work
        log(f"[5] {name} work list: {w.num_items} items, {w.num_split} split rows, "
            f"{w.num_partials} partials, longest item "
            f"{torch.diff(w.item_ptr).max().item()} edges")
    log(f"[5] shapes: n_pad={n_pad} J={num_regs} E={num_edges} "
        f"(cascade: {vis_pairs} (edge, register) pairs with a VISITED source)")
    gather = num_edges * num_regs
    log(f"[5] the sweeps' gathers (each edge's read row, E x J): {gather / 1e9:.3f} GB, "
        f"{gather / HBM_BW * 1e3:.4f} ms at the device memory rate")
    return rows


# --------------------------------------------------------------- phase 6 ----

def phase_serve() -> dict:
    """The serving path at full width through the serve launcher, then the
    query loop alone, then an insertion delta and a warm top-k."""
    import numpy as np
    import torch

    from repro_torch.graphs import GraphDelta
    from repro_torch.kernels import cost, counters, sketch_cardinality
    from repro_torch.launch import serve_im
    from repro_torch.service import InfluenceEngine, Request, SpreadEstimate, TopKSeeds
    from repro_torch.service.queries import pad_candidate_sets

    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model", FULL["model"],
            "--registers", str(SERVE["registers"]), "--banks", str(SERVE["banks"]),
            "--queries", str(SERVE["queries"]), "--topk", str(SERVE["topk"]),
            "--max-batch", str(SERVE["max_batch"])]
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    out, sess, served = serve_im.run(argv, return_session=True)
    wall = time.perf_counter() - t0
    launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    entry = sess.entry()
    graph_before, built = sess.graph, entry.matrix.cpu().numpy()
    log(f"[6] serve {FULL['graph']} J={SERVE['registers']} {SERVE['banks']} bank, "
        f"{SERVE['queries']} queries: cold find_seeds {out['cold_s']:.3f}s, store build "
        f"{out['build_s']:.3f}s ({entry.build_iters} sweeps), served in {out['wall_s']:.4f}s "
        f"({out['qps']:.1f} qps), p50 {out['p50_ms']:.4f} ms, p99 {out['p99_ms']:.4f} ms, "
        f"amortized {out['amortized_s'] * 1e3:.4f} ms/query, top-k cache hits "
        f"{out['cache_hits']}, by backend {out['by_backend']}; launcher total {wall:.2f}s; "
        f"register matrix {entry.device_bytes() / 1e9:.3f} GB")
    log(f"[6] launcher run: launches {launches}; plain calls {plain}")
    check(not plain, f"plain versions ran on the serving path: {plain}")
    missing = [n for n in SINGLE_KERNELS if launches.get(n, 0) <= 0]
    check(not missing, f"kernels not launched on the serving path: {missing}")

    # the query loop alone, on the warm store, with a fresh memo
    workload = serve_im.make_workload(entry.graph.n, SERVE["queries"], k=SERVE["topk"],
                                      seed=7)
    requests = [Request(entry.key, q) for q in workload]
    engine = InfluenceEngine(sess.store, max_batch=SERVE["max_batch"])
    counters.reset()
    t0 = time.perf_counter()
    results = engine.run(requests)
    loop_s = time.perf_counter() - t0
    loop_launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    log(f"[6] query loop alone: {len(results)} queries in {loop_s:.4f}s "
        f"({len(results) / loop_s:.1f} qps); launches {loop_launches}; plain calls {plain}")
    check(not plain and loop_launches.get("sketch_cardinality", 0) > 0,
          f"query loop: launches {loop_launches}, plain {plain}")
    reductions = [r for r in requests if not isinstance(r.query, TopKSeeds)]
    with plain_ops():
        plain_results = InfluenceEngine(sess.store, max_batch=SERVE["max_batch"]).run(
            reductions)
    got = [_answer(r) for r in results if not isinstance(r.query, TopKSeeds)]
    check(got == [_answer(r) for r in plain_results],
          "query answers differ from the plain path's")
    for r in results:
        v = r.value
        vals = v["est"] if isinstance(v, dict) else getattr(v, "scores", v)
        check(np.all(np.isfinite(vals)), ("non-finite answer", r.query))
    log(f"[6] the {len(got)} spread, marginal and probe answers equal the plain path's")
    # the merged rows of the loop's first spread batch, as the kernel saw them
    sets = [r.query.candidates for r in requests
            if isinstance(r.query, SpreadEstimate)][:SERVE["max_batch"]]
    cands = pad_candidate_sets(sets, entry.graph.n_pad - 1, 8).astype(np.int64)
    rows = entry.matrix[torch.from_numpy(cands).cuda()].amax(1)
    card_ms = _time_ms(lambda: sketch_cardinality.cardinality_stats_cuda(rows), reps=20)
    card_plain = _time_ms(lambda: sketch_cardinality.cardinality_stats_plain(rows), reps=5)
    bound_ms, bound_by = cost.bound_ms(cost.sketch_cardinality(*rows.shape))
    log(f"[6] sketch_cardinality at a batch's shape ({tuple(rows.shape)}): {card_ms:.4f} ms "
        f"(plain {card_plain:.4f} ms, bound {bound_ms:.6f} ms by {bound_by})")

    # one insertion delta, then a warm top-k against a cold run
    rng = np.random.default_rng(1)
    n = entry.graph.n
    delta = GraphDelta.make(add=(rng.integers(0, n, SERVE["delta_edges"]),
                                 rng.integers(0, n, SERVE["delta_edges"])))
    counters.reset()
    rep = sess.apply_delta(delta)
    delta_launches = dict(counters.LAUNCHES)
    log(f"[6] insertion delta of {SERVE['delta_edges']} edges: {rep.time_s:.3f}s, repair "
        f"sweeps {rep.repair_sweeps}, banks touched {rep.banks_touched}, rebuilt "
        f"{rep.rebuilt}; launches {delta_launches}")
    check(not rep.rebuilt and rep.repair_sweeps > 0, f"delta report {rep}")
    repaired = entry.matrix.cpu().numpy()
    t0 = time.perf_counter()
    warm = sess.find_seeds_warm(SERVE["topk"])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = sess.find_seeds(SERVE["topk"])
    cold_s = time.perf_counter() - t0
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    peak = torch.cuda.max_memory_allocated()
    log(f"[6] warm top-{SERVE['topk']} after the delta {warm_s:.3f}s, seeds "
        f"{warm.seeds.tolist()} equal a cold find_seeds on the post-delta graph "
        f"({cold_s:.3f}s); max_memory_allocated {peak / 2**30:.2f} GiB")
    # phase 7 repeats this build and this delta through the async engine
    _SERVE.update(built=built, repaired=repaired, delta=delta, graph=graph_before,
                  spec=sess.spec, answers=[_exact(r) for r in served],
                  insert=(rep.repair_sweeps, rep.banks_touched, rep.rebuilt))
    plain_s = _serve_plain_replay(sess.spec, graph_before, delta, built, rep, repaired, warm)
    host = _serve_host_split(entry, delta)
    log("[6] host steps, each run once more (host clock, device work synced): " +
        ", ".join(f"{k} {v:.3f}s" for k, v in host.items()))
    return dict(out, launches=launches, loop_launches=loop_launches, loop_s=loop_s,
                delta_s=rep.time_s, repair_sweeps=rep.repair_sweeps,
                delta_launches=delta_launches, warm_s=warm_s, peak_bytes=peak,
                card_batch_ms=card_ms, card_batch_plain_ms=card_plain, host_s=host,
                plain_replay_s=plain_s)


def _serve_plain_replay(spec, graph, delta, built, rep, repaired, warm) -> float:
    """Phase 6's store build, delta and warm top-k once more on the plain
    path, from the same graph, spec (so the same x) and delta: the built
    and the repaired matrices, the repair's sweeps and banks, and the warm
    seeds must equal the kernel path's. Returns the replay's seconds."""
    import numpy as np

    from repro_torch.kernels import counters
    from repro_torch.runtime import InfluenceSession

    counters.reset()
    t0 = time.perf_counter()
    with plain_ops():
        sess = InfluenceSession(graph, spec, num_banks=SERVE["banks"], device="cuda")
        check(np.array_equal(sess.entry().matrix.cpu().numpy(), built),
              "serve: the built matrix differs from the plain path's")
        rep_p = sess.apply_delta(delta)
        check(np.array_equal(sess.entry().matrix.cpu().numpy(), repaired),
              "serve: the repaired matrix differs from the plain path's")
        warm_p = sess.find_seeds_warm(SERVE["topk"])
    dt = time.perf_counter() - t0
    check(not counters.LAUNCHES and set(counters.PLAIN_CALLS) == set(SINGLE_KERNELS),
          f"serve plain replay: launches {dict(counters.LAUNCHES)}, plain "
          f"{dict(counters.PLAIN_CALLS)}")
    for key in ("repair_sweeps", "banks_touched", "rebuilt", "removed"):
        check(getattr(rep_p, key) == getattr(rep, key), ("serve delta report", key))
    np.testing.assert_array_equal(warm_p.seeds, warm.seeds)
    np.testing.assert_array_equal(warm_p.rebuilds, warm.rebuilds)
    check(warm_p.stats["cascade_sweeps"] == warm.stats["cascade_sweeps"],
          "serve warm top-k cascade sweeps")
    np.testing.assert_allclose(warm.scores, warm_p.scores, rtol=1e-6, atol=0)
    log(f"[6] plain-path replay ({dt:.2f}s): the built matrix, the repaired matrix, repair "
        f"sweeps {rep_p.repair_sweeps}, banks touched {rep_p.banks_touched} and the warm "
        f"seeds equal the kernel path's")
    return dt


def _serve_host_split(entry, delta) -> dict:
    """The host steps of the serve launcher and of a delta, timed one by one
    on phase 6's graph: the graph's generation, one store key, the
    destination sort, the model lowering with its upload and work lists, and
    the delta's new graph (``Graph.apply_delta``'s dedup) and the match of
    its added pairs."""
    import numpy as np
    import torch

    from repro_torch.core.difuser import edge_operands
    from repro_torch.graphs import edge_pair_keys
    from repro_torch.launch.common import make_graph

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    g = entry.graph
    split = {}
    _, split["graph generation"] = timed(lambda: make_graph(FULL["graph"], FULL["setting"], 0))
    _, split["store key"] = timed(g.content_key)
    _, split["destination sort"] = timed(g.sorted_by_dst)
    _, split["edge operands"] = timed(lambda: edge_operands(g, entry.cfg, "cuda"))
    _, split["delta's new graph"] = timed(lambda: g.apply_delta(delta))
    r = g.m_real
    _, split["added-pair match"] = timed(lambda: np.isin(
        edge_pair_keys(g.src[:r], g.dst[:r], g.n_pad),
        edge_pair_keys(delta.add_src, delta.add_dst, g.n_pad)))
    return split


_SERVE: dict = {}   # phase 6's matrices, delta and answers, for phases 7, 8 and 11
_TRACED: list = []  # phase 8 (d)'s span events, for phase 9's report


@contextlib.contextmanager
def _reuse_full_graph(module):
    """``module.make_graph`` hands back phase 4's graph (``full_graph``)
    instead of generating it again, for the length of a block."""
    orig = module.make_graph

    def make(spec, setting, seed):
        if (spec, setting, seed) == (FULL["graph"], FULL["setting"], 0):
            return full_graph()
        return orig(spec, setting, seed)

    module.make_graph = make
    try:
        yield
    finally:
        module.make_graph = orig


@contextlib.contextmanager
def _counted(into, what):
    """Adds the kernel launches made inside the block to ``into`` (a
    ``Counter``); fails if a plain version ran there. Phase 7 counts only
    the launcher and the async engines: its sync reference answers run
    outside such blocks."""
    from repro_torch.kernels import counters

    counters.reset()
    yield
    launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    check(not plain, f"plain versions ran in {what}: {plain}")
    into.update(launches)


def _ms(lat) -> str:
    import numpy as np

    if not lat:
        return "n/a"
    return (f"p50 {np.percentile(lat, 50) * 1e3:.4f} ms, "
            f"p99 {np.percentile(lat, 99) * 1e3:.4f} ms")


def phase_async() -> dict:
    """Async serving at full width: the serve launcher with ``--async`` on
    phase 6's graph and stream; phase 6's delta through
    ``apply_delta_async`` while spread and probe queries keep coming; then
    two rmat:18 graphs beside the rmat:20 index under a resident budget.
    Launches are counted around the launcher (``launcher``) and the async
    engines (``engines``) alone."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.kernels import counters
    from repro_torch.launch import serve_im
    from repro_torch.launch.common import make_graph
    from repro_torch.obs import metrics
    from repro_torch.service import (CoverageProbe, InfluenceEngine, MarginalGain, Request,
                                     SketchStore, SpreadEstimate, TopKSeeds)

    check(bool(_SERVE), "phase 7 repeats phase 6's build and delta: run phase 6 first")
    torch.cuda.reset_peak_memory_stats()
    launcher, engines = Counter(), Counter()
    t_phase = time.perf_counter()

    # 1. the launcher, --async, phase 6's arguments
    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model", FULL["model"],
            "--registers", str(SERVE["registers"]), "--banks", str(SERVE["banks"]),
            "--queries", str(SERVE["queries"]), "--topk", str(SERVE["topk"]),
            "--max-batch", str(SERVE["max_batch"]), "--async", "--deadline-ms", "50"]
    t0 = time.perf_counter()
    with _reuse_full_graph(serve_im), _counted(launcher, "serve --async"):
        out, sess, results = serve_im.run(argv, return_session=True)
    launcher_s = time.perf_counter() - t0
    store, entry = sess.store, sess.entry()
    key = entry.key
    check(np.array_equal(entry.matrix.cpu().numpy(), _SERVE["built"]),
          "phase 7's store build differs from phase 6's")
    workload = serve_im.make_workload(entry.graph.n, SERVE["queries"], k=SERVE["topk"],
                                      seed=7)
    sync = InfluenceEngine(store, max_batch=SERVE["max_batch"])
    want = [_exact(r) for r in sync.run([Request(key, q) for q in workload])]
    check([r.query for r in results] == workload, "the launcher's stream")
    check([_exact(r) for r in results] == want,
          "serve --async answers differ from the sync engine's")
    adm = out["admission"]
    log(f"[7] serve --async --deadline-ms 50, {FULL['graph']} J={SERVE['registers']}, "
        f"{SERVE['queries']} queries: served in {out['wall_s']:.4f}s ({out['qps']:.1f} qps), "
        f"end to end p50 {adm['e2e_p50_ms']:.4f} ms p95 {adm['e2e_p95_ms']:.4f} ms p99 "
        f"{adm['e2e_p99_ms']:.4f} ms, deadline misses {adm['deadline_misses']} "
        f"({adm['deadline_miss_rate']:.4f}), flushes {adm['flushes']}; batch latency p50 "
        f"{out['p50_ms']:.4f} ms p99 {out['p99_ms']:.4f} ms; launcher {launcher_s:.2f}s "
        f"(graph reused); the {len(want)} answers equal the sync engine's byte for byte")

    # 2. phase 6's delta under load
    pool = [q for q in workload if isinstance(q, (SpreadEstimate, CoverageProbe))][:256]
    before = [_exact(r) for r in sync.run([Request(key, q) for q in pool])]
    with _counted(engines, "the async delta"), _timed_engine(
            engine=InfluenceEngine(store, max_batch=SERVE["max_batch"]),
            deadline_ms=50.0) as aeng:
        rep, delta_wall, sent = _delta_under_load(aeng, key, _SERVE["delta"], pool,
                                                  interval_s=0.002)
        marks = dict(aeng.marks)
    repaired = store.entry(key).matrix.cpu().numpy()
    check(np.array_equal(repaired, _SERVE["repaired"]),
          "the async delta's matrix differs from phase 6's repaired matrix")
    check((rep.repair_sweeps, rep.banks_touched, rep.rebuilt) == _SERVE["insert"],
          ("async delta report", rep))
    after = [_exact(r) for r in sync.run([Request(key, q) for q in pool])]
    lat = _check_swap_order(marks, sent, before, after, "phase 7 delta")
    swap_s = marks["swapped"] - marks["before_swap"]
    log(f"[7] async insertion delta of {SERVE['delta_edges']} edges: {rep.time_s:.3f}s in "
        f"apply_delta, {delta_wall:.3f}s from submit to its future, swap {swap_s * 1e3:.4f} ms "
        f"(repair sweeps {rep.repair_sweeps}, banks touched {rep.banks_touched}); "
        f"{len(sent)} spread and probe queries submitted meanwhile, {len(lat)} answered "
        f"from version N while the delta was in flight ({_ms(lat)}); every answer before the "
        f"swap is version N's, after it the repaired index's, which equals phase 6's")

    # 3. tenancy: two rmat:18 graphs beside the rmat:20 index, under a budget
    cfg = entry.cfg
    t0 = time.perf_counter()
    g18 = [make_graph(TENANT_GRAPH, FULL["setting"], seed) for seed in (1, 2)]
    keys = [key] + [sync.register(g, cfg) for g in g18]
    sizes = [store.entry(k).device_bytes() for k in keys]
    budget = int(sizes[0] + 1.5 * sizes[1])
    check(budget < sum(sizes), "the budget must hold fewer than the three indexes")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    waves = []
    for w, (a, b) in enumerate([(0, 1), (1, 2), (2, 0)] * 2):   # round robin over the keys
        # a warm top-k against a first: while the serve thread runs it, the
        # rest of the wave queues up, so its buckets of both keys flush
        # together (the cross-entry batch)
        wave = [(a, TopKSeeds(SERVE["topk"] + w))]
        for i in range(48):
            k = (a, b)[i % 2]
            n = store.entry(keys[k]).graph.n
            kind = int(rng.integers(0, 5))
            if kind < 3:
                q = SpreadEstimate(rng.integers(0, n, int(rng.integers(1, 9))))
            elif kind == 3:
                q = MarginalGain(int(rng.integers(0, n)), rng.integers(0, n, 3))
            else:
                q = CoverageProbe(rng.integers(0, n, 3))
            wave.append((k, q))
        waves.append(wave)
    want = [[_exact(r) for r in sync.run([Request(keys[k], q) for k, q in wave])]
            for wave in waves]
    evictions0 = metrics.counter("store.evictions").value
    rebuilt = metrics.histogram("store.evicted_rebuild_s", unit="s")
    rebuilt0 = (rebuilt.count, rebuilt.total)
    t0 = time.perf_counter()
    with _counted(engines, "tenancy"), _timed_engine(
            engine=InfluenceEngine(store, max_batch=SERVE["max_batch"]),
            deadline_ms=50.0, max_resident_mb=budget / 2**20) as aeng:
        check(aeng.evictor.budget_bytes <= budget, "budget")
        window_s = aeng.deadline_ms / 4e3
        for wave, wave_want in zip(waves, want):
            futs = [aeng.submit(keys[wave[0][0]], wave[0][1])]
            time.sleep(2 * window_s)        # the top-k's bucket has flushed
            futs += [aeng.submit(keys[k], q) for k, q in wave[1:]]
            got = [_exact(r) for r in _results(futs, "tenancy stream")]
            check(got == wave_want, "a tenancy answer differs from the sync engine's")
            aeng.drain(600)
        after_enforce, cross = list(aeng.after_enforce), list(aeng.cross_keys)
        budget_bytes = aeng.evictor.budget_bytes
    tenancy_s = time.perf_counter() - t0
    evictions = metrics.counter("store.evictions").value - evictions0
    rebuilds, rebuild_s = rebuilt.count - rebuilt0[0], rebuilt.total - rebuilt0[1]
    cross_18 = sum(1 for ks in cross if keys[1] in ks and keys[2] in ks)
    check(after_enforce and max(after_enforce) <= budget_bytes,
          f"held bytes over the budget after a budget pass: {after_enforce}")
    check(evictions >= 1 and rebuilds >= 1 and cross_18 >= 1,
          f"tenancy: evictions {evictions}, rebuilds {rebuilds}, cross batches {cross}")
    log(f"[7] tenancy: {FULL['graph']} ({sizes[0] / 1e9:.3f} GB) and two {TENANT_GRAPH} "
        f"({sizes[1] / 1e9:.3f}, {sizes[2] / 1e9:.3f} GB) at J={SERVE['registers']} under "
        f"{budget_bytes / 1e9:.3f} GB ({setup_s:.2f}s to generate and build the two): "
        f"{sum(len(w) for w in waves)} queries in {len(waves)} waves in {tenancy_s:.2f}s, "
        f"evictions {evictions}, evicted rebuilds {rebuilds} ({rebuild_s:.3f}s), "
        f"cross-entry batches {len(cross)} ({cross_18} with both {TENANT_GRAPH} entries), held "
        f"bytes (resident and the cross stack) after each of {len(after_enforce)} budget passes "
        f"at most {max(after_enforce) / 1e9:.3f} GB; every answer equals the sync engine's")

    # an rmat:18 index rebuilt after its eviction against a plain-path build
    k18 = next((k for k in keys[1:] if not store.is_evicted(k) and store.entry(k).evictions),
               keys[1])
    e18 = store.entry(k18)       # rebuilt here, outside the counts, if still evicted
    check(e18.evictions >= 1, f"{TENANT_GRAPH} entry {k18} was never evicted")
    counters.reset()
    t0 = time.perf_counter()
    with plain_ops():
        plain18 = SketchStore(num_banks=store.num_banks, spec=store.spec,
                              device="cuda").get_or_build(e18.graph, e18.cfg, e18.x)
    plain18_s = time.perf_counter() - t0
    check(not counters.LAUNCHES and set(counters.PLAIN_CALLS) >= {"sketch_fill",
                                                                 "sketch_propagate"},
          f"plain {TENANT_GRAPH} build: launches {dict(counters.LAUNCHES)}, plain "
          f"{dict(counters.PLAIN_CALLS)}")
    check(np.array_equal(plain18.matrix.cpu().numpy(), e18.matrix.cpu().numpy()),
          f"the {TENANT_GRAPH} index rebuilt after eviction differs from the plain path's")
    log(f"[7] the {TENANT_GRAPH} index rebuilt after {e18.evictions} eviction(s) equals its "
        f"build on the plain path ({plain18_s:.2f}s)")

    # 4. the phase's launches: the launcher's and the async engines' own
    peak = torch.cuda.max_memory_allocated()
    log(f"[7] launches of serve --async {dict(launcher)}; of the async engines "
        f"{dict(engines)}; max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    missing = [n for n in SINGLE_KERNELS if engines.get(n, 0) <= 0]
    check(not missing, f"kernels not launched by the async engines: {missing}")
    _SERVE["admission"] = adm      # phase 9's report
    return dict(launches=dict(launcher + engines), launcher_launches=dict(launcher),
                engine_launches=dict(engines), qps=out["qps"], e2e_p50_ms=adm["e2e_p50_ms"],
                e2e_p99_ms=adm["e2e_p99_ms"], miss_rate=adm["deadline_miss_rate"],
                flushes=adm["flushes"], delta_s=rep.time_s, delta_wall_s=delta_wall,
                swap_s=swap_s, in_flight=len(lat), sent=len(sent),
                in_flight_p50_ms=float(np.percentile(lat, 50) * 1e3) if lat else None,
                in_flight_p99_ms=float(np.percentile(lat, 99) * 1e3) if lat else None,
                evictions=evictions, rebuilds=rebuilds, rebuild_s=rebuild_s,
                cross_batches=len(cross), cross_18=cross_18, budget_bytes=budget_bytes,
                peak_bytes=peak, phase_s=time.perf_counter() - t_phase)


# --------------------------------------------------------------- phase 8 ----

@contextlib.contextmanager
def _timed_merges(into: list):
    """``ops.bucket_propagate`` with a pair of CUDA events around each launch,
    for the length of a block; ``into`` gets the pairs (read them after a
    sync). The serial ring calls the merge as a module attribute."""
    import torch

    from repro_torch.kernels import ops

    orig = ops.bucket_propagate

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        into.append((start, end))
        return out

    ops.bucket_propagate = timed
    try:
        yield
    finally:
        ops.bucket_propagate = orig


def _events_s(pairs) -> float:
    import torch

    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) * 1e-3


def _span_split(events, top=8) -> str:
    """Seconds and count per span name, the largest first."""
    from collections import defaultdict

    tot, cnt = defaultdict(float), defaultdict(int)
    for ev in events:
        tot[ev["name"]] += ev["dur_s"]
        cnt[ev["name"]] += 1
    names = sorted(tot, key=tot.get, reverse=True)[:top]
    return ", ".join(f"{n} {tot[n]:.3f}s x{cnt[n]}" for n in names)


def _traced_repair(store, key, delta, launches, what):
    """``apply_delta(…, backend="serial")`` with the span recorder on, its
    launches added to ``launches`` and its merges timed by CUDA events.
    Returns (report, the repaired matrix, wall s, merge device s, spans)."""
    from repro_torch.obs import trace
    from repro_torch.service import apply_delta

    rec = trace.get_recorder()
    pairs: list = []
    rec.start()
    try:
        with _counted(launches, what), _timed_merges(pairs):
            t0 = time.perf_counter()
            rep = apply_delta(store, key, delta, backend="serial")
            wall = time.perf_counter() - t0
    finally:
        rec.stop()
    return rep, store.entry(key).matrix, wall, _events_s(pairs), rec.events()


def phase_shard_repair(full, serial, k: int) -> dict:
    """Shard-restricted delta repair and the drivers' spans on phase 4's
    graph: phase 6's J = 512 index with an 8-shard ``block`` plan attached
    takes (a) phase 6's random delta and (b) a delta inside plan shard 0,
    each through ``apply_delta(…, backend="serial")`` and held against the
    per-bank repair of the same delta on a clone; the backends' hooks and a
    warm top-k after (b); (c) the same on the plain path; (d) ``im --trace
    --metrics`` on the single path and the phase 4b grid traced."""
    import argparse
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.core.difuser import find_seeds
    from repro_torch.core.sketch import VISITED
    from repro_torch.graphs import GraphDelta
    from repro_torch.kernels import counters
    from repro_torch.launch import im
    from repro_torch.launch.common import make_graph, observe
    from repro_torch.obs import metrics, shardprof, trace
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import InfluenceSession, RunSpec, get_backend, run
    from repro_torch.service import apply_delta
    from repro_torch.service.queries import top_k_seeds

    check(bool(_SERVE), "phase 8 repeats phase 6's index and delta: run phase 6 first")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    launches = Counter()
    graph, spec, delta = _SERVE["graph"], _SERVE["spec"], _SERVE["delta"]
    single, ring = get_backend("single"), get_backend("serial")

    sess = InfluenceSession(graph, spec, device="cuda")
    entry = sess.entry()
    key, x = entry.key, entry.x
    built = entry.matrix            # version 0's banks: every mutation is out of place
    check(np.array_equal(built.cpu().numpy(), _SERVE["built"]),
          "phase 8's index differs from phase 6's build")
    t0 = time.perf_counter()
    plan = plan_partition(entry.graph, REPAIR["plan_shards"], mu_s=1,
                          strategy=REPAIR["strategy"], x=x, seed=spec.seed, device="cuda")
    plan_s = time.perf_counter() - t0
    sess.store.attach_plan(key, plan)

    # (a) phase 6's random delta; its per-bank repair is phase 6's own, whose
    # matrix this one must equal (the phase no longer repeats it on a clone)
    rep_a, m_a, wall_a, dev_a, spans_a = _traced_repair(sess.store, key, delta, launches,
                                                        "8a repair")
    check(np.array_equal(m_a.cpu().numpy(), _SERVE["repaired"]),
          "8a: the shard repair differs from phase 6's per-bank repaired matrix")
    clone = sess.store.shadow(key)  # (b)'s per-bank repair's copy, sharing (a)'s banks
    check(torch.equal(built, torch.from_numpy(_SERVE["built"]).cuda()),
          "8a: the repair wrote version 0's matrix")
    all_shards = tuple(range(REPAIR["plan_shards"]))
    check(rep_a.repair_backend == "serial" and not rep_a.rebuilt
          and rep_a.plan_shards_touched == all_shards and rep_a.shards_swept == all_shards,
          f"8a report {rep_a}")
    log(f"[8a] {REPAIR['plan_shards']}-shard {REPAIR['strategy']} plan (mu_s 1) in "
        f"{plan_s:.3f}s; {REPAIR['delta_edges']}-edge random delta through the serial "
        f"shard repair: repair sweeps {rep_a.repair_sweeps}, plan shards touched "
        f"{rep_a.plan_shards_touched}, shards swept {rep_a.shards_swept}, banks touched "
        f"{rep_a.banks_touched}; bucket_propagate launches "
        f"{launches.get('bucket_propagate', 0)}; host {wall_a:.3f}s, merges on the device "
        f"{dev_a:.3f}s; byte-equal to phase 6's per-bank repair of it "
        f"({_SERVE['insert'][0]} sweeps)")
    log(f"[8a] spans: {_span_split(spans_a)}")

    # the backends' hooks from version 0's matrix on the post-(a) graph
    g_a = sess.store.entry(key).graph
    with _counted(launches, "8a hooks"):
        t0 = time.perf_counter()
        m_fix, it_fix = single.fixpoint(built, g_a, spec, x)
        t1 = time.perf_counter()
        m_ring, it_ring = ring.fixpoint(built, g_a, spec.with_(mu_v=REPAIR["plan_shards"],
                                                               mu_s=1), x)
        t2 = time.perf_counter()
    check(torch.equal(m_fix, m_a) and torch.equal(m_ring, m_a),
          "8a: a backend's fixpoint hook differs from the shard repair")
    log(f"[8a] hooks: single fixpoint {it_fix} sweeps {t1 - t0:.3f}s, serial fixpoint (all "
        f"shards dirty) {it_ring} sweeps {t2 - t1:.3f}s; both equal the shard repair")
    del m_fix, m_ring

    # (b) a delta inside plan shard 0
    in_0 = np.flatnonzero(plan.owner_of(np.arange(graph.n)) == 0)
    rng = np.random.default_rng(2)
    local = GraphDelta.make(add=(rng.choice(in_0, REPAIR["delta_edges"]),
                                 rng.choice(in_0, REPAIR["delta_edges"])))
    before = launches.get("bucket_propagate", 0)
    t0 = time.perf_counter()
    rep_pb_b = apply_delta(clone, key, local)
    pb_b_s = time.perf_counter() - t0
    rep_b, m_b, wall_b, dev_b, spans_b = _traced_repair(sess.store, key, local, launches,
                                                        "8b repair")
    check(torch.equal(m_b, clone.entry(key).matrix),
          "8b: the shard repair differs from the per-bank repair")
    check(rep_b.plan_shards_touched == (0,) and rep_b.repair_backend == "serial"
          and 0 in rep_b.shards_swept, f"8b report {rep_b}")
    per_sweep = [ev["attrs"]["shards"] for ev in spans_b if ev["name"] == "serial.repair_sweep"]
    log(f"[8b] {REPAIR['delta_edges']}-edge delta inside plan shard 0 ({in_0.size} vertices): "
        f"plan shards touched {rep_b.plan_shards_touched}, shards swept {rep_b.shards_swept}, "
        f"per sweep {per_sweep}; repair sweeps {rep_b.repair_sweeps}, banks touched "
        f"{rep_b.banks_touched}; bucket_propagate launches "
        f"{launches.get('bucket_propagate', 0) - before}; host {wall_b:.3f}s, merges on the "
        f"device {dev_b:.3f}s; byte-equal to the per-bank repair on a clone ({pb_b_s:.3f}s, "
        f"{rep_pb_b.repair_sweeps} sweeps)")
    log(f"[8b] spans: {_span_split(spans_b)}")
    del clone

    # a warm top-k and the cascade hook on the repaired index
    g_b = sess.store.entry(key).graph
    with _counted(launches, "8b warm top-k and cascade hook"):
        warm = top_k_seeds(sess.store, sess.store.entry(key), SERVE["topk"])
        s0 = int(warm.seeds[0])
        m_c, it_c = single.cascade(m_b, s0, g_b, spec, x)
    cold = find_seeds(g_b, SERVE["topk"], entry.cfg, x=x, device="cuda")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    check(bool((m_c[s0] == VISITED).all()), "8b: the cascade hook left the seed's row")
    log(f"[8b] warm top-{SERVE['topk']} after both repairs {warm.seeds.tolist()} equals a "
        f"cold find_seeds; cascade hook from seed {s0}: {it_c} sweeps")
    missing = [n for n in REPAIR_KERNELS if launches.get(n, 0) <= 0]
    check(not missing, f"kernels not launched on the repair path: {missing}")
    peak_kernel = torch.cuda.max_memory_allocated()
    log(f"[8b] max_memory_allocated on the kernel path (a, b, hooks, top-k) "
        f"{peak_kernel / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    # (c) the plain path, at rmat:18: the build, both repairs and the cascade
    # hook on both paths (a cut of depth from rmat:20, which bounds the
    # script's time; the kernel path at rmat:20 is held by (a) and (b) above)
    del m_c, m_a, m_b, built, sess, entry
    torch.cuda.empty_cache()
    g18 = make_graph(TENANT_GRAPH, FULL["setting"], 0)
    plan18 = plan_partition(g18.sorted_by_dst(), REPAIR["plan_shards"], mu_s=1,
                            strategy=REPAIR["strategy"], x=x, seed=spec.seed, device="cuda")
    rng = np.random.default_rng(1)
    d18 = [GraphDelta.make(add=(rng.integers(0, g18.n, REPAIR["delta_edges"]),
                                rng.integers(0, g18.n, REPAIR["delta_edges"])))]
    in_0 = np.flatnonzero(plan18.owner_of(np.arange(g18.n)) == 0)
    d18.append(GraphDelta.make(add=(rng.choice(in_0, REPAIR["delta_edges"]),
                                    rng.choice(in_0, REPAIR["delta_edges"]))))
    s18 = int(np.argmax(np.bincount(g18.src[:g18.m_real], minlength=g18.n)))

    def replay():
        psess = InfluenceSession(g18, spec, device="cuda")
        pe = psess.entry()
        psess.store.attach_plan(pe.key, plan18)
        got = dict(built=pe.matrix.clone())
        for name, d in zip(("a", "b"), d18):
            got[name] = apply_delta(psess.store, pe.key, d, backend="serial")
            got[name + "_m"] = psess.store.entry(pe.key).matrix
        pe = psess.store.entry(pe.key)
        got["cascade"] = single.cascade(got["b_m"], s18, pe.graph, spec, pe.x)
        return got

    t0 = time.perf_counter()
    with _counted(Counter(), "8c kernel path"):
        kern = replay()
    kern_s = time.perf_counter() - t0
    counters.reset()
    t0 = time.perf_counter()
    with plain_ops():
        plain = replay()
    plain_s = time.perf_counter() - t0
    check(not counters.LAUNCHES, f"8c plain path launched {dict(counters.LAUNCHES)}")
    for name in ("built", "a_m", "b_m"):
        check(torch.equal(kern[name], plain[name]), f"8c: {name} differs")
    for name in ("a", "b"):
        for field in ("repair_sweeps", "plan_shards_touched", "shards_swept", "banks_touched"):
            check(getattr(kern[name], field) == getattr(plain[name], field),
                  ("8c report", name, field))
    check(kern["b"].plan_shards_touched == (0,) and kern["a"].repair_backend == "serial",
          f"8c reports {kern['a']}, {kern['b']}")
    check(torch.equal(kern["cascade"][0], plain["cascade"][0])
          and kern["cascade"][1] == plain["cascade"][1], "8c: the cascade hook differs")
    log(f"[8c] plain-path replay at {TENANT_GRAPH} ({plain_s:.2f}s; the kernel path "
        f"{kern_s:.2f}s; plain calls {dict(counters.PLAIN_CALLS)}): build, both repairs "
        f"({kern['a'].repair_sweeps} and {kern['b'].repair_sweeps} sweeps, shards swept "
        f"{kern['b'].shards_swept} for the delta inside shard 0), their sweeps and shards and "
        f"the cascade hook ({kern['cascade'][1]} sweeps) equal the kernel path's")
    del kern, plain

    # (d) the launcher's spans at full size, single path and the phase 4b grid
    traced = {}
    OUT.mkdir(parents=True, exist_ok=True)
    rec = trace.get_recorder()
    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model", FULL["model"],
            "--registers", str(FULL["registers"]), "--k", str(k),
            "--trace", str(OUT / "trace_single.json"),
            "--metrics", str(OUT / "metrics_single.jsonl")]
    t0 = time.perf_counter()
    with _reuse_full_graph(im):   # phase 4's graph, not a second generation of it
        out = im.run(argv)
    traced["single"] = dict(wall_s=time.perf_counter() - t0, time_s=out["time_s"],
                            seeds=out["seeds"], events=rec.events())
    args = argparse.Namespace(trace=str(OUT / "trace_serial.json"),
                              metrics=str(OUT / "metrics_serial.jsonl"))
    t0 = time.perf_counter()
    with observe(args):
        rep = run(full_graph(), k, RunSpec(num_registers=FULL["registers"],
                                           model=FULL["model"], **SERIAL), device="cuda")
    traced["serial"] = dict(wall_s=time.perf_counter() - t0, time_s=rep.wall_s,
                            seeds=rep.result.seeds.tolist(), events=rec.events())
    check(traced["single"]["seeds"] == traced["serial"]["seeds"],
          "8d: traced single and serial seeds differ")
    _TRACED.extend(traced["single"]["events"] + traced["serial"]["events"])  # phase 9
    for name, ref in (("single", full), ("serial", serial)):
        t = traced[name]
        evs = t["events"]
        top = sum(ev["dur_s"] for ev in evs if ev["depth"] == 0)
        lanes = sorted({ev["phase"] for ev in evs})
        untraced = ""
        if ref is not None:
            check(t["seeds"] == list(ref["seeds"]), f"8d: traced {name} seeds differ")
            untraced = (f"; untraced (phase {'4' if name == 'single' else '4b'}) "
                        f"{ref['time_s'] if name == 'single' else ref['wall_s']:.2f}s, "
                        f"seeds equal")
        log(f"[8d] traced {name}: {len(evs)} spans, lanes {lanes}, top-level span seconds "
            f"{top:.3f} of {t['wall_s']:.3f}s wall ({top / t['wall_s'] * 100:.1f}%); "
            f"driver {t['time_s']:.2f}s traced{untraced}")
        log(f"[8d] {name} spans: {_span_split(evs, top=10)}")
    gauge = metrics.registry().gauge("partition.predicted_vs_measured_edge_imb",
                                     backend="serial", strategy=SERIAL["partition"]).value
    prof = shardprof.last_profile()
    check(prof is not None and prof.per_step_timed, "8d: no timed shard profile")
    log(f"[8d] partition.predicted_vs_measured_edge_imb {gauge:.6f}; measured profile "
        f"(CUDA events per merge):\n{prof.skew_table()}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[8] launches {dict(launches)}; max_memory_allocated of (c) and (d) "
        f"{peak / 2**30:.2f} GiB; phase {time.perf_counter() - t_phase:.1f}s")
    return dict(launches=dict(launches), plan_s=plan_s,
                a=dict(sweeps=rep_a.repair_sweeps, swept=list(rep_a.shards_swept),
                       host_s=wall_a, device_s=dev_a, per_bank_sweeps=_SERVE["insert"][0]),
                b=dict(sweeps=rep_b.repair_sweeps, swept=list(rep_b.shards_swept),
                       per_sweep=per_sweep, host_s=wall_b, device_s=dev_b,
                       per_bank_s=pb_b_s, per_bank_sweeps=rep_pb_b.repair_sweeps),
                plain_s=plain_s, plain_graph=TENANT_GRAPH,
                hooks=dict(single_s=t1 - t0, serial_s=t2 - t1),
                traced={n: {k2: v for k2, v in t.items() if k2 != "events"}
                        for n, t in traced.items()},
                edge_imb_ratio=gauge, profile=prof.summary(), peak_bytes=peak,
                peak_kernel_bytes=peak_kernel,
                phase_s=time.perf_counter() - t_phase)



# --------------------------------------------------------------- phase 9 ----

#: the section headings of the HTML report (obs.report)
REPORT_SECTIONS = ("Runtime backends", "Phase breakdown", "Shard skew — measured",
                   "Admission", "Kernel tuning", "SLO")


def _tune_lines(tag: str, records: dict) -> None:
    """Each candidate's time, GB/s and share of the memory roof, then the
    family's default against its winner."""
    from repro_torch.utils.roofline import HBM_BW

    for family, rec in records.items():
        for c in rec["candidates"]:
            log(f"[{tag}] {family} {c['label']}: {c['us']:.1f} us, {c['gbps']:.1f} GB/s, "
                f"{c['gbps'] * 1e9 / HBM_BW * 100:.1f}% of the roof")
        best = min(rec["candidates"], key=lambda c: c["us"])
        log(f"[{tag}] {family}: default {rec['candidates'][0]['label']} "
            f"{rec['default_us']:.1f} us, winner {best['label']} {rec['tuned_us']:.1f} us "
            f"({rec['tuned_gbps']:.1f} GB/s, {rec['frac_of_roof'] * 100:.1f}% of the roof), "
            f"speedup {rec['speedup']:.4f}")


def phase_tuning(full: dict, serial: dict, serve, smi: str, k: int) -> dict:
    """Measured tuning and the HTML report at phase 4's size: (a) the single
    path's sweep families, every candidate's output held byte-equal to the
    default geometry's and to the plain version's; (b) the serial ring's
    families at phase 4b's spec; (c) phases 4 and 4b again from that cache
    (``--tuning cached``), their results equal; (d) the report of this
    run's records. Launches of (a)-(c) are ``launches_tune``; the
    comparisons run outside the count."""
    import shutil
    import tempfile
    from collections import Counter

    import torch

    from repro_torch.kernels import cascade_step, sketch_propagate
    from repro_torch.launch import im
    from repro_torch.obs import metrics, shardprof
    from repro_torch.obs.report import write_report
    from repro_torch.runtime import RunSpec, run
    from repro_torch.tune import (CACHE_ENV, KernelConfig, TuningCache, autotune,
                                  reset_default_cache)
    from repro_torch.tune.autotuner import sweep_call, sweep_operands

    check(full is not None and serial is not None,
          "phase 9 replays phases 4 and 4b: run them first")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    launches = Counter()
    tmp = tempfile.mkdtemp(prefix="repro_tune_")   # never the working directory
    cache_path = os.path.join(tmp, "TUNE_cache.json")
    cache = TuningCache(cache_path)
    g = full_graph()

    # (a) the single path's sweeps at every work-item geometry
    single = RunSpec(num_registers=FULL["registers"], model=FULL["model"], backend="single")
    t0 = time.perf_counter()
    with _counted(launches, "9a autotune"):
        rec_a = autotune(g, single, backend="single", cache=cache, device="cuda")
    tune_a_s = time.perf_counter() - t0
    _tune_lines("9a", rec_a)
    for family, plain in (("sketch_propagate", sketch_propagate.propagate_sweep_plain),
                          ("cascade_step", cascade_step.cascade_sweep_plain)):
        op = sweep_operands(g, single, family, device="cuda")
        default = sweep_call(op, family, KernelConfig())()
        check(torch.equal(default, plain(op.m, op.edges, op.x, variant=op.variant)[0]),
              f"9a: {family}'s default geometry differs from its plain version")
        for c in rec_a[family]["candidates"]:
            got = sweep_call(op, family, KernelConfig.from_dict(c["config"]))()
            check(torch.equal(got, default), f"9a: {family} {c['label']} differs")
            del got
        log(f"[9a] {family}: the outputs of all {len(rec_a[family]['candidates'])} "
            f"candidates equal the default geometry's and the plain version's byte for byte")
        del op, default
    log(f"[9a] autotune (single) {tune_a_s:.2f}s")

    # (b) the serial ring's schedule and fused prologue at phase 4b's spec
    ring = RunSpec(num_registers=FULL["registers"], model=FULL["model"], **SERIAL)
    t0 = time.perf_counter()
    with _counted(launches, "9b autotune"):
        rec_b = autotune(g, ring, backend="serial", cache=cache, device="cuda")
    tune_b_s = time.perf_counter() - t0
    _tune_lines("9b", rec_b)
    log(f"[9b] autotune (serial) {tune_b_s:.2f}s; cache {cache_path}: {len(cache)} entries")

    # (c) phases 4 and 4b from the cache
    os.environ[CACHE_ENV] = cache_path
    reset_default_cache()
    try:
        argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model",
                FULL["model"], "--registers", str(FULL["registers"]), "--k", str(k),
                "--tuning", "cached"]
        with _reuse_full_graph(im), _counted(launches, "9c im --tuning cached"):
            out = im.run(argv)
        for key in ("seeds", "difuser_score", "rebuilds", "propagate_iters",
                    "cascade_sweeps", "rebuild_sweeps"):
            check(out[key] == full[key], f"9c: the tuned single run's {key} differs from "
                                         f"phase 4's")
        log(f"[9c] im --tuning cached: {out['time_s']:.2f}s (phase 4 untuned "
            f"{full['time_s']:.2f}s; prep {out['prep_s']:.3f}s against "
            f"{full['prep_s']:.3f}s, build {out['build_s']:.3f}s against "
            f"{full['build_s']:.3f}s, rounds {out['rounds_s']:.3f}s against "
            f"{full['rounds_s']:.3f}s); seeds, score, rebuilds and sweeps equal phase 4's")
        t0 = time.perf_counter()
        with _counted(launches, "9c serial tuning=cached"):
            rep = run(g, k, ring.with_(tuning="cached"), device="cuda")
        wall = time.perf_counter() - t0
    finally:
        del os.environ[CACHE_ENV]
        reset_default_cache()
    res, st = rep.result, rep.result.stats
    knobs = {f: getattr(rep.spec, f)
             for f in ("local_sweeps", "pad_mode", "fuse_sweeps", "lane_fill")}
    check(res.seeds.tolist() == list(serial["seeds"]), "9c: tuned serial seeds differ")
    check(float(res.scores[-1]) == serial["score"], "9c: tuned serial score differs")
    check(int(res.rebuilds.sum()) == serial["rebuilds"], "9c: tuned serial rebuilds differ")
    check(st["cascade_sweeps"] == serial["cascade_sweeps"],
          "9c: tuned serial cascade sweeps differ")
    # ring sweeps to the fixpoint depend on the comm-free sweeps before each:
    # held against phase 4b's where the schedule is 4b's, else against an
    # untuned run at the tuned knobs
    if (knobs["local_sweeps"], knobs["pad_mode"]) == (SERIAL["local_sweeps"], "step"):
        want, against = (serial["propagate_iters"], serial["rebuild_sweeps"]), "phase 4b's"
    else:
        ref = run(g, k, ring.with_(**knobs), device="cuda").result
        check(ref.seeds.tolist() == list(serial["seeds"]), "9c: untuned serial seeds differ")
        want = (ref.propagate_iters, ref.stats["rebuild_sweeps"])
        against = f"an untuned run at {knobs}"
    check((res.propagate_iters, st["rebuild_sweeps"]) == want,
          f"9c: tuned serial sweeps {(res.propagate_iters, st['rebuild_sweeps'])} "
          f"differ from {against}: {want}")
    prep = ("sort_s", "sample_s", "plan_s", "buckets_s", "state_s")
    log(f"[9c] serial tuning=cached {knobs}: {wall:.2f}s (phase 4b untuned "
        f"{serial['wall_s']:.2f}s; host prep {sum(st[p] for p in prep):.3f}s against "
        f"{sum(serial[p] for p in prep):.3f}s, build {st['build_s']:.3f}s against "
        f"{serial['build_s']:.3f}s with {res.propagate_iters} ring sweeps against "
        f"{serial['propagate_iters']}, rounds {st['rounds_s']:.3f}s against "
        f"{serial['rounds_s']:.3f}s); seeds, score, rebuilds and cascade sweeps equal "
        f"phase 4b's, build and rebuild sweeps equal {against}")

    # (d) the report of this run's records
    def backend_record(cold_s, warm_s, build_s, seeds):
        return dict(available=True, cold_s=cold_s, seeds_per_s_cold=k / cold_s,
                    warm_s=warm_s, seeds_per_s_warm=k / warm_s, store_build_s=build_s,
                    seeds_identical=list(seeds) == list(full["seeds"]))

    runtime = dict(graph=FULL["graph"], n=full["n"], m=full["m"], k=k, backends=dict(
        single=backend_record(full["time_s"], full["rounds_s"], full["build_s"],
                              full["seeds"]),
        serial=backend_record(serial["wall_s"], serial["rounds_s"], serial["build_s"],
                              serial["seeds"])))
    service = None
    if serve is not None:
        service = dict(qps=serve["qps"], p50_ms=serve["p50_ms"], p99_ms=serve["p99_ms"],
                       n=SERVE["queries"])
        if "admission" in _SERVE:
            service["async"] = _SERVE["admission"]
    OUT.mkdir(parents=True, exist_ok=True)
    path = write_report(os.path.join(tmp, "report.html"),
                        title="repro_torch perf report (chip_smoke.py)", runtime=runtime,
                        service=service, events=_TRACED,
                        metrics_rows=metrics.registry().snapshot(),
                        profiles=shardprof.profiles(), tuning=cache.records(), generated=smi)
    page = Path(path).read_text()
    missing = [h for h in REPORT_SECTIONS if f"<h2>{h}</h2>" not in page]
    check(not missing, f"9d: report sections missing: {missing}")
    (OUT / "report.html").write_text(page)
    log(f"[9d] report {path}: {len(page.encode())} bytes, sections {list(REPORT_SECTIONS)} "
        f"(events {len(_TRACED)}, profiles {len(shardprof.profiles())}, tuning entries "
        f"{len(cache)}); copied to {OUT / 'report.html'}")
    shutil.rmtree(tmp)
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    log(f"[9] launches {dict(launches)}; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"phase {phase_s:.1f}s")
    return dict(launches=dict(launches), single=rec_a, serial=rec_b, tune_single_s=tune_a_s,
                tune_serial_s=tune_b_s, tuned_single_s=out["time_s"], tuned_serial_s=wall,
                tuned_serial_knobs=knobs, report_bytes=len(page.encode()), peak_bytes=peak,
                phase_s=phase_s)


# -------------------------------------------------------------- phase 10 ----

# phase 10's worlds: phase 4b's spec on a (2, 2) process mesh of 4 ranks
# sharing the card (gloo, host-staged exchanges); (b) the allgather schedule
# at K = 8, (c) a build at J = 512; (d) a world of 1 on NCCL; (e) the
# launcher under torch.distributed.run
MESH = dict(SERIAL, backend="mesh", schedule="ring")
MESH_RANKS = 4
MESH_ALLGATHER_K = 8
MESH_BUILD_REGS = 512
MESH_NCCL = dict(graph="rmat:14", registers=256, k=8)
MESH_LAUNCHER_GRAPH = "rmat:14"
MESH_TIMEOUT_S = 600.0
# (a)'s rank peak (max_memory_allocated, GiB) when each rank filled the whole
# n_pad x j_loc matrix and then kept its owned rows (the port at commit
# 79c500f, on this card; the partition's build sets it): no rank may go
# more than 1 % above it
MESH_WHOLE_FILL_PEAK_GIB = 3.112
# (a)'s rank peak when every rank built the whole partition and kept its own
# buckets (the port at commit 9d529ac, on this card); each rank now prepares
# only its own shard, and (a) gates its prep and its whole peak
MESH_WHOLE_PARTITION_PEAK_GIB = 3.112
MESH_PREP_PEAK_LIMIT_GIB = 1.0
MESH_RANK_PEAK_LIMIT_GIB = 2.0
# the names through which a rank could reach the whole partition's build or
# its graph-wide sample sets: (a)-(c) count each rank's calls through them
# (none allowed) and through the own-shard prep (one a run)
WHOLE_BUILD_NAMES = (("repro_torch.partition.builder", "build_partition_2d"),
                     ("repro_torch.partition.serial", "build_partition_2d"),
                     ("repro_torch.partition.serial", "_prepare"),
                     ("repro_torch.partition.plan", "sample_edge_sets"),
                     ("repro_torch.partition.builder", "sample_edge_sets"),
                     ("repro_torch.partition.serial", "sample_edge_sets"))


@contextlib.contextmanager
def _prep_calls(calls: dict):
    """Count a rank's calls through ``WHOLE_BUILD_NAMES`` (``calls["whole"]``)
    and of the own-shard prep as the mesh reaches it (``calls["own"]``)."""
    import importlib

    from repro_torch.core import distributed

    calls.update(whole=0, own=0)
    targets = [(importlib.import_module(m), n, "whole") for m, n in WHOLE_BUILD_NAMES]
    targets.append((distributed, "build_shard_2d", "own"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def counted(fn, kind):
        def call(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return call

    for (mod, name, kind), (_, _, fn) in zip(targets, saved):
        setattr(mod, name, counted(fn, kind))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _state_peaks(marks: dict):
    """Split a mesh run's device peak at the rank state's construction:
    ``prep`` is the peak before it (the partition's build), ``state`` the
    peak of the construction above what was allocated when it began
    (``base``). The peak counter restarts at the construction, so
    ``max_memory_allocated`` afterwards covers the state, the build and the
    rounds. ``fills`` lists the shape of each ``sketch_fill`` the
    construction launched and whether it took row ids."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.kernels import ops

    init, fill = distributed._RankState.__init__, ops.sketch_fill
    marks["fills"] = []

    def counted_fill(m, **kw):
        marks["fills"].append((tuple(m.shape), kw.get("ids") is not None))
        return fill(m, **kw)

    def measured(self, *a, **k):
        torch.cuda.synchronize()
        marks["prep"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks["base"] = torch.cuda.memory_allocated()
        ops.sketch_fill = counted_fill
        try:
            init(self, *a, **k)
        finally:
            ops.sketch_fill = fill
        torch.cuda.synchronize()
        marks["state"] = torch.cuda.max_memory_allocated() - marks["base"]

    distributed._RankState.__init__ = measured
    try:
        yield marks
    finally:
        distributed._RankState.__init__ = init


def _span_sums(events) -> dict:
    """{name: [count, seconds]} of the recorded spans."""
    out: dict = {}
    for ev in events:
        c, t = out.get(ev["name"], (0, 0.0))
        out[ev["name"]] = (c + 1, t + ev["dur_s"])
    return out


def _mesh_rank(rank: int, g, k: int) -> dict:
    """Phase 10 (a)-(c) on one rank of the shared-card world."""
    import torch

    from repro_torch.kernels import counters
    from repro_torch.obs import trace
    from repro_torch.runtime import RunSpec, get_backend, run

    rec = trace.get_recorder()
    out: dict = {}
    spec = RunSpec(num_registers=FULL["registers"], model=FULL["model"], **MESH)
    for tag, kk, sp in (("a", k, spec),
                        ("b", MESH_ALLGATHER_K, spec.with_(schedule="allgather"))):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        if rank == 0:
            rec.clear()
            rec.start()
        t0 = time.perf_counter()
        marks: dict = {}
        calls: dict = {}
        with _prep_calls(calls), (_state_peaks(marks) if tag == "a"
                                  else contextlib.nullcontext()):
            rep = run(g, kk, sp, device="cuda")
        wall = time.perf_counter() - t0
        spans = {}
        if rank == 0:
            rec.stop()
            spans = _span_sums(rec.events())
        res = rep.result
        out[tag] = dict(seeds=res.seeds.tolist(), rebuilds=res.rebuilds.tolist(),
                        scores=res.scores.tolist(), propagate_iters=res.propagate_iters,
                        stats=res.stats, wall_s=wall, spans=spans,
                        launches=dict(counters.LAUNCHES), plain=dict(counters.PLAIN_CALLS),
                        peak_bytes=max(torch.cuda.max_memory_allocated(),
                                       marks.get("prep", 0)),
                        rest_peak=torch.cuda.max_memory_allocated(), marks=marks,
                        prep_calls=calls,
                        n_loc=rep.partition.n_loc, n_pad=rep.partition.n_pad,
                        j_loc=rep.partition.j_loc, device=rep.device,
                        describe=rep.partition.stats().describe())
        if tag == "a":   # phase 12 (b)'s prediction of this run
            out[tag]["dry"] = _dry_prediction(rank, rep)
    # (c) the build alone, against the single path's matrix at the same J
    bspec = spec.with_(num_registers=MESH_BUILD_REGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calls = {}
    with _prep_calls(calls):
        m, iters = get_backend("mesh").build_matrix(g, bspec, None, device="cuda")
    torch.cuda.synchronize()
    out["c"] = dict(iters=iters, wall_s=time.perf_counter() - t0, shape=tuple(m.shape),
                    peak_bytes=torch.cuda.max_memory_allocated(), prep_calls=calls)
    if rank == 0:
        want, want_iters = get_backend("single").build_matrix(
            g, RunSpec(num_registers=MESH_BUILD_REGS, model=FULL["model"]), None,
            device="cuda")
        out["c"].update(equal=bool(torch.equal(m, want)), single_iters=want_iters)
        del want
    del m
    return out


def _dry_prediction(rank: int, rep) -> dict:
    """The dry program of this rank's partition of a mesh run (its real
    bucket widths), times the run's sweep counts: exchanges per kind
    ``(calls, bytes sent)``, kernel launches, and the peak it predicts
    (arguments and temp)."""
    from repro_torch.launch.dryrun import dry_program

    part = rep.partition
    prog = dry_program(part, rep.spec.distributed_config(), k=len(rep.result.seeds),
                       coord=divmod(rank, part.mu_s))
    pred = prog.for_run(rep.result)
    return dict(exchange={kind: (v["calls"], v["bytes_sent"])
                          for kind, v in pred.summary().items()},
                launches=dict(pred.launches), host_s=prog.host_s,
                argument_bytes=prog.argument_bytes, temp_bytes=prog.temp_bytes)


def _nccl_rank(rank: int) -> dict:
    """Phase 10 (d): a world of 1 on NCCL, against the single path."""
    import torch.distributed as dist

    from repro_torch.launch.common import make_graph
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import RunSpec, run

    g = make_graph(MESH_NCCL["graph"], FULL["setting"], 0)
    base = dict(num_registers=MESH_NCCL["registers"], model=FULL["model"])
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    got = run(g, MESH_NCCL["k"], RunSpec(backend="mesh", **base), device="cuda", mesh=mesh)
    want = run(g, MESH_NCCL["k"], RunSpec(**base), device="cuda")
    return dict(backend=dist.get_backend(), transport=mesh.transport,
                seeds=got.result.seeds.tolist(), single=want.result.seeds.tolist(),
                iters=got.result.propagate_iters, single_iters=want.result.propagate_iters,
                exchange=got.result.stats["exchange"])


def phase_mesh(full: dict, serial: dict, k: int) -> dict:
    """Phase 10: the mesh backend on process meshes that share the card
    (needs phases 4 and 4b)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import im
    from repro_torch.launch.mesh import spawn_world

    check(full is not None and serial is not None, "phase 10 needs phases 4 and 4b")
    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    g = full_graph()
    t0 = time.perf_counter()
    ranks = spawn_world(_mesh_rank, MESH_RANKS, workdir=work / "shared", device="cuda",
                        args=(g, k), timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    a = ranks[0]["a"]
    log(f"[10a] mesh {FULL['graph']} J={FULL['registers']} K={k} grid 2x2 "
        f"{MESH['partition']}, local_sweeps {MESH['local_sweeps']} fused, lane_fill "
        f"{MESH['lane_fill']}, ring schedule; {MESH_RANKS} ranks on {a['device']} "
        f"(gloo+host); world {world_s:.1f}s (spawn, (a), (b), (c), teardown)")
    for r, rk in enumerate(ranks):
        st = rk["a"]["stats"]
        ex = st["exchange"]
        log(f"[10a] rank {r}: prep dst sort {st['sort_s']:.3f}s, sample sets "
            f"{st['sample_s']:.3f}s, plan {st['plan_s']:.3f}s, buckets {st['buckets_s']:.3f}s, "
            f"rank state {st['state_s']:.3f}s; build {st['build_s']:.3f}s "
            f"({rk['a']['propagate_iters']} sweeps); rounds {st['rounds_s']:.3f}s "
            f"({st['cascade_sweeps']} cascade sweeps, {st['rebuild_sweeps']} rebuild sweeps); "
            f"total {rk['a']['wall_s']:.2f}s; max_memory_allocated "
            f"{rk['a']['peak_bytes'] / 2**30:.2f} GiB")
        log(f"[10a] rank {r} exchanges: " + "; ".join(
            f"{kind} {v['calls']} calls, {v['bytes_sent'] / 1e9:.3f} GB sent, "
            f"{v['seconds']:.3f}s" for kind, v in ex.items()))
    from repro_torch.core.sketch import padded_regs

    for r, rk in enumerate(ranks):
        ra, gib = rk["a"], 2**30
        mk, block = ra["marks"], ra["n_loc"] * ra["j_loc"]
        whole = 2 * ra["n_pad"] * ra["j_loc"]
        peak, prep = ra["peak_bytes"] / gib, mk["prep"] / gib
        log(f"[10a] rank {r} peak {peak:.4f} GiB, {peak / MESH_WHOLE_PARTITION_PEAK_GIB:.4f} "
            f"of the whole partition's build ({MESH_WHOLE_PARTITION_PEAK_GIB} GiB; "
            f"whole-matrix fill: {MESH_WHOLE_FILL_PEAK_GIB} GiB): its own shard's prep "
            f"{prep:.4f} GiB; the rank state's construction (the fill, the block, the ring "
            f"buffers) {mk['state'] / gib:.4f} GiB above the {mk['base'] / gib:.4f} GiB it began "
            f"with, {mk['state'] / block:.2f} n_loc x j_loc blocks (the whole matrix and its "
            f"fill alone: {whole / gib:.4f} GiB); from the state on (build, rounds) "
            f"{ra['rest_peak'] / gib:.4f} GiB")
        # the fill ran on the rank's owned rows, keyed on their ids (at this
        # 2 x 2 grid the whole matrix is two blocks, so the peaks cannot tell)
        want_fill = [((ra["n_loc"], padded_regs(ra["j_loc"])), True)]
        check(mk["fills"] == want_fill, f"10a: rank {r}'s state filled {mk['fills']}, not "
              f"its owned rows {want_fill}")
        check(peak <= 1.01 * MESH_WHOLE_FILL_PEAK_GIB,
              f"10a: rank {r}'s peak {peak:.4f} GiB is above the whole-matrix fill's")
        check(prep <= MESH_PREP_PEAK_LIMIT_GIB,
              f"10a: rank {r}'s partition prep peaks at {prep:.4f} GiB, above "
              f"{MESH_PREP_PEAK_LIMIT_GIB} GiB")
        check(peak <= MESH_RANK_PEAK_LIMIT_GIB,
              f"10a: rank {r}'s peak {peak:.4f} GiB is above {MESH_RANK_PEAK_LIMIT_GIB} GiB")
        for tag in ("a", "b", "c"):
            calls = rk[tag]["prep_calls"]
            check(calls == {"whole": 0, "own": 1},
                  f"10{tag}: rank {r}'s work lists did not come from one own-shard prep "
                  f"alone: {calls}")
    log("[10a-c] every rank prepared its own shard once a run and never reached the whole "
        "partition's build or its graph-wide sample sets")
    spans = ranks[0]["a"]["spans"]
    log("[10a] rank 0 spans: " + ", ".join(
        f"{n} {t:.3f}s x{c}" for n, (c, t) in sorted(spans.items(), key=lambda i: -i[1][1])))
    launches, plain = {}, {}
    for rk in ranks:
        for name, c in rk["a"]["launches"].items():
            launches[name] = launches.get(name, 0) + c
        for name, c in rk["a"]["plain"].items():
            plain[name] = plain.get(name, 0) + c
    log(f"[10a] launches (all ranks) {launches}; plain calls {plain}")
    check(not plain, f"plain versions ran on the mesh path: {plain}")
    missing = [n for n in SERIAL_KERNELS if launches.get(n, 0) <= 0]
    check(not missing, f"kernels not launched on the mesh path: {missing}")
    for r, rk in enumerate(ranks):
        check(rk["a"]["seeds"] == a["seeds"], f"10a: rank {r}'s seeds differ from rank 0's")
    check(a["seeds"] == list(serial["seeds"]), "10a: mesh seeds differ from phase 4b's")
    check(a["seeds"] == list(full["seeds"]), "10a: mesh seeds differ from phase 4's")
    check(int(np.sum(a["rebuilds"])) == serial["rebuilds"], "10a: rebuilds differ from 4b's")
    st = a["stats"]
    sweeps = (a["propagate_iters"], st["cascade_sweeps"], st["rebuild_sweeps"])
    want = (serial["propagate_iters"], serial["cascade_sweeps"], serial["rebuild_sweeps"])
    check(sweeps == want, f"10a: sweeps {sweeps} differ from phase 4b's {want}")
    log(f"[10a] seeds, rebuilds and sweeps {sweeps} equal phase 4b's; seeds equal phase 4's")
    b = ranks[0]["b"]
    check(b["seeds"] == a["seeds"][:MESH_ALLGATHER_K]
          and b["rebuilds"] == a["rebuilds"][:MESH_ALLGATHER_K],
          "10b: allgather seeds or rebuilds differ from the first of (a)")
    bst = b["stats"]
    log(f"[10b] allgather K={MESH_ALLGATHER_K}: build {bst['build_s']:.3f}s "
        f"({b['propagate_iters']} sweeps), rounds {bst['rounds_s']:.3f}s "
        f"({bst['cascade_sweeps']} cascade sweeps), total {b['wall_s']:.2f}s; rank 0 "
        "exchanges: " + "; ".join(f"{kind} {v['calls']} calls, "
                                  f"{v['bytes_sent'] / 1e9:.3f} GB sent, {v['seconds']:.3f}s"
                                  for kind, v in bst["exchange"].items())
        + f"; seeds and rebuilds equal the first {MESH_ALLGATHER_K} of (a)")
    c = ranks[0]["c"]
    check(c["equal"], "10c: the mesh's build differs from the single path's")
    check(c["iters"] == ranks[1]["c"]["iters"], "10c: ranks disagree on the sweeps")
    log(f"[10c] MeshBackend.build_matrix J={MESH_BUILD_REGS}: {c['shape']}, {c['iters']} "
        f"sweeps (single path {c['single_iters']}), {c['wall_s']:.3f}s on rank 0, byte-equal "
        "to the single path's matrix; peaks "
        + ", ".join(f"{rk['c']['peak_bytes'] / 2**30:.2f}" for rk in ranks) + " GiB")
    # (d) NCCL, one rank
    t0 = time.perf_counter()
    (d,) = spawn_world(_nccl_rank, 1, workdir=work / "nccl", device="cuda",
                       timeout_s=MESH_TIMEOUT_S)
    d_s = time.perf_counter() - t0
    check(d["backend"] == "nccl" and d["transport"] == "nccl", f"10d: transport {d}")
    check(d["seeds"] == d["single"], "10d: NCCL world's seeds differ from the single path's")
    log(f"[10d] world of 1 on {d['transport']}, {MESH_NCCL['graph']} J="
        f"{MESH_NCCL['registers']} K={MESH_NCCL['k']}: seeds equal the single path's "
        f"({d['iters']} mesh sweeps, {d['single_iters']} single); {d_s:.1f}s with spawn; "
        f"exchanges {d['exchange']}")
    # (e) the launcher under torch.distributed.run, against the serial backend
    args = ["--graph", MESH_LAUNCHER_GRAPH, "--setting", FULL["setting"], "--model",
            FULL["model"], "--registers", str(FULL["registers"]), "--k", str(k)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MESH_RANKS), "-m", "repro_torch", "im", *args,
           "--devices", str(MESH_RANKS), "--backend", "mesh"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=work, capture_output=True, text=True,
                          timeout=MESH_TIMEOUT_S)
    e_s = time.perf_counter() - t0
    (OUT / "mesh_launcher.log").write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    check(proc.returncode == 0, f"10e: the launcher failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    for ln in lines:
        log(f"[10e] {ln}")
    seeds_lines = [ln for ln in lines if ln.startswith("seeds: ")]
    check(len(seeds_lines) == 1, "10e: rank 0 alone prints")
    got = json.loads(seeds_lines[0][len("seeds: "):])
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        want = im.run(args + ["--backend", "serial"])
    check(got == want["seeds"], "10e: the launcher's mesh seeds differ from the serial "
          "backend's")
    log(f"[10e] {MESH_RANKS} ranks through torch.distributed.run at {MESH_LAUNCHER_GRAPH}: "
        f"{e_s:.1f}s with startup; seeds equal the serial backend's")
    phase_s = time.perf_counter() - t_phase
    log(f"[10] phase {phase_s:.1f}s")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, ranks=[{t: {kk: v for kk, v in rk[t].items()
                                               if kk not in ("spans",)}
                                           for t in ("a", "b", "c")} for rk in ranks],
                spans=spans, nccl=d, world_s=world_s, launcher_s=e_s, phase_s=phase_s)


# -------------------------------------------------------------- phase 11 ----

# phase 11: phase 6's index placed on a serving mesh of 4 ranks sharing the
# card (gloo, host-staged) under a 4-shard block plan (4, not the serve
# launcher's 8, bounds the chip time; phase 8 keeps the 8-shard plan on the
# serial ring); (e) the launcher's --residency device at rmat:14
SERVING = dict(ranks=4, strategy="block")
SERVING_LAUNCHER_GRAPH = "rmat:14"
# a follower's peak (GiB) when every rank built the whole partition (the port
# at commit 9d529ac, on this card), and the most predicted now that each
# rank prepares only its own shard (printed, not a gate)
MESH_SERVE_WHOLE_PARTITION_GIB = 3.19
MESH_SERVE_FOLLOWER_PREDICTED_GIB = 1.6
# the device-resident path: the partition's sample sets, the warm rounds'
# fill, selection, cascades and rebuild sweeps, the repair's merges, the
# queries' estimator
MESH_SERVE_KERNELS = ("fused_sample", "sketch_fill", "sketch_cardinality",
                      "bucket_propagate", "bucket_cascade")


def _digest(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=32).hexdigest()


def _serving_rank(rank: int, g, inp: dict) -> dict:
    """Phase 11 (a)-(d) on one rank of the shared-card serving world: rank 0
    controls it, the others follow."""
    import torch

    from repro_torch.launch import mesh as M

    torch.cuda.reset_peak_memory_stats()
    res = M.serve_world(lambda: _serving_controller(g, inp), graphs=[g])
    out = dict(peak_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        out.update(res)
    return out


def _op_launch_window(state, p, local):
    """Phase 11's launch window, an operation of the serving world: "reset"
    zeroes every rank's counters; "read" gathers every rank's launches and
    plain calls to the controller, in rank order."""
    import torch.distributed as dist

    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import ProcessMesh

    if p["do"] == "reset":
        counters.reset()
        return None
    mesh = ProcessMesh.by_key(p["mesh"])
    got = [None] * mesh.size
    dist.all_gather_object(got, (dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)),
                           group=mesh.grid_group)
    return got


def _serving_controller(g, inp: dict) -> dict:
    import torch

    from repro_torch.launch import serve_im
    from repro_torch.launch.mesh import require_controller
    from repro_torch.obs import trace
    from repro_torch.partition import plan_partition
    from repro_torch.service import (AsyncInfluenceEngine, InfluenceEngine, Request,
                                     SketchStore, TopKSeeds, apply_delta, summarize_latencies)

    spec = inp["spec"]
    out: dict = {}
    store = SketchStore(num_banks=SERVE["banks"], spec=spec, device="cuda")
    t0 = time.perf_counter()
    e = store.get_or_build(g, spec.difuser_config())
    out.update(get_s=time.perf_counter() - t0, build_s=e.build_time_s,
               built=_digest(e.matrix.cpu().numpy()))
    t0 = time.perf_counter()
    plan = plan_partition(e.graph, SERVING["ranks"], mu_s=1, strategy=SERVING["strategy"],
                          x=e.x, seed=spec.seed, device="cuda")
    store.attach_plan(e.key, plan)
    out["plan_s"] = time.perf_counter() - t0
    # (c)'s reference, before the launch window: the serial shard repair of
    # phase 6's delta at this plan, on a host-resident twin
    twin = SketchStore(num_banks=SERVE["banks"], spec=spec, device="cuda")
    te = twin.get_or_build(g, spec.difuser_config())
    twin.attach_plan(te.key, plan)
    t0 = time.perf_counter()
    rep_s = apply_delta(twin, te.key, inp["delta"], backend="serial")
    serial_s = time.perf_counter() - t0
    twin_m = twin.entry(te.key).matrix
    del twin, te

    # the launch window: placement, (a), (b), (d) and (c)'s mesh repair, on every rank
    ctl = require_controller()
    mesh = ctl.serving_mesh(SERVING["ranks"], device="cuda")
    ctl.call(_op_launch_window, {"mesh": mesh.key, "do": "reset"})
    t0 = time.perf_counter()
    e.place_on_mesh(mesh)
    torch.cuda.synchronize()
    out.update(place_s=time.perf_counter() - t0, residency=e.residency,
               serving=e.serving_backend, device_bytes=e.device_bytes(),
               block_bytes=plan.n_loc * e.x.shape[0], describe=mesh.describe())

    # (a) the stream through the sync engine; (b) its warm top-10
    workload = serve_im.make_workload(e.graph.n, SERVE["queries"], k=SERVE["topk"], seed=7)
    engine = InfluenceEngine(store, max_batch=SERVE["max_batch"])
    ex0 = dict(mesh.exchange.stats)
    t0 = time.perf_counter()
    results = engine.run([Request(e.key, q) for q in workload])
    wall = time.perf_counter() - t0
    stats = summarize_latencies(results)
    top = next(r.value for r in results if isinstance(r.query, TopKSeeds) and not r.cache_hit)
    out["a"] = dict(wall_s=wall, qps=len(results) / wall, p50_ms=stats["p50_ms"],
                    p99_ms=stats["p99_ms"], by_backend=stats["by_backend"],
                    cache_hits=stats["cache_hits"], answers=[_exact(r) for r in results],
                    exchange=mesh.exchange.summary(since=ex0))
    out["b"] = dict(seeds=top.seeds.tolist(), rebuilds=top.rebuilds.tolist(),
                    stats={k: v for k, v in top.stats.items()})

    # (d) the async engine on the placed entry (the same engine: its top-k memo holds)
    t0 = time.perf_counter()
    with AsyncInfluenceEngine(engine, deadline_ms=50) as aeng:
        futures = [aeng.submit(e.key, q) for q in workload]
        aeng.drain()
        got = _results(futures, "11d")
        admission = aeng.admission_summary()
    out["d"] = dict(wall_s=time.perf_counter() - t0, answers=[_exact(r) for r in got],
                    e2e_p99_ms=admission["e2e_p99_ms"], misses=admission["deadline_misses"],
                    flushes=admission["flushes"])

    # (c) phase 6's delta through the mesh repair, against the serial one at this plan
    ex0 = dict(mesh.exchange.stats)
    rec = trace.get_recorder()
    pairs: list = []
    rec.clear()
    rec.start()
    try:
        with _timed_merges(pairs):
            rep = apply_delta(store, e.key, inp["delta"], backend="auto")
    finally:
        rec.stop()
    merges_s = _events_s(pairs)
    spans = _span_sums(rec.events())
    exchange = mesh.exchange.summary(since=ex0)
    out["window"] = ctl.call(_op_launch_window, {"mesh": mesh.key, "do": "read"})
    e = store.entry(e.key)
    t0 = time.perf_counter()
    repaired = e.matrix
    gather_s = time.perf_counter() - t0
    out["c"] = dict(rep=dict(rep.__dict__), serial=dict(rep_s.__dict__), residency=e.residency,
                    equal_serial=bool(torch.equal(repaired, twin_m)),
                    repaired=_digest(repaired.cpu().numpy()), merges_s=merges_s,
                    gather_s=gather_s, serial_s=serial_s, spans=spans, exchange=exchange)
    return out


def phase_mesh_serving() -> dict:
    """Phase 11: phase 6's index served device-resident on a serving mesh of
    ranks that share the card (needs phase 6)."""
    import shutil
    from collections import Counter

    import torch

    from repro_torch.launch import serve_im
    from repro_torch.launch.mesh import spawn_world

    check(bool(_SERVE), "phase 11 serves phase 6's index: run phase 6 first")
    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_serving"
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    inp = dict(spec=_SERVE["spec"], delta=_SERVE["delta"])
    t0 = time.perf_counter()
    ranks = spawn_world(_serving_rank, SERVING["ranks"], workdir=work / "world",
                        device="cuda", args=(_SERVE["graph"], inp), timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"[11] serving world of {SERVING['ranks']} ranks sharing the card: "
        f"{r0['describe']}; world {world_s:.1f}s (spawn, (a)-(d), teardown)")
    check(r0["built"] == _digest(_SERVE["built"]), "11: the index differs from phase 6's")
    check((r0["residency"], r0["serving"]) == ("device", "mesh:device"),
          f"11: residency {r0['residency']}, serving {r0['serving']}")
    log(f"[11] store get_or_build {r0['get_s']:.3f}s (the store key, the destination sort "
        f"and the build, {r0['build_s']:.3f}s; equal to phase 6's), {SERVING['ranks']}-shard "
        f"{SERVING['strategy']} plan {r0['plan_s']:.3f}s, placement {r0['place_s']:.3f}s: "
        f"{SERVING['ranks']} row blocks x {r0['block_bytes']} B, device bytes "
        f"{r0['device_bytes']}")
    a = r0["a"]
    check(a["answers"] == _SERVE["answers"], "11a: answers differ from phase 6's host answers")
    check(set(a["by_backend"]) <= {"mesh:device", "memo"}, f"11a: backends {a['by_backend']}")
    log(f"[11a] {SERVE['queries']} queries through the sync engine: {a['wall_s']:.4f}s "
        f"({a['qps']:.1f} qps), p50 {a['p50_ms']:.4f} ms, p99 {a['p99_ms']:.4f} ms, by "
        f"backend {a['by_backend']}, top-k cache hits {a['cache_hits']}; answers byte-equal "
        f"to phase 6's host answers; controller exchanges: " + "; ".join(
            f"{kind} {v['calls']} calls, {v['bytes_sent'] / 1e6:.3f} MB sent, "
            f"{v['seconds']:.3f}s" for kind, v in a["exchange"].items()))
    b = r0["b"]
    st = b["stats"]
    ring = st["exchange"].get("ring_shift", {})
    log(f"[11b] warm top-{SERVE['topk']} off the placed blocks (the stream's first): seeds "
        f"{b['seeds']}; partition {st['partition_s']:.3f}s (host, rank 0), rounds "
        f"{st['rounds_s']:.3f}s, {st['cascade_sweeps']} cascade and {st['rebuild_sweeps']} "
        f"rebuild sweeps; ring shifts {ring.get('calls', 0)}, "
        f"{ring.get('bytes_sent', 0) / 1e9:.3f} GB sent, {ring.get('seconds', 0.0):.3f}s; "
        "exchanges " + "; ".join(f"{kind} {v['calls']} calls, {v['seconds']:.3f}s"
                                 for kind, v in st["exchange"].items()))
    d = r0["d"]
    check(d["answers"] == a["answers"], "11d: async answers differ from the sync engine's")
    log(f"[11d] the async engine on the placed entry: {d['wall_s']:.3f}s, e2e p99 "
        f"{d['e2e_p99_ms']:.2f} ms, {d['misses']} deadline misses, {d['flushes']} flushes; "
        "answers equal (a)'s")
    c = r0["c"]
    rep, ser = c["rep"], c["serial"]
    check(rep["repair_backend"] == "mesh" and not rep["rebuilt"] and c["residency"] == "device",
          f"11c: report {rep}")
    check(c["repaired"] == _digest(_SERVE["repaired"]),
          "11c: the mesh repair differs from phase 6's repaired matrix")
    check(c["equal_serial"], "11c: the mesh repair differs from the serial shard repair")
    check((rep["repair_sweeps"], tuple(rep["shards_swept"]))
          == (ser["repair_sweeps"], tuple(ser["shards_swept"])),
          f"11c: sweeps/shards {rep['repair_sweeps']}/{rep['shards_swept']} differ from the "
          f"serial repair's {ser['repair_sweeps']}/{ser['shards_swept']}")
    spans = c["spans"]
    log(f"[11c] phase 6's {SERVE['delta_edges']}-edge delta on the mesh: host "
        f"{rep['time_s']:.3f}s, {rep['repair_sweeps']} sweeps, shards touched "
        f"{rep['plan_shards_touched']}, swept {rep['shards_swept']}, banks touched "
        f"{rep['banks_touched']}; rank 0's merges on the device {c['merges_s']:.4f}s; spans "
        + ", ".join(f"{n} {t:.3f}s x{k}" for n, (k, t) in
                    sorted(spans.items(), key=lambda i: -i[1][1])[:8])
        + "; controller exchanges " + "; ".join(
            f"{kind} {v['calls']} calls, {v['bytes_sent'] / 1e6:.3f} MB sent, "
            f"{v['seconds']:.3f}s" for kind, v in c["exchange"].items())
        + f"; gather {c['gather_s']:.3f}s; byte-equal to phase 6's repaired matrix and to "
        f"the serial shard repair at this plan ({c['serial_s']:.3f}s, "
        f"{ser['repair_sweeps']} sweeps, swept {ser['shards_swept']})")
    launches, plain = Counter(), Counter()
    for rank_launches, rank_plain in r0["window"]:
        launches.update(rank_launches)
        plain.update(rank_plain)
    launches, plain = dict(launches), dict(plain)
    log(f"[11] launches from placement to (c)'s mesh repair (all ranks; the store builds, "
        f"the plan and the serial twin outside) {launches}; per rank "
        + "; ".join(str(rl) for rl, _ in r0["window"]) + f"; plain calls {plain}; "
        "max_memory_allocated "
        + ", ".join(f"{rk['peak_bytes'] / 2**30:.2f}" for rk in ranks) + " GiB")
    log("[11] follower peaks " + ", ".join(
        f"rank {r} {rk['peak_bytes'] / 2**30:.4f}" for r, rk in enumerate(ranks) if r)
        + f" GiB (predicted at most {MESH_SERVE_FOLLOWER_PREDICTED_GIB} GiB; "
        f"{MESH_SERVE_WHOLE_PARTITION_GIB} GiB when every rank built the whole partition)")
    check(not plain, f"plain versions ran on the device-resident path: {plain}")
    for r, (rank_launches, _) in enumerate(r0["window"]):
        missing = [n for n in MESH_SERVE_KERNELS if rank_launches.get(n, 0) <= 0]
        check(not missing, f"11: rank {r} did not launch {missing}")
    stray = sorted(set(launches) - set(MESH_SERVE_KERNELS))
    check(not stray, f"11: kernels off the device-resident path launched in its window: "
          f"{stray}")

    # (e) the launcher under torch.distributed.run, against a host-resident run
    args = ["--graph", SERVING_LAUNCHER_GRAPH, "--setting", FULL["setting"], "--model",
            FULL["model"], "--registers", str(SERVE["registers"]), "--queries",
            str(SERVE["queries"]), "--topk", str(SERVE["topk"])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(SERVING["ranks"]), "-m", "repro_torch", "serve", *args,
           "--residency", "device", "--plan-shards", str(SERVING["ranks"]),
           "--answers", str(work / "device.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=work, capture_output=True, text=True,
                          timeout=MESH_TIMEOUT_S)
    e_s = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "serving_launcher.log").write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    check(proc.returncode == 0, f"11e: the launcher failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    for ln in lines:
        log(f"[11e] {ln}")
    check(sum(ln.startswith("device-resident: ") and ln.endswith("(serving mesh:device)")
              for ln in lines) == 1, "11e: no device-resident line from rank 0 alone")
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        host = serve_im.run(args + ["--residency", "host", "--answers",
                                    str(work / "host.json")])
    check(host["residency"] == "host", f"11e: host run residency {host['residency']}")
    check(json.loads((work / "device.json").read_text())
          == json.loads((work / "host.json").read_text()),
          "11e: the device-resident launcher's answers differ from the host run's")
    log(f"[11e] {SERVING['ranks']} ranks through torch.distributed.run at "
        f"{SERVING_LAUNCHER_GRAPH}: {e_s:.1f}s with startup; its {SERVE['queries']} answers "
        f"equal a host-resident run's ({host['qps']:.1f} qps there)")
    phase_s = time.perf_counter() - t_phase
    log(f"[11] phase {phase_s:.1f}s")
    shutil.rmtree(work, ignore_errors=True)
    strip = ("answers", "spans", "window")
    return dict(launches=launches, world_s=world_s, launcher_s=e_s, phase_s=phase_s,
                peaks=[rk["peak_bytes"] for rk in ranks],
                ranks0={t: ({kk: v for kk, v in r0[t].items() if kk not in strip}
                            if isinstance(r0[t], dict) else r0[t])
                        for t in ("a", "b", "c", "d")})


# -------------------------------------------------------------- phase 12 ----

# phase 12 (a): the reference's six production records and twitter under the
# allgather schedule; (c): the CUDA names of the port's kernels
DRYRUN_EXTRA = ("difuser-twitter", "pod16x16", "allgather")
# each record's temp bytes (GB) when a rank filled the whole n_pad x j_loc
# matrix and its fill before keeping its rows (the port's dry run at commit
# 79c500f): the owned-rows fill keeps every record at a quarter of it or less
WHOLE_FILL_TEMP_GB = {
    ("difuser-livejournal", "pod16x16"): 2.148, ("difuser-twitter", "pod16x16"): 8.594,
    ("difuser-friendster", "pod16x16"): 17.184, ("difuser-livejournal", "pods2x16x16"): 1.074,
    ("difuser-twitter", "pods2x16x16"): 4.299, ("difuser-friendster", "pods2x16x16"): 8.594}
# the reference's all-reduce bytes per device (its compiled program, XLA's
# CPU lowering: the selection's psum and two int flags), by record; the
# port's selection sum must move them within 10 %
REF_ALL_REDUCE = {
    ("difuser-livejournal", "pod16x16"): 7_864_351.875,
    ("difuser-twitter", "pod16x16"): 62_914_591.875,
    ("difuser-friendster", "pod16x16"): 62_914_591.875,
    ("difuser-livejournal", "pods2x16x16"): 8_126_495.938,
    ("difuser-twitter", "pods2x16x16"): 65_011_743.938,
    ("difuser-friendster", "pods2x16x16"): 65_011_743.938}
KERNEL_SYMBOLS = ("sketch_fill_kernel", "cardinality_kernel", "item_sweep", "item_combine",
                  "fused_sample_kernel")


def phase_dryrun(mesh: dict, full) -> dict:
    """Phase 12: the dry run held against the card (needs 10; 4 for (c)'s
    seeds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun, im
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.utils import opprof
    from repro_torch.utils.roofline import Roofline

    check(mesh is not None, "phase 12 needs phase 10")
    t_phase = time.perf_counter()
    out_dir = OUT / "dryrun"
    cells = [(name, mesh_name, "ring") for mesh_name in ("pod16x16", "pods2x16x16")
             for name in dryrun.IM_CELLS] + [DRYRUN_EXTRA]
    records = []
    for name, mesh_name, schedule in cells:
        grid = make_production_mesh(multi_pod=mesh_name != "pod16x16")
        rec = dryrun.run_cell(name, grid, mesh_name, out_dir=out_dir, schedule=schedule,
                              tag="" if schedule == "ring" else schedule)
        check(rec["ok"], f"12a: {name} {mesh_name} {schedule}: {rec.get('error')}")
        n, _, j, _ = dryrun.IM_CELLS[name]
        by_kind = rec["collectives"]["by_kind"]
        if schedule == "ring":
            want = 3 * (grid.mu_v - 1) * (n // grid.mu_v) * (j // grid.mu_s)
            check(by_kind["collective-permute"] == want,
                  f"12a: {name} {mesh_name}: permute {by_kind} is not {want}")
            temp_gb = rec["memory"]["temp_bytes"] / 1e9
            whole = WHOLE_FILL_TEMP_GB[(name, mesh_name)]
            check(temp_gb <= whole / 4, f"12a: {name} {mesh_name}: temp {temp_gb:.4f} GB is "
                  f"over a quarter of the whole-matrix fill's {whole} GB")
            ref_ar = REF_ALL_REDUCE[(name, mesh_name)]
            check(abs(by_kind["all-reduce"] - ref_ar) <= 0.1 * ref_ar,
                  f"12a: {name} {mesh_name}: selection bytes {by_kind['all-reduce']} are not "
                  f"within 10 % of the reference's {ref_ar}")
            log(f"[12a] {name} {mesh_name}: temp {temp_gb:.4f} GB (whole-matrix fill "
                f"{whole} GB, ratio {temp_gb / whole:.4f}); all-reduce "
                f"{by_kind['all-reduce']} B (reference {ref_ar} B, ratio "
                f"{by_kind['all-reduce'] / ref_ar:.6f})")
        roof = Roofline(name, rec["shape"], mesh_name, rec["chips"], rec["flops"],
                        rec["bytes_accessed"], rec["wire_bytes"], 0.0)
        log(f"[12a] {name} {mesh_name} {schedule}: per device wire "
            + ", ".join(f"{kind} {b:.6g} B" for kind, b in sorted(by_kind.items()))
            + f"; flops {rec['flops']:.6g}, bytes_accessed {rec['bytes_accessed']:.6g}; "
            + ", ".join(f"{key} {v}" for key, v in rec["memory"].items())
            + f"; roofline compute {roof.t_compute:.6g}s, memory {roof.t_memory:.6g}s, "
            f"collective {roof.t_collective:.6g}s -> {roof.bottleneck}; dry run "
            f"{rec['compile_s']}s")
        records.append(rec)

    # (b) the dry program of each phase 10 (a) rank's partition against its run
    for r, rk in enumerate(mesh["ranks"]):
        a = rk["a"]
        dry = a["dry"]
        real = {kind: (v["calls"], v["bytes_sent"]) for kind, v in a["stats"]["exchange"].items()}
        check(dry["exchange"] == real, f"12b: rank {r}: dry exchanges {dry['exchange']} are "
              f"not the run's {real}")
        # the partition's sampling (fused_sample) runs before the rank program
        program = {name: c for name, c in a["launches"].items() if name != "fused_sample"}
        check(dry["launches"] == program, f"12b: rank {r}: dry launches {dry['launches']} "
              f"are not the run's {program}")
    a = mesh["ranks"][0]["a"]
    dry = a["dry"]
    predicted = dry["argument_bytes"] + dry["temp_bytes"]
    log(f"[12b] phase 10 (a), every rank: the dry program times the run's sweeps "
        f"({a['propagate_iters']} build, {a['stats']['cascade_sweeps']} cascade, "
        f"{a['stats']['rebuild_sweeps']} rebuild, K={len(a['seeds'])}) equals its exchanges "
        f"and launches; rank 0: " + "; ".join(f"{kind} {c} calls, {b} B"
                                              for kind, (c, b) in dry["exchange"].items())
        + f"; launches {dry['launches']}; dry program {dry['host_s']:.3f}s")
    log(f"[12b] rank 0 peak: predicted {predicted / 2**30:.3f} GiB (arguments "
        f"{dry['argument_bytes'] / 2**30:.3f}, temp {dry['temp_bytes'] / 2**30:.3f}), "
        f"measured max_memory_allocated {a['peak_bytes'] / 2**30:.3f} GiB (partition prep "
        f"included), ratio {a['peak_bytes'] / predicted:.3f}")
    ratios = []
    for rk in mesh["ranks"]:
        ra = rk["a"]
        ratios.append(ra["peak_bytes"] / (ra["dry"]["argument_bytes"] + ra["dry"]["temp_bytes"]))
    log("[12b] measured / predicted peak by rank: " + ", ".join(f"{q:.4f}" for q in ratios))

    # (c) phase 4's single path once under the profiler
    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model",
            FULL["model"], "--registers", str(FULL["registers"]), "--k", str(
                len(full["seeds"]) if full else 50)]
    torch.cuda.synchronize()
    with _reuse_full_graph(im), contextlib.redirect_stdout(open(os.devnull, "w")), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = im.run(argv)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if full:
        check(list(got["seeds"]) == list(full["seeds"]), "12c: seeds differ from phase 4's")
    total, rows = opprof.op_profile(prof, top=12)
    _, every = opprof.op_profile(prof, top=1 << 30)
    kernels_us = sum(v for _, v, _, name in every if any(k in name for k in KERNEL_SYMBOLS))
    busy_us = opprof.device_busy_us(prof)
    profiled = dict(wall_us=wall_us, busy_us=busy_us, device_us=total, kernels_us=kernels_us,
                    top=[(share, v, c, name[:120]) for share, v, c, name in rows])
    if not total:
        log("[12c] the profiler recorded no device activity: not measured")
    else:
        log(f"[12c] phase 4's launcher under torch.profiler (CUDA activity): wall "
            f"{wall_us / 1e6:.3f}s, device self time {total / 1e6:.4f}s, device busy "
            f"{busy_us / 1e6:.4f}s = {busy_us / wall_us * 100:.2f}% of wall (idle "
            f"{100 - busy_us / wall_us * 100:.2f}%); the port's kernels "
            f"{kernels_us / total * 100:.2f}% of device time")
        for share, v, c, name in rows:
            log(f"[12c] {share * 100:6.2f}% {v / 1e3:10.3f} ms x{c:<6d} {name[:96]}")
    phase_s = time.perf_counter() - t_phase
    log(f"[12] phase {phase_s:.1f}s")
    return dict(records=records, profile=profiled, phase_s=phase_s)


# -------------------------------------------------------------- phase 13 ----

# FASST at full width: phase 4's graph, the reference launcher's R = 1024,
# sample shards of the 16 x 16 (mu 4 of its pods) and 8-way grids
FASST = dict(registers=1024, mus=(4, 8), methods=("fasst", "naive"), lane_widths=(32, 128))
FASST_FILL = dict(rows=1 << 19, regs=512, id_space=1 << 20)


def _fasst_metrics(g, x, mu: int, method: str) -> dict:
    """Phase 13's metrics of one (mu, method) on the current ``ops``, each
    timed (host clock, ending in a device sync)."""
    import numpy as np
    import torch

    from repro_torch.core import fasst

    out, secs = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return val

    part = timed("build_partition", lambda: fasst.build_partition(
        g, x, mu, method=method, device="cuda"))
    out["partition"] = part
    out["max_shard_fraction"] = timed("max_shard_fraction",
                                      lambda: fasst.max_shard_fraction(g, part))
    out["duplication_histogram"] = timed("duplication_histogram",
                                         lambda: fasst.duplication_histogram(g, part,
                                                                             device="cuda"))
    for lw in FASST["lane_widths"]:
        for order, xs in (("sorted", np.sort(x)), ("unsorted", x)):
            out[f"lane_fill_{lw}_{order}"] = timed(
                f"lane_fill_{lw}_{order}",
                lambda: fasst.lane_fill_rate(g, xs, lane_width=lw, device="cuda"))
    out["seconds"] = secs
    return out


def _same_fasst(kern: dict, plain: dict, what: str) -> None:
    a, b = kern["partition"], plain["partition"]
    for field in ("x_shards", "perm", "edge_index", "edge_counts"):
        x, y = getattr(a, field), getattr(b, field)
        check(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(),
              f"{what}: {field} differs between the kernel and the plain path")
    check(kern["duplication_histogram"].tobytes() == plain["duplication_histogram"].tobytes(),
          f"{what}: histograms differ")
    for key, val in kern.items():
        if isinstance(val, float):
            check(val == plain[key], f"{what}: {key} {val} != {plain[key]}")


def phase_fasst() -> dict:
    """Phase 13: FASST's partition and its Table 5-7 metrics at full width,
    kernel path against plain path; ``fill_registers`` with row ids."""
    import numpy as np
    import torch

    from repro_torch.core.sampling import make_x_vector
    from repro_torch.core.sketch import blank_matrix, fill_registers
    from repro_torch.kernels import counters
    from repro_torch.kernels.sketch_fill import sketch_fill_plain

    t_phase = time.perf_counter()
    g = full_graph()
    x = make_x_vector(FASST["registers"], seed=0)
    launches: dict = {}
    results = {}
    for mu in FASST["mus"]:
        for method in FASST["methods"]:
            what = f"13: mu={mu} {method}"
            counters.reset()
            kern = _fasst_metrics(g, x, mu, method)
            check(not counters.PLAIN_CALLS and set(counters.LAUNCHES) == {"fused_sample"},
                  f"{what} kernel path: launches {dict(counters.LAUNCHES)}, plain "
                  f"{dict(counters.PLAIN_CALLS)}")
            for name, c in counters.LAUNCHES.items():
                launches[name] = launches.get(name, 0) + c
            counters.reset()
            with plain_ops():
                plain = _fasst_metrics(g, x, mu, method)
            check(not counters.LAUNCHES and set(counters.PLAIN_CALLS) == {"fused_sample"},
                  f"{what} plain path launched {dict(counters.LAUNCHES)}")
            _same_fasst(kern, plain, what)
            part = kern["partition"]
            hist = kern["duplication_histogram"]
            log(f"[13] mu={mu} {method}: edge_counts {part.edge_counts.tolist()}, E_max "
                f"{part.edge_index.shape[1]} (of {g.m_real} real edges); max_shard_fraction "
                f"{kern['max_shard_fraction']!r}; duplication_histogram (k = 0..{mu}) "
                f"{[float(v) for v in hist]}")
            log(f"[13] mu={mu} {method}: lane_fill_rate " + ", ".join(
                f"{lw} {order} {kern[f'lane_fill_{lw}_{order}']!r}"
                for lw in FASST["lane_widths"] for order in ("sorted", "unsorted")))
            times = {path: ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
                     for path, res in (("kernel", kern), ("plain", plain))}
            log(f"[13] mu={mu} {method}: seconds, kernel path {times['kernel']}; plain path "
                f"{times['plain']}; kernel and plain path byte-equal")
            results[f"{mu}_{method}"] = dict(
                edge_counts=part.edge_counts.tolist(), e_max=int(part.edge_index.shape[1]),
                max_shard_fraction=kern["max_shard_fraction"],
                duplication_histogram=[float(v) for v in hist],
                lane_fill={k: v for k, v in kern.items() if k.startswith("lane_fill")},
                seconds=kern["seconds"], plain_seconds=plain["seconds"])
    # fill_registers with row ids on the card against the plain fill
    rows, regs = FASST_FILL["rows"], FASST_FILL["regs"]
    ids = torch.from_numpy(np.random.default_rng(0).permutation(
        FASST_FILL["id_space"])[:rows].astype(np.int64)).cuda()
    counters.reset()
    got = fill_registers(rows, regs, reg_offset=regs, seed=0, ids=ids, device="cuda")
    check(dict(counters.LAUNCHES) == {"sketch_fill": 1} and not counters.PLAIN_CALLS,
          f"13: fill_registers ran {dict(counters.LAUNCHES)} {dict(counters.PLAIN_CALLS)}")
    want = sketch_fill_plain(blank_matrix(rows, regs, "cuda"), ids=ids, reg_offset=regs,
                             seed=0)
    check(torch.equal(got, want), "13: fill_registers with row ids differs from the plain "
          "fill")
    log(f"[13] fill_registers({rows}, {regs}, ids of {FASST_FILL['id_space']}) on the card "
        f"equals sketch_fill_plain with the same ids")
    phase_s = time.perf_counter() - t_phase
    log(f"[13] phase {phase_s:.1f}s")
    return dict(launches=launches, results=results, phase_s=phase_s)


# -------------------------------------------------------------- phase 14 ----

# phase 14: (a) the port's scripts at their own sizes (rmat:10, rmat:12, ER
# n = 1,024); (b) every registered model but wc (phase 4's) at phase 4's size
SCRIPTS = {"examples_torch/quickstart.py": SINGLE_KERNELS + ("fused_sample",),
           "examples_torch/influence_service.py": SINGLE_KERNELS,
           "scripts_torch/check_models.py": SINGLE_KERNELS}
DIST_SCRIPT = "examples_torch/distributed_im.py"
DIST_TIMEOUT_S = 300.0
# the kernels every rank of distributed_im's mesh run launches (its spec keeps
# the unfused ring sweeps, so fused_sweep is not among them)
DIST_KERNELS = ("fused_sample", "sketch_fill", "sketch_cardinality", "bucket_propagate",
                "bucket_cascade")
# argv: output directory, script, its arguments. Runs the script; each rank
# writes its counts when it leaves the world (the mesh run's end; rank 0's
# single-device half comes after it), to <output directory>/rank<R>.json.
# The script re-executes its whole command line under torch.distributed.run,
# so every rank runs this too.
DIST_RUNNER = """
import json, os, runpy, sys
from repro_torch.kernels import counters
from repro_torch.launch import mesh
out, script = sys.argv[1], sys.argv[2]
leave = mesh.shutdown_world
def count_then_leave():
    if mesh.env_world():
        with open(os.path.join(out, "rank%s.json" % os.environ["RANK"]), "w") as f:
            json.dump(dict(launches=counters.LAUNCHES, plain=counters.PLAIN_CALLS), f)
    leave()
mesh.shutdown_world = count_then_leave
counters.reset()
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
"""
ZOO = ("ic:0.1", "dic:1.0", "lt")
RESULT_WORDS = ("qps", "p50", "p99", "amortized")


def result_lines(stdout: str) -> list:
    """A script's result lines: those of qps, p50/p99 and "amortized"
    dropped, and every ``<number>s`` (a wall time) masked. The CPU tests of
    the scripts (``tests/test_torch_examples.py``) compare by this too."""
    import re

    return [re.sub(r"\b\d+(?:\.\d+)?s\b", "<t>s", line) for line in stdout.splitlines()
            if not any(word in line for word in RESULT_WORDS)]


def _run_script(path: Path) -> str:
    """Run a script in this process on the card; its standard output."""
    import io
    import runpy

    import torch

    buf = io.StringIO()
    argv, sys.argv = sys.argv, [str(path), "--device", "cuda"]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    except SystemExit as e:
        check(e.code in (0, None), f"{path.name} exited with {e.code}: {buf.getvalue()}")
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    return buf.getvalue()


def _same_lines(kern: str, plain: str, what: str) -> None:
    check(result_lines(kern) == result_lines(plain),
          f"{what}: kernel path printed {kern!r}, plain path {plain!r}")


def phase_scripts() -> dict:
    """Phase 14 (a): the three single-process scripts in this process, on the
    kernel path and on the plain path (result lines equal); then
    ``distributed_im``'s 8 ranks under ``torch.distributed.run``, sharing
    the card, and its rank-0 single half here, kernel path against plain."""
    import runpy
    import shutil

    from repro_torch.kernels import counters
    from repro_torch.runtime import run

    launches: dict = {}
    seconds = {}
    OUT.mkdir(parents=True, exist_ok=True)
    for rel, kernels in SCRIPTS.items():
        path = ROOT / rel
        counts = []   # each run's launches, read before the next reset

        def drive():
            out = _run_script(path)
            counts.append(dict(counters.LAUNCHES))
            return out

        out, t_k, t_p = _kernel_and_plain(drive, kernels, f"14a {path.name}",
                                          same=_same_lines)
        for name, c in counts[0].items():   # the kernel path's run
            launches[name] = launches.get(name, 0) + c
        (OUT / f"{path.stem}.log").write_text(out)
        seconds[path.stem] = dict(kernel_s=t_k, plain_s=t_p)
        log(f"[14a] {rel}: exit 0, result lines equal the plain path's; kernel path "
            f"{t_k:.2f}s, plain path {t_p:.2f}s; launches {counts[0]}")
        for line in out.splitlines():
            if any(w in line for w in ("qps", "warm TopKSeeds", "check_models.")):
                log(f"[14a] {path.stem}: {line}")
    # distributed_im: 8 ranks sharing the card (gloo, host-staged exchanges),
    # started through DIST_RUNNER so that each rank reports its counts
    ranks_dir = OUT / "distributed_im_ranks"
    shutil.rmtree(ranks_dir, ignore_errors=True)
    ranks_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DIST_RUNNER, str(ranks_dir),
                           str(ROOT / DIST_SCRIPT)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
    dist_s = time.perf_counter() - t0
    (OUT / "distributed_im.log").write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    check(proc.returncode == 0, f"14a distributed_im failed: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        if line:
            log(f"[14a] distributed_im: {line}")
    check(sum(ln.startswith("graph: ") for ln in lines) == 1, "14a: rank 0 alone prints")
    check(any(ln.startswith("sharded (2x4 mesh, ring): ") for ln in lines),
          "14a: distributed_im did not run on the mesh")
    check("distributed == single-device: bitwise identical seeds" in lines,
          "14a: distributed_im's mesh seeds differ from its single-device seeds")
    ns = runpy.run_path(str(ROOT / DIST_SCRIPT), run_name="distributed_im")
    rank_counts = {}
    for r in range(ns["RANKS"]):
        path = ranks_dir / f"rank{r}.json"
        check(path.exists(), f"14a: distributed_im's rank {r} wrote no counts")
        rank_counts[r] = json.loads(path.read_text())
        got, plain = rank_counts[r]["launches"], rank_counts[r]["plain"]
        missing = [n for n in DIST_KERNELS if got.get(n, 0) <= 0]
        check(not missing, f"14a: distributed_im's rank {r} launched none of {missing}")
        check(not plain, f"14a: distributed_im's rank {r} ran plain versions: {plain}")
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c
    log(f"[14a] distributed_im: each of the {ns['RANKS']} ranks launched {', '.join(DIST_KERNELS)} "
        f"in its mesh run, no plain version; rank 0 {rank_counts[0]['launches']}, rank 1 "
        f"{rank_counts[1]['launches']}")
    single_line = next(ln for ln in lines if ln.startswith("single-device:"))
    g = ns["make_graph"]()
    spec = ns["SPEC"].with_(backend="single")
    half, t_k, t_p = _kernel_and_plain(lambda: run(g, ns["K"], spec, device="cuda").result,
                                       SINGLE_KERNELS, "14a distributed_im single half")
    check(single_line.endswith(f"spread={half.scores[-1]:.0f}"),
          f"14a: the script's {single_line!r} against {half.scores[-1]}")
    seconds["distributed_im"] = dict(wall_s=dist_s, single_kernel_s=t_k, single_plain_s=t_p,
                                     ranks=rank_counts)
    log(f"[14a] {DIST_SCRIPT}: {ns['RANKS']} ranks, exit 0, {dist_s:.1f}s with startup; its single "
        f"half here equals the plain path's (seeds {half.seeds.tolist()[:5]}...; kernel "
        f"path {t_k:.2f}s, plain path {t_p:.2f}s)")
    return dict(launches=launches, seconds=seconds)


def phase_models(k: int) -> dict:
    """Phase 14 (b): ic:0.1, dic:1.0 and lt through the launcher at phase
    4's size, each checked as phase 4 is."""
    import torch

    # phase 6's matrices served phases 7, 8 and 11; dropped, the peaks below
    # read as phase 4's
    _SERVE.clear()
    log(f"[14b] allocated before the runs: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    launches: dict = {}
    runs = {}
    for model in ZOO:
        runs[model] = phase_full(k, model=model, tag="14b")
        for name, c in runs[model]["launches"].items():
            launches[name] = launches.get(name, 0) + c
    return dict(launches=launches, runs=runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,4b,5,6,7,8,9,10,11,12,13,14")
    ap.add_argument("--k", type=int, default=50, help="seed rounds of phases 4 and 4b")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    # SLO breaches and admission stalls dump the flight ring: beside the output
    os.environ.setdefault("REPRO_TORCH_FLIGHT_DIR", str(OUT / "flight"))

    smi = nvidia_smi_line()
    log(f"[1] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    if "2" in phases:
        phase_kernels()
    if "3" in phases:
        phase_parity()
    full = phase_full(args.k) if "4" in phases else None
    serial = None
    if "4b" in phases:
        serial = phase_full_serial(args.k, full["seeds"] if full else None)
    rows = []
    if "5" in phases and full:
        rows += phase_timings(full)
    if "5" in phases and serial:
        rows += phase_ring_timings(serial)
        for row in rows:   # the owned-rows fill beside the whole fill
            if row["name"] == "sketch_fill":
                row.update(serial["fill_ids"])
    serve = phase_serve() if "6" in phases else None
    if serve:
        for row in rows:   # launches of each kernel on the serving path too
            row["launches_serve"] = int(serve["launches"].get(row["name"], 0))
    served_async = phase_async() if "7" in phases else None
    if served_async:
        for row in rows:   # and on the async path
            row["launches_async"] = int(served_async["launches"].get(row["name"], 0))
    repair = phase_shard_repair(full, serial, args.k) if "8" in phases else None
    if repair:
        for row in rows:   # and on the shard repair's path
            row["launches_repair"] = int(repair["launches"].get(row["name"], 0))
    tuning = phase_tuning(full, serial, serve, smi, args.k) if "9" in phases else None
    if tuning:
        for row in rows:   # and on the tuning path
            row["launches_tune"] = int(tuning["launches"].get(row["name"], 0))
    mesh = phase_mesh(full, serial, args.k) if "10" in phases else None
    if mesh:
        for row in rows:   # and on the mesh's path, summed over its ranks
            row["launches_mesh"] = int(mesh["launches"].get(row["name"], 0))
    mesh_serve = phase_mesh_serving() if "11" in phases else None
    if mesh_serve:
        for row in rows:   # and on the device-resident path, summed over its ranks
            row["launches_mesh_serve"] = int(mesh_serve["launches"].get(row["name"], 0))
    dry = phase_dryrun(mesh, full) if "12" in phases else None
    fasst = phase_fasst() if "13" in phases else None
    if fasst:
        for row in rows:   # and on FASST's analysis (its kernel path)
            row["launches_fasst"] = int(fasst["launches"].get(row["name"], 0))
    zoo = None
    if "14" in phases:
        t14 = time.perf_counter()
        zoo = dict(scripts=phase_scripts(), models=phase_models(args.k))
        zoo["phase_s"] = time.perf_counter() - t14
        log(f"[14] phase {zoo['phase_s']:.1f}s")
        for row in rows:   # and on the scripts' kernel paths, and the other models'
            row["launches_scripts"] = int(zoo["scripts"]["launches"].get(row["name"], 0))
            row["launches_models"] = int(zoo["models"]["launches"].get(row["name"], 0))
    log(f"total {time.perf_counter() - t0:.1f}s")
    if rows:
        OUT.mkdir(parents=True, exist_ok=True)
        serial_out = {k: v for k, v in (serial or {}).items() if k != "partition"}
        (OUT / "kernels.json").write_text(json.dumps(
            dict(rows=rows, full=full, serial=serial_out, serve=serve,
                 served_async=served_async, repair=repair, tuning=tuning, mesh=mesh,
                 mesh_serve=mesh_serve, dryrun=dry, fasst=fasst, zoo=zoo, smi=smi),
            indent=1,
            default=str))
        print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
