#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # all phases, as the check runs it
    python3 chip_smoke.py --phases 1,2    # build and kernel checks only
    python3 chip_smoke.py --phases 1,6,7  # the serving phases (7 needs 6)

Phases (each raises on failure; none is caught):

1. device: the card's name and power limit (``nvidia-smi``); build the
   seven CUDA sources from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, in parallel) and print what ``ptxas`` reports for each kernel
   instance (registers, spills);
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
   version's time, the largest difference between the two, and the bound;
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
   future holds an exception.

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
launcher and async engines), the
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

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): device memory
# 3.35 TB/s; INT32 = 132 SMs x 64 INT32 lanes x 1.98 GHz.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# integer operations per (edge, register): the predicate (xor, subtract,
# compare; the lt remix adds fmix32's 8) and the merge
SWEEP_OPS = {0: 4, 1: 12}
# per register: j * M2 (one add from the word's base), xor, fmix32's 8, clz,
# byte pack; the VISITED merge is per 4-register word and not counted
FILL_OPS = 12
CARD_OPS = 5          # compare, shift, 64-bit add, count
REGS_PER_WORD = 4     # the sweeps test VISITED on 4 registers at once

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
SINGLE_KERNELS = ("sketch_fill", "sketch_cardinality", "sketch_propagate", "cascade_step")
SERIAL_KERNELS = ("fused_sample", "sketch_fill", "sketch_cardinality", "fused_sweep",
                  "bucket_propagate", "bucket_cascade")


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


def phase_kernels():
    import torch

    from repro_torch.kernels import sketch_cardinality, sketch_fill

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

def phase_full(k: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import counters
    from repro_torch.launch import im

    argv = ["--graph", FULL["graph"], "--setting", FULL["setting"], "--model",
            FULL["model"], "--registers", str(FULL["registers"]), "--k", str(k)]
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out = im.run(argv)
    launches, plain = dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] {FULL['graph']} n={out['n']} m={out['m']} J={FULL['registers']} K={k}: "
        f"prep {out['prep_s']:.3f}s, build {out['build_s']:.3f}s "
        f"({out['propagate_iters']} sweeps), rounds {out['rounds_s']:.3f}s ({out['cascade_sweeps']} cascade sweeps, "
        f"{out['rebuild_sweeps']} rebuild sweeps), total {out['time_s']:.2f}s, "
        f"rebuilds {out['rebuilds']}/{k}, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[4] launches {launches}; plain calls {plain}")
    check(not plain, f"plain versions ran on the main path: {plain}")
    missing = [n for n in ("sketch_fill", "sketch_cardinality", "sketch_propagate",
                           "cascade_step") if launches.get(n, 0) <= 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    seeds = np.asarray(out["seeds"])
    check(len(seeds) == k and len(set(seeds.tolist())) == k, "seeds not distinct")
    check(((seeds >= 0) & (seeds < out["n"])).all(), "seed outside [0, n)")
    check(np.isfinite(out["difuser_score"]) and out["difuser_score"] > 0,
          f"influence estimate {out['difuser_score']}")
    out.update(launches=launches, peak_bytes=peak)
    return out


def phase_full_serial(k: int, single_seeds) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import counters
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
                propagate_iters=res.propagate_iters, **st)


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
    from repro_torch.kernels import fused_sample, fused_sweep
    from repro_torch.partition.serial import _RingState

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
    ops_per_pair = SWEEP_OPS[variant]
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
        return (f"gathers {nbytes / 1e9:.4f} GB, {nbytes / MEM_BYTES_PER_S * 1e3:.4f} ms "
                f"at the device memory rate")

    def bucket_bytes(rows):
        n_w = int((torch.diff(rows.rowptr) > 0).sum().item())
        n_r = int(torch.unique(rows.nbr).numel())
        slots = rows.nbr.numel()
        return 2 * n_w * j + n_r * j + 16 * slots + 4 * (part.n_loc + 1) + 4 * j, slots

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
        nbytes, slots = bucket_bytes(rows)
        if name == "bucket_propagate":
            ops = ops_per_pair * slots * j
        else:   # one VISITED test per (slot, word), the predicate on VISITED reads
            vis_pairs = int((block == -1).sum(1)[rows.nbr.long()].sum().item())
            ops = slots * j // REGS_PER_WORD + ops_per_pair * vis_pairs
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
                        ms, plain_ms, _bound(nbytes, ops), note=gathers(slots * j)))

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
        _bound(2 * part.n_loc * j + 16 * slots + 4 * (part.n_loc + 1) + 4 * j,
               SERIAL["local_sweeps"] * ops_per_pair * slots * j),
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
        _bound(num_e * j + 12 * num_e + 4 * j, ops_per_pair * num_e * j)))
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


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.kernels import (cascade_step, sketch_cardinality, sketch_fill,
                                     sketch_propagate)
    from repro_torch.kernels.edges import work_list

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
    cells = n_pad * num_regs
    edge_bytes = num_edges * 16 + (n_pad + 1) * 4 + num_regs * 4
    vis_rows = (m_casc == -1).sum(1)
    vis_pairs = int(vis_rows[edges.src.long()].sum().item())

    bound = _bound
    specs = [
        ("sketch_fill", "sketch_fill.cu", "src/repro/kernels/sketch_fill.py:47",
         lambda: sketch_fill.sketch_fill_cuda(m),
         lambda: sketch_fill.sketch_fill_plain(m),
         bound(2 * cells, FILL_OPS * cells)),
        ("sketch_cardinality", "sketch_cardinality.cu",
         "src/repro/kernels/sketch_cardinality.py:40",
         lambda: sketch_cardinality.cardinality_stats_cuda(m),
         lambda: sketch_cardinality.cardinality_stats_plain(m),
         bound(cells + 8 * n_pad, CARD_OPS * cells)),
        ("sketch_propagate", "sketch_propagate.cu",
         "src/repro/kernels/sketch_propagate.py:121",
         lambda: sketch_propagate.propagate_sweep_cuda(m, edges, x_t, variant=variant),
         lambda: sketch_propagate.propagate_sweep_plain(m, edges, x_t, variant=variant),
         bound(2 * cells + edge_bytes, SWEEP_OPS[variant] * num_edges * num_regs)),
        # the cascade needs the predicate only where the source register is
        # VISITED: one test per (edge, 4-register word), the predicate on
        # vis_pairs
        ("cascade_step", "cascade_step.cu", "src/repro/kernels/cascade_step.py:80",
         lambda: cascade_step.cascade_sweep_cuda(m_casc, edges, x_t, variant=variant),
         lambda: cascade_step.cascade_sweep_plain(m_casc, edges, x_t, variant=variant),
         bound(2 * cells + edge_bytes,
               num_edges * num_regs // REGS_PER_WORD + SWEEP_OPS[variant] * vis_pairs)),
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
        f"{gather / MEM_BYTES_PER_S * 1e3:.4f} ms at the device memory rate")
    return rows


# --------------------------------------------------------------- phase 6 ----

def phase_serve() -> dict:
    """The serving path at full width through the serve launcher, then the
    query loop alone, then an insertion delta and a warm top-k."""
    import numpy as np
    import torch

    from repro_torch.graphs import GraphDelta
    from repro_torch.kernels import counters, sketch_cardinality
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
    out, sess, _ = serve_im.run(argv, return_session=True)
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
    cells = rows.numel()
    card_ms = _time_ms(lambda: sketch_cardinality.cardinality_stats_cuda(rows), reps=20)
    card_plain = _time_ms(lambda: sketch_cardinality.cardinality_stats_plain(rows), reps=5)
    bound_ms, bound_by = _bound(cells + 8 * rows.shape[0], CARD_OPS * cells)
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
    _SERVE.update(built=built, repaired=repaired, delta=delta,
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


_SERVE: dict = {}   # phase 6's built and repaired matrices and its delta, for phase 7


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
    check(not plain, f"plain versions ran on the async path ({what}): {plain}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,4b,5,6,7")
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
    serve = phase_serve() if "6" in phases else None
    if serve:
        for row in rows:   # launches of each kernel on the serving path too
            row["launches_serve"] = int(serve["launches"].get(row["name"], 0))
    served_async = phase_async() if "7" in phases else None
    if served_async:
        for row in rows:   # and on the async path
            row["launches_async"] = int(served_async["launches"].get(row["name"], 0))
    log(f"total {time.perf_counter() - t0:.1f}s")
    if rows:
        OUT.mkdir(parents=True, exist_ok=True)
        serial_out = {k: v for k, v in (serial or {}).items() if k != "partition"}
        (OUT / "kernels.json").write_text(json.dumps(
            dict(rows=rows, full=full, serial=serial_out, serve=serve,
                 served_async=served_async, smi=smi), indent=1))
        print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
