#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # all phases, as the check runs it
    python3 chip_smoke.py --phases 1,2    # build and kernel checks only

Phases (each raises on failure; none is caught):

1. device: the card's name and power limit (``nvidia-smi``); build the four
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, in
   parallel) and print what ``ptxas`` reports;
2. each kernel against its plain PyTorch version on the card, on several
   shapes (both predicate forms, ``reg_offset != 0``, VISITED rows, a prime
   edge count, register counts that are not multiples of 32): equal int8
   matrices and bit-equal float32 statistics; a register count off
   multiples of 4 is refused;
3. the kernel path against the plain path on the card at rmat:14, J=256,
   K=8, for wc, ic:0.1, lt and dic:1.0 (for the plain path this script puts
   the plain versions in place of ``kernels.ops``' four functions): seeds,
   rebuilds and sweep counts equal, gains and scores to rtol 1e-6;
4. the slice at full size through the launcher's entry point
   (``repro_torch.launch.im``: rmat:20, setting 0.1, wc, J=1024, K=50), with
   the launch counters reset before and read after: every kernel launched,
   no plain version called;
5. each kernel at phase 4's shapes: time (CUDA events), its plain version's
   time, the largest difference between the two, and the bound.

It prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the
contract line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository around it, it exits non-zero before printing any.
Longer output goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
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

def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[1] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s -> {build.BUILD_DIR}")
    OUT.mkdir(parents=True, exist_ok=True)
    for name, rep in reports.items():
        (OUT / f"ptxas_{name}.txt").write_text(rep)
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    for name in build.KERNELS:
        build.load(name)


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


def phase_kernels():
    import torch

    from repro_torch.kernels import (cascade_step, sketch_cardinality,
                                     sketch_fill, sketch_propagate)

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
        for variant in (0, 1):
            for cuda_fn, plain_fn in (
                    (sketch_propagate.propagate_sweep_cuda,
                     sketch_propagate.propagate_sweep_plain),
                    (cascade_step.cascade_sweep_cuda, cascade_step.cascade_sweep_plain)):
                a, fa = cuda_fn(m, edges, x, variant=variant)
                b, fb = plain_fn(m, edges, x, variant=variant)
                check(torch.equal(a, b), (cuda_fn.__name__, n_pad, num_regs, variant))
                check(bool(fa.item()) == bool(fb.item()), (cuda_fn.__name__, "changed"))
        log(f"[2] n_pad={n_pad} J={num_regs} E={num_edges}: 4 kernels equal "
            f"their plain versions (both predicates, reg_offset 0 and 12345)")
    m, _, _ = _random_case(64, 37, 101, seed=99, device="cuda")
    try:
        sketch_fill.sketch_fill_cuda(m)
    except ValueError as e:
        log(f"[2] J=37 refused: {e}")
    else:
        check(False, "sketch_fill_cuda took a register count off multiples of 4")
    torch.cuda.synchronize()


# --------------------------------------------------------------- phase 3 ----

@contextlib.contextmanager
def plain_ops():
    """Put the plain versions in place of ``kernels.ops``' four functions,
    which the driver calls as module attributes, for the length of a block."""
    from repro_torch.kernels import (cascade_step, ops, sketch_cardinality,
                                     sketch_fill, sketch_propagate)

    swap = dict(sketch_fill=sketch_fill.sketch_fill_plain,
                cardinality_stats=sketch_cardinality.cardinality_stats_plain,
                propagate_sweep=sketch_propagate.propagate_sweep_plain,
                cascade_sweep=cascade_step.cascade_sweep_plain)
    saved = {name: getattr(ops, name) for name in swap}
    try:
        for name, fn in swap.items():
            setattr(ops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def phase_parity():
    import numpy as np

    from repro_torch.core.difuser import DiFuserConfig, find_seeds
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import counters

    g = rmat_graph(14, setting="0.1", seed=0)
    for model in ("wc", "ic:0.1", "lt", "dic:1.0"):
        cfg = DiFuserConfig(num_registers=256, model=model)
        counters.reset()
        t0 = time.perf_counter()
        kern = find_seeds(g, 8, cfg, device="cuda")
        t1 = time.perf_counter()
        check(not counters.PLAIN_CALLS and len(counters.LAUNCHES) == 4,
              f"kernel path: launches {dict(counters.LAUNCHES)}, plain "
              f"{dict(counters.PLAIN_CALLS)}")
        counters.reset()
        with plain_ops():
            plain = find_seeds(g, 8, cfg, device="cuda")
        t2 = time.perf_counter()
        check(not counters.LAUNCHES and len(counters.PLAIN_CALLS) == 4,
              f"plain path launched {dict(counters.LAUNCHES)}")
        np.testing.assert_array_equal(kern.seeds, plain.seeds)
        np.testing.assert_array_equal(kern.rebuilds, plain.rebuilds)
        check(kern.propagate_iters == plain.propagate_iters, (model, "build sweeps"))
        check(kern.stats["cascade_sweeps"] == plain.stats["cascade_sweeps"],
              (model, "cascade sweeps"))
        np.testing.assert_allclose(kern.est_gains, plain.est_gains, rtol=1e-6, atol=0)
        np.testing.assert_allclose(kern.scores, plain.scores, rtol=1e-6, atol=0)
        log(f"[3] rmat:14 J=256 K=8 {model}: seeds {kern.seeds.tolist()} "
            f"sweeps={kern.propagate_iters} rebuilds={int(kern.rebuilds.sum())} "
            f"equal; kernel path {t1 - t0:.2f}s, plain path {t2 - t1:.2f}s")


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


# --------------------------------------------------------------- phase 5 ----

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
    from repro_torch.launch.common import make_graph

    cfg = DiFuserConfig(num_registers=FULL["registers"], model=FULL["model"])
    g, x = normalize_inputs(make_graph(FULL["graph"], FULL["setting"], 0), cfg)
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

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    src = "src/repro_torch/kernels/csrc/"
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
    for name, file, replaces, kern, plain, (bound_ms, bound_by) in specs:
        err = _max_abs_err(kern(), plain())
        ms = _time_ms(kern, reps=5)
        plain_ms = _time_ms(plain, reps=1)
        rows.append(dict(name=name, route="cuda", source=src + file, replaces=replaces,
                         launches=int(full["launches"].get(name, 0)), max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
        log(f"[5] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}), max_abs_err {err}")
        check(err == 0.0, f"{name} differs from its plain version at full size")
    out_deg = torch.diff(edges.by_src.rowptr).max().item()
    in_deg = torch.diff(edges.by_dst.rowptr).max().item()
    log(f"[5] longest row walk: out-degree {out_deg} (propagate), in-degree {in_deg} "
        f"(cascade)")
    log(f"[5] shapes: n_pad={n_pad} J={num_regs} E={num_edges} "
        f"(cascade: {vis_pairs} (edge, register) pairs with a VISITED source)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    ap.add_argument("--k", type=int, default=50, help="seed rounds of phase 4")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    smi = nvidia_smi_line()
    log(f"[1] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    if 2 in phases:
        phase_kernels()
    if 3 in phases:
        phase_parity()
    full = phase_full(args.k) if 4 in phases else None
    rows = phase_timings(full) if 5 in phases and full else []
    log(f"total {time.perf_counter() - t0:.1f}s")
    if rows:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "kernels.json").write_text(json.dumps(dict(rows=rows, full=full,
                                                          smi=smi), indent=1))
        print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
