"""The benchmark of the PyTorch and CUDA port (``repro_torch``): seconds per
seed set of DiFuseR's influence maximization on one H100.

    python3 imbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, which holds the program under ``src/``.
It runs the cell of ``BENCHMARK.json`` named ``<cell>`` (``harness/bench.py``
says how) and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with the reference beside its limit, which are also the
last lines of standard error.

A cell whose ``chips`` is more than 1 runs as a world of one rank a card
(``harness/world.py``): this process starts the ranks, each this script
with the same arguments, passes on rank 0's output and exits 0 only if
every rank did. A one-card cell runs in this process alone.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; it never falls back to the CPU. It exits with 3,
and prints no result, if jax, jaxlib, flax or the JAX package ``repro`` is
loaded once the window has closed: in this process, or in any rank of a
world.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder is not a package root: only ``imbench.*`` names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "imbench"]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level modules that must not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="imbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, bench=None, data_dir=None, device=None, t_start=T_START) -> int:
    """``bench``, ``data_dir`` and ``device`` stand in for ``BENCHMARK.json``,
    the benchmark's data files and the card, in the tests."""
    args = parse(argv)
    from imbench.harness import cells

    rank = None
    if os.environ.get("IMBENCH_WORLD"):  # world.WORLD_ENV: a rank this script started
        from imbench.harness import world

        rank = world.Rank.from_env()
        bench, data_dir, device, t_start = rank.bench, rank.data_dir, rank.device, rank.t_start
    cell = cells.load_cell(bench if bench is not None else cells.load_benchmark(ROOT),
                           args.workload, Path(data_dir) if data_dir else cells.HERE)
    if cell.chips > 1 and rank is None:
        from imbench.harness import world

        return world.launch(args, cell.chips, t_start=t_start, forbidden=forbidden_modules,
                            bench=bench, data_dir=data_dir, device=device)
    # a rank's set-up counts from the launcher's start, its own start a step of it
    marks = {} if rank is None else {"rank started": T_START}
    import torch

    marks["torch"] = time.perf_counter()
    from imbench.harness import bench as _bench

    if device is None:
        marks["harness"] = time.perf_counter()
        if not torch.cuda.is_available():
            print("imbench: no CUDA device; the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"imbench: {args.workload} needs {cell.chips} CUDA devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
        marks["driver"] = time.perf_counter()
    joined = None
    if rank is not None:
        joined = rank.join(device)
        device = joined.device
        marks["world"] = time.perf_counter()
    result = _bench.run_cell(cell, seed=args.seed % 2 ** 64, seconds=args.seconds,
                             trace=bool(args.trace), device=device, t_start=t_start,
                             marks=marks, world=joined)
    bad = forbidden_modules()
    if bad:  # a rank other than 0 fails the launcher, which then prints nothing
        where = "the reporting process" if result is not None else f"rank {rank.rank}"
        print(f"imbench: loaded in {where}: {bad}", file=sys.stderr)
        return 3
    if result is None:  # a rank of a world other than rank 0
        return 0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
