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

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; it never falls back to the CPU. It exits with 3,
and prints no result, if jax, jaxlib, flax or the JAX package ``repro`` is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
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
    import torch

    marks = {"torch": time.perf_counter()}
    from imbench.harness import bench as _bench
    from imbench.harness import cells

    cell = cells.load_cell(bench if bench is not None else cells.load_benchmark(ROOT),
                           args.workload, data_dir or cells.HERE)
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
    result = _bench.run_cell(cell, seed=args.seed % 2 ** 64, seconds=args.seconds,
                             trace=bool(args.trace), device=device, t_start=t_start,
                             marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"imbench: loaded in the reporting process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
