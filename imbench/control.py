"""The control of a cell's comparison, at the cell's own size: the plain
reference put in the program's place with its score and estimate
arithmetic one precision lower (bfloat16 for the configuration's float32),
judged against the float32 reference by the cell's numbers and limits.
The comparison is sound only where the control fails it on every seed.

    python3 imbench/control.py --workload <cell>[,<cell>...] --seeds 11,12,13

For each cell and seed it makes the cell's graph as a run does, takes the
hash seed of the window's first job, and prints one JSON line: the seed,
each number's reading against its limit, whether the control passed, and
the seconds each reference took. Cells of one configuration, K and count
of simulation shards share the two references' answers. It runs the benchmark's own runs never, and
the program not at all. On the CPU (``--device cpu``) only at small sizes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "imbench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="imbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from imbench.harness import cells

    bench = cells.load_benchmark(ROOT)
    dev = torch.device(args.device)
    for seed in (int(s) % 2 ** 64 for s in args.seeds.split(",")):
        shared: dict = {}
        for name in args.workload.split(","):
            cell = cells.load_cell(bench, name)
            batch = cell.generator().plan(cell.traffic, cell.config, seed)
            key = (json.dumps(cell.config, sort_keys=True), batch.k, batch.sim_shards)
            if key not in shared:
                shared[key] = _answers(cell.config, batch, seed, dev)
            print(json.dumps(_verdict(name, seed, cell.check, *shared[key])),
                  flush=True)
    return 0


def _answers(config, batch, seed, dev):
    """The reference's and the control's answers for the first job, and
    the seconds each took."""
    import torch

    from imbench.harness import graph
    from imbench.reference import alg4

    edges = graph.make_edges(config, seed, dev)
    answers, took = {}, {}
    for name, dtype in (("reference", torch.float32), ("control", torch.bfloat16)):
        t0 = time.perf_counter()
        answers[name] = alg4.find_seeds(
            *edges, model=batch.model, num_registers=batch.num_registers, k=batch.k,
            seed=batch.hash_seed(0), device=dev, dtype=dtype,
            sim_shards=batch.sim_shards)
        took[name] = time.perf_counter() - t0
    return answers["reference"], answers["control"], took


def _verdict(name, seed, spec, ref, ctl, took) -> dict:
    from imbench.harness import check

    verdict = check.judge(check.readings(ctl, ref, spec), spec["limits"])
    return {"workload": name, "seed": seed,
            "control_passed": all(v["ok"] for v in verdict.values()),
            "numbers": {k: [v["value"], v["limit"]] for k, v in verdict.items()},
            "seconds": took,
            "sweeps": [ref.build_sweeps, ref.cascade_sweeps, ref.rebuild_sweeps]}


if __name__ == "__main__":
    sys.exit(main())
