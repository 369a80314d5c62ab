"""A cell shrunk to CPU size in a temporary folder, and one run of it
through ``imbench/run.py``'s ``main`` on the CPU (the harness's look for a
card skipped: ``device="cpu"``)."""
import contextlib
import io
import json
import sys
import time
from pathlib import Path
from unittest import mock

from imbench import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "imbench"
NAME = "tiny.cell"


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_cell(tmp_path: Path, cell: str, *, scale: int = 8, registers: int = 32,
              k: int = 6):
    """``(bench, data_dir)``: ``BENCHMARK.json`` with the cell ``tiny.cell``
    added, a copy of ``cell`` at ``scale`` and ``registers`` with K = ``k``,
    reported by the metrics that report ``cell``."""
    bench = _load(ROOT / "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    data = tmp_path / "data"
    for sub in ("configs", "traffic", "workloads"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    config = _load(DATA / "configs" / f"{entry['config']}.json")
    config.update(scale=scale, num_registers=registers)
    traffic = _load(DATA / "traffic" / f"{entry['traffic']}.json")
    traffic.update(k=k)
    (data / "configs" / "tiny.json").write_text(json.dumps(config))
    (data / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (data / "workloads" / f"{NAME}.json").write_text(
        (DATA / "workloads" / f"{cell}.json").read_text())
    bench["workloads"].append(dict(entry, name=NAME, config="tiny", traffic="tiny"))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if cell in metric.get("workloads", ()):
            metric["workloads"].append(NAME)
    return bench, data


def run_tiny(bench, data, *, trace: int = 0, seconds: float = 0.01,
             seed: int = 2 ** 31 + 11, device="cpu"):
    """``(exit code, standard output's lines)`` of one run. The test process
    may hold jax from other tests, so the run's check for it looks only at
    the modules the run itself loads."""
    before = set(sys.modules)
    real = bench_run.forbidden_modules
    out = io.StringIO()
    with mock.patch.object(bench_run, "forbidden_modules",
                           lambda: [m for m in real() if m not in before]), \
            contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", NAME, "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", str(trace)],
                            bench=bench, data_dir=data, device=device,
                            t_start=time.perf_counter())
    return rc, out.getvalue().splitlines()


def result(lines) -> dict:
    return json.loads(lines[-1])
