"""The harness on the CPU: ``BENCHMARK.json`` and the files it names hold
together, a run prints the result line its readers expect, and without a card a
run prints nothing and fails."""
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from imbench import run as bench_run
from imbench.harness import check, profile
from imbench.tests._tiny import ROOT, result, run_tiny, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["imbench"] and BENCH["command"][1] == "imbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert [m["name"] for m in BENCH["end_to_end"]] == ["seedset_s", "peak_mem_gib",
                                                        "setup_s"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"] == f"imbench/configs/{entry['name']}.json"
    config = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) == set(config["reduced_from"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_every_cell_names_its_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and LINE.match(entry["why"])
    assert entry["chips"] == 1
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((ROOT / "imbench/traffic" / f"{entry['traffic']}.json").read_text())
    assert hasattr(importlib.import_module(f"imbench.traffic.{traffic['kind']}"), "plan")
    limits = json.loads((ROOT / "imbench/workloads" / f"{entry['name']}.json").read_text())
    assert set(limits["check"]["limits"]) <= set(check.NUMBERS)
    assert set(limits["check"]["sweeps"]) <= set(check.SWEEPS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert hasattr(importlib.import_module(f"imbench.metrics.{metric['name']}"), "read")
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert LINE.match(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in CELLS and _reported(moved, cell)
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if _reported(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reported(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_result_line(tmp_path, cell, trace):
    bench, data = tiny_cell(tmp_path, cell, scale=8, registers=32, k=4)
    rc, lines = run_tiny(bench, data, trace=trace)
    assert rc == 0
    out = result(lines)
    assert set(out) == KEYS | {"check"} | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        wanted = {m["name"] for m in bench["per_layer"] if "tiny.cell" in m["workloads"]}
        # the CPU has no device trace: the readers of the device's metrics say nothing
        assert {"prep_s", "build_s", "rounds_s"} <= set(out["metrics"]) <= wanted
    else:
        assert set(out["metrics"]) == {"seedset_s", "setup_s"}
    for name, v in out["check"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_the_command_fails_here_without_a_card():
    # no card is visible to the run, whether or not the machine has one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "imbench/run.py", "--workload", CELLS[1],
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_a_loaded_jax_refuses_the_result(tmp_path, monkeypatch):
    """The program loading jax during the window voids the run."""
    from repro_torch import runtime

    bench, data = tiny_cell(tmp_path, CELLS[0], scale=7, registers=16, k=2)
    real = runtime.run

    def loads_jax(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax.imbench_probe", types.ModuleType("probe"))
        return real(*args, **kwargs)
    monkeypatch.setattr(runtime, "run", loads_jax)
    rc, lines = run_tiny(bench, data)
    assert rc == 3 and lines == []


def test_busy_is_the_union_of_device_intervals():
    spans = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 60]])
    merged = profile._union(spans)
    assert merged.tolist() == [[0, 20], [30, 40], [50, 60]]
    assert profile._busy(merged, 15, 55) == 5 + 10 + 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark's cells run on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_cell_on_the_card(tmp_path, card, cell):
    bench, data = tiny_cell(tmp_path, cell, scale=12, registers=256, k=8)
    rc, lines = run_tiny(bench, data, trace=1, seconds=1.0, device=card)
    out = result(lines)
    assert rc == 0 and out["correct"] is True and out["device"]["busy_s"] > 0


def test_mismatches_count_every_exact_output():
    base = check.Outputs(seeds=np.array([1, 2, 3]), gains=np.ones(3, np.float32),
                         scores=np.ones(3, np.float32),
                         rebuilds=np.array([True, False, False]), build_sweeps=5,
                         cascade_sweeps=9, rebuild_sweeps=4)
    other = dataclasses.replace(base, seeds=np.array([1, 3, 2]),
                                rebuilds=np.array([True, True, False]), build_sweeps=6,
                                rebuild_sweeps=2, scores=np.array([1, 1, 1.5], np.float32))
    spec = {"sweeps": ["build", "cascade", "rebuild"],
            "limits": {"mismatches": 0, "score_gap": 0, "gain_gap": 0}}
    assert check.readings(other, base, spec) == {"mismatches": 2 + 1 + 1 + 2,
                                                  "score_gap": 0.5, "gain_gap": 0.0}
    assert check.readings(other, base, dict(spec, sweeps=["cascade"]))["mismatches"] == 3
    nan = dataclasses.replace(base, gains=np.array([1, np.nan, 1], np.float32))
    worst = check.worst([check.readings(base, base, spec), check.readings(nan, base, spec)])
    assert not check.judge(worst, spec["limits"])["gain_gap"]["ok"]
