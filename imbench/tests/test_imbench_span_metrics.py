"""The readers of the program's prep and visited-count spans: each is the mean
of its stats key over a window's jobs, says nothing where a job lacks the key,
and a traced run on the CPU reports it in the cells its entry names."""
import importlib
import json
import types

import pytest

from imbench.tests._tiny import ROOT, result, run_tiny, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

#: the readers of one stats key each: the prep's parts and the visited count
SPAN_KEYS = ["sort_s", "lower_s", "upload_s", "worklists_s", "visited_s"]


def _entry(name):
    return next(m for m in BENCH["per_layer"] if m["name"] == name)


@pytest.mark.parametrize("name", SPAN_KEYS)
def test_a_span_reader_is_the_mean_of_its_key(name):
    read = importlib.import_module(f"imbench.metrics.{name}").read
    win = types.SimpleNamespace(stats=[{name: 1.0, "prep_s": 9.0}, {name: 2.5}])
    assert read(win) == pytest.approx(1.75)
    # a job without the key (a program that has no such span) reads nothing
    assert read(types.SimpleNamespace(stats=[{name: 1.0}, {"prep_s": 2.0}])) is None
    assert read(types.SimpleNamespace(stats=[])) is None
    entry = _entry(name)
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "s", "lower", "program_span", "seedset_s")
    assert entry["workloads"] and set(entry["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics_of_its_cell(tmp_path, cell):
    bench, data = tiny_cell(tmp_path, cell, scale=8, registers=32, k=4)
    rc, lines = run_tiny(bench, data, trace=1)
    assert rc == 0
    out = result(lines)
    assert out["correct"] is True
    named = {n for n in SPAN_KEYS if cell in _entry(n)["workloads"]}
    assert named <= set(out["metrics"])
    assert all(out["metrics"][n]["value"] >= 0 and out["metrics"][n]["unit"] == "s"
               for n in named)
    # the readers of a cell's prep parts are left out where its entry does not name it
    assert not (set(SPAN_KEYS) - named) & set(out["metrics"])
