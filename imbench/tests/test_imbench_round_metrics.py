"""The readers of the rounds' cascade and rebuild spans: each is the mean of
its stats key over a window's jobs and says nothing where a job lacks the
key; a traced run on the CPU reports both in the cells their entries name
and leaves them out of the others and of every untraced run."""
import importlib
import json
import types

import pytest

from imbench.tests._tiny import ROOT, result, run_tiny, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["cascade_s", "rebuild_s"]


def _entry(name):
    return next(m for m in BENCH["per_layer"] if m["name"] == name)


@pytest.mark.parametrize("name", KEYS)
def test_a_round_span_reader_is_the_mean_of_its_key(name):
    read = importlib.import_module(f"imbench.metrics.{name}").read
    win = types.SimpleNamespace(stats=[{name: 0.5, "rounds_s": 9.0}, {name: 2.0}])
    assert read(win) == pytest.approx(1.25)
    # a program without the span (the parent of these readers, the mesh) reads nothing
    assert read(types.SimpleNamespace(stats=[{name: 1.0}, {"rounds_s": 2.0}])) is None
    assert read(types.SimpleNamespace(stats=[])) is None
    entry = _entry(name)
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "s", "lower", "program_span", "seedset_s")
    assert entry["workloads"] and set(entry["workloads"]) <= set(CELLS)
    assert "g500-s20-ic01.k50-mesh4" not in entry["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_rounds_of_its_cell(tmp_path, cell):
    bench, data = tiny_cell(tmp_path, cell, scale=8, registers=32, k=4)
    rc, lines = run_tiny(bench, data, trace=1)
    assert rc == 0
    out = result(lines)
    assert out["correct"] is True
    m = out["metrics"]
    named = {n for n in KEYS if cell in _entry(n)["workloads"]}
    assert named <= set(m) and not (set(KEYS) - named) & set(m)
    if named:
        assert all(m[n]["value"] >= 0 and m[n]["unit"] == "s" for n in named)
        assert m["cascade_s"]["value"] + m["rebuild_s"]["value"] \
            + m["visited_s"]["value"] <= m["rounds_s"]["value"]


def test_an_untraced_run_leaves_the_rounds_out(tmp_path):
    bench, data = tiny_cell(tmp_path, "g500-s20-ic01.k50", scale=8, registers=32, k=4)
    rc, lines = run_tiny(bench, data, trace=0)
    out = result(lines)
    assert rc == 0 and out["correct"] is True
    assert not set(KEYS) & set(out["metrics"])
