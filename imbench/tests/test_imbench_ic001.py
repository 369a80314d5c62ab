"""The cell ``g500-s20-ic001.k50`` (the paper's IC setting w = 0.01 on the
single path) at CPU size: its tiny copy is ``correct``, and the control and
the faults of ``test_imbench_faults`` make it read ``correct`` false.

At SCALE 10 and J = 64 the live graph at w = 0.01 is thin enough that each
round's cascade runs several times the sweeps of the same graph at w = 0.1,
so the tiny copy works the fixpoints. That holds only at small sizes: on
Graph500 SCALE 20 the hubs carry the live graph, and its cascades are
shallower than at w = 0.1."""
import json
import types

import pytest

from imbench.harness.graph import make_edges
from imbench.metrics import cascade_s, rebuild_s
from imbench.reference import alg4
from imbench.tests._tiny import DATA, ROOT, result, run_tiny, tiny_cell
from imbench.tests.test_imbench_faults import _patch

CELL = "g500-s20-ic001.k50"
K50 = "g500-s20-ic01.k50"
SCALE, REGISTERS, K = 10, 64, 6


def _config(cell: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    return json.loads((DATA / "configs" / f"{entry['config']}.json").read_text())


def test_the_cell_is_the_k50_cell_at_w_001():
    ic001, k50 = _config(CELL), _config(K50)
    assert ic001["weight"] == 0.01 and k50["weight"] == 0.1
    differ = {key for key in ic001 if ic001[key] != k50.get(key)}
    assert differ <= {"weight", "source", "why_reduced", "assumed"}
    assert (DATA / "workloads" / f"{CELL}.json").read_text() \
        == (DATA / "workloads" / f"{K50}.json").read_text()


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_the_tiny_copy_cascades_deeper_than_k50s(seed):
    per_round = {}
    for cell in (CELL, K50):
        config = dict(_config(cell), scale=SCALE)
        n, src, dst, weight = make_edges(config, seed, "cpu")
        ans = alg4.find_seeds(n, src, dst, weight, model=config["model"],
                              num_registers=REGISTERS, k=K, seed=seed)
        per_round[cell] = ans.cascade_sweeps / K
    assert per_round[CELL] > 1.5 * per_round[K50]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_copy_is_correct(tmp_path, trace):
    bench, data = tiny_cell(tmp_path, CELL, scale=SCALE, registers=REGISTERS, k=K)
    rc, lines = run_tiny(bench, data, trace=trace)
    out = result(lines)
    assert rc == 0 and out["correct"] is True and out["failed"] == 0
    assert all(v["value"] == 0 for v in out["check"].values())
    if trace:
        m = out["metrics"]
        assert {"cascade_s", "rebuild_s", "visited_s", "rounds_s"} <= set(m)
        assert m["cascade_s"]["value"] + m["rebuild_s"]["value"] \
            + m["visited_s"]["value"] <= m["rounds_s"]["value"]


@pytest.mark.parametrize("fault", ["control", "unchanged_propagate", "unchanged_cascade",
                                   "altered_seed"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3, 77])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault, seed):
    bench, data = tiny_cell(tmp_path, CELL, scale=SCALE, registers=REGISTERS, k=K)
    _patch(monkeypatch, fault)
    rc, lines = run_tiny(bench, data, seed=seed)
    out = result(lines)
    assert rc == 0 and out["correct"] is False and out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["check"].values())


@pytest.mark.parametrize("reader,key", [(cascade_s, "cascade_s"), (rebuild_s, "rebuild_s")])
def test_the_round_readers_average_a_deep_window(reader, key):
    win = types.SimpleNamespace(stats=[{key: 0.25, "cascade_sweeps": 40},
                                       {key: 0.75, "cascade_sweeps": 44}])
    assert reader.read(win) == pytest.approx(0.5)
    assert reader.read(types.SimpleNamespace(stats=[{"cascade_sweeps": 40}])) is None
