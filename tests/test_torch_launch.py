"""The port's launcher surfaces beside the reference's, on the CPU: ``im
--trace/--metrics`` (the reference launcher's span names and lanes, the
coverage line, the measured shard profile's gauge), the supervisor
(``launch/ft.py``: restart until success, give up, the ``-- <cmd>`` form),
the elastic snapshot round trip on the port's store and planner, and the
workload presets."""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TRACE_LINE = re.compile(r"^trace: (\d+) spans -> (\S+) \(lanes: ([a-z, ]+); "
                        r"span coverage ([\d.]+)% of ([\d.]+)s wall\)$", re.M)
IM_ARGS = ["--graph", "rmat:8", "--setting", "0.1", "--k", "4", "--registers", "64"]


def _spans(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e["ph"] == "X"]


def _gauge(path, name, **tags):
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        if rec["name"] == name and rec.get("tags", {}) == tags:
            return rec["value"]
    raise KeyError(name)


@pytest.mark.parametrize("backend", ["single", "serial"])
def test_im_trace_and_metrics_match_the_reference_launcher(backend, tmp_path, capsys):
    from repro.launch import im as R_im
    from repro.obs import shardprof as R_shardprof
    from repro_torch.launch import im as T_im
    from repro_torch.obs import shardprof as T_shardprof

    extra = ["--backend", backend] + (["--partition", "degree"] if backend == "serial" else [])
    saved = T_shardprof.enabled(), R_shardprof.enabled()
    T_shardprof.set_enabled(True)
    R_shardprof.set_enabled(True)
    try:
        out = {}
        for name, mod, dev in (("port", T_im, ["--device", "cpu"]), ("ref", R_im, [])):
            t, m = tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl"
            out[name] = mod.run(IM_ARGS + extra + dev + ["--trace", str(t), "--metrics",
                                                         str(m)])
            printed = capsys.readouterr().out
            found = TRACE_LINE.search(printed)
            assert found, printed
            out[name + "_line"] = found
            assert "metrics: " in printed
    finally:
        T_shardprof.set_enabled(saved[0])
        R_shardprof.set_enabled(saved[1])
    assert out["port"]["seeds"] == out["ref"]["seeds"]
    # the JSON carries every phase timing, the single path's prep split too
    prep = ({"prep_s", "sort_s", "lower_s", "upload_s", "worklists_s"} if backend == "single"
            else {"sort_s", "sample_s", "plan_s", "buckets_s", "state_s"})
    assert prep | {"build_s", "rounds_s", "visited_s"} <= set(out["port"])
    assert all(out["port"][key] >= 0 for key in prep)
    port, ref = _spans(tmp_path / "port.json"), _spans(tmp_path / "ref.json")
    port_names, ref_names = {e["name"] for e in port}, {e["name"] for e in ref}
    assert ref_names <= port_names, ref_names - port_names
    lanes = set(out["port_line"].group(3).split(", "))
    assert set(out["ref_line"].group(3).split(", ")) <= lanes
    assert lanes == {e["cat"] for e in port}
    assert int(out["port_line"].group(1)) == len(port)
    assert 0.0 < float(out["port_line"].group(4)) <= 100.0
    assert {e["name"] for e in port if e["args"]["depth"] == 0} >= {"launch.make_graph"}
    rounds = [e for e in port if e["name"] == f"{backend}.round"]
    assert [e["args"]["seed"] for e in rounds] == out["port"]["seeds"]
    if backend == "serial":
        tags = dict(backend="serial", strategy="degree")
        name = "partition.predicted_vs_measured_edge_imb"
        assert _gauge(tmp_path / "port.jsonl", name, **tags) == pytest.approx(
            _gauge(tmp_path / "ref.jsonl", name, **tags), rel=1e-12)
        build = next(e for e in port if e["name"] == "serial.build_fixpoint")
    else:
        build = next(e for e in port if e["name"] == "single.build_matrix")
    # the build's bandwidth attribution (rounded to 1 MB/s, so only its presence)
    assert build["args"]["iters"] > 0
    assert build["args"]["achieved_gbps"] >= 0 and "frac_of_roof" in build["args"]


def test_ft_supervisor_restarts_until_success(tmp_path):
    """A command that fails twice, then succeeds, is relaunched until it does."""
    from repro_torch.launch.ft import supervise

    marker = tmp_path / "attempts"
    script = (
        "import sys, pathlib\n"
        f"p = pathlib.Path({str(marker)!r})\n"
        "n = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(n + 1))\n"
        "sys.exit(0 if n >= 2 else 1)\n"
    )
    assert supervise([sys.executable, "-c", script], max_restarts=5) == 0
    assert marker.read_text() == "3"


def test_ft_supervisor_gives_up():
    from repro_torch.launch.ft import supervise

    assert supervise([sys.executable, "-c", "import sys; sys.exit(3)"], max_restarts=1) == 3


def test_ft_module_runs_the_command_after_the_separator():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.launch.ft", "--max-restarts", "0",
                         "--", sys.executable, "-c", "print('supervised')"],
                        capture_output=True, text=True, env=env, timeout=120)
    assert ok.returncode == 0 and ok.stdout.strip() == "supervised"
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.ft", "--max-restarts", "0",
                          "--", sys.executable, "-c", "import sys; sys.exit(4)"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 4 and "giving up" in bad.stderr


def test_elastic_snapshot_roundtrip(tmp_path):
    """A relaunch restores the saved index, plan included, instead of the
    cold build; the reference's store reads the port's snapshot too."""
    from repro.service import SketchStore as RStore
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.graphs import rmat_graph
    from repro_torch.partition import plan_partition
    from repro_torch.service import SketchStore

    g = rmat_graph(7, edge_factor=6, seed=2, setting="w1")
    store = SketchStore(device="cpu")
    e = store.get_or_build(g, DiFuserConfig(num_registers=64, seed=2))
    store.attach_plan(e.key, plan_partition(e.graph, 4, mu_s=1, x=e.x, device="cpu"))
    path = str(tmp_path / "index")
    store.save(path, e.key)
    restored = SketchStore(device="cpu").load(path)
    np.testing.assert_array_equal(restored.matrix.numpy(), e.matrix.numpy())
    assert restored.plan is not None and restored.plan.mu_v == 4
    np.testing.assert_array_equal(restored.plan.perm, e.plan.perm)
    assert restored.residency == "host"
    ref = RStore().load(path)
    np.testing.assert_array_equal(np.asarray(ref.matrix), e.matrix.numpy())
    assert ref.plan.mu_v == 4


def test_presets_equal_the_reference_field_for_field():
    from repro.configs import PRESETS as R_PRESETS
    from repro_torch.configs import PRESETS, IMWorkload

    assert list(PRESETS) == list(R_PRESETS)
    for name, w in PRESETS.items():
        assert isinstance(w, IMWorkload) and w.name == name
        assert dataclasses.asdict(w) == dataclasses.asdict(R_PRESETS[name])
    assert [f.name for f in dataclasses.fields(IMWorkload)] == [
        f.name for f in dataclasses.fields(type(R_PRESETS["zoo-wc"]))]
