"""A cell on several cards runs as a world of one rank a card
(``harness/world.py``). On the CPU, a world of 4 gloo ranks at a tiny size,
started by ``run.py``'s ``main`` as the benchmark's command starts it (the
look for a card skipped): one result line, from rank 0, with the same jobs
on every rank, also where one rank is slow; a rank that fails, or that
loads a module the benchmark forbids, is named and fails the run; a
one-card cell still runs in one process.

What a test plants in the ranks (``_world_hooks``) reaches them through a
``sitecustomize`` module on the ``PYTHONPATH`` that the launcher hands on
to each rank, so the benchmark's entry point takes no test-only
argument."""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import pytest

from imbench import run as bench_run
from imbench.harness import world
from imbench.tests import _world_hooks
from imbench.tests._tiny import ROOT, result, run_tiny, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MESH = "g500-s20-ic01.k50-mesh4"
JOBS = re.compile(r"world of 4 ranks: jobs \[(\d+), (\d+), (\d+), (\d+)\]")


def _site(tmp_path, hook) -> dict:
    """The environment in which each rank, as it starts, calls
    ``_world_hooks.<hook>`` with its rank (nothing for ``hook`` None)."""
    if hook is None:
        return {}
    folder = tmp_path / "site"
    folder.mkdir()
    (folder / "sitecustomize.py").write_text(
        "import os, sys\n"
        f"if os.environ.get({world.WORLD_ENV!r}):\n"
        f"    sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "    from imbench.tests import _world_hooks\n"
        f"    _world_hooks.{hook}(int(os.environ['RANK']))\n")
    return {"PYTHONPATH": os.pathsep.join(
        [str(folder)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}


def world_run(tmp_path, *, trace=0, seconds=0.01, hook=None, seed=2 ** 31 + 17):
    """``(exit code, standard output's lines, standard error)`` of one run of
    the mesh cell at CPU size, on 4 ranks, each having called
    ``_world_hooks.<hook>`` with its rank as it started."""
    bench, data = tiny_cell(tmp_path, MESH, scale=7, registers=16, k=3)
    before = set(sys.modules)
    real = bench_run.forbidden_modules
    out, err = io.StringIO(), io.StringIO()
    with mock.patch.object(bench_run, "forbidden_modules",
                           lambda: [m for m in real() if m not in before]), \
            mock.patch.dict(os.environ, _site(tmp_path, hook)), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", "tiny.cell", "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", str(trace)], bench=bench,
                            data_dir=data, device="cpu", t_start=time.perf_counter())
    return rc, out.getvalue().splitlines(), err.getvalue()


def _jobs(err: str):
    return [int(n) for n in JOBS.search(err).groups()]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("hook", [None, "slow"])
def test_a_world_prints_one_result_with_its_ranks_in_step(tmp_path, trace, hook):
    rc, lines, err = world_run(tmp_path, trace=trace, seconds=1.0, hook=hook)
    assert rc == 0, err
    assert len(lines) == 1
    out = result(lines)
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["count"] == 4
    jobs = _jobs(err)
    assert jobs == [out["attempted"]] * 4 and out["attempted"] >= 1
    # the check's lines come last on standard error, as in a one-card run
    assert err.rstrip().splitlines()[-1].startswith("check gain_gap")
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert {"prep_s", "partition_s", "sort_s", "build_s", "rounds_s"} <= set(
            out["metrics"])
    else:
        assert set(out["metrics"]) == {"seedset_s", "setup_s"}


@pytest.mark.parametrize("hook,how", [("raises", "exit code 1"),
                                      ("killed", "killed by signal SIGKILL")])
def test_a_failing_rank_fails_the_run_and_is_named(tmp_path, hook, how):
    rc, lines, err = world_run(tmp_path, hook=hook)
    assert rc != 0 and lines == []
    named = re.findall(r"imbench: rank (\d) of 4 failed, ([^;]*);", err)
    assert any(rank == str(_world_hooks.ODD_RANK) and said.startswith(how)
               for rank, said in named), err
    if hook == "raises":
        assert "a fault planted in the window's first job" in err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_rank_that_loads_a_forbidden_module_fails_the_run(tmp_path, trace):
    rc, lines, err = world_run(tmp_path, trace=trace, hook="loads_forbidden")
    rank = _world_hooks.ODD_RANK
    assert rc == 3 and lines == [], err
    assert f"imbench: rank {rank} of 4 failed, exit code 3;" in err
    assert f"imbench: loaded in rank {rank}: ['{_world_hooks.FORBIDDEN}']" in err


def test_a_one_card_cell_runs_in_one_process(tmp_path, monkeypatch):
    import torch.distributed as dist

    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell started a process or a process group")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(world, "launch", refuse)
    bench, data = tiny_cell(tmp_path, "g500-s20-ic01.k50-grid2x2", scale=7, registers=16,
                            k=3)
    rc, lines = run_tiny(bench, data)
    assert rc == 0 and result(lines)["correct"] is True
    assert result(lines)["device"]["count"] == 1
    assert not dist.is_initialized()


def test_a_world_without_cards_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "imbench/run.py", "--workload", MESH, "--seed",
                           "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_four_card_cells_are_few_and_fill_their_grid():
    cells = BENCH["workloads"]
    wide = [w for w in cells if w["chips"] > 1]
    assert all(w["chips"] == 4 for w in wide)
    assert len(wide) <= max(1, len(cells) // 4)
    for w in wide:
        spec = json.loads((ROOT / "imbench/traffic" / f"{w['traffic']}.json").read_text())
        assert spec["spec"]["backend"] == "mesh"
        assert spec["spec"]["mu_v"] * spec["spec"]["mu_s"] == w["chips"]


def test_the_mesh_cell_is_the_grid_cell_on_the_mesh():
    def read(sub, name):
        return json.loads((ROOT / "imbench" / sub / f"{name}.json").read_text())
    grid, mesh = read("traffic", "k50-grid2x2"), read("traffic", "k50-mesh4")
    assert dict(grid["spec"], backend="mesh") == mesh["spec"]
    assert {k: v for k, v in grid.items() if k != "spec"} == {
        k: v for k, v in mesh.items() if k != "spec"}
    assert read("workloads", MESH) == read("workloads", "g500-s20-ic01.k50-grid2x2")
