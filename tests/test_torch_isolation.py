"""The port stands alone: importing it loads neither jax nor the reference
package, no source of it (its examples and scripts too) imports either, and
no entry point falls back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, check=True, timeout=120).stdout.split(maxsplit=1)
    assert int(out[0]) > 15, "the walk imported too few modules"
    assert out[1].strip() == "[]", out[1]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples_torch").glob("*.py"))
                         + sorted((ROOT / "scripts_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    found = IMPORT_RE.findall(path.read_text())
    assert not found, f"{path} imports {found}"


def test_walk_covers_the_host_modules():
    """The source scan above covers the presets, the utilities, the shard
    profiles, the supervisor, the mesh backend's modules and the dry run's."""
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"configs/__init__.py", "configs/difuser_workloads.py", "utils/__init__.py",
            "utils/roofline.py", "obs/shardprof.py", "launch/ft.py", "launch/mesh.py",
            "core/distributed.py", "runtime/mesh.py", "launch/dryrun.py",
            "utils/collectives.py", "utils/opprof.py", "kernels/cost.py"} <= files


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _graph():
    from repro_torch.graphs import rmat_graph

    return rmat_graph(6, edge_factor=4, seed=1)


@pytest.mark.parametrize("entry", ["find_seeds", "build_sketch_matrix",
                                   "find_seeds_warm", "run", "launcher", "run_serial",
                                   "find_seeds_ring_serial", "build_matrix_ring_serial",
                                   "sample_edge_sets", "launcher_serial",
                                   "store_get_or_build", "engine", "session_find_seeds",
                                   "session_apply_delta", "launcher_validate",
                                   "serve_launcher", "async_engine", "engine_own_store",
                                   "serve_launcher_async", "serial_fixpoint_hook",
                                   "launcher_trace"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    from repro_torch import partition
    from repro_torch.core import difuser
    from repro_torch.graphs import GraphDelta
    from repro_torch.launch import im, serve_im
    from repro_torch.runtime import InfluenceSession, RunSpec, get_backend, run
    from repro_torch.service import AsyncInfluenceEngine, InfluenceEngine, SketchStore

    g = _graph()
    cfg = difuser.DiFuserConfig(num_registers=32)
    calls = {
        "find_seeds": lambda: difuser.find_seeds(g, 2, cfg),
        "build_sketch_matrix": lambda: difuser.build_sketch_matrix(g, cfg),
        "find_seeds_warm": lambda: difuser.find_seeds_warm(
            g, 2, cfg, matrix=np.zeros((g.n_pad, 32), np.int8),
            x=np.arange(32, dtype=np.uint32)),
        "run": lambda: run(g, 2, RunSpec(num_registers=32)),
        "launcher": lambda: im.run(["--graph", "rmat:6", "--k", "2", "--registers", "32"]),
        "run_serial": lambda: run(g, 2, RunSpec(num_registers=32, mu_v=2, mu_s=2)),
        "find_seeds_ring_serial": lambda: partition.find_seeds_ring_serial(g, 2, cfg),
        "build_matrix_ring_serial": lambda: partition.build_matrix_ring_serial(g, cfg),
        "sample_edge_sets": lambda: partition.sample_edge_sets(
            g, np.arange(32, dtype=np.uint32), 2),
        "launcher_serial": lambda: im.run(["--graph", "rmat:6", "--k", "2", "--registers",
                                           "32", "--backend", "serial"]),
        "store_get_or_build": lambda: SketchStore().get_or_build(g, cfg),
        "engine": lambda: InfluenceEngine(SketchStore()).register(g, cfg),
        "session_find_seeds": lambda: InfluenceSession(g, RunSpec(num_registers=32)
                                                       ).find_seeds(2),
        "session_apply_delta": lambda: InfluenceSession(g, RunSpec(num_registers=32)
                                                        ).apply_delta(GraphDelta.make(
                                                            add=([1], [2]))),
        "launcher_validate": lambda: im.run(["--graph", "rmat:6", "--k", "2", "--registers",
                                             "32", "--validate", "--ris"]),
        "serve_launcher": lambda: serve_im.run(["--graph", "rmat:6", "--registers", "32",
                                                "--queries", "4"]),
        "async_engine": lambda: AsyncInfluenceEngine(),
        "engine_own_store": lambda: InfluenceEngine(),
        "serve_launcher_async": lambda: serve_im.run(["--graph", "rmat:6", "--registers",
                                                      "32", "--queries", "4", "--async"]),
        "serial_fixpoint_hook": lambda: get_backend("serial").fixpoint(
            np.zeros((g.n_pad, 32), np.int8), g.sorted_by_dst(),
            RunSpec(num_registers=32, mu_v=2), np.arange(32, dtype=np.uint32)),
        "launcher_trace": lambda: im.run(["--graph", "rmat:6", "--k", "2", "--registers",
                                          "32", "--trace", os.devnull]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import (bucket_propagate, fused_sample, fused_sweep,
                                     sketch_cardinality, sketch_fill)
    from repro_torch.kernels.edges import group_rows

    m = torch.zeros((8, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sketch_fill.sketch_fill_cuda(m)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sketch_cardinality.cardinality_stats_cuda(m)
    e = torch.zeros(4, dtype=torch.int32)
    rows = group_rows(e, e, e, e, e, 8)
    x = torch.zeros(32, dtype=torch.int32)
    for call in (lambda: bucket_propagate.bucket_propagate_cuda(m, m.clone(), rows, x,
                                                                variant=0),
                 lambda: bucket_propagate.bucket_cascade_cuda(m, m.clone(), rows, x,
                                                              variant=0),
                 lambda: fused_sweep.fused_sweep_cuda(m, rows, x, variant=0, num_sweeps=2),
                 lambda: fused_sample.fused_sample_cuda(e, e, e, x, variant=0)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def test_dispatch_rejects_other_devices():
    """CUDA, the CPU and ``meta`` (the dry run's shape functions,
    ``tests/test_torch_dryrun.py``) are dispatched; any other device raises
    before anything reads the tensor."""
    from repro_torch.kernels import ops

    with pytest.raises(ValueError, match="unsupported device"):
        ops.sketch_fill(type("OnXpu", (), {"device": torch.device("xpu")})())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_wrappers_check_operands():
    from repro_torch.kernels import ops

    with pytest.raises(TypeError, match="int8"):
        ops.sketch_fill(torch.zeros((8, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.cardinality_stats(torch.zeros((32, 8), dtype=torch.int8).t())
