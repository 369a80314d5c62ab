"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.

Each pair runs in subprocesses, the reference under ``JAX_PLATFORMS=cpu``
and the port with ``--device cpu``, all six started at once. Their result
lines must be equal: seeds, spreads, rebuilds, sweeps, banks, lane fill,
the FASST shard percentages, the oracle and RIS scores and the quality
ratio. Lines of qps, p50/p99 or "amortized" are dropped, and every
``<number>s`` is masked, since wall time differs.

``quickstart`` runs at its own size. ``influence_service`` and
``distributed_im`` run both packages on the same smaller graph: a runner
caps ``rmat_graph``'s scale at ``SCALE_CAP`` in both, because the port's
plain lt path is slow on the CPU (it recomputes the remix hash for every
edge and register on every sweep), and because the test suite runs beside
these processes. The result lines are ``chip_smoke.result_lines``, the rule
by which the card's run compares each script's kernel path with its plain
path. The port's ``distributed_im`` starts its
8 ranks under ``torch.distributed.run`` with the runner in front of it, the
reference's takes 8 fake XLA devices. Also: each port script (the three
examples and ``scripts_torch/check_models.py``) raises without a CUDA device
unless given ``--device cpu``.
"""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import result_lines  # noqa: E402
SCALE_CAP = 8
TIMEOUT_S = 240
#: name -> scale cap (None: the script's own size)
EXAMPLES = {"quickstart": None, "influence_service": SCALE_CAP,
            "distributed_im": SCALE_CAP}
PORT_SCRIPTS = ("examples_torch/quickstart.py", "examples_torch/influence_service.py",
                "examples_torch/distributed_im.py", "scripts_torch/check_models.py")

# argv: package, script, script arguments. Caps rmat_graph's scale in the
# package's ``graphs``, where the scripts import it from, then runs the script.
RUNNER = """
import importlib, runpy, sys
pkg, script, cap = sys.argv[1], sys.argv[2], int(sys.argv[3])
graphs = importlib.import_module(pkg + ".graphs")
rmat = graphs.rmat_graph
graphs.rmat_graph = lambda scale, *a, **kw: rmat(min(scale, cap), *a, **kw)
sys.argv = [script] + sys.argv[4:]
runpy.run_path(script, run_name="__main__")
"""


def _command(pkg: str, script: str, cap, args=()) -> list:
    if cap is None:
        return [sys.executable, script, *args]
    return [sys.executable, "-c", RUNNER, pkg, script, str(cap), *args]


def _start(cmd: list, **extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def procs():
    """Every pair's two processes, started together."""
    started = {}
    for name, cap in EXAMPLES.items():
        ref_env = dict(JAX_PLATFORMS="cpu")
        if name == "distributed_im":   # its mesh, without its own re-exec
            ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        started[name] = (
            _start(_command("repro", f"examples/{name}.py", cap), **ref_env),
            _start(_command("repro_torch", f"examples_torch/{name}.py", cap,
                            ["--device", "cpu"])))
    yield started
    for pair in started.values():
        for proc in pair:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _stdout(proc: subprocess.Popen) -> str:
    stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_port_example_prints_the_reference_results(procs, name):
    ref_proc, port_proc = procs[name]
    ref, port = _stdout(ref_proc), _stdout(port_proc)
    want = result_lines(ref)
    assert len(want) >= 5, ref
    assert result_lines(port) == want, (port, ref)


def test_distributed_im_runs_a_world_of_8_on_the_mesh(procs):
    """``auto`` resolved to the mesh on 8 ranks, rank 0 alone printed, and
    the script's own check (mesh seeds == single-device seeds) held."""
    stdout = _stdout(procs["distributed_im"][1])
    lines = stdout.splitlines()
    assert sum(ln.startswith("graph: ") for ln in lines) == 1, stdout
    assert any(ln.startswith("sharded (2x4 mesh, ring): ") for ln in lines), stdout
    assert "distributed == single-device: bitwise identical seeds" in lines


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_port_script_raises_without_a_card(no_cuda, monkeypatch, script):
    """The default ``--device cuda`` raises as the entry points do, before
    any work (``distributed_im`` before it starts a rank)."""
    monkeypatch.setattr(sys, "argv", [script])
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(str(ROOT / script), run_name="__main__")
