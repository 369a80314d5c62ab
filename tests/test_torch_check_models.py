"""The port's model-zoo smoke (``scripts_torch/check_models.py``) against the
reference's (``scripts/check_models.py``), on the CPU, at its own size (ER
n = 1,024, J = 64, K = 2).

Both run in subprocesses, started together: the reference under
``JAX_PLATFORMS=cpu``, the port with ``--device cpu``. Each exits 0 and
prints one ``check_models.<spec>: ok (build N sweeps, spread S, ...)`` line
per registered model; the port's lines equal the reference's, so every
model's build sweeps and spread agree. (That the port's script raises
without a CUDA device is held in ``test_torch_examples.py``.)
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 180


def _start(script: str, *args, **extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, script, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def outputs():
    procs = (_start("scripts/check_models.py", JAX_PLATFORMS="cpu"),
             _start("scripts_torch/check_models.py", "--device", "cpu"))
    try:
        outs = [proc.communicate(timeout=TIMEOUT_S) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, stderr) in zip(procs, outs):
        assert proc.returncode == 0, stderr[-3000:]
    return [stdout.splitlines() for stdout, _ in outs]


@pytest.mark.parametrize("spec", ["wc", "ic:0.1", "lt", "dic:1.0"])
def test_port_model_line_equals_the_reference(outputs, spec):
    ref, port = outputs
    want = [ln for ln in ref if ln.startswith(f"check_models.{spec}: ")]
    assert len(want) == 1 and want[0].startswith(f"check_models.{spec}: ok "), ref
    assert [ln for ln in port if ln.startswith(f"check_models.{spec}: ")] == want, port


def test_port_prints_the_reference_lines_in_order(outputs):
    ref, port = outputs
    assert port == ref
