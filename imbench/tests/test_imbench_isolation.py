"""The benchmark measures the port alone: no file under ``imbench/``
imports jax or the JAX package ``repro`` (top-level names compared whole:
``repro_torch`` is not ``repro``), the reference imports nothing of the
program, and no file reads the JAX package's harness ``benchmarks/``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every import, ``importlib.import_module`` and
    ``__import__`` with a constant argument in ``path``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                  "import_module", "__import__")):
            names.append(node.args[0].value.split(".")[0])
    return names


def _strings(path: Path):
    return [node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)]


def _rel(p: Path) -> str:
    return str(p.relative_to(HERE.parent))


@pytest.mark.parametrize("path", FILES, ids=_rel)
def test_imports_neither_jax_nor_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN, _imports(path)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=_rel)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "dataclasses", "typing", "numpy", "torch"}


# this file names the JAX harness's folder only to look for it
@pytest.mark.parametrize("path", [p for p in FILES if p != Path(__file__).resolve()],
                         ids=_rel)
def test_reads_nothing_of_the_jax_harness(path):
    assert "benchmarks" not in _imports(path)
    assert not [s for s in _strings(path) if "benchmarks/" in s or s == "benchmarks"]


def test_the_scan_sees_whole_names(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import repro_torch.runtime\nfrom repro_torch import x\nimport jaxtyping\n"
                    "import importlib\nimportlib.import_module('repro.core')\n")
    assert _imports(path) == ["repro_torch", "repro_torch", "jaxtyping", "importlib", "repro"]
