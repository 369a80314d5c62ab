"""Execution API of the port: ``RunSpec`` and ``run``.

    from repro_torch.runtime import RunSpec, run
    report = run(graph, 10, RunSpec(num_registers=512, model="ic"))

``run`` executes the single-device driver (the one backend the port has so
far) on CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime import single
from repro_torch.runtime.single import RunReport
from repro_torch.runtime.spec import RunSpec


def run(g, k: int, spec: Optional[RunSpec] = None, *, x=None, device=None) -> RunReport:
    """Run Alg. 4 on one device."""
    spec = spec if spec is not None else RunSpec()
    return single.find_seeds(g, k, spec, x=x, device=device)


__all__ = ["RunReport", "RunSpec", "run"]
