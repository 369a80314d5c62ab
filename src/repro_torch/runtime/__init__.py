"""Execution API of the port: ``RunSpec``, the ``Backend`` registry and
``run``.

    from repro_torch.runtime import RunSpec, run
    report = run(graph, 10, RunSpec(num_registers=512, model="ic"))
    report = run(graph, 10, RunSpec(backend="serial", mu_v=2, mu_s=2,
                                    partition="degree"))

Three backends: ``single`` (the single-device driver), ``serial`` (the 2-D
ring schedule on one device) and ``mesh`` (the same schedule, one process
per shard of a ``torch.distributed`` process mesh, ``launch/mesh.py``).
``backend="auto"`` takes ``single`` for one shard, ``mesh`` for a grid when
a process group of enough ranks is initialized, else ``serial``. All run on
CUDA unless ``device="cpu"`` is passed, and give the same seeds.
``InfluenceSession`` binds a graph to a spec and adds the resident path (the
sketch store, warm seeds, deltas); ``resolve_residency`` says whether its
index is placed on the serving mesh (``RunSpec.residency``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime import mesh as _mesh  # noqa: F401  (registers)
from repro_torch.runtime import serial as _serial  # noqa: F401  (registers)
from repro_torch.runtime import single as _single  # noqa: F401  (registers)
from repro_torch.runtime.base import (Backend, BackendCapabilities, BackendUnavailable,
                                      RunReport, available_backends, get_backend,
                                      register_backend, resolve_backend, resolve_residency)
from repro_torch.runtime.session import InfluenceSession
from repro_torch.runtime.spec import RunSpec


def run(g, k: int, spec: Optional[RunSpec] = None, *, x=None, plan=None,
        device=None, mesh=None) -> RunReport:
    """Resolve the backend for ``spec`` and run Alg. 4 (``plan``: a
    precomputed ``PartitionPlan`` for a sharded backend; ``mesh``: the
    ``launch.mesh.ProcessMesh`` the ``mesh`` backend runs on, made from the
    spec's grid when not given)."""
    spec = spec if spec is not None else RunSpec()
    backend = resolve_backend(spec, g, mesh=mesh)
    kw = {} if mesh is None else {"mesh": mesh}
    return backend.find_seeds(g, k, spec, x=x, plan=plan, device=device, **kw)


__all__ = ["Backend", "BackendCapabilities", "BackendUnavailable", "InfluenceSession",
           "RunReport", "RunSpec", "available_backends", "get_backend", "register_backend",
           "resolve_backend", "resolve_residency", "run"]
