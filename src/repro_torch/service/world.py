"""A backend's cold call on the controller of a serving world.

The mesh backend is SPMD: every rank of its grid makes the same call. On
the controller of a serving world (``launch.mesh.serve_world``) the other
ranks wait for operation records, so the serving layer (the store's builds,
the session's cold path) sends such a call as one operation of the world:
each rank makes it on the graph the record names, which it holds already
or is sent once. Every other call runs where it is made.
"""
from __future__ import annotations

from repro_torch.launch import mesh as launch_mesh


def backend_call(backend, method: str, g, *args, **kw):
    """``getattr(backend, method)(g, *args, **kw)``; on a serving world's
    controller, outside an operation, a backend that needs the mesh runs it
    on every rank as one operation (``edges`` is dropped: the ranks bucket
    their own operands)."""
    ctl = launch_mesh.current_controller()
    if ctl is None or ctl.in_op() or not backend.capabilities().needs_mesh:
        return getattr(backend, method)(g, *args, **kw)
    kw.pop("edges", None)
    mesh = kw.pop("mesh", None)
    return ctl.call(_op_backend, dict(
        backend=backend.name, method=method, graph=ctl.share_graph(g), args=args, kw=kw,
        mesh_key=None if mesh is None else mesh.key))


def _op_backend(state, p, local):
    """The backend call on every rank, SPMD inside the operation (the mesh,
    when one is named, by its key: each rank's own view of it)."""
    from repro_torch.runtime import get_backend

    kw = dict(p["kw"])
    if p["mesh_key"] is not None:
        kw["mesh"] = launch_mesh.ProcessMesh.by_key(p["mesh_key"])
    return getattr(get_backend(p["backend"]), p["method"])(state.graph(p["graph"]),
                                                           *p["args"], **kw)
