"""InfluenceSession: one object over the whole influence pipeline.

Counterpart of the reference's ``runtime/session.py``. A session binds a
graph to a ``RunSpec`` once and offers the cold path (``find_seeds``,
``build_sketch_matrix``) through the spec's backend and the resident path
(``entry``, ``find_seeds_warm``, ``apply_delta``) through a ``SketchStore``.
It runs on CUDA unless ``device="cpu"`` is passed.

``entry()`` routes the index's residency (``runtime.resolve_residency``):
where the spec asks for the device, or ``"auto"`` resolves to the mesh
backend, the entry gets a plan of ``spec.partition`` (unless it has one)
and is placed on the serving mesh, which only the controller of a serving
world holds (``launch.mesh.serve_world``; ``serve`` under torchrun). On
that controller the cold path's mesh calls run on every rank of the world
(``service.world.backend_call``). Without
a process group, or with too few ranks, that raises ``BackendUnavailable``
naming the reason; it never serves host-order instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import difuser as _difuser
from repro_torch.core.difuser import InfluenceResult
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph, GraphDelta
from repro_torch.runtime.base import (Backend, BackendUnavailable, RunReport,
                                      resolve_backend, resolve_residency)
from repro_torch.runtime.spec import RunSpec
from repro_torch.service.delta import DeltaReport, apply_delta
from repro_torch.service.store import SketchStore, StoreEntry
from repro_torch.service.world import backend_call


class InfluenceSession:
    """A graph bound to one ``RunSpec``. ``store`` shares a ``SketchStore``
    between sessions; by default the session owns one of ``num_banks``
    banks on its device, built through the session's spec. ``mesh``: a
    ``launch.mesh.ProcessMesh`` for the ``mesh`` backend's cold path, and
    the serving mesh when it is a ``(mu_v, 1)`` one that fits the plan."""

    def __init__(self, graph: Graph, spec: Optional[RunSpec] = None, *,
                 store: Optional[SketchStore] = None, num_banks: int = 1, device=None,
                 mesh=None):
        self.graph = graph
        self.spec = spec if spec is not None else RunSpec()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.store = (store if store is not None
                      else SketchStore(num_banks=num_banks, spec=self.spec,
                                       device=self.device))
        self.last_report: Optional[RunReport] = None
        # store keys name the lineage graph (they outlive deltas), so the
        # session keeps its entry's key instead of deriving it again
        self._entry_key = None

    @property
    def backend(self) -> Backend:
        return resolve_backend(self.spec, self.graph, mesh=self.mesh)

    def _mesh_kw(self, backend: Backend) -> dict:
        if self.mesh is None or backend.name != "mesh":
            return {}
        return {"mesh": self.mesh}

    # -- cold path ----------------------------------------------------------

    def find_seeds(self, k: int, *, x: Optional[np.ndarray] = None,
                   plan=None) -> InfluenceResult:
        """Alg. 4 through the spec's backend; its ``RunReport`` is kept in
        ``last_report``."""
        backend = self.backend
        report = backend_call(backend, "find_seeds", self.graph, k, self.spec, x=x,
                              plan=plan, device=self.device, **self._mesh_kw(backend))
        self.last_report = report
        return report.result

    def build_sketch_matrix(self, *, x: Optional[np.ndarray] = None, reg_offset: int = 0):
        """Alg. 4 lines 3-6 through the spec's backend: ``(matrix, iters,
        x_used)``, the matrix in the canonical layout."""
        cfg = self.spec.difuser_config()
        g, x_norm = _difuser.normalize_inputs(self.graph, cfg, x)
        backend = self.backend
        m, iters = backend_call(backend, "build_matrix", g, self.spec, x_norm,
                                reg_offset=reg_offset, normalized=True, device=self.device,
                                **self._mesh_kw(backend))
        return m, iters, x_norm

    # -- resident path ------------------------------------------------------

    def entry(self, *, x: Optional[np.ndarray] = None) -> StoreEntry:
        """The store's entry for this session's (graph, setting), built on
        first demand and placed as the spec's residency says (module doc)."""
        if x is None and self._entry_key is not None and self._entry_key in self.store:
            e = self.store.entry(self._entry_key)
        else:
            e = self.store.get_or_build(self.graph, self.spec.difuser_config(), x)
            self._entry_key = e.key
        self._route_residency(e)
        return e

    def _route_residency(self, e: StoreEntry) -> None:
        """Place a host-order entry on the serving mesh when the spec asks
        for the device (or ``"auto"`` resolves to the mesh backend), with a
        plan of ``spec.partition`` over the spec's vertex shards attached
        first when the entry has none."""
        if e.residency == "device" or resolve_residency(self.spec,
                                                         self.backend) != "device":
            return
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise BackendUnavailable(
                "device residency places row blocks on a serving mesh, and no process "
                "group is initialized (serve under torchrun --nproc-per-node N, or run "
                "launch.mesh.serve_world); residency='host' serves the same answers "
                "host-order")
        spec = self.spec
        shards = (e.plan.mu_v if e.plan is not None
                  else max(spec.mu_v if spec.mu_v > 1 else spec.num_shards, 1))
        if dist.get_world_size() < shards:
            raise BackendUnavailable(
                f"device residency places {shards} row blocks but the process group has "
                f"{dist.get_world_size()} rank(s); residency='host' serves the same "
                "answers host-order")
        if e.plan is None:
            from repro_torch.partition import plan_partition

            self.store.attach_plan(e.key, plan_partition(
                e.graph, shards, mu_s=1, strategy=self.spec.partition, x=e.x,
                seed=e.cfg.seed, model=e.cfg.model, device=self.device))
        e.place_on_mesh(self._serving_mesh(e.plan), vertex_axis=self.spec.vertex_axis)

    def _serving_mesh(self, plan):
        """The session's mesh when it is the plan's row-only ``(mu_v, 1)``
        layout, else a serving mesh of ``plan.mu_v`` ranks."""
        if (self.mesh is not None and self.mesh.size == plan.mu_v
                and self.mesh.axis_size(self.spec.vertex_axis) == plan.mu_v):
            return self.mesh
        from repro_torch.launch.mesh import require_controller

        return require_controller().serving_mesh(
            plan.mu_v, vertex_axis=self.spec.vertex_axis, sim_axis=self.spec.sim_axes[0],
            device=self.device.type)

    def find_seeds_warm(self, k: int, *, x: Optional[np.ndarray] = None) -> InfluenceResult:
        """The K seed rounds from the resident matrix, as engine-served
        ``TopKSeeds``: a stale entry is rebuilt first; a device entry runs
        them on its mesh off the placed blocks. The seeds equal
        ``find_seeds``'s."""
        from repro_torch.service.queries import top_k_seeds

        return top_k_seeds(self.store, self.entry(x=x), k)

    def apply_delta(self, delta: GraphDelta, *,
                    staleness_threshold: float = 0.1) -> DeltaReport:
        """Apply a graph delta to the resident entry through the session's
        backend: on a shard-repair backend (``serial``, or ``mesh`` for a
        device-resident entry) with a plan attached, insertions sweep only
        the plan shards the delta dirtied.
        The session's graph follows the entry's, so the cold and the
        resident paths keep answering about the same graph."""
        e = self.entry()
        report = apply_delta(self.store, e.key, delta,
                             staleness_threshold=staleness_threshold,
                             backend=self.backend)
        self.graph = self.store.entry(e.key).graph
        return report
