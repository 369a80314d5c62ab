"""Backend protocol and registry: one execution contract, two strategies.

Counterpart of the reference's ``runtime/base.py``. A ``Backend`` answers,
for one (graph, ``RunSpec``) pair, whether it can run it (``supports``), the
full Alg. 4 loop (``find_seeds``) and the build alone (``build_matrix``:
fill + propagate to a fixpoint, in the canonical layout, ``int8[g.n_pad,
len(x)]`` with rows in original-id order). Results are backend-invariant:
the same graph and sketch setting give the same seeds and matrix on every
backend.

Two inner hooks serve repair-style callers that hold a sound lower bound of
the fixpoint: ``fixpoint`` re-propagates a canonical matrix and ``cascade``
spreads one committed seed. A backend whose capabilities report
``shard_repair`` also implements ``repair_plan_shards``, which
``service.delta.apply_delta`` dispatches to for a plan-attached entry. Each
hook raises ``NotImplementedError``, naming the backend, where it is not
implemented.

``resolve_backend`` implements ``backend="auto"`` as the reference does:
``single`` for one shard and no mesh; else ``mesh`` where it supports the
spec (an initialized process group of enough ranks, ``runtime/mesh.py``);
else ``serial``, which runs the same schedule on one device. An explicit
name is honored and raises, with the reason, when that backend cannot run
the spec.

``resolve_residency`` implements ``RunSpec.residency="auto"`` as the
reference does: an index's banks live on the mesh (device residency,
``service.store.StoreEntry.place_on_mesh``) exactly when the resolved
backend reports ``needs_mesh``.

``apply_tuning`` is the backends' tuning hook (``RunSpec.tuning``): the
spec a backend runs carries the measured winners of ``repro_torch.tune``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.difuser import InfluenceResult
from repro_torch.graphs.structs import Graph
from repro_torch.runtime.spec import RunSpec


class BackendUnavailable(RuntimeError):
    """The requested backend cannot run this spec."""


def apply_tuning(g: Optional[Graph], spec: RunSpec, backend_name: str, *,
                 device=None) -> RunSpec:
    """``spec`` with the tuning cache's winners for this graph, backend and
    device overlaid, per ``spec.tuning`` (``repro_torch.tune.resolve_spec``).
    ``"off"`` (or no graph) returns ``spec`` itself without importing the
    tuner. The tuned fields are performance knobs only: seeds and matrices
    are the same whichever spec comes back."""
    if spec.tuning == "off" or g is None:
        return spec
    from repro_torch.tune import resolve_spec

    return resolve_spec(g, spec, backend=backend_name, device=device)


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    name: str
    distributed: bool        # shards work across a (mu_v, mu_s) grid
    description: str = ""
    shard_repair: bool = False   # can re-propagate individual plan shards
    needs_mesh: bool = False     # runs on a process mesh (launch.mesh)


@dataclasses.dataclass
class RunReport:
    """A backend's ``find_seeds`` result with its provenance: the device it
    ran on, the built ``Partition2D`` (``None`` on ``single``) and the wall
    time including host preparation."""

    result: InfluenceResult
    backend: str
    spec: RunSpec
    device: str
    partition: Optional[object] = None
    wall_s: float = 0.0


class Backend(abc.ABC):
    name: str = "?"

    @abc.abstractmethod
    def capabilities(self) -> BackendCapabilities:
        ...

    def available(self) -> Tuple[bool, str]:
        """An environment check only (the torch build, the process group's
        module): can this backend run at all, and if not, why not."""
        return True, ""

    def supports(self, g: Optional[Graph], spec: RunSpec) -> Tuple[bool, str]:
        """Can this backend run ``spec``, and if not, why not."""
        return self.available()

    @abc.abstractmethod
    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, mesh=None, plan=None,
                   device=None) -> RunReport:
        """The full Alg. 4 loop; seeds are original vertex ids. ``plan``: a
        precomputed ``PartitionPlan`` for a sharded backend (the others
        ignore it). ``mesh``: an explicit ``launch.mesh.ProcessMesh``, which
        only the ``mesh`` backend takes (the others ignore it)."""

    @abc.abstractmethod
    def build_matrix(self, g: Graph, spec: RunSpec, x: np.ndarray, *,
                     reg_offset: int = 0, normalized: bool = False, edges=None,
                     mesh=None, plan=None, device=None):
        """Fill + propagate to a fixpoint; returns ``(matrix, iters)`` with the
        matrix in the canonical layout on the device. ``normalized=True``
        promises ``g`` sorted by destination and ``x`` sorted already.
        ``edges``: the ``EdgeOperands`` of the normalized graph on the
        device, a hint that only the ``single`` backend takes (a store of
        several banks uploads them once); ``mesh`` and ``plan`` as in
        ``find_seeds``."""

    def fixpoint(self, m, g: Graph, spec: RunSpec, x: np.ndarray, *, edges=None):
        """Hook: re-propagate an existing canonical matrix to its fixpoint.
        Returns ``(matrix, iters)``."""
        raise NotImplementedError(f"backend {self.name!r} has no fixpoint hook")

    def cascade(self, m, seed_vertex: int, g: Graph, spec: RunSpec, x: np.ndarray, *,
                edges=None):
        """Hook: commit ``seed_vertex`` and spread its cascade to a fixpoint.
        Returns ``(matrix, iters)``."""
        raise NotImplementedError(f"backend {self.name!r} has no cascade hook")

    def repair_plan_shards(self, g: Graph, spec: RunSpec, x: np.ndarray, planned_m, plan,
                           touched, *, mesh=None):
        """Shard-restricted repair of a plan-order matrix; returns
        ``(planned_matrix, sweeps, shards_swept)``. Every backend whose
        ``capabilities().shard_repair`` is True implements it. ``mesh``: the
        mesh of a device-resident matrix, which only the ``mesh`` backend
        takes."""
        raise NotImplementedError(
            f"backend {self.name!r} reports no shard_repair capability")


_BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    """Register ``backend`` under ``backend.name``; a registered name raises
    unless ``overwrite``."""
    if backend.name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(name) -> Backend:
    """The backend registered under ``name``; a ``Backend`` passes through."""
    if isinstance(name, Backend):
        return name
    b = _BACKENDS.get(name)
    if b is None:
        raise KeyError(f"unknown backend {name!r}; registered: {sorted(_BACKENDS)} "
                       f"(plus 'auto')")
    return b


def available_backends() -> Dict[str, Tuple[bool, str]]:
    """name -> (available, the reason where not) for every registered
    backend."""
    return {name: b.available() for name, b in sorted(_BACKENDS.items())}


def resolve_backend(spec: RunSpec, g: Optional[Graph] = None, *, mesh=None) -> Backend:
    """Apply the ``backend="auto"`` rules (module doc) to pick a backend."""
    if spec.backend != "auto":
        b = get_backend(spec.backend)
        ok, why = b.supports(g, spec)
        if not ok:
            raise BackendUnavailable(f"backend {spec.backend!r} cannot run this spec: {why}")
        return b
    if mesh is None and spec.num_shards <= 1:
        return get_backend("single")
    b = get_backend("mesh")
    ok, _ = b.supports(g, spec)
    if ok:
        return b
    serial = get_backend("serial")
    ok, why = serial.supports(g, spec)
    if not ok:
        raise BackendUnavailable(
            f"no backend can run this spec: mesh unavailable and the "
            f"serial fallback cannot either: {why}")
    return serial


def resolve_residency(spec: RunSpec, backend: Backend) -> str:
    """The ``residency="auto"`` rule: ``"device"`` (plan-order row blocks
    placed on the serving mesh, queries reduced shard-locally) when
    ``backend`` runs on a mesh (``needs_mesh``), else ``"host"``. An
    explicit ``"host"`` or ``"device"`` is returned as it is."""
    if spec.residency != "auto":
        return spec.residency
    return "device" if backend.capabilities().needs_mesh else "host"
