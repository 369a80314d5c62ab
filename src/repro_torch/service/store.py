"""Persistent sketch store: the index half of the influence query service.

Counterpart of the reference's ``service/store.py``. The costly step of
DiFuseR is the build of the register matrix to its fixpoint (Alg. 1 and
Alg. 4 lines 3-6); top-k selection, spread estimates and marginal gains are
cheap reductions over it. The ``SketchStore`` runs
that build once per (graph, diffusion setting, seed) key, keeps the
``int8[n_pad, J]`` matrix on the device, and hands queries the warm matrix.

Register banks: the sorted x vector splits into ``num_banks`` contiguous
chunks of ``J / num_banks`` registers, and bank b fills register slots
``[b * j_loc, (b + 1) * j_loc)`` (``reg_offset = b * j_loc``). Propagation
is column-independent, so the concatenation of the banks is byte-equal to
one build; a delta repairs bank by bank.

Residency. A ``"host"`` entry keeps its banks on the store's device in
canonical (original-id) row order; ``attach_plan`` adds a vertex-shard plan
whose row order ``planned_matrix`` serves. ``place_on_mesh`` makes an entry
``"device"``-resident: its plan-order matrix is scattered as row blocks
over a serving mesh (``launch.mesh.make_serving_mesh``; block v, rows ``[v
* n_loc, (v + 1) * n_loc)``, on rank v), each bank a column slice of every
block (``PlacedBank``). The query reductions then run shard-locally where
the rows live, ``planned_matrix()`` is the placement itself
(``launch.mesh.Placement``), ``matrix`` is the gather fallback (the blocks
gathered to the controller and put back in canonical order), and a delta
re-sweeps the dirtied shards on the mesh. ``set_matrix``,
``set_planned_matrix`` and ``install_canonical_banks`` keep the residency:
a device entry's new matrix is placed again. ``to_host`` undoes the
placement. A device entry is not evictable and takes no other plan; it
lives as long as its serving world. Snapshots (``save``/``load``) use the
reference's npz fields, device-saved ones included, so either package
loads the other's; ``load(path, mesh=…)`` places the entry.

Eviction and the double buffer (the async engine's half of the store):
``evict`` drops an entry's banks and keeps an ``EvictionRecipe``, from
which the next ``entry``/``get_or_build`` rebuilds the entry transparently,
its version resuming past the evicted one. ``shadow`` hands a mutation a
store holding a ``StoreEntry.clone_for_update`` of an entry, and
``swap_entry`` installs the mutated clone as the next version under the
store lock, then calls the swap hooks.

The clone shares its bank tensors with the version it was made from, and
torch tensors, unlike the reference's jax arrays, can be written in place.
So no mutation path may write into a bank it did not allocate. They do not:
``delta._repair_insertions`` sweeps out of place (``ops.propagate_sweep``
returns a new matrix; ``pad_columns`` returns its input only when no padding
is needed, and the sweep does not write it) and rebinds the clone's own
``banks`` list; ``rebuild`` builds fresh banks; ``set_matrix`` splits a
matrix the caller made; the serial ring's in-place merges
(``bucket_propagate``/``bucket_cascade``) write only the ring state that its
build or its repair allocated (the shard repair copies ``planned_matrix()``
into its own grid, and ``set_planned_matrix`` gathers new banks from the
repair's output). Placed blocks too: the mesh repair and the warm rounds
copy a rank's block into their own state, the repair's output is a new
block under a new handle, and ``swap_entry`` installs the entry that holds
it. ``tests/test_torch_async_service.py`` holds version N's bank bytes
across a shadow's delta, rebuild and ``set_matrix``.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.difuser import (DiFuserConfig, edge_operands, normalize_inputs,
                                      normalize_x)
from repro_torch.core.sketch import VISITED
from repro_torch.device import resolve_device, synchronize
from repro_torch.diffusion.constants import DEFAULT_MODEL
from repro_torch.graphs.structs import Graph
from repro_torch.kernels.edges import EdgeOperands
from repro_torch.launch import mesh as launch_mesh
from repro_torch.obs import metrics, trace
from repro_torch.partition.plan import PartitionPlan
from repro_torch.service.world import backend_call

#: what a snapshot records for the reference's ``DiFuserConfig.impl`` and
#: ``edge_chunk`` (its plain path and its default chunk): the port has
#: neither knob, and neither changes a result
SNAPSHOT_IMPL = "ref"
SNAPSHOT_EDGE_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class StoreKey:
    """Identity of one cached index: the graph's content and every field of
    the sketch setting that changes a result. ``model`` is part of it, so
    one engine serves several models of one graph through distinct keys."""

    graph_key: str
    num_registers: int
    seed: int
    estimator: str
    sort_x: bool
    rebuild_threshold: float
    max_propagate_iters: int
    max_cascade_iters: int
    model: str = DEFAULT_MODEL

    @staticmethod
    def for_graph(g: Graph, cfg: DiFuserConfig) -> "StoreKey":
        return StoreKey(graph_key=g.content_key(), num_registers=cfg.num_registers,
                        seed=cfg.seed, estimator=cfg.estimator, sort_x=cfg.sort_x,
                        rebuild_threshold=cfg.rebuild_threshold,
                        max_propagate_iters=cfg.max_propagate_iters,
                        max_cascade_iters=cfg.max_cascade_iters, model=cfg.model)


class PlacedBank:
    """Bank b of a device entry: columns ``[b * j_loc, (b + 1) * j_loc)`` of
    every placed row block (the reference's per-bank sharded array).
    ``shape``, ``numel`` and ``device`` describe the whole bank."""

    def __init__(self, placement, b: int, j_loc: int):
        self.placement, self.b = placement, b
        self.shape = (placement.shape[0], j_loc)
        self.dtype, self.device = placement.dtype, placement.device

    def numel(self) -> int:
        return self.shape[0] * self.shape[1]


@dataclasses.dataclass
class StoreEntry:
    """One resident index: ``banks[b]`` is ``int8[n_pad, J / num_banks]`` on
    the device, rows in original-id order (``residency="host"``), or a
    ``PlacedBank`` of the plan-order row blocks on ``mesh``
    (``residency="device"``, ``place_on_mesh``)."""

    key: StoreKey
    graph: Graph                 # serving layout, sorted by destination
    cfg: DiFuserConfig
    x: np.ndarray                # uint32[J], sorted iff cfg.sort_x
    banks: list                  # list of torch int8[n_pad, j_loc]
    build_iters: int
    build_time_s: float
    version: int = 0             # bumped by every delta and rebuild
    stale: bool = False          # removals applied, matrix not rebuilt yet
    staleness_frac: float = 0.0  # removed-edge fraction since the last rebuild
    rebuilds: int = 0
    evictions: int = 0           # times this index was evicted and rebuilt
    plan: Optional[PartitionPlan] = None
    residency: str = "host"      # "host" | "device" (the banks' row order and place)
    mesh: Optional[object] = None           # the serving mesh of a device entry
    vertex_axis: str = "data"               # the mesh axis its row blocks split on
    _matrix_cache: Optional[tuple] = None   # (version, concatenated banks)
    _edges_cache: Optional[tuple] = None    # (version, EdgeOperands)
    _planned_cache: Optional[tuple] = None  # (version, plan-order matrix)

    @property
    def device(self) -> torch.device:
        return self.banks[0].device

    @property
    def num_banks(self) -> int:
        return len(self.banks)

    @property
    def regs_per_bank(self) -> int:
        return self.x.shape[0] // len(self.banks)

    @property
    def serving_backend(self) -> str:
        """The path that answers queries against this entry, as
        ``QueryResult.backend`` records it: ``"mesh:device"`` (shard-local
        reductions on the placed blocks) or ``"single:host"`` (reductions
        over the canonical matrix on one device)."""
        return "mesh:device" if self.residency == "device" else "single:host"

    def device_bytes(self) -> int:
        """Device bytes of the banks, every placed block of a device entry
        counted (the eviction currency: the caches are derived and
        droppable, the banks are the index)."""
        return sum(b.numel() for b in self.banks)

    def clone_for_update(self) -> "StoreEntry":
        """A shallow clone for a double-buffered mutation: it shares the
        graph, x and the bank tensors, owns its ``banks`` list and starts
        with cold caches. It is version N until the mutation bumps it;
        ``SketchStore.swap_entry`` installs it. Sharing the bank tensors is
        sound because no mutation path writes into a bank in place (see the
        module docstring)."""
        c = copy.copy(self)
        c.banks = list(self.banks)
        c._matrix_cache = c._edges_cache = c._planned_cache = None
        return c

    @property
    def matrix(self) -> torch.Tensor:
        """The ``int8[n_pad, J]`` matrix, rows in original-id order; several
        banks are concatenated once per ``version``. On a device entry this
        is the gather fallback: the placed blocks gathered to the controller
        and un-permuted with ``plan.perm`` (shard-local serving never calls
        it), once per ``version``."""
        if self.residency == "device":
            if self._matrix_cache is None or self._matrix_cache[0] != self.version:
                perm = torch.from_numpy(self.plan.perm[:self.graph.n_pad].astype(np.int64))
                pm = self._placement().gather()
                self._matrix_cache = (self.version, pm.index_select(0, perm.to(pm.device)))
            return self._matrix_cache[1]
        if len(self.banks) == 1:
            return self.banks[0]
        if self._matrix_cache is None or self._matrix_cache[0] != self.version:
            self._matrix_cache = (self.version, torch.cat(self.banks, dim=1))
        return self._matrix_cache[1]

    def device_edges(self) -> EdgeOperands:
        """The edge operands of the serving graph under the entry's model, on
        the device, made once per ``version`` (a delta bumps it)."""
        if self._edges_cache is None or self._edges_cache[0] != self.version:
            self.prime_edges_cache()
        return self._edges_cache[1]

    def prime_edges_cache(self, edges: Optional[EdgeOperands] = None) -> EdgeOperands:
        """Install ``edges`` (made fresh when None) as the operands of the
        entry's current graph and version."""
        if edges is None:
            edges = edge_operands(self.graph, self.cfg, self.device)
        self._edges_cache = (self.version, edges)
        return edges

    def planned_matrix(self):
        """The matrix with rows in the attached plan's order (shard v owns
        rows ``[v * n_loc, (v + 1) * n_loc)``), padded to ``plan.n_pad``
        with VISITED rows; made once per ``version``. On a device entry it
        is the ``launch.mesh.Placement`` of the resident blocks themselves
        (no data moves)."""
        if self.plan is None:
            raise ValueError("entry has no partition plan attached")
        if self.residency == "device":
            return self._placement()
        if self._planned_cache is None or self._planned_cache[0] != self.version:
            self._planned_cache = (self.version, self._to_plan_order(self.matrix))
        return self._planned_cache[1]

    # -- residency ------------------------------------------------------------

    def _placement(self):
        return self.banks[0].placement

    def _to_plan_order(self, m: torch.Tensor) -> torch.Tensor:
        """Canonical rows -> plan-order rows, padded to ``plan.n_pad`` with
        VISITED rows."""
        extra = self.plan.n_pad - m.shape[0]
        if extra > 0:
            m = torch.cat([m, torch.full((extra, m.shape[1]), VISITED, dtype=m.dtype,
                                         device=m.device)])
        inv = torch.from_numpy(self.plan.inv_perm.astype(np.int64)).to(m.device)
        return m.index_select(0, inv)

    def _install_planned(self, placement) -> None:
        """Make a placed plan-order matrix the resident state (its banks are
        column slices of it); bumps ``version``."""
        j_loc = self.regs_per_bank
        self.banks = [PlacedBank(placement, b, j_loc) for b in range(self.num_banks)]
        self.version += 1
        self._matrix_cache = self._planned_cache = None

    def place_on_mesh(self, mesh, vertex_axis: str = "data") -> "StoreEntry":
        """Place this entry's banks on ``mesh`` as plan-order row blocks:
        block v of the attached plan on the mesh's rank v, every bank a
        column slice of each block. Needs a plan whose ``mu_v`` is the
        mesh's ``vertex_axis`` size and a mesh whose other axes are trivial
        (rows are the only split; the sample space splits into banks, not
        mesh columns). A layout change, not a version bump."""
        if self.plan is None:
            raise ValueError("attach a partition plan before device placement "
                             "(SketchStore.attach_plan)")
        if mesh.axis_size(vertex_axis) != self.plan.mu_v:
            raise ValueError(f"plan has mu_v={self.plan.mu_v} row blocks but mesh axis "
                             f"{vertex_axis!r} is {mesh.axis_size(vertex_axis)}-way")
        if mesh.size != self.plan.mu_v or mesh.axis_names[0] != vertex_axis:
            raise ValueError("serving meshes shard rows only: the vertex axis comes first "
                             "and every other axis has size 1, got shape "
                             f"{dict(zip(mesh.axis_names, mesh.shape))}")
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks run on {mesh.device.type}, the entry's "
                             f"banks on {self.device.type}")
        canonical = self.matrix
        pm = self._to_plan_order(canonical)
        with trace.span("store.place_banks", phase="build", mu_v=self.plan.mu_v) as sp:
            placement = launch_mesh.place_rows(mesh, pm, self.plan.n_loc)
            sp.sync(placement.local)
        was_device = self.residency == "device"
        self.mesh, self.vertex_axis, self.residency = mesh, vertex_axis, "device"
        j_loc = self.regs_per_bank
        self.banks = [PlacedBank(placement, b, j_loc) for b in range(self.num_banks)]
        metrics.counter("store.device_placements").inc()
        if not was_device:
            metrics.gauge("store.device_resident_entries").value += 1.0
        self._planned_cache = None
        self._matrix_cache = (self.version, canonical)
        return self

    def to_host(self) -> "StoreEntry":
        """Undo ``place_on_mesh``: canonical host-order banks again."""
        if self.residency != "device":
            return self
        canonical = self.matrix
        self.residency, self.mesh = "host", None
        metrics.gauge("store.device_resident_entries").value -= 1.0
        self.banks = _split_banks(canonical, self.num_banks)
        self._matrix_cache = (self.version, canonical)
        self._planned_cache = None
        return self

    def set_matrix(self, m: torch.Tensor) -> None:
        """Replace the matrix (canonical row order), keeping the bank split
        and the residency; bumps ``version``."""
        if self.residency == "device":
            self._install_planned(launch_mesh.place_rows(
                self.mesh, self._to_plan_order(m), self.plan.n_loc))
            return
        self.install_canonical_banks(_split_banks(m, self.num_banks))

    def set_planned_matrix(self, pm) -> None:
        """Replace the matrix from a plan-order one (a shard repair's output);
        bumps ``version``. A device entry installs a placement as it is (a
        tensor is placed first); a host entry un-permutes ``pm`` to canonical
        row order and keeps ``pm`` as the new version's plan-order cache."""
        if self.residency == "device":
            if not isinstance(pm, launch_mesh.Placement):
                pm = launch_mesh.place_rows(self.mesh, pm, self.plan.n_loc)
            self._install_planned(pm)
            return
        perm = torch.from_numpy(self.plan.perm[:self.graph.n_pad].astype(np.int64))
        self.set_matrix(pm.index_select(0, perm.to(pm.device)))
        self._planned_cache = (self.version, pm)

    def install_canonical_banks(self, banks: list) -> None:
        """Adopt freshly built canonical banks (the rebuild path), keeping the
        residency (a device entry places the new matrix); bumps ``version``."""
        if self.residency == "device":
            m = banks[0] if len(banks) == 1 else torch.cat(banks, dim=1)
            self._install_planned(launch_mesh.place_rows(
                self.mesh, self._to_plan_order(m), self.plan.n_loc))
            return
        self.banks = list(banks)
        self.version += 1


@dataclasses.dataclass
class EvictionRecipe:
    """What an evicted entry is rebuilt from on its next touch: its current
    graph (deltas applied), its sketch setting and its x. A build from these
    is byte-equal to the dropped matrix (an insertion repair ends at the
    build's fixpoint; stale entries are never evicted). The recipe is
    O(graph); the banks it replaces are O(n_pad * J) device bytes."""

    key: StoreKey
    graph: Graph
    cfg: DiFuserConfig
    x: np.ndarray
    plan: Optional[PartitionPlan]
    version: int                 # version at eviction; the rebuild resumes past it
    build_time_s: float          # last measured build (the evictor's cost)
    evictions: int               # lifetime evictions of this index


def _split_banks(m: torch.Tensor, num_banks: int) -> list:
    if m.shape[1] % num_banks:
        raise ValueError(f"{m.shape[1]} registers do not split into {num_banks} banks")
    j_loc = m.shape[1] // num_banks
    return [m[:, b * j_loc:(b + 1) * j_loc].contiguous() for b in range(num_banks)]


class SketchStore:
    """Build-once, query-many cache of propagated sketch matrices.

    ``spec`` (a ``runtime.RunSpec``, for its execution fields: ``backend``,
    ``mu_v``, ``partition``, ...) chooses how the banks are built; every
    backend returns the same canonical matrix. ``backend`` (a registered
    name or a ``runtime.Backend``) overrides the spec's choice, so any
    registered backend can build the banks. ``device`` is where the banks
    live: CUDA unless ``device="cpu"`` is passed.
    """

    def __init__(self, num_banks: int = 1, backend=None, spec=None, device=None):
        if num_banks < 1:
            raise ValueError(f"num_banks must be at least 1, got {num_banks}")
        self.num_banks = num_banks
        self.backend = backend   # str | runtime.Backend | None (the spec's choice)
        self.spec = spec
        self.device = resolve_device(device)
        self._entries: dict = {}
        # evicted keys: banks dropped, recipe kept; entry() and get_or_build
        # rebuild them on the next touch
        self._evicted: dict = {}
        # evict, the evicted rebuild and swap_entry serialize on this; the
        # query path stays an unlocked dict read
        self._lock = threading.RLock()
        # hook(key, old entry or None, new entry), after every swap_entry
        self._swap_hooks: list = []

    def _resolve_backend(self, cfg: DiFuserConfig):
        """The (backend, RunSpec) that builds run through: ``cfg``'s sketch
        fields over ``self.spec``'s execution fields; ``self.backend``, when
        set, in place of the spec's choice."""
        from repro_torch.runtime import RunSpec, get_backend, resolve_backend

        spec = RunSpec.from_config(cfg, base=self.spec)
        if self.backend is not None:
            return get_backend(self.backend), spec
        return resolve_backend(spec), spec

    def __len__(self) -> int:
        return len(self._entries) + len(self._evicted)

    def __contains__(self, key: StoreKey) -> bool:
        return key in self._entries or key in self._evicted

    def entry(self, key: StoreKey) -> StoreEntry:
        """The resident entry for ``key``; an evicted key is rebuilt here
        from its recipe, so a caller sees an eviction only as latency."""
        e = self._entries.get(key)
        if e is not None:
            return e
        if key in self._evicted:
            return self._rebuild_evicted(key)
        raise KeyError(key)

    def keys(self) -> list:
        return list(self._entries) + list(self._evicted)

    def resident_keys(self) -> list:
        """Keys whose banks are on the device (evicted ones excluded)."""
        return list(self._entries)

    def is_evicted(self, key: StoreKey) -> bool:
        return key in self._evicted

    def resident_bytes(self) -> int:
        """Device bytes of every resident entry's banks (the evictor's
        budget currency)."""
        return sum(e.device_bytes() for e in list(self._entries.values()))

    def invalidate(self, key: StoreKey) -> None:
        """Forget ``key``, resident or evicted."""
        with self._lock:
            self._entries.pop(key, None)
            self._evicted.pop(key, None)

    def get_or_build(self, g: Graph, config: Optional[DiFuserConfig] = None,
                     x: Optional[np.ndarray] = None) -> StoreEntry:
        """The entry for (g, config), built on a miss. A hit checks that the
        caller's x (or the seed's default) is the one the entry holds."""
        cfg = config or DiFuserConfig()
        key = StoreKey.for_graph(g, cfg)
        hit = self._entries.get(key)
        if hit is None and key in self._evicted:
            hit = self._rebuild_evicted(key)
        if hit is not None:
            if not np.array_equal(normalize_x(cfg, x), hit.x):
                raise ValueError(
                    "store hit for this (graph, config) was built with a different "
                    "sample vector x; use a distinct config.seed or a separate store "
                    "for a separate sample space")
            return hit
        g_norm, x_norm = normalize_inputs(g, cfg, x)
        banks, iters, dt, edges = self._build_banks(g_norm, cfg, x_norm)
        entry = StoreEntry(key=key, graph=g_norm, cfg=cfg, x=x_norm, banks=banks,
                           build_iters=iters, build_time_s=dt)
        entry.prime_edges_cache(edges)
        self._entries[key] = entry
        return entry

    def _build_banks(self, g_norm: Graph, cfg: DiFuserConfig, x_norm: np.ndarray):
        """Build every bank; returns (banks, most sweeps of a bank, seconds,
        the graph's edge operands)."""
        j = x_norm.shape[0]
        if j % self.num_banks:
            raise ValueError(f"{j} registers do not split into {self.num_banks} banks")
        j_loc = j // self.num_banks
        t0 = time.perf_counter()
        backend, spec = self._resolve_backend(cfg)
        with trace.span("store.build_banks", phase="build", banks=self.num_banks,
                        n=g_norm.n, registers=j):
            # one upload for every bank: banks split the samples, not the graph
            edges = edge_operands(g_norm, cfg, self.device)
            banks, iters = [], 0
            for b in range(self.num_banks):
                with trace.span("store.build_bank", bank=b, timed=True) as sp:
                    m_b, it_b = backend_call(
                        backend, "build_matrix", g_norm, spec, x_norm[b * j_loc:(b + 1) * j_loc],
                        reg_offset=b * j_loc, normalized=True, edges=edges,
                        device=self.device)
                    sp.sync(m_b)
                banks.append(m_b)
                iters = max(iters, it_b)
                metrics.histogram("store.bank_build_s", unit="s").observe(sp.duration_s)
            # the banks are complete before any caller (or another thread's
            # stream) sees them
            synchronize(self.device)
        dt = time.perf_counter() - t0
        metrics.counter("store.bank_builds").inc(self.num_banks)
        metrics.histogram("store.entry_build_s", unit="s").observe(dt)
        return banks, iters, dt, edges

    def rebuild(self, key: StoreKey) -> StoreEntry:
        """A pristine rebuild from the entry's current graph: clears the
        staleness, bumps the version."""
        entry = self.entry(key)
        banks, iters, dt, edges = self._build_banks(entry.graph, entry.cfg, entry.x)
        entry.install_canonical_banks(banks)
        entry.build_iters = iters
        entry.build_time_s = dt
        entry.stale = False
        entry.staleness_frac = 0.0
        entry.rebuilds += 1
        metrics.counter("store.rebuilds").inc()
        entry.prime_edges_cache(edges)
        return entry

    # -- eviction and the double-buffered swap --------------------------------

    def evict(self, key: StoreKey) -> int:
        """Drop a resident entry's banks and keep its rebuild recipe; the
        next ``entry``/``get_or_build`` rebuilds it. Returns the device bytes
        freed. A stale entry (removals not rebuilt) is refused: its matrix
        depends on its history, and a rebuild would change its answers. So is
        a device entry: it pins mesh state the recipe cannot make again."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                if key in self._evicted:
                    return 0
                raise KeyError(key)
            if e.stale:
                raise ValueError("stale entries are not evictable: the over-approximating "
                                 "matrix cannot be reconstructed by a pristine rebuild")
            if e.residency == "device":
                raise ValueError("device-resident entries are not evictable; to_host() "
                                 "first")
            freed = e.device_bytes()
            self._evicted[key] = EvictionRecipe(
                key=e.key, graph=e.graph, cfg=e.cfg, x=e.x, plan=e.plan, version=e.version,
                build_time_s=e.build_time_s, evictions=e.evictions + 1)
            del self._entries[key]
        metrics.counter("store.evictions").inc()
        metrics.gauge("store.resident_bytes").set(float(self.resident_bytes()))
        return freed

    def _rebuild_evicted(self, key: StoreKey) -> StoreEntry:
        """Rebuild an evicted entry from its recipe (the touch path): byte-
        equal to the dropped matrix, its version one past the evicted one so
        that memos of the old version miss."""
        with self._lock:
            live = self._entries.get(key)
            if live is not None:     # another thread rebuilt it first
                return live
            recipe = self._evicted.pop(key)
            with trace.span("store.evicted_rebuild", phase="build", timed=True):
                banks, iters, dt, edges = self._build_banks(recipe.graph, recipe.cfg,
                                                            recipe.x)
            entry = StoreEntry(key=recipe.key, graph=recipe.graph, cfg=recipe.cfg,
                               x=recipe.x, banks=banks, build_iters=iters,
                               build_time_s=dt, version=recipe.version + 1,
                               plan=recipe.plan, evictions=recipe.evictions)
            entry.prime_edges_cache(edges)
            self._entries[key] = entry
        metrics.counter("store.evicted_rebuilds").inc()
        metrics.histogram("store.evicted_rebuild_s", unit="s").observe(dt)
        metrics.gauge("store.resident_bytes").set(float(self.resident_bytes()))
        return entry

    def add_swap_hook(self, fn: Callable) -> None:
        """Call ``fn(key, old entry or None, new entry)`` after every
        ``swap_entry`` (engines sharing the store drop their memos here)."""
        if fn not in self._swap_hooks:
            self._swap_hooks.append(fn)

    def shadow(self, key: StoreKey) -> "SketchStore":
        """The double buffer: a new store (same banks, backend, spec and device)
        holding ``clone_for_update`` of ``key``'s entry (an evicted
        one is rebuilt first). A mutation (``apply_delta``, ``rebuild``)
        runs against the shadow while this store serves version N;
        ``swap_entry`` then installs the shadow's entry."""
        e = self.entry(key)
        s = SketchStore(num_banks=self.num_banks, backend=self.backend, spec=self.spec,
                        device=self.device)
        s._entries[key] = e.clone_for_update()
        return s

    def swap_entry(self, key: StoreKey, new_entry: StoreEntry) -> Optional[StoreEntry]:
        """Make ``new_entry`` the resident state of ``key`` under the store
        lock, then call the swap hooks. Returns the displaced entry (None on
        a cold admit). A query that took the entry before the swap finishes
        against version N; every later lookup sees the new one. The caller
        makes sure the new entry's device work is complete."""
        t0 = time.perf_counter()
        with self._lock:
            old = self._entries.get(key)
            self._evicted.pop(key, None)
            self._entries[key] = new_entry
        for hook in list(self._swap_hooks):
            try:
                hook(key, old, new_entry)
            except Exception:  # noqa: BLE001 (an observer must not break serving)
                metrics.counter("store.swap_hook_errors").inc()
        metrics.counter("store.swaps").inc()
        metrics.histogram("store.swap_s", unit="s").observe(time.perf_counter() - t0)
        metrics.gauge("store.resident_bytes").set(float(self.resident_bytes()))
        return old

    def attach_plan(self, key: StoreKey, plan: PartitionPlan) -> StoreEntry:
        """Keep a vertex-shard plan with an entry: queries are unchanged,
        ``planned_matrix`` serves the plan's row order, and deltas report
        the plan shards they touch. The plan outlives deltas and rebuilds
        (the vertex set is fixed) and rides in snapshots. A device entry,
        placed under its plan, is refused."""
        entry = self.entry(key)
        if entry.residency == "device":
            raise ValueError("entry is device-resident under its current plan; "
                             "to_host() before attaching another")
        plan.validate(entry.graph)
        entry.plan = plan
        entry._planned_cache = None
        return entry

    def place(self, key: StoreKey, mesh, *, vertex_axis: str = "data") -> StoreEntry:
        """``StoreEntry.place_on_mesh`` by key."""
        return self.entry(key).place_on_mesh(mesh, vertex_axis=vertex_axis)

    # -- persistence --------------------------------------------------------

    @staticmethod
    def _npz_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str, key: StoreKey) -> None:
        """Write one entry (matrix, graph, setting) as the reference's npz; a
        device entry writes its gathered canonical matrix with
        ``residency="device"``."""
        e = self.entry(key)
        g = e.graph
        plan_fields = {}
        if e.plan is not None:
            plan_fields = dict(plan_strategy=np.str_(e.plan.strategy), plan_perm=e.plan.perm,
                               plan_mu_v=e.plan.mu_v, plan_mu_s=e.plan.mu_s)
        np.savez_compressed(
            self._npz_path(path),
            matrix=e.matrix.cpu().numpy(), x=e.x, **plan_fields,
            n=g.n, n_pad=g.n_pad, m_real=g.m_real, src=g.src, dst=g.dst, weight=g.weight,
            graph_key=np.str_(e.key.graph_key),
            num_registers=e.cfg.num_registers, seed=e.cfg.seed,
            estimator=np.str_(e.cfg.estimator), impl=np.str_(SNAPSHOT_IMPL),
            model=np.str_(e.cfg.model), sort_x=e.cfg.sort_x,
            rebuild_threshold=e.cfg.rebuild_threshold,
            max_propagate_iters=e.cfg.max_propagate_iters,
            max_cascade_iters=e.cfg.max_cascade_iters, edge_chunk=SNAPSHOT_EDGE_CHUNK,
            build_iters=e.build_iters, version=e.version, residency=np.str_(e.residency),
            stale=e.stale, staleness_frac=e.staleness_frac)

    def load(self, path: str, *, mesh=None, vertex_axis: str = "data") -> StoreEntry:
        """Restore an entry written by either package's ``save`` (no build).
        The reference's ``impl`` and ``edge_chunk`` are ignored; a snapshot
        without ``model`` predates the model zoo and is ``wc``. The key's
        ``graph_key`` is the saved one: it names the lineage, the graph the
        index was registered under before any delta. With ``mesh`` the entry
        is placed on it (its snapshot must carry a plan); a snapshot saved
        device-resident and loaded without one warns and serves host-order,
        with the same answers."""
        z = np.load(self._npz_path(path))
        files = set(z.files)
        cfg = DiFuserConfig(
            num_registers=int(z["num_registers"]), seed=int(z["seed"]),
            estimator=str(z["estimator"]),
            model=str(z["model"]) if "model" in files else DEFAULT_MODEL,
            sort_x=bool(z["sort_x"]), rebuild_threshold=float(z["rebuild_threshold"]),
            max_propagate_iters=int(z["max_propagate_iters"]),
            max_cascade_iters=int(z["max_cascade_iters"]))
        g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], weight=z["weight"],
                  n_pad=int(z["n_pad"]), m_real=int(z["m_real"]))
        key = StoreKey(graph_key=str(z["graph_key"]), num_registers=cfg.num_registers,
                       seed=cfg.seed, estimator=cfg.estimator, sort_x=cfg.sort_x,
                       rebuild_threshold=cfg.rebuild_threshold,
                       max_propagate_iters=cfg.max_propagate_iters,
                       max_cascade_iters=cfg.max_cascade_iters, model=cfg.model)
        m = torch.from_numpy(np.require(z["matrix"], np.int8, ["C"])).to(self.device)
        entry = StoreEntry(key=key, graph=g, cfg=cfg, x=z["x"].astype(np.uint32),
                           banks=_split_banks(m, self.num_banks),
                           build_iters=int(z["build_iters"]), build_time_s=0.0,
                           version=int(z["version"]), stale=bool(z["stale"]),
                           staleness_frac=float(z["staleness_frac"]))
        if "plan_strategy" in files:
            entry.plan = PartitionPlan.from_permutation(
                g.n, int(z["plan_mu_v"]), int(z["plan_mu_s"]), z["plan_perm"],
                strategy=str(z["plan_strategy"]))
        self._entries[key] = entry
        saved = str(z["residency"]) if "residency" in files else "host"
        if mesh is not None:
            if entry.plan is None:
                raise ValueError("load(mesh=...) asked for device placement but the "
                                 "snapshot carries no partition plan to place with")
            entry.place_on_mesh(mesh, vertex_axis=vertex_axis)
        elif saved == "device":
            warnings.warn("snapshot was saved device-resident; pass load(mesh=...) to "
                          "place its row blocks again (serving host-order for now: the "
                          "same answers, through the canonical matrix)", stacklevel=2)
        return entry
