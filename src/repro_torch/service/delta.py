"""Incremental repair of a resident index after a graph delta.

Counterpart of the reference's ``service/delta.py``. Edge insertions need no
rebuild: registers form a max-merge lattice and new edges only grow each
simulation's reachable sets, so the old fixpoint lies below the new one and
monotone sweeps climb the rest of the way. Per bank, one propagate sweep
over the touched edges alone (the probe) decides whether anything changed;
only then does a full fixpoint run, from the probe's matrix, so it ends in
about as many sweeps as the change spreads.

Removals cannot un-merge registers, so they accrue staleness: the matrix
over-estimates until the removed fraction passes ``staleness_threshold``,
when a pristine rebuild runs. Below it the entry is only marked stale, and
``queries.top_k_seeds`` rebuilds it on the first top-k query.

Both fast paths need ``context_free_edges`` (``diffusion.models``): under
lt any delta rebuilds.

With a partition plan attached and a backend of the ``shard_repair``
capability asked for (``"auto"`` picks ``serial`` when a plan is attached),
the insertion repair runs on the plan-order matrix instead and sweeps only
the plan shards the delta dirtied, widening only where changes spread
(``partition.serial.repair_plan_shards``); its result is byte-equal to the
per-bank repair's.

The entry's residency decides over the caller's backend both ways, as in
the reference: a device entry (plan-order row blocks on a serving mesh)
repairs on ``mesh`` where its rows live (``"auto"`` or no backend), on
``serial`` when the caller names a backend that cannot repair plan shards
(the blocks gathered to the controller, repaired there and placed again),
never bank by bank; its delta reaches every rank's graph as the
``GraphDelta`` itself, every rank making the new graph at once
(``launch.mesh.Controller.apply_delta``). A host entry
never repairs on ``mesh`` (``serial`` takes its place). Where the reference
takes ``serial`` because no mesh is there, a device entry raises: its
blocks are never repaired elsewhere behind the caller's back.

Each call runs in a ``delta.apply`` span (the ``repair`` lane, annotated
with the repair's backend), with the port's ``delta.new_graph``,
``delta.edge_operands`` and (per-bank) ``delta.touched_edges`` spans
inside, and lands in the ``delta.*`` metrics (sweeps, seconds, rebuilds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.difuser import x_tensor
from repro_torch.core.simulate import propagate_to_fixpoint
from repro_torch.core.sketch import pad_columns, real_columns
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph, GraphDelta, edge_pair_keys
from repro_torch.kernels import ops
from repro_torch.kernels.edges import EdgeOperands
from repro_torch.launch import mesh as launch_mesh
from repro_torch.obs import metrics, trace
from repro_torch.service.store import SketchStore, StoreEntry, StoreKey


@dataclasses.dataclass
class DeltaReport:
    """What ``apply_delta`` did: the repair path and its work."""

    added: int
    removed: int              # edges actually removed (absent pairs do not count)
    rebuilt: bool             # a full rebuild ran
    stale: bool               # the entry is left stale (removals below the threshold)
    staleness_frac: float
    repair_sweeps: int        # sweeps of the insertion repair, probes included
    banks_touched: int        # banks whose probe changed a register
    time_s: float
    # vertex shards of the entry's plan that the delta's endpoints land in
    # (empty without a plan)
    plan_shards_touched: tuple = ()
    # with a shard_repair backend: the shards whose buckets were swept
    # (plan_shards_touched for a localized delta; more only where the
    # repair spread)
    shards_swept: tuple = ()
    repair_backend: str = "single"   # backend the insertion repair ran on


def _touched_edges(new_g: Graph, delta: GraphDelta, ep) -> Optional[tuple]:
    """The new graph's edges whose (src, dst) pair the delta adds, with their
    operands ``ep`` (made against the whole new graph, so an added duplicate
    carries the pair's compound probability); None if none is left."""
    r = new_g.m_real
    hit = np.isin(edge_pair_keys(new_g.src[:r], new_g.dst[:r], new_g.n_pad),
                  edge_pair_keys(delta.add_src, delta.add_dst, new_g.n_pad))
    if not hit.any():
        return None     # every added edge was a self loop
    return (new_g.src[:r][hit], new_g.dst[:r][hit], ep.h[:r][hit], ep.lo[:r][hit],
            ep.thr[:r][hit])


def _shard_repair_backend(backend, entry: StoreEntry):
    """The backend of the shard-restricted repair, or None for the per-bank
    one, routed as the reference routes it (module doc): ``"auto"`` takes
    ``serial`` when a plan is attached; a device entry takes ``mesh`` for
    ``"auto"`` and ``None``, ``serial`` for a backend without the
    ``shard_repair`` capability, never the per-bank repair; a host entry
    never takes ``mesh``."""
    from repro_torch.runtime import BackendUnavailable, get_backend

    device = entry.residency == "device"
    if backend == "auto" or (backend is None and device):
        if entry.plan is None:
            return None
        if device:
            b = get_backend("mesh")
            ok, why = b.available()
            if not ok:
                raise BackendUnavailable(f"a device-resident entry repairs on the mesh: "
                                         f"{why}")
            return b
        return get_backend("serial")
    if backend is None:
        return None
    b = get_backend(backend) if isinstance(backend, str) else backend
    caps = b.capabilities()
    if not caps.shard_repair:
        return get_backend("serial") if device else None
    if caps.needs_mesh and not device:
        return get_backend("serial")
    return b


def apply_delta(store: SketchStore, key: StoreKey, delta: GraphDelta, *,
                staleness_threshold: float = 0.1, backend=None) -> DeltaReport:
    """Apply edge insertions and removals to a resident entry, repairing or
    invalidating its matrix as cheaply as soundness allows.

    The entry's graph always follows the delta; its key stays (the key
    names the lineage, so engine handles stay valid). ``staleness_threshold``
    is the removed-edge fraction past which removals rebuild at once; it is
    not ``DiFuserConfig.rebuild_threshold``, Alg. 4's per-round epsilon.

    ``backend`` (a name or a ``Backend``): with a plan attached, shards
    touched and a backend of the ``shard_repair`` capability, the insertion
    repair sweeps only the dirtied plan shards; ``"auto"`` picks ``serial``
    when a plan is attached. ``None`` and the other backends run the
    per-bank repair. Either way the matrix ends byte-equal to a rebuild.
    """
    with trace.span("delta.apply", phase="repair", timed=True, added=delta.num_added,
                    removals=delta.num_removed) as sp:
        rep = _apply(store, key, delta, staleness_threshold, backend)
        sp.annotate(rebuilt=rep.rebuilt, sweeps=rep.repair_sweeps,
                    backend=rep.repair_backend)
    rep.time_s = sp.duration_s
    metrics.histogram("delta.repair_sweeps").observe(rep.repair_sweeps)
    metrics.histogram("delta.apply_s", unit="s").observe(rep.time_s)
    if rep.rebuilt:
        metrics.counter("delta.rebuilds").inc()
    entry = store.entry(key)
    if entry.plan is not None and entry.plan.mu_v:
        metrics.gauge("delta.dirty_shard_frac").set(
            len(rep.plan_shards_touched) / entry.plan.mu_v)
    return rep


def _apply(store: SketchStore, key: StoreKey, delta: GraphDelta,
           staleness_threshold: float, backend) -> DeltaReport:
    """``apply_delta``'s work, in its span; the caller sets ``time_s``."""
    entry = store.entry(key)
    g = entry.graph
    m_before = g.m_real
    removed = 0
    if delta.num_removed:
        removed = int(np.isin(edge_pair_keys(g.src[:m_before], g.dst[:m_before], g.n_pad),
                              edge_pair_keys(delta.rem_src, delta.rem_dst, g.n_pad)).sum())
    plan_shards: tuple = ()
    if entry.plan is not None:
        touched_v = np.unique(np.concatenate(
            [delta.add_src, delta.add_dst, delta.rem_src, delta.rem_dst]))
        if touched_v.size:
            plan_shards = tuple(np.unique(entry.plan.owner_of(touched_v)).tolist())
    context_free = resolve_model(entry.cfg.model).context_free_edges

    with trace.span("delta.new_graph", phase="repair"):
        if entry.residency == "device":   # every rank makes it from its own copy
            new_g = launch_mesh.controller_of(entry.mesh).apply_delta(g, delta)
        else:
            new_g = g.apply_delta(delta).sorted_by_dst()
    entry.graph = new_g
    entry.version += 1
    rebuilt = False
    repair_sweeps = banks_touched = 0
    shards_swept: tuple = ()
    repair_backend = "single"
    if removed:
        entry.staleness_frac += removed / max(m_before, 1)
        if not context_free or entry.staleness_frac > staleness_threshold:
            store.rebuild(key)      # clears the staleness, bumps the version
            rebuilt = True
        else:
            entry.stale = True
    if delta.num_added and not rebuilt:
        if context_free:
            shard_backend = _shard_repair_backend(backend, entry)
            if shard_backend is not None and entry.plan is not None and plan_shards:
                repair_sweeps, banks_touched, shards_swept = _repair_insertions_sharded(
                    entry, new_g, plan_shards, shard_backend)
                repair_backend = shard_backend.name
            else:
                repair_sweeps, banks_touched = _repair_insertions(entry, new_g, delta)
        else:
            store.rebuild(key)
            rebuilt = True
    return DeltaReport(added=delta.num_added, removed=removed, rebuilt=rebuilt,
                       stale=entry.stale, staleness_frac=entry.staleness_frac,
                       repair_sweeps=repair_sweeps, banks_touched=banks_touched,
                       time_s=0.0, plan_shards_touched=plan_shards,
                       shards_swept=shards_swept, repair_backend=repair_backend)


def _repair_insertions_sharded(entry: StoreEntry, new_g: Graph, touched: tuple, backend):
    """The shard-restricted monotone insertion repair through a
    ``shard_repair`` backend: the plan-order matrix is repaired from the
    shards the delta dirtied, sweeps widening only where changes spread. A
    device entry's blocks go in placed and come back placed (``mesh``).
    Returns (sweeps, banks touched, shards swept)."""
    from repro_torch.runtime.spec import RunSpec

    spec = RunSpec.from_config(entry.cfg, vertex_axis=entry.vertex_axis)
    planned_old = entry.planned_matrix()
    kw = {}
    if isinstance(planned_old, launch_mesh.Placement):
        if backend.name == "mesh":
            kw["mesh"] = entry.mesh
        else:   # an explicit serial repair of a device entry runs on the controller
            planned_old = planned_old.gather()
    planned_new, sweeps, swept = backend.repair_plan_shards(
        new_g, spec, entry.x, planned_old, entry.plan, touched, **kw)
    old_banks = list(entry.banks)
    entry.set_planned_matrix(planned_new)
    if entry.residency == "device":
        banks_touched = sum(old_banks[0].placement.changed_columns(
            entry.banks[0].placement, entry.num_banks))
        return sweeps, banks_touched, swept   # its queries never read edge operands
    banks_touched = sum(1 for b_old, b_new in zip(old_banks, entry.banks)
                        if not torch.equal(b_old, b_new))
    # the serving cache gets the new graph's operands (the version moved)
    with trace.span("delta.edge_operands", phase="repair") as sp:
        sp.sync(entry.prime_edges_cache())
    return sweeps, banks_touched, swept


def _repair_insertions(entry: StoreEntry, new_g: Graph, delta: GraphDelta):
    """Monotone insertion repair, bank by bank, on the entry's device.
    Returns (sweeps, banks touched). A stale entry is repaired too: its
    matrix stays a sound over-approximation."""
    if entry.residency == "device":
        raise ValueError("a device-resident entry repairs plan shards on its mesh, "
                         "not bank by bank")
    cfg = entry.cfg
    model = resolve_model(cfg.model)
    dev = entry.device
    with trace.span("delta.edge_operands", phase="repair") as sp:
        ep = model.edge_params(new_g, seed=cfg.seed)
        # the serving cache gets the new graph's operands (the version moved)
        full = sp.sync(entry.prime_edges_cache(EdgeOperands.from_numpy(
            new_g.src, new_g.dst, ep.h, ep.lo, ep.thr, new_g.n_pad, dev)))
    with trace.span("delta.touched_edges", phase="repair"):
        touched = _touched_edges(new_g, delta, ep)
    if touched is None:
        return 0, 0
    probe_edges = EdgeOperands.from_numpy(*touched, new_g.n_pad, dev)
    j_loc = entry.regs_per_bank
    sweeps = banks_touched = 0
    new_banks = []
    for b, m_b in enumerate(entry.banks):
        x_b = x_tensor(entry.x[b * j_loc:(b + 1) * j_loc], dev)
        m_pad = pad_columns(m_b, j_loc)
        m_probe, _ = ops.propagate_sweep(m_pad, probe_edges, x_b, variant=model.variant)
        if torch.equal(m_probe, m_pad):
            new_banks.append(m_b)   # no sample of this bank uses the new edges
            continue
        banks_touched += 1
        m_fix, iters = propagate_to_fixpoint(m_probe, full, x_b, variant=model.variant,
                                             max_iters=cfg.max_propagate_iters)
        sweeps += iters + 1
        new_banks.append(real_columns(m_fix, j_loc))
    entry.banks = new_banks
    return sweeps, banks_touched
