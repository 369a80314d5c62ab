"""Incremental repair of a resident index after a graph delta.

Counterpart of the reference's ``service/delta.py`` (the per-bank repair).
Edge insertions need no rebuild: registers form a max-merge lattice and new
edges only grow each simulation's reachable sets, so the old fixpoint lies
below the new one and monotone sweeps climb the rest of the way. Per bank,
one propagate sweep over the touched edges alone (the probe) decides whether
anything changed; only then does a full fixpoint run, from the probe's
matrix, so it ends in about as many sweeps as the change spreads.

Removals cannot un-merge registers, so they accrue staleness: the matrix
over-estimates until the removed fraction passes ``staleness_threshold``,
when a pristine rebuild runs. Below it the entry is only marked stale, and
``queries.top_k_seeds`` rebuilds it on the first top-k query.

Both fast paths need ``context_free_edges`` (``diffusion.models``): under
lt any delta rebuilds.

The reference also repairs only the plan shards a delta dirtied, on its
``serial`` backend. The port does not have that repair yet (ROADMAP §1.3):
a request for it raises ``NotImplementedError``.

Each call runs in a ``delta.apply`` span (the ``repair`` lane) and lands in
the ``delta.*`` metrics (sweeps, seconds, rebuilds).
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


def _wants_shard_repair(backend, entry: StoreEntry, plan_shards: tuple) -> bool:
    """Whether the reference would repair only the dirtied plan shards: a
    plan attached, shards touched, and ``backend`` "auto" or the ring's."""
    if backend is None or entry.plan is None or not plan_shards:
        return False
    if backend == "auto":
        return True
    from repro_torch.runtime import get_backend

    return get_backend(backend).name == "serial"


def apply_delta(store: SketchStore, key: StoreKey, delta: GraphDelta, *,
                staleness_threshold: float = 0.1, backend=None) -> DeltaReport:
    """Apply edge insertions and removals to a resident entry, repairing or
    invalidating its matrix as cheaply as soundness allows.

    The entry's graph always follows the delta; its key stays (the key
    names the lineage, so engine handles stay valid). ``staleness_threshold``
    is the removed-edge fraction past which removals rebuild at once; it is
    not ``DiFuserConfig.rebuild_threshold``, Alg. 4's per-round epsilon.

    ``backend``: ``None`` or the name of a backend without shard repair
    runs the per-bank repair. Where the reference would repair shard by shard
    (``"auto"`` or ``"serial"``, with a plan attached and shards touched),
    this raises ``NotImplementedError`` before anything changes.
    """
    with trace.span("delta.apply", phase="repair", timed=True, added=delta.num_added,
                    removals=delta.num_removed) as sp:
        rep = _apply(store, key, delta, staleness_threshold, backend)
        sp.annotate(rebuilt=rep.rebuilt, sweeps=rep.repair_sweeps, backend="single")
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
    staleness = entry.staleness_frac + removed / max(m_before, 1)
    rebuilds = bool(removed) and (not context_free or staleness > staleness_threshold)
    if (delta.num_added and not rebuilds and context_free
            and _wants_shard_repair(backend, entry, plan_shards)):
        raise NotImplementedError(
            "the shard-restricted insertion repair (the reference's serial "
            "repair_plan_shards) is not ported yet (ROADMAP §1.3); pass "
            "backend=None for the per-bank repair")

    new_g = g.apply_delta(delta).sorted_by_dst()
    entry.graph = new_g
    entry.version += 1
    rebuilt = False
    repair_sweeps = banks_touched = 0
    if removed:
        entry.staleness_frac = staleness
        if rebuilds:
            store.rebuild(key)      # clears the staleness, bumps the version
            rebuilt = True
        else:
            entry.stale = True
    if delta.num_added and not rebuilt:
        if context_free:
            repair_sweeps, banks_touched = _repair_insertions(entry, new_g, delta)
        else:
            store.rebuild(key)
            rebuilt = True
    return DeltaReport(added=delta.num_added, removed=removed, rebuilt=rebuilt,
                       stale=entry.stale, staleness_frac=entry.staleness_frac,
                       repair_sweeps=repair_sweeps, banks_touched=banks_touched,
                       time_s=0.0, plan_shards_touched=plan_shards)


def _repair_insertions(entry: StoreEntry, new_g: Graph, delta: GraphDelta):
    """Monotone insertion repair, bank by bank, on the entry's device.
    Returns (sweeps, banks touched). A stale entry is repaired too: its
    matrix stays a sound over-approximation."""
    cfg = entry.cfg
    model = resolve_model(cfg.model)
    ep = model.edge_params(new_g, seed=cfg.seed)
    touched = _touched_edges(new_g, delta, ep)
    dev = entry.device
    # the serving cache gets the new graph's operands (the version moved)
    full = entry.prime_edges_cache(EdgeOperands.from_numpy(
        new_g.src, new_g.dst, ep.h, ep.lo, ep.thr, new_g.n_pad, dev))
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
