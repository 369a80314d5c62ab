"""Load-balanced partition planning for the 2-D shard grid.

Counterpart of the reference's ``partition/plan.py``. A ``PartitionPlan`` is
a relabeling permutation of the vertex ids such that the contiguous split of
the relabeled ids over ``mu_v`` vertex shards balances the per-shard edge
work. Register hashes, validity and seeds go through ``owned_ids``
(relabeled row -> original id), so results do not depend on the plan.

Strategies (a registry): ``block`` (identity), ``degree`` (LPT bin-packing
on the sampled out+in degree, the paper's balancing analogue), ``edge``
(greedy on the per-(write shard, ring step) bucket loads; a Python loop,
too slow for millions of vertices) and ``random`` (seeded, balanced).

Planning is host numpy, as in the reference, and gives the same ``perm``
byte for byte. ``sample_edge_sets`` runs the FASST sampling on a device
(``kernels.ops.fused_sample``) and keeps each shard's sampled edge ids and
the edge operands there for the bucket builder.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fasst import _bits, partition_samples, sampled_by_any
from repro_torch.device import resolve_device
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.obs import metrics, trace
from repro_torch.partition.cost import PlanStats, predicted_stats


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A vertex relabeling that the 2-D partition builder keys on.

    ``perm`` maps original ids to relabeled ids over ``[0, n_pad)`` (``n_pad``
    rounded so ``mu_v | n_pad``); shard ``v`` owns relabeled rows
    ``[v * n_loc, (v + 1) * n_loc)``; ``inv_perm`` is the inverse. Padding
    ids (>= n) fill the leftover slots."""

    strategy: str
    n: int
    n_pad: int
    n_loc: int
    mu_v: int
    mu_s: int
    perm: np.ndarray       # int32[n_pad] original id -> relabeled id
    inv_perm: np.ndarray   # int32[n_pad] relabeled id -> original id
    predicted: Optional[PlanStats] = None

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning vertex shard of each original vertex id."""
        return (self.perm[np.asarray(ids, dtype=np.int64)] // self.n_loc).astype(np.int32)

    def local_row_of(self, ids: np.ndarray) -> np.ndarray:
        """Row of each original vertex id within its owning shard's block."""
        return (self.perm[np.asarray(ids, dtype=np.int64)] % self.n_loc).astype(np.int32)

    def owned_ids(self) -> np.ndarray:
        """int32[mu_v, n_loc] original vertex id per (shard, local row)."""
        return self.inv_perm.reshape(self.mu_v, self.n_loc)

    def validate(self, g: Graph) -> None:
        if g.n != self.n:
            raise ValueError(f"plan built for n={self.n}, graph has n={g.n}")

    @staticmethod
    def from_permutation(n: int, mu_v: int, mu_s: int, perm: np.ndarray, *,
                         strategy: str = "custom") -> "PartitionPlan":
        """A plan from a saved permutation of ``[0, len(perm))``, ``mu_v``
        dividing ``len(perm)`` (the store snapshot path)."""
        perm = np.asarray(perm, dtype=np.int32)
        n_pad = perm.shape[0]
        if n_pad % mu_v != 0:
            raise ValueError(f"len(perm)={n_pad} not divisible by mu_v={mu_v}")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_pad, dtype=np.int32)
        return PartitionPlan(strategy=strategy, n=n, n_pad=n_pad, n_loc=n_pad // mu_v,
                             mu_v=mu_v, mu_s=mu_s, perm=perm, inv_perm=inv)


@dataclasses.dataclass(frozen=True)
class SampledEdges:
    """The preprocessing the planner and the bucket builder share: the
    model's ``EdgeParams`` (host numpy) and its operands as int32 bit
    patterns on the device, the FASST sample chunks and each sim shard's
    sampled edge ids (int64, ascending, on the device)."""

    ep: object             # diffusion EdgeParams (h, lo, thr)
    x_shards: np.ndarray   # uint32[mu_s, j_loc]
    masks: tuple           # per sim shard: int64 tensor of sampled edge ids
    h: torch.Tensor
    lo: torch.Tensor
    thr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.h.device


@trace.traced("partition.sample_edge_sets", phase="plan", sync=True)
def sample_edge_sets(g: Graph, x: np.ndarray, mu_s: int, *, seed: int = 0,
                     model: str = "wc", method: str = "fasst",
                     device=None) -> SampledEdges:
    """Each sim shard's sampled edge set (edges live under at least one of
    its samples), on ``device`` (CUDA unless ``"cpu"`` is passed), in a
    ``partition.sample_edge_sets`` span (the port's; the reference has
    none here)."""
    dev = resolve_device(device)
    mdl = resolve_model(model)
    ep = mdl.edge_params(g, seed=seed)
    x_shards, _ = partition_samples(np.asarray(x, dtype=np.uint32), mu_s, method=method)
    h, lo, thr = _bits(ep.h, dev), _bits(ep.lo, dev), _bits(ep.thr, dev)
    masks = tuple(
        torch.nonzero(sampled_by_any(h, lo, thr, _bits(x_shards[s], dev),
                                     variant=mdl.variant)).flatten()
        for s in range(mu_s))
    return SampledEdges(ep=ep, x_shards=x_shards, masks=masks, h=h, lo=lo, thr=thr)


def _edge_multiplicity(g: Graph, x: Optional[np.ndarray], mu_s: int, *, seed: int,
                       model: str, method: str, sampled: Optional[SampledEdges],
                       device) -> np.ndarray:
    """int64[m_real]: how many sim shards sample each edge, or 1 per real
    edge when no sample vector is given."""
    if sampled is None:
        if x is None:
            return np.ones(g.m_real, dtype=np.int64)
        sampled = sample_edge_sets(g, x, mu_s, seed=seed, model=model, method=method,
                                   device=device)
    c = torch.bincount(torch.cat(sampled.masks), minlength=g.m)
    return c[: g.m_real].cpu().numpy().astype(np.int64)


def _vertex_weights(g: Graph, c_e: np.ndarray) -> np.ndarray:
    """int64[n] sampled out+in degree."""
    src = g.src[: g.m_real].astype(np.int64)
    dst = g.dst[: g.m_real].astype(np.int64)
    w = np.bincount(src, weights=c_e, minlength=g.n)
    w += np.bincount(dst, weights=c_e, minlength=g.n)
    return w.astype(np.int64)


# ----------------------------------------------------- assignment strategies ----
# each returns int32[n] owner per real vertex, at most n_loc per owner

def _assign_block(g: Graph, c_e, w_v, mu_v: int, n_loc: int, seed: int) -> np.ndarray:
    return (np.arange(g.n, dtype=np.int64) // n_loc).astype(np.int32)


def _assign_random(g: Graph, c_e, w_v, mu_v: int, n_loc: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shuffled = rng.permutation(g.n)
    owner = np.empty(g.n, dtype=np.int32)
    owner[shuffled] = (np.arange(g.n, dtype=np.int64) // n_loc).astype(np.int32)
    return owner


def _assign_degree(g: Graph, c_e, w_v, mu_v: int, n_loc: int, seed: int) -> np.ndarray:
    """LPT bin-packing with per-bin capacity: heaviest vertex first into the
    lightest non-full bin; ties break by bin index. The loop runs on Python
    ints (one pass over the vertices)."""
    owner = [0] * g.n
    counts = [0] * mu_v
    heap = [(0, b) for b in range(mu_v)]  # (load, bin)
    heapq.heapify(heap)
    weights = w_v.tolist()
    for v in np.argsort(-w_v, kind="stable").tolist():
        while True:
            load, b = heapq.heappop(heap)
            if counts[b] < n_loc:
                break  # a full bin stays full: its entry is dropped for good
        owner[v] = b
        counts[b] += 1
        heapq.heappush(heap, (load + weights[v], b))
    return np.asarray(owner, dtype=np.int32)


def _assign_edge(g: Graph, c_e, w_v, mu_v: int, n_loc: int, seed: int) -> np.ndarray:
    """Greedy over vertices in descending weight: place each vertex in the
    non-full bin that minimizes the peak load over every bucket its placed
    neighborhood touches (its own write buckets and its neighbors')."""
    n = g.n
    src = g.src[: g.m_real].astype(np.int64)
    dst = g.dst[: g.m_real].astype(np.int64)
    out_order = np.argsort(src, kind="stable")
    out_ptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))]).astype(np.int64)
    out_nbr = dst[out_order]
    out_w = c_e[out_order].astype(np.float64)
    in_order = np.argsort(dst, kind="stable")
    in_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))]).astype(np.int64)
    in_nbr = src[in_order]
    in_w = c_e[in_order].astype(np.float64)

    owner = np.full(n, -1, dtype=np.int32)
    counts = np.zeros(mu_v, dtype=np.int64)
    prop = np.zeros((mu_v, mu_v), dtype=np.float64)  # [write shard, ring step]
    casc = np.zeros((mu_v, mu_v), dtype=np.float64)
    steps = np.arange(mu_v)
    own_at_step = (steps[:, None] + steps[None, :]) % mu_v   # [b, k] -> o
    step_of_bin = (steps[None, :] - steps[:, None]) % mu_v   # [o, b] -> k

    for v in np.argsort(-w_v, kind="stable"):
        oo = owner[out_nbr[out_ptr[v]: out_ptr[v + 1]]]
        ow = out_w[out_ptr[v]: out_ptr[v + 1]]
        sel = oo >= 0
        out_by = np.bincount(oo[sel], weights=ow[sel], minlength=mu_v)
        io = owner[in_nbr[in_ptr[v]: in_ptr[v + 1]]]
        iw = in_w[in_ptr[v]: in_ptr[v + 1]]
        sel = io >= 0
        in_by = np.bincount(io[sel], weights=iw[sel], minlength=mu_v)
        peak_own = np.maximum(prop + out_by[own_at_step],
                              casc + in_by[own_at_step]).max(axis=1)
        peak_other = np.maximum(prop[steps[:, None], step_of_bin] + in_by[:, None],
                                casc[steps[:, None], step_of_bin] + out_by[:, None]).max(axis=0)
        peak = np.maximum(peak_own, peak_other)
        tie = prop.sum(axis=1) + casc.sum(axis=1)  # prefer the lighter bin
        peak[counts >= n_loc] = np.inf
        b = int(np.lexsort((steps, tie, peak))[0])

        owner[v] = b
        counts[b] += 1
        prop[b] += out_by[own_at_step[b]]
        casc[b] += in_by[own_at_step[b]]
        np.add.at(prop, (steps, step_of_bin[:, b]), in_by)
        np.add.at(casc, (steps, step_of_bin[:, b]), out_by)
    return owner


_STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str, fn: Callable) -> None:
    """Register ``fn(g, c_e, w_v, mu_v, n_loc, seed) -> int32[n]`` owners."""
    if name in _STRATEGIES:
        raise ValueError(f"partition strategy {name!r} already registered")
    _STRATEGIES[name] = fn


def available_strategies() -> Tuple[str, ...]:
    return tuple(_STRATEGIES)


register_strategy("block", _assign_block)
register_strategy("degree", _assign_degree)
register_strategy("edge", _assign_edge)
register_strategy("random", _assign_random)


def plan_partition(g: Graph, mu_v: int, *, mu_s: int = 1, strategy: str = "block",
                   x: Optional[np.ndarray] = None, seed: int = 0, model: str = "wc",
                   method: str = "fasst", sampled: Optional[SampledEdges] = None,
                   device=None) -> PartitionPlan:
    """A ``PartitionPlan`` for a ``(mu_v, mu_s)`` grid. ``sampled`` (or
    ``x``, which samples on ``device``) weights each edge by the sim shards
    that sample it; without either, plain degrees are used. The plan carries
    its predicted ``PlanStats``, which also set the ``partition.*`` gauges;
    the planning runs in a ``partition.plan`` span."""
    _strategy(strategy)
    c_e = _edge_multiplicity(g, x, mu_s, seed=seed, model=model, method=method,
                             sampled=sampled, device=device)
    if sampled is not None:
        j_loc = int(sampled.x_shards.shape[1])
    else:
        j_loc = (np.asarray(x).shape[0] // mu_s) if x is not None else 0
    return _plan_from_multiplicity(g, mu_v, c_e, mu_s=mu_s, strategy=strategy,
                                   j_loc=j_loc, seed=seed)


def _strategy(name: str) -> Callable:
    fn = _STRATEGIES.get(name)
    if fn is None:
        raise KeyError(f"unknown partition strategy {name!r}; "
                       f"registered: {sorted(_STRATEGIES)}")
    return fn


def _plan_from_multiplicity(g: Graph, mu_v: int, c_e: np.ndarray, *, mu_s: int,
                            strategy: str, j_loc: int, seed: int = 0) -> PartitionPlan:
    """``plan_partition`` from each real edge's sim-shard multiplicity
    (``c_e``, int64[m_real]), as a mesh rank plans from the counts of its
    chunked sample sets."""
    fn = _strategy(strategy)
    with trace.span("partition.plan", phase="plan", strategy=strategy, mu_v=mu_v,
                    mu_s=mu_s, n=g.n):
        n_pad = g.n_pad + ((-g.n_pad) % mu_v)
        n_loc = n_pad // mu_v
        w_v = _vertex_weights(g, c_e)
        owner = np.asarray(fn(g, c_e, w_v, mu_v, n_loc, seed), dtype=np.int64)
        if owner.shape[0] != g.n:
            raise ValueError(f"strategy {strategy!r} assigned {owner.shape[0]} "
                             f"vertices, expected {g.n}")
        counts = np.bincount(owner, minlength=mu_v)
        if counts.max(initial=0) > n_loc:
            raise ValueError(f"strategy {strategy!r} overfilled a shard: "
                             f"{counts.tolist()} vs capacity {n_loc}")
        # padding ids fill the leftover slots, ascending id into ascending shard;
        # the stable sort keeps ascending original id within each shard
        pad_owner = np.repeat(np.arange(mu_v, dtype=np.int64), n_loc - counts)
        inv_perm = np.argsort(np.concatenate([owner, pad_owner]), kind="stable").astype(np.int32)
        perm = np.empty_like(inv_perm)
        perm[inv_perm] = np.arange(n_pad, dtype=np.int32)
        stats = predicted_stats(g, strategy, perm, c_e, mu_v, mu_s, n_loc, j_loc)
    metrics.gauge("partition.ring_bytes_per_sweep",
                  strategy=strategy).set(stats.ring_bytes_per_sweep)
    metrics.gauge("partition.edge_imbalance", strategy=strategy).set(stats.edge_imbalance)
    metrics.gauge("partition.bucket_imbalance",
                  strategy=strategy).set(stats.bucket_imbalance)
    return PartitionPlan(strategy=strategy, n=g.n, n_pad=n_pad, n_loc=n_loc,
                         mu_v=mu_v, mu_s=mu_s, perm=perm, inv_perm=inv_perm,
                         predicted=stats)
