"""The measuring half of ``repro_torch.tune``: time candidates, pick winners.

Counterpart of the reference's ``tune/autotuner.py``. Each candidate runs
inside a ``trace.span("tune.trial", timed=True)`` whose output is declared
with ``sp.sync`` (the current stream is synchronized inside the span, so
queueing is not taken for execution), and each trial is annotated with its
achieved GB/s and share of the bandwidth roof
(``utils.roofline.annotate_bandwidth``). The winner is the candidate of the
least min-of-N time; every trial also lands in the ``tune.*`` metrics, which
the HTML report (``obs.report``) shows beside the cache.

Candidates run on the device the caller names (CUDA by default): on the card
the kernels, on the CPU their plain versions; a CUDA measurement never times
a plain version. The libraries of every candidate's block shape are built
(``kernels.build.build``) before the first trial, so no trial times ``nvcc``.
Each candidate's work lists are made before the timed window.

``resolve_spec`` is the hook the backends call (``runtime.base.apply_tuning``):
``"off"`` returns the spec itself; ``"cached"`` overlays the cache's winners
and keeps the spec's own values on a miss; ``"auto"`` measures a miss on the
actual graph, persists the winner and overlays it. All of it is
performance-only: seeds and matrices are the same in every mode.

The ring-schedule family (``bucket_propagate``) is seeded from the planner's
``PlanStats`` and the last published ``MeasuredProfile``
(``config.schedule_candidates``); its probe, the serial ring's build,
publishes a fresh profile.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.kernels.edges import ITEM_WARPS, EdgeOperands, with_work
from repro_torch.obs import metrics, shardprof, trace
from repro_torch.tune.cache import TuningCache, cache_key, default_cache
from repro_torch.tune.config import (KernelConfig, default_config, fused_candidates,
                                     schedule_candidates, spec_overrides,
                                     sweep_candidates)
from repro_torch.utils import roofline

#: timing repetitions per candidate (min-of-N)
TRIALS = 3

#: sweeps the fused_sweep family is timed at: back-to-back sweeps fused
#: against looped, the local_sweeps values schedule_candidates offers (1-2)
FUSED_PROBE_SWEEPS = 2

#: the kernel sources each family's probe launches (built before its trials)
_FAMILY_SOURCES = {
    "sketch_propagate": ("sketch_fill", "sketch_propagate"),
    "cascade_step": ("sketch_fill", "cascade_step"),
    "fused_sample": ("sketch_fill", "fused_sample"),
    "fused_sweep": ("sketch_fill", "sketch_propagate", "fused_sweep"),
    "bucket_propagate": ("sketch_fill", "fused_sample", "bucket_propagate", "fused_sweep"),
}


def _time_grid(fns, labels, *, family: str, nbytes: int, trials: int = TRIALS,
               warmup: int = 1):
    """min-of-N wall seconds per candidate, trials interleaved round-robin
    (warm-up drift within a process is monotone, so blocks of trials would
    favour whichever candidate ran last). Every trial runs in a timed
    ``tune.trial`` span that syncs the candidate's output and carries its
    GB/s. Returns ``[(seconds, gbps), ...]``."""
    for fn in fns:
        for _ in range(max(warmup, 0)):
            fn()
    best = [math.inf] * len(fns)
    for _ in range(max(trials, 1)):
        for i, fn in enumerate(fns):
            with trace.span("tune.trial", phase="other", timed=True,
                            family=family, candidate=labels[i]) as sp:
                sp.sync(fn())
            best[i] = min(best[i], sp.duration_s)
            roofline.annotate_bandwidth(sp, nbytes, sp.duration_s)
    return [(s, (nbytes / s / 1e9) if s > 0 and nbytes > 0 else 0.0) for s in best]


def _publish(family: str, backend: str, label: str, seconds: float, gbps: float) -> None:
    metrics.counter("tune.trials", family=family, backend=backend).inc()
    metrics.gauge("tune.candidate_us", family=family, backend=backend,
                  candidate=label).set(seconds * 1e6)
    if gbps:
        metrics.gauge("tune.candidate_gbps", family=family, backend=backend,
                      candidate=label).set(round(gbps, 3))


def _measurement_record(family: str, backend: str, results) -> dict:
    """The evidence the cache keeps: each candidate's time, and the default
    against the winner. ``results`` is ``[(config, label, seconds, gbps)]``
    with the default first."""
    default_s = results[0][2]
    best = min(results, key=lambda r: r[2])
    return {
        "family": family, "backend": backend,
        "default_us": round(default_s * 1e6, 3),
        "tuned_us": round(best[2] * 1e6, 3),
        "tuned_gbps": round(best[3], 3),
        "frac_of_roof": round(best[3] * 1e9 / roofline.HBM_BW, 6),
        "speedup": round(default_s / best[2], 4) if best[2] > 0 else 1.0,
        "candidates": [
            {"label": lab, "config": cfg.to_dict(),
             "us": round(s * 1e6, 3), "gbps": round(g, 3)}
            for cfg, lab, s, g in results],
    }


def _finish(family: str, backend: str, cands, labels, timings):
    """Publish every trial, and return ``(winner, record)``."""
    results = []
    for c, label, (sec, gbps) in zip(cands, labels, timings):
        _publish(family, backend, label, sec, gbps)
        results.append((c, label, sec, gbps))
    record = _measurement_record(family, backend, results)
    metrics.gauge("tune.speedup", family=family, backend=backend).set(record["speedup"])
    return min(results, key=lambda r: r[2])[0], record


def _ready_kernels(device, family: str, warps=()) -> None:
    """Build (and load) the libraries ``family``'s probe launches on the
    card, at every block shape of ``warps``, before any trial."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build

    build.build(_FAMILY_SOURCES[family], warps=tuple(warps) or (ITEM_WARPS,))
    for w in warps:
        build.load(family, w)


# --------------------------------------------------- single-path sweeps ----


@dataclasses.dataclass
class SweepOperands:
    """A sweep probe's inputs on the device: the graph's edges (default work
    lists), x, a filled register matrix (with one VISITED row for the
    cascade) and the predicate form."""

    edges: EdgeOperands
    x: object
    m: object
    variant: int


def sweep_operands(g, spec, family: str, *, device=None) -> SweepOperands:
    """The operands of ``family``'s probe at ``spec``'s sketch setting: the
    graph normalized and lowered as the single driver does, and the fill of
    its register matrix."""
    from repro_torch.core import difuser as _difuser
    from repro_torch.diffusion import resolve
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    cfg = spec.difuser_config()
    g2, x = _difuser.normalize_inputs(g, cfg)
    edges = _difuser.edge_operands(g2, cfg, dev)
    m = _difuser._init_registers(g2.n_pad, g2.n, cfg.num_registers, dev)
    m = ops.sketch_fill(m, seed=cfg.seed)
    if family == "cascade_step":
        m[0] = -1                  # a VISITED row, so the sweep has work
    return SweepOperands(edges=edges, x=_difuser.x_tensor(x, dev), m=m,
                         variant=resolve(cfg.model).variant)


def with_geometry(edges: EdgeOperands, family: str, c: KernelConfig) -> EdgeOperands:
    """``edges`` with the work list ``family``'s sweep walks recut at ``c``'s
    geometry (``by_src`` for the propagate sweep, ``by_dst`` for the
    cascade)."""
    item_edges, item_warps = c.geometry()
    order = "by_dst" if family == "cascade_step" else "by_src"
    rows = with_work(getattr(edges, order), item_edges, item_warps)
    return dataclasses.replace(edges, **{order: rows})


def sweep_bytes(op: SweepOperands) -> int:
    """The bytes one work-item sweep of ``op`` moves: each edge's 16 B of
    operands (``nbr``, ``h``, ``lo``, ``thr``) and the register row it
    gathers, and one read and one write of the matrix. (The reference counts
    an edge-wise merge's bytes, ``obs.shardprof.bucket_bytes``: a gather and
    a write a register of every edge, which would put a sweep of this walk
    above the memory roof.) Gathers of rows many edges read come from L2, so
    the share of the device-memory roof can pass 1.0."""
    n_rows, num_regs = op.m.shape
    return op.edges.num_edges * (16 + num_regs) + 2 * n_rows * num_regs


def sweep_label(c: KernelConfig) -> str:
    item_edges, item_warps = c.geometry()
    return f"ie{item_edges}.w{item_warps}"


def sweep_call(op: SweepOperands, family: str, c: KernelConfig):
    """A no-argument call of one ``family`` sweep at ``c``'s geometry (its
    work list made now, outside any timing); it returns the output matrix."""
    from repro_torch.kernels import ops

    if family == "fused_sample":
        e = op.edges
        return lambda: ops.fused_sample(e.h, e.lo, e.thr, op.x, variant=op.variant)
    e = with_geometry(op.edges, family, c)
    if family == "sketch_propagate":
        return lambda: ops.propagate_sweep(op.m, e, op.x, variant=op.variant)[0]
    if family == "cascade_step":
        return lambda: ops.cascade_sweep(op.m, e, op.x, variant=op.variant)[0]
    raise ValueError(f"unknown sweep family {family!r}")


def measure_sweep_family(g, spec, family: str, *, backend: str = "single",
                         candidates=None, device=None) -> Tuple[KernelConfig, dict]:
    """Time one sweep of ``family`` per candidate on the actual graph.
    Returns ``(winning config, measurement record)``; the default is always
    candidate 0, so the record's ``speedup`` is tuned against today's."""
    dev = resolve_device(device)
    op = sweep_operands(g, spec, family, device=dev)
    if candidates is None:
        # fused_sample has no geometry knob
        candidates = () if family == "fused_sample" else sweep_candidates(op.edges.num_edges)
    base = default_config(family)
    cands = [base] + [c for c in candidates if c != base]
    warps = sorted({c.geometry()[1] for c in cands}) if family != "fused_sample" else []
    _ready_kernels(dev, family, warps)
    nbytes = sweep_bytes(op)
    labels = [sweep_label(c) for c in cands]
    timings = _time_grid([sweep_call(op, family, c) for c in cands], labels,
                         family=family, nbytes=nbytes)
    return _finish(family, backend, cands, labels, timings)


# ------------------------------------------- the fused multi-sweep kernel ----


def measure_fused_family(g, spec, *, backend: str = "serial", candidates=None,
                         device=None) -> Tuple[KernelConfig, dict]:
    """Time ``FUSED_PROBE_SWEEPS`` back-to-back propagate sweeps per
    candidate on the actual graph. Candidate 0 is today's behaviour, one
    ``propagate_sweep`` call a sweep; the fused candidates run the same
    sweeps through one ``ops.fused_sweep`` call over the source-grouped rows
    at their lane fill (``fused_candidates``: model-aware, from the register
    width and the last measured profile)."""
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    op = sweep_operands(g, spec, "fused_sweep", device=dev)
    num_regs = int(spec.num_registers)
    if candidates is None:
        candidates = fused_candidates(None, shardprof.last_profile(), model=spec.model,
                                      num_regs=num_regs)
    base = default_config("fused_sweep")           # fuse_sweeps=False: the loop
    cands = [base] + [c for c in candidates if c != base]
    _ready_kernels(dev, "fused_sweep")
    sweeps = FUSED_PROBE_SWEEPS
    nbytes = sweep_bytes(op) * sweeps

    def make_fn(c: KernelConfig):
        if not c.fuse_sweeps:
            def loop():
                mm = op.m
                for _ in range(sweeps):
                    mm = ops.propagate_sweep(mm, op.edges, op.x, variant=op.variant)[0]
                return mm

            return loop
        return lambda: ops.fused_sweep(op.m, op.edges.by_src, op.x, variant=op.variant,
                                       num_sweeps=sweeps, lane_fill=c.lane_fill)

    labels = [f"fused.lf{c.lane_fill or 0}" if c.fuse_sweeps else "loop" for c in cands]
    timings = _time_grid([make_fn(c) for c in cands], labels, family="fused_sweep",
                         nbytes=nbytes)
    return _finish("fused_sweep", backend, cands, labels, timings)


# ------------------------------------------------ the ring schedule ----


def measure_schedule_family(g, spec, *, backend: str = "serial", candidates=None,
                            device=None) -> Tuple[KernelConfig, dict]:
    """Time the serial ring's build per ``(local_sweeps, pad_mode)``
    candidate (``partition.serial.build_matrix_ring_serial``). The plan is
    made once, weighted by the run's own samples as the ring's driver makes
    it, and shared by every candidate; each candidate re-buckets (the pad
    mode changes the buckets). Candidates come from the plan's predicted
    ``PlanStats`` and the last published profile; the default
    ``(0, spec.pad_mode)`` is candidate 0."""
    from repro_torch.core.sampling import make_x_vector
    from repro_torch.partition.plan import plan_partition
    from repro_torch.partition.serial import build_matrix_ring_serial

    dev = resolve_device(device)
    cfg = spec.difuser_config()
    g2 = g.sorted_by_dst()
    mu_v, mu_s = max(spec.mu_v, 1), max(spec.mu_s, 1)
    x = np.sort(np.asarray(make_x_vector(cfg.num_registers, seed=cfg.seed),
                           dtype=np.uint32))
    _ready_kernels(dev, "bucket_propagate")
    plan = plan_partition(g2, mu_v, mu_s=mu_s, strategy=spec.partition, x=x,
                          seed=cfg.seed, model=cfg.model, device=dev)
    if candidates is None:
        candidates = schedule_candidates(plan.predicted, shardprof.last_profile(),
                                         pad_mode=spec.pad_mode)
    base = KernelConfig(local_sweeps=0, pad_mode=spec.pad_mode)
    cands = [base] + [c for c in candidates if c != base]
    nbytes = shardprof.bucket_bytes(int(g2.m), int(cfg.num_registers))

    def make_fn(c: KernelConfig):
        return lambda: build_matrix_ring_serial(
            g2, cfg, x, mu_v=mu_v, mu_s=mu_s, strategy=spec.partition, plan=plan,
            pad_mode=c.pad_mode, local_sweeps=c.local_sweeps, device=dev)[0]

    labels = [f"ls{c.local_sweeps}.{c.pad_mode}" for c in cands]
    timings = _time_grid([make_fn(c) for c in cands], labels, family="bucket_propagate",
                         nbytes=nbytes, trials=2, warmup=0)
    return _finish("bucket_propagate", backend, cands, labels, timings)


# ------------------------------------------------------- the runtime hook ----


def families_for(spec, backend: str) -> Tuple[str, ...]:
    """The kernel families a backend's run launches with a tunable knob."""
    if backend == "single":
        return ("sketch_propagate", "cascade_step")
    if backend in ("serial", "mesh") and spec.num_shards > 1:
        # bucket_propagate picks (local_sweeps, pad_mode), fused_sweep whether
        # those sweeps run fused (disjoint spec fields: the merge is order-free)
        return ("bucket_propagate", "fused_sweep")
    return ()


def _measure_family(family: str, g, spec, backend: str, device):
    if family in ("sketch_propagate", "cascade_step", "fused_sample"):
        return measure_sweep_family(g, spec, family, backend=backend, device=device)
    if family == "bucket_propagate":
        return measure_schedule_family(g, spec, backend=backend, device=device)
    if family == "fused_sweep":
        return measure_fused_family(g, spec, backend=backend, device=device)
    raise ValueError(f"unknown kernel family {family!r}")


def _key(family: str, g, spec, backend: str, device) -> str:
    return cache_key(family, backend=backend, impl=device.type, model=spec.model,
                     num_edges=int(g.m))


def resolve_spec(g, spec, *, backend: str, cache: Optional[TuningCache] = None,
                 device=None):
    """``spec`` with the measured winners for this (graph, backend, device)
    overlaid per ``spec.tuning``: ``"off"`` (or no graph) returns ``spec``
    itself; ``"cached"`` overlays cache hits and keeps the spec's own values
    on a miss; ``"auto"`` measures a miss, persists it and overlays it. Any
    other mode raises. Counts ``tune.cache_hit`` and ``tune.cache_miss``."""
    mode = spec.tuning
    if mode == "off" or g is None:
        return spec
    if mode not in ("cached", "auto"):
        raise ValueError(f"unknown tuning mode {mode!r} (expected 'off' | 'cached' | 'auto')")
    dev = resolve_device(device)
    cache = cache if cache is not None else default_cache()
    overrides: Dict[str, object] = {}
    for family in families_for(spec, backend):
        key = _key(family, g, spec, backend, dev)
        cfg = cache.lookup(key)
        if cfg is None:
            metrics.counter("tune.cache_miss", family=family, backend=backend).inc()
            if mode != "auto":
                continue                       # the spec's own values
            with trace.span("tune.measure", phase="plan", family=family,
                            backend=backend, timed=True):
                cfg, record = _measure_family(family, g, spec, backend, dev)
            cache.put(key, cfg, measurement=record)
            cache.save()
        else:
            metrics.counter("tune.cache_hit", family=family, backend=backend).inc()
        overrides.update(spec_overrides(family, cfg, spec))
    return spec.with_(**overrides) if overrides else spec


def autotune(g, spec, *, backend: str = "single",
             families: Optional[Tuple[str, ...]] = None,
             cache: Optional[TuningCache] = None, device=None) -> Dict[str, dict]:
    """Measure every family of ``families`` (default: ``families_for``) now
    and persist the winners. Returns family -> measurement record."""
    dev = resolve_device(device)
    cache = cache if cache is not None else default_cache()
    out: Dict[str, dict] = {}
    for family in families or families_for(spec, backend):
        winner, record = _measure_family(family, g, spec, backend, dev)
        cache.put(_key(family, g, spec, backend, dev), winner, measurement=record)
        out[family] = record
    cache.save()
    return out
