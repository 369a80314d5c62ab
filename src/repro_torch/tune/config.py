"""Kernel tuning search space: one ``KernelConfig`` per kernel family.

Counterpart of the reference's ``tune/config.py``, retargeted to the port's
knobs. The reference tunes Pallas tiles (``edge_block``, ``reg_tile``) and
``lax.scan`` chunks; the port has neither. Its single-path sweeps
(``sketch_propagate``, ``cascade_step``) walk work items
(``kernels.edges.WorkList``), and the two knobs of that walk are the item's
size, ``item_edges`` (``edges.CHUNK`` = 256 by default), and the block shape,
``item_warps`` (``edges.ITEM_WARPS`` = 4 by default; ``kernels.build``
compiles the sweeps at every shape of ``build.ITEM_WARPS``). The ring's knobs
(``local_sweeps``, ``pad_mode``, ``fuse_sweeps``, ``lane_fill``) are the
reference's. Every knob is performance-only: max and OR merges give the same
bytes however a row's edges are cut, launched or scheduled, and extra
comm-free sweeps move no fixpoint.

Candidates are seeded from measurements where the reference seeds them:
``schedule_candidates`` and ``fused_candidates`` read the planner's
``PlanStats`` and the last published ``obs.shardprof.MeasuredProfile``, with
the reference's logic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.kernels.build import ITEM_WARPS as BUILT_WARPS
from repro_torch.kernels.edges import CHUNK, ITEM_WARPS

#: kernel families the tuner knows how to time and thread
KERNEL_FAMILIES = ("fused_sample", "sketch_propagate", "cascade_step",
                   "bucket_propagate", "fused_sweep")

#: families whose knob is the single-device sweep geometry
SWEEP_FAMILIES = ("fused_sample", "sketch_propagate", "cascade_step")

#: the item sizes ``sweep_candidates`` offers (edges an item)
ITEM_EDGES = (64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the per-family search space.

    ``item_edges``: the most edges of a work item of the single path's
    sweeps (0 = ``edges.CHUNK``). ``item_warps``: warps, and so items, a
    block of those sweeps (0 = ``edges.ITEM_WARPS``; one of
    ``build.ITEM_WARPS``). ``local_sweeps``: comm-free sweeps before each
    ring sweep (``bucket_propagate`` family). ``pad_mode``: bucket padding of
    the 2-D partition, "step" | "global" (``bucket_propagate``).
    ``fuse_sweeps``: run the ``local_sweeps`` prologue as one ``fused_sweep``
    call per shard (``fused_sweep`` family). ``lane_fill``: the reference's
    register slab of the fused sweep (``fused_sweep``; the port's kernel takes
    and ignores it).
    """

    item_edges: int = 0
    item_warps: int = 0
    local_sweeps: int = 0
    pad_mode: str = "step"
    fuse_sweeps: bool = False
    lane_fill: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        """From a cache entry; keys of other fields (the reference's
        ``edge_block``, ``reg_tile``) are ignored."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def geometry(self) -> Tuple[int, int]:
        """``(item_edges, item_warps)`` with the defaults filled in."""
        return self.item_edges or CHUNK, self.item_warps or ITEM_WARPS


#: today's defaults, per family: what ``tuning="off"`` runs and what every
#: measured speedup is reported against
DEFAULT_CONFIGS = {
    "fused_sample": KernelConfig(),
    "sketch_propagate": KernelConfig(),
    "cascade_step": KernelConfig(),
    "bucket_propagate": KernelConfig(),
    "fused_sweep": KernelConfig(),
}


def sweep_candidates(num_edges: int) -> Tuple[KernelConfig, ...]:
    """Work-item geometries for the single-path sweep families: ``item_edges``
    in ``ITEM_EDGES`` times ``item_warps`` in ``build.ITEM_WARPS``. An item
    size above the edge count is clamped to it; candidates that clamp to the
    same geometry as an earlier one are dropped. The default geometry comes
    first, as ``KernelConfig()``."""
    cap = max(int(num_edges), 1)
    seen = {(min(CHUNK, cap), ITEM_WARPS)}
    out = [KernelConfig()]
    for warps in BUILT_WARPS:
        for edges in ITEM_EDGES:
            geo = (min(edges, cap), int(warps))
            if geo not in seen:
                seen.add(geo)
                out.append(KernelConfig(item_edges=geo[0], item_warps=geo[1]))
    return tuple(out)


def _comm_fraction(stats=None, profile=None) -> Optional[float]:
    """Measured exchange share of sweep traffic: the planner's (predicted or
    measured) ring bytes per sweep against the per-sweep bucket bytes of the
    last published ``MeasuredProfile``. ``None`` when either signal is
    missing; callers fall back to a conservative probe."""
    if stats is None or not getattr(stats, "ring_bytes_per_sweep", 0):
        return None
    ring = float(stats.ring_bytes_per_sweep)
    local = None
    if profile is not None:
        try:
            import numpy as np

            per_sweep = max(int(getattr(profile, "sweeps", 0)), 1)
            local = float(np.asarray(profile.step_bytes).sum()) / per_sweep
        except (AttributeError, TypeError, ValueError):
            local = None
    if local and local > 0:
        return ring / (ring + local)
    return None


def schedule_candidates(stats=None, profile=None, *, pad_mode: str = "step",
                        max_local_sweeps: int = 2) -> Tuple[KernelConfig, ...]:
    """``(local_sweeps, pad_mode)`` candidates for ``bucket_propagate``,
    seeded from measured signals instead of the full grid:

    * ``local_sweeps`` > 0 is only worth timing when exchanges are a
      non-trivial share of sweep traffic (``_comm_fraction``); without a
      profile the conservative (0, 1) pair is explored;
    * ``pad_mode="global"`` is only a candidate when the step-mode pad waste
      is already small (< 10%), otherwise global padding inflates it.
    """
    sweeps = [0]
    comm_frac = _comm_fraction(stats, profile)
    if comm_frac is None:
        sweeps.append(1)                      # no measurement: probe one step
    else:
        if comm_frac > 0.05:
            sweeps.append(1)
        if comm_frac > 0.20 and max_local_sweeps >= 2:
            sweeps.append(2)
    pads = [pad_mode]
    waste = getattr(stats, "pad_waste_frac", None) if stats is not None else None
    if pad_mode == "step" and waste is not None and waste < 0.10:
        pads.append("global")
    out = []
    for pm in pads:
        for ls in sweeps:
            out.append(KernelConfig(local_sweeps=int(ls), pad_mode=pm))
    return tuple(dict.fromkeys(out))


def _remixed_lanes(model) -> bool:
    """True when ``model``'s predicate remixes the per-(vertex, sample)
    uniform (``lt``'s extra fmix32: the kernels' predicate form 1), which
    decorrelates which lanes fire per edge."""
    from repro_torch.diffusion import resolve

    try:
        return resolve(model).variant == 1
    except (KeyError, TypeError, ValueError):
        return False


def fused_candidates(stats=None, profile=None, *, model: str = "wc",
                     num_regs: int = 0) -> Tuple[KernelConfig, ...]:
    """``(fuse_sweeps, lane_fill)`` candidates for the ``fused_sweep``
    family, seeded like ``schedule_candidates``:

    * the unfused sweep loop is always the baseline (callers prepend the
      family default);
    * lane fills come from the register width: 256 and 512 above 512
      registers, 256 above 256;
    * remixed-predicate models (``lt``) also get the denser 128-lane fill
      above 128 registers;
    * when the measured comm fraction says exchanges are nearly free
      (< 5%), only the full-width fused candidate is probed.
    """
    fills = [0]
    if num_regs > 512:
        fills += [256, 512]
    elif num_regs > 256:
        fills.append(256)
    if _remixed_lanes(model) and num_regs > 128:
        fills.append(128)
    comm_frac = _comm_fraction(stats, profile)
    if comm_frac is not None and comm_frac < 0.05:
        fills = fills[:1]
    return tuple(KernelConfig(fuse_sweeps=True, lane_fill=int(f)) for f in fills)


def spec_overrides(family: str, cfg: KernelConfig, spec) -> dict:
    """A family's winning ``KernelConfig`` as ``RunSpec`` field overrides.

    ``sketch_propagate`` owns the propagate sweep's ``item_edges`` and the
    block shape ``item_warps``, which both sweeps share (one block shape a
    spec, as the reference's Pallas tiles follow its propagate winner);
    ``cascade_step`` owns ``cascade_item_edges``. ``bucket_propagate`` owns
    the ring schedule, ``fused_sweep`` the fused prologue.
    """
    if family == "sketch_propagate":
        return {"item_edges": int(cfg.item_edges or 0),
                "item_warps": int(cfg.item_warps or 0)}
    if family == "cascade_step":
        return {"cascade_item_edges": int(cfg.item_edges or 0)}
    if family == "bucket_propagate":
        return {"local_sweeps": int(cfg.local_sweeps), "pad_mode": cfg.pad_mode}
    if family == "fused_sweep":
        return {"fuse_sweeps": bool(cfg.fuse_sweeps), "lane_fill": int(cfg.lane_fill)}
    return {}                          # fused_sample: no spec-level knob


def default_config(family: str) -> KernelConfig:
    """The deterministic fallback on a cache miss: today's defaults."""
    return DEFAULT_CONFIGS.get(family, KernelConfig())
