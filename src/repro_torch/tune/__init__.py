"""Measured kernel tuning of the port (counterpart of ``repro.tune``).

A per-family ``KernelConfig`` search space (the single path's work-item
geometry, ``item_edges`` and ``item_warps``, and the serial ring's
``local_sweeps``, ``pad_mode``, ``fuse_sweeps``, ``lane_fill``), an autotuner
that times candidates in timed ``obs.trace`` spans with their bandwidth
(``utils.roofline``), and a persistent ``TuningCache`` keyed by kernel family
x backend x device type x diffusion model x size bucket. The backends consult
``resolve_spec`` through ``RunSpec.tuning`` ("off" | "cached" | "auto",
``runtime.base.apply_tuning``); the launchers take ``--tuning``. Tuning
moves time only: seeds and matrices are the same in every mode.
"""
from repro_torch.tune.autotuner import (autotune, families_for, measure_fused_family,
                                        measure_schedule_family, measure_sweep_family,
                                        resolve_spec)
from repro_torch.tune.cache import (CACHE_ENV, DEFAULT_CACHE_PATH, TuningCache, cache_key,
                                    default_cache, reset_default_cache, size_bucket)
from repro_torch.tune.config import (DEFAULT_CONFIGS, KERNEL_FAMILIES, SWEEP_FAMILIES,
                                     KernelConfig, default_config, fused_candidates,
                                     schedule_candidates, spec_overrides, sweep_candidates)

__all__ = [
    "KernelConfig", "KERNEL_FAMILIES", "SWEEP_FAMILIES", "DEFAULT_CONFIGS",
    "sweep_candidates", "schedule_candidates", "fused_candidates",
    "spec_overrides", "default_config",
    "TuningCache", "cache_key", "size_bucket", "default_cache",
    "reset_default_cache", "CACHE_ENV", "DEFAULT_CACHE_PATH",
    "autotune", "resolve_spec", "families_for",
    "measure_sweep_family", "measure_schedule_family", "measure_fused_family",
]
