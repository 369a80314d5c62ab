"""Device dispatch over the four kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version. A CUDA tensor launches
the CUDA kernel, which raises when its library cannot be built or loaded;
nothing falls back. The launch and call counters (``kernels.counters``) show
which of the two ran.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cascade_step import cascade_sweep_cuda, cascade_sweep_plain
from repro_torch.kernels.edges import EdgeOperands
from repro_torch.kernels.sketch_cardinality import (cardinality_stats_cuda,
                                                    cardinality_stats_plain)
from repro_torch.kernels.sketch_fill import sketch_fill_cuda, sketch_fill_plain
from repro_torch.kernels.sketch_propagate import (propagate_sweep_cuda,
                                                  propagate_sweep_plain)


def _kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use cuda or cpu")


def sketch_fill(m: torch.Tensor, *, reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    fn = sketch_fill_cuda if _kernel(m) else sketch_fill_plain
    return fn(m, reg_offset=reg_offset, seed=seed)


def cardinality_stats(m: torch.Tensor) -> torch.Tensor:
    return (cardinality_stats_cuda if _kernel(m) else cardinality_stats_plain)(m)


def propagate_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                    variant: int):
    fn = propagate_sweep_cuda if _kernel(m) else propagate_sweep_plain
    return fn(m, edges, x, variant=variant)


def cascade_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                  variant: int):
    fn = cascade_sweep_cuda if _kernel(m) else cascade_sweep_plain
    return fn(m, edges, x, variant=variant)
