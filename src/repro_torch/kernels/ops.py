"""Device dispatch over the kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version. A CUDA tensor launches
the CUDA kernel, which raises when its library cannot be built or loaded;
nothing falls back. The launch and call counters (``kernels.counters``) show
which of the two ran.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bucket_propagate import (bucket_cascade_cuda,
                                                  bucket_cascade_plain,
                                                  bucket_propagate_cuda,
                                                  bucket_propagate_plain)
from repro_torch.kernels.cascade_step import cascade_sweep_cuda, cascade_sweep_plain
from repro_torch.kernels.edges import EdgeOperands, EdgeRows
from repro_torch.kernels.fused_sample import fused_sample_cuda, fused_sample_plain
from repro_torch.kernels.fused_sweep import fused_sweep_cuda, fused_sweep_plain
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


def fused_sample(h: torch.Tensor, lo: torch.Tensor, thr: torch.Tensor, x: torch.Tensor, *,
                 variant: int) -> torch.Tensor:
    fn = fused_sample_cuda if _kernel(h) else fused_sample_plain
    return fn(h, lo, thr, x, variant=variant)


def fused_sweep(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor, *, variant: int,
                num_sweeps: int = 1, lane_fill: int = 0) -> torch.Tensor:
    fn = fused_sweep_cuda if _kernel(m) else fused_sweep_plain
    return fn(m, rows, x, variant=variant, num_sweeps=num_sweeps, lane_fill=lane_fill)


def bucket_propagate(acc: torch.Tensor, block: torch.Tensor, rows: EdgeRows,
                     x: torch.Tensor, *, variant: int,
                     partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    fn = bucket_propagate_cuda if _kernel(acc) else bucket_propagate_plain
    return fn(acc, block, rows, x, variant=variant, partial=partial)


def bucket_cascade(acc: torch.Tensor, block: torch.Tensor, rows: EdgeRows,
                   x: torch.Tensor, *, variant: int,
                   partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    fn = bucket_cascade_cuda if _kernel(acc) else bucket_cascade_plain
    return fn(acc, block, rows, x, variant=variant, partial=partial)
