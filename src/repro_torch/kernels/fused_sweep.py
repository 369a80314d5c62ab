"""``num_sweeps`` Jacobi SIMULATE sweeps in one launch, over slots grouped
by write row: each sweep, where the predicate fires on slot (w, r) for
register j, ``next[w, j] = max(next[w, j], cur[r, j])`` from ``next = cur``,
VISITED entries kept. Both w and r index rows of ``m`` (the serial ring's
kk = 0 bucket: a shard's own block).

``fused_sweep_cuda`` launches ``csrc/fused_sweep.cu``, which replaces the
Pallas kernel ``src/repro/kernels/fused_sweep.py`` (``fused_sweep_pallas``);
``fused_sweep_plain`` is its plain PyTorch version. Both return a new
matrix and leave ``m`` as it was. ``lane_fill`` (the reference's register
slab width) is accepted and ignored: the result does not depend on it, and
the CUDA kernel picks its own slab.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.bucket_propagate import merge_propagate_plain
from repro_torch.kernels.common import check_cuda, check_rows, stream
from repro_torch.kernels.edges import EdgeRows

NAME = "fused_sweep"


def _check_counts(num_sweeps: int, lane_fill: int) -> None:
    if int(num_sweeps) < 0 or int(lane_fill) < 0:
        raise ValueError(f"num_sweeps and lane_fill must be >= 0, got {num_sweeps}, "
                         f"{lane_fill}")


def fused_sweep_cuda(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor, *, variant: int,
                     num_sweeps: int = 1, lane_fill: int = 0) -> torch.Tensor:
    check_rows(m, rows, x)
    _check_counts(num_sweeps, lane_fill)
    dev = check_cuda(m)
    if num_sweeps == 0:
        return m.clone()
    out = torch.empty_like(m)
    scratch = torch.empty_like(m) if num_sweeps > 1 else out
    fn = build.load(NAME)
    build.check(NAME, fn(m.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                         rows.rowptr.data_ptr(), rows.nbr.data_ptr(), rows.h.data_ptr(),
                         rows.lo.data_ptr(), rows.thr.data_ptr(), x.data_ptr(),
                         m.shape[0], m.shape[1], int(variant), int(num_sweeps),
                         stream(dev)))
    counters.LAUNCHES[NAME] += 1
    return out


def fused_sweep_plain(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor, *, variant: int,
                      num_sweeps: int = 1, lane_fill: int = 0) -> torch.Tensor:
    check_rows(m, rows, x)
    _check_counts(num_sweeps, lane_fill)
    counters.PLAIN_CALLS[NAME] += 1
    cur = m
    for _ in range(int(num_sweeps)):
        nxt = cur.clone()
        merge_propagate_plain(nxt, cur, rows, x, variant)
        cur = nxt
    return cur.clone() if cur is m else cur
