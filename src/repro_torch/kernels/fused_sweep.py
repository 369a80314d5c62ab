"""``num_sweeps`` Jacobi SIMULATE sweeps in one call, over slots grouped
by write row: each sweep, where the predicate fires on slot (w, r) for
register j, ``next[w, j] = max(next[w, j], cur[r, j])`` from ``next = cur``,
VISITED entries kept. Both w and r index rows of ``m`` (the serial ring's
kk = 0 bucket: a shard's own block).

``fused_sweep_cuda`` launches ``csrc/fused_sweep.cu``, which replaces the
Pallas kernel ``src/repro/kernels/fused_sweep.py`` (``fused_sweep_pallas``):
``num_sweeps`` whole-card work-item sweeps over ``rows.work`` (made with
``edges.with_work``), one after another on the current stream, ping-ponging
between the output and a scratch matrix; each call allocates those two and
the split rows' partial scratch (``num_partials x J`` bytes).
``fused_sweep_plain`` is its plain PyTorch version. Both return a new
matrix and leave ``m`` as it was. ``lane_fill`` (the reference's register
slab width) is accepted and ignored: the result does not depend on it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.bucket_propagate import merge_propagate_plain
from repro_torch.kernels.common import (check_cuda, check_rows, item_operands,
                                        partial_scratch, stream, work_of)
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
    work = work_of(rows)
    if num_sweeps == 0:
        return m.clone()
    out = torch.empty_like(m)
    scratch = torch.empty_like(m) if num_sweeps > 1 else out
    partial = partial_scratch(work, m.shape[1], dev)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)   # set by the sweeps, unread
    fn = build.load(NAME)
    build.check(NAME, fn(m.data_ptr(), out.data_ptr(), scratch.data_ptr(), partial.data_ptr(),
                         *item_operands(rows, x), work.num_items, work.num_split, m.shape[1],
                         int(variant), int(num_sweeps), changed.data_ptr(), stream(dev)))
    counters.launched(NAME)
    return out


def fused_sweep_plain(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor, *, variant: int,
                      num_sweeps: int = 1, lane_fill: int = 0) -> torch.Tensor:
    check_rows(m, rows, x)
    _check_counts(num_sweeps, lane_fill)
    counters.plain_called(NAME)
    cur = m
    for _ in range(int(num_sweeps)):
        nxt = cur.clone()
        merge_propagate_plain(nxt, cur, rows, x, variant)
        cur = nxt
    return cur.clone() if cur is m else cur
