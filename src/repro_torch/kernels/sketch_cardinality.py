"""Per-row cardinality statistics: ``float32[2, n]`` holding, per row u,
``sum over valid j of 2^-M[u, j]`` and the number of valid j (valid: not
VISITED).

``cardinality_stats_cuda`` launches ``csrc/sketch_cardinality.cu``, which
replaces the Pallas kernel ``src/repro/kernels/sketch_cardinality.py``
(``cardinality_stats_pallas``). Both it and ``cardinality_stats_plain`` sum
``2^(32 - M)`` exactly in 64-bit integers, round once to float32 and scale
by 2^-32, so the two agree bit for bit whatever their order of summation.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import VISITED
from repro_torch.kernels import build, counters
from repro_torch.kernels.common import PLAIN_STEP, check_cuda, check_matrix, stream

NAME = "sketch_cardinality"
_SCALE = 2.0 ** -32


def cardinality_stats_cuda(m: torch.Tensor) -> torch.Tensor:
    check_matrix(m)
    dev = check_cuda(m)
    n, j = m.shape
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    fn = build.load(NAME)
    build.check(NAME, fn(m.data_ptr(), out.data_ptr(), n, j, stream(dev)))
    counters.launched(NAME)
    return out


def cardinality_stats_plain(m: torch.Tensor) -> torch.Tensor:
    check_matrix(m)
    counters.plain_called(NAME)
    n, num_regs = m.shape
    out = torch.empty((2, n), dtype=torch.float32, device=m.device)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for r0 in range(0, n, step):
        blk = m[r0:r0 + step].to(torch.int64)
        valid = blk != VISITED
        pow2 = torch.where(valid, torch.ones_like(blk) << (32 - blk), torch.zeros_like(blk))
        out[0, r0:r0 + step] = pow2.sum(1).to(torch.float32) * _SCALE
        out[1, r0:r0 + step] = valid.sum(1).to(torch.float32)
    return out
